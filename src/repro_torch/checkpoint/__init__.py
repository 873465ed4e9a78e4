"""Crash-consistent .npz checkpoints (the port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.store import (CheckpointCorruptError,  # noqa: F401
                                          available_steps, gc_checkpoints,
                                          latest_step, leaf_name,
                                          load_arrays, load_metadata,
                                          restore_checkpoint,
                                          save_checkpoint)
