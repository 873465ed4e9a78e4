"""Model families of the port (dense decoder LM so far)."""
from repro_torch.models.api import build_model  # noqa: F401
