"""The port's .npz checkpoint store (``repro_torch.checkpoint``): the
cases of ``tests/test_checkpoint.py`` on the port's store, and archives
of one tree written by both packages holding the same member names and
arrays."""
import json
import os

import numpy as np
import pytest

import torch

from repro import checkpoint as jcheckpoint
from repro_torch.checkpoint import (CheckpointCorruptError, available_steps,
                                    gc_checkpoints, latest_step, leaf_name,
                                    load_arrays, load_metadata,
                                    restore_checkpoint, save_checkpoint)


def _tree():
    return {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "nested": {"b": np.ones((4,), np.int32)},
            "list": [np.zeros((2,)), np.full((1,), 7.0)]}


def test_roundtrip(tmp_path):
    d = str(tmp_path)
    t = _tree()
    save_checkpoint(d, 5, t, metadata={"loss": 1.25})
    out = restore_checkpoint(d, t)
    assert np.allclose(out["a"], t["a"])
    assert np.allclose(out["nested"]["b"], t["nested"]["b"])
    assert np.allclose(out["list"][1], 7.0)


def test_latest_step_and_multiple(tmp_path):
    d = str(tmp_path)
    assert latest_step(d) is None
    save_checkpoint(d, 1, _tree())
    save_checkpoint(d, 12, _tree())
    assert latest_step(d) == 12
    restore_checkpoint(d, _tree())       # restores step 12 by default


def test_shape_mismatch_raises(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, {"a": np.zeros((2,))})
    with pytest.raises(ValueError):
        restore_checkpoint(d, {"a": np.zeros((3,))})


def test_missing_leaf_raises(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, {"a": np.zeros((2,))})
    with pytest.raises(KeyError):
        restore_checkpoint(d, {"a": np.zeros((2,)), "b": np.zeros((1,))})


# ------------------------------------------- crash consistency + retention
def _corrupt(d, step):
    path = os.path.join(d, f"step_{step:08d}.npz")
    with open(path, "r+b") as f:        # truncate mid-archive
        f.truncate(os.path.getsize(path) // 2)


def test_metadata_sidecar_roundtrip(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 3, _tree(), metadata={"round": 3, "note": "x"})
    assert load_metadata(d, 3) == {"round": 3, "note": "x"}
    assert load_metadata(d, 99) is None


def test_gc_checkpoints_keeps_newest(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 5, 8):
        save_checkpoint(d, s, _tree(), metadata={"round": s})
    deleted = gc_checkpoints(d, keep=2)
    assert deleted == [1, 2]
    assert available_steps(d) == [5, 8]
    # metadata sidecars of the deleted steps are gone too
    assert load_metadata(d, 1) is None
    assert load_metadata(d, 5) == {"round": 5}
    with pytest.raises(ValueError):
        gc_checkpoints(d, keep=0)


def test_corrupt_archive_raises_clear_error(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 4, _tree())
    _corrupt(d, 4)
    with pytest.raises(CheckpointCorruptError, match="corrupt or partial"):
        load_arrays(d, step=4)          # explicit step: never falls back
    with pytest.raises(CheckpointCorruptError):
        restore_checkpoint(d, _tree(), step=4)


def test_corrupt_latest_falls_back_to_previous(tmp_path):
    d = str(tmp_path)
    t = _tree()
    save_checkpoint(d, 1, t)
    t2 = {**t, "a": t["a"] + 100.0}
    save_checkpoint(d, 2, t2)
    _corrupt(d, 2)
    with pytest.warns(UserWarning, match="falling back"):
        step, arrs = load_arrays(d)
    assert step == 1
    with pytest.warns(UserWarning, match="falling back"):
        out = restore_checkpoint(d, t)
    assert np.allclose(out["a"], t["a"])        # step 1's values
    with pytest.raises(CheckpointCorruptError):
        load_arrays(d, fallback=False)


def test_all_corrupt_raises(tmp_path):
    d = str(tmp_path)
    for s in (1, 2):
        save_checkpoint(d, s, _tree())
        _corrupt(d, s)
    with pytest.warns(UserWarning):
        with pytest.raises(CheckpointCorruptError, match="every checkpoint"):
            load_arrays(d)


def test_corrupt_metadata_raises(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree(), metadata={"round": 1})
    with open(os.path.join(d, "step_00000001.json"), "w") as f:
        f.write('{"round": 1')          # truncated json
    with pytest.raises(CheckpointCorruptError, match="metadata"):
        load_metadata(d, 1)


def test_save_is_atomic_no_tmp_left_behind(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree(), metadata={"round": 1})
    assert not [fn for fn in os.listdir(d) if fn.endswith(".tmp")]
    # metadata is valid standalone json
    with open(os.path.join(d, "step_00000001.json")) as f:
        assert json.load(f)["round"] == 1


# ------------------------------------------ names shared with the reference
def test_member_names_and_arrays_match_reference(tmp_path):
    t = dict(_tree(), params={"conv1": torch.arange(4.0).reshape(2, 2)})
    save_checkpoint(str(tmp_path / "ours"), 1, t)
    jt = dict(t, params={"conv1": t["params"]["conv1"].numpy()})
    jcheckpoint.save_checkpoint(str(tmp_path / "theirs"), 1, jt)
    _, ours = load_arrays(str(tmp_path / "ours"))
    _, theirs = jcheckpoint.load_arrays(str(tmp_path / "theirs"))
    assert set(ours) == set(theirs)
    assert leaf_name("params", "conv1") in ours
    assert leaf_name("list", 1) == "['list'][1]" and "['list'][1]" in ours
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_restore_into_tensors(tmp_path):
    d = str(tmp_path)
    t = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "n": torch.tensor([1, 2], dtype=torch.int64)}
    save_checkpoint(d, 2, t)
    out = restore_checkpoint(d, {"w": torch.zeros(2, 3),
                                 "n": torch.zeros(2, dtype=torch.int64)})
    assert isinstance(out["w"], torch.Tensor)
    assert out["w"].dtype == torch.float32 and out["n"].dtype == torch.int64
    assert torch.equal(out["w"], t["w"]) and torch.equal(out["n"], t["n"])
