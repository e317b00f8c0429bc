"""The port's checkpoint manager: the five non-slow cases of the
reference's ``tests/test_checkpoint.py`` (round trip, latest and rotation,
asynchronous save, corruption detected, a crashed write leaves the earlier
checkpoint), on trees of tensors, plus the optimizer state's named tuple
and a bf16 leaf.  Restoring under another world size (the reference's
``slow`` case) runs on gloo ranks in ``tests/test_torch_recipe_train.py``."""
import os

import numpy as np
import pytest
import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.train.optimizer import OptConfig, OptState, init_opt_state


def tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn(4, 8, generator=g),
        "nested": {"b": torch.arange(12, dtype=torch.int32), "c": torch.tensor(3.5)},
        "h": torch.randn(3, generator=g).to(torch.bfloat16),
    }


def _leaves(t):
    return [t["a"], t["h"], t["nested"]["b"], t["nested"]["c"]]


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    t = tree()
    mgr.save(7, t, extra={"loss": 1.25})
    restored, extra = mgr.restore(tree(1))
    assert extra["loss"] == 1.25
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_and_rotation(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree(s))
    assert mgr.latest_step() == 4
    assert mgr.all_steps() == [3, 4]  # rotated


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(5, tree())
    mgr.wait()
    assert mgr.latest_step() == 5
    restored, _ = mgr.restore(tree())
    assert restored["nested"]["b"].shape == (12,)


def test_corruption_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree())
    # flip bytes in an array file
    path = os.path.join(str(tmp_path), "step_00000001", "leaf_0.npy")
    data = bytearray(open(path, "rb").read())
    data[len(data) - 5] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(IOError, match="corruption"):
        mgr.restore(tree())


def test_crash_mid_write_preserves_previous(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree(1))
    # simulate a crashed partial write (tmp dir left behind)
    os.makedirs(os.path.join(str(tmp_path), "step_00000002.tmp-999"), exist_ok=True)
    assert mgr.latest_step() == 1
    restored, _ = mgr.restore(tree())
    assert torch.equal(restored["a"], tree(1)["a"])


def test_optimizer_state_roundtrip(tmp_path):
    params = {"w": torch.randn(3, 4), "b": {"c": torch.randn(2)}}
    opt = init_opt_state(params, OptConfig(compress="int8"))
    opt = opt._replace(step=opt.step + 9, mu={"w": torch.ones(3, 4), "b": {"c": torch.ones(2)}})
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(9, {"params": params, "opt": opt})
    restored, _ = mgr.restore({"params": params, "opt": init_opt_state(params,
                                                                       OptConfig(compress="int8"))})
    assert isinstance(restored["opt"], OptState) and int(restored["opt"].step) == 9
    assert restored["opt"].step.dtype == torch.int32
    assert torch.equal(restored["opt"].mu["w"], torch.ones(3, 4))
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"params": params})
    np.testing.assert_array_equal(restored["params"]["w"].numpy(), params["w"].numpy())
