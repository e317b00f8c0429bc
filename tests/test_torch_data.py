"""The port's data pipeline against the reference's: ``make_batch`` gives
the reference's tokens and labels bitwise for steps 0-3, from the
synthetic source and from a memmap file, and the ``embeds`` (musicgen)
and ``tokens+image`` (llama-3.2-vision) kinds' frames and images bitwise
too; ``batch_specs`` gives the reference's shapes and dtypes for every
input kind."""
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.configs.base import ShapeCell as JShapeCell
from repro.data import pipeline as jpipe
from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tpipe

ARCHS = ["phi4-mini-3.8b", "phi3.5-moe-42b-a6.6b", "minicpm3-4b"]


def _cells(kind="train"):
    return JShapeCell("tiny", 32, 4, kind), tpipe.ShapeCell("tiny", 32, 4, kind)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_batches_match_reference_bitwise(arch, seed):
    jc, tc = _cells()
    jcfg, tcfg = jconfigs.get(arch, smoke=True), tconfigs.get(arch, smoke=True)
    for step in range(4):
        want = jpipe.make_batch(jcfg, jc, step, jpipe.DataConfig(seed=seed))
        got = tpipe.make_batch(tcfg, tc, step, tpipe.DataConfig(seed=seed))
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def test_memmap_batches_match_reference_bitwise(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.arange(100000, dtype=np.int32).tofile(path)
    jc, tc = _cells()
    jcfg, tcfg = jconfigs.get("phi4-mini-3.8b", smoke=True), tconfigs.get("phi4-mini-3.8b",
                                                                           smoke=True)
    for step in range(4):
        want = jpipe.make_batch(jcfg, jc, step, jpipe.DataConfig(source="memmap", path=path))
        got = tpipe.make_batch(tcfg, tc, step, tpipe.DataConfig(source="memmap", path=path))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_batch_specs_match_reference(kind):
    jc, tc = _cells(kind)
    want = jpipe.batch_specs(jconfigs.get("phi4-mini-3.8b", smoke=True), jc)
    got = tpipe.batch_specs(tconfigs.get("phi4-mini-3.8b", smoke=True), tc)
    assert {k: (tuple(s.shape), np.dtype(s.dtype)) for k, s in want.items()} == got


def test_input_kinds_not_ported_raise():
    """The two input kinds the port once refused (``embeds``,
    ``tokens+image``) now build a batch, whose leaves, shapes and dtypes are
    those ``batch_specs`` names (bitwise the reference's: the tests
    below)."""
    for arch in ("musicgen-large", "llama-3.2-vision-11b"):
        cfg = tconfigs.get(arch, smoke=True)
        _, tc = _cells()
        got = tpipe.make_batch(cfg, tc, 0)
        specs = tpipe.batch_specs(cfg, tc)
        assert sorted(got) == sorted(specs)
        assert {k: (v.shape, v.dtype) for k, v in got.items()} == specs


@pytest.mark.parametrize("arch", ["musicgen-large", "llama-3.2-vision-11b"])
@pytest.mark.parametrize("seed", [0, 5])
def test_embeds_and_image_batches_match_reference_bitwise(arch, seed):
    """The frames (``embeds``, float32 (B, S, d_model)) and the labels drawn
    after them, or the tokens and then the image (``image_embeds``, float32
    (B, enc_len, enc_dim)), from one generator in the reference's order."""
    jc, tc = _cells()
    jcfg, tcfg = jconfigs.get(arch, smoke=True), tconfigs.get(arch, smoke=True)
    for step in range(3):
        want = jpipe.make_batch(jcfg, jc, step, jpipe.DataConfig(seed=seed))
        got = tpipe.make_batch(tcfg, tc, step, tpipe.DataConfig(seed=seed))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ["musicgen-large", "llama-3.2-vision-11b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_batch_specs_of_both_kinds_match_reference(arch, kind):
    jc, tc = _cells(kind)
    want = jpipe.batch_specs(jconfigs.get(arch, smoke=True), jc)
    got = tpipe.batch_specs(tconfigs.get(arch, smoke=True), tc)
    assert {k: (tuple(s.shape), np.dtype(s.dtype)) for k, s in want.items()} == got
