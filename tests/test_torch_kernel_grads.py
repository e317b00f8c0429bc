"""Gradients through the card's kernel wrappers, on the CPU.

A kernel's wrapper writes its result through ``ctypes`` into a fresh
tensor, so the result carries no autograd history.  On the card,
``ops.flash_attention`` used to return that tensor as it was, and a loss
through it gave q, k and v no gradient, with no error.  The fix routes a
call that wants a gradient through ``ops._FlashAttention``, whose backward
recomputes through the plain version.  The test stands in for the kernel
with a function that does what the wrapper does (a fresh result from the
plain version, computed under ``torch.no_grad()``) and holds the gradients
that reach q, k and v against the plain version's own, to ``1e-6`` (the
same float32 arithmetic, summed in another order by autograd).

The wrappers with no gradient (decode, the GEMMs, the transpose) raise
``TypeError`` for an input that requires grad while grad mode is on.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref


def _qkv(seed, B=2, Hq=4, G=2, S=40, D=16, Dv=16):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return mk(B, Hq, S, D), mk(B, G, S, D), mk(B, G, S, Dv)


def _kernel_stand_in(calls):
    def flash_attention_cuda(q, k, v, *, causal=True, scale=None):
        calls.append(1)
        with torch.no_grad():  # what the ctypes wrapper gives: no history
            return kref.flash_attention_ref(q, k, v, causal=causal, scale=scale).clone()
    return flash_attention_cuda


@pytest.mark.parametrize("causal,Dv", [(True, 16), (False, 16), (True, 8)])
def test_card_forward_attention_passes_the_gradient(monkeypatch, causal, Dv):
    calls = []
    monkeypatch.setattr(ops, "flash_attention_cuda", _kernel_stand_in(calls))
    q, k, v = _qkv(0, Dv=Dv)
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 4, 40, Dv)).astype(np.float32))
    got = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*got, causal=causal, impl="cuda", block=16)
    assert calls == [1] and out.requires_grad
    (out * w).sum().backward()
    want = [t.clone().requires_grad_() for t in (q, k, v)]
    (kref.flash_attention_ref(*want, causal=causal, block=16) * w).sum().backward()
    for a, b, name in zip(got, want, "qkv"):
        assert a.grad is not None, name
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    # without a gradient the kernel's result is returned as it is
    with torch.no_grad():
        assert not ops.flash_attention(*got, causal=causal, impl="cuda").requires_grad
    assert calls == [1, 1]


def test_wrappers_without_a_gradient_refuse_inputs_that_require_grad():
    x = torch.ones(8, 8, requires_grad=True)
    q, k, v = (t.requires_grad_() for t in _qkv(2))
    cache_len = torch.full((2,), 40, dtype=torch.int32)
    calls = [
        lambda: ops.gemm(x, torch.ones(8, 8), impl="cuda"),
        lambda: ops.gemm_panel(x, torch.ones(8, 8), torch.zeros(8, 16), 0, impl="cuda"),
        lambda: ops.transpose_tiled(x, impl="cuda"),
        lambda: ops.flash_decode(q[:, :, :1], k, v, cache_len, impl="cuda"),
        lambda: fa.flash_attention_cuda(q, k, v),
        lambda: fa.flash_attention_carry_cuda(q, k, v, (torch.zeros(2, 4, 40, 16),
                                                        torch.zeros(2, 4, 40),
                                                        torch.zeros(2, 4, 40))),
    ]
    for call in calls:
        with pytest.raises(TypeError, match="has no gradient"):
            call()
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            call()  # grad mode off: the device check speaks instead
