"""Gradients through the card's attention kernels, on the card.

``ops.flash_attention`` on CUDA tensors that require grad runs the kernel
forward inside ``_FlashAttention`` and recomputes the backward through the
plain version; the carry step does the same in ``_CarryStep``.  Held: the
forward launched the kernel once, and q's, k's and v's gradients equal the
plain version's own gradients (the plain forward and its autograd) at
float32 to ``rtol=atol=2e-4`` (float32 sums in another order) and at bf16
to ``rtol=atol=2e-2`` (the cotangent and the gradients are bf16; a bf16 ulp
of a sum over the sequence), for head dims (128, 128) and MLA's (96, 64);
a short training step on the card gives every leaf a finite, nonzero
gradient.  These tests import neither ``jax`` nor the reference package and
skip without a CUDA device.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.models.module import tree_leaves
from repro_torch.train import trainer

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the GPU)")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield torch.device("cuda")
    torch.set_float32_matmul_precision(prev)


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, device=device, generator=g).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", [(128, 128), (96, 64)])
def test_flash_attention_gradient_matches_plain_version(cuda, dtype, dims):
    D, Dv = dims
    B, Hq, G, S = 1, 8, 2, 300
    inputs = [_randn(shape, dtype, cuda, i) for i, shape in
              enumerate(((B, Hq, S, D), (B, G, S, D), (B, G, S, Dv)))]
    w = _randn((B, Hq, S, Dv), dtype, cuda, 9)
    got = [t.clone().requires_grad_() for t in inputs]
    before = fa.flash_attention_cuda.launches
    out = ops.flash_attention(*got)
    assert fa.flash_attention_cuda.launches == before + 1 and out.requires_grad
    (out.float() * w.float()).sum().backward()
    want = [t.clone().requires_grad_() for t in inputs]
    (ops.flash_attention(*want, impl="ref").float() * w.float()).sum().backward()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a.grad, b.grad, rtol=TOL[dtype], atol=TOL[dtype])


def test_carry_step_gradient_matches_plain_version(cuda):
    q, k, v = (_randn((1, 4, 128, 64), torch.bfloat16, cuda, i) for i in range(3))
    got = [t.clone().requires_grad_() for t in (q, k, v)]
    before = fa.flash_attention_carry_cuda.launches
    acc, _, l = ops.flash_attention_carry(*got, q_offset=0, k_offset=0)
    assert fa.flash_attention_carry_cuda.launches == before + 1
    (acc / l[..., None]).sum().backward()
    want = [t.clone().requires_grad_() for t in (q, k, v)]
    acc, _, l = ops.flash_attention_carry(*want, q_offset=0, k_offset=0, impl="ref")
    (acc / l[..., None]).sum().backward()
    for a, b in zip(got, want):
        torch.testing.assert_close(a.grad, b.grad, rtol=2e-2, atol=2e-2)


def test_smoke_train_step_gives_every_leaf_a_gradient(cuda):
    cfg = dataclasses.replace(configs.get("phi4-mini-3.8b", smoke=True), head_dim=64)
    params = lm.init_model(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 65), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    before = fa.flash_attention_cuda.launches
    loss, _, grads = trainer._accum_loss_grads(params, batch, cfg, 2)
    # 2 microbatches x 2 layers x (forward + remat's recompute)
    assert fa.flash_attention_cuda.launches - before == 8
    assert torch.isfinite(loss)
    for g in tree_leaves(grads):
        assert g.dtype == torch.float32 and torch.isfinite(g).all() and g.abs().sum() > 0
