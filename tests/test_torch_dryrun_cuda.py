"""The dry run's prediction of a program against the card's run of it.

This file imports neither ``jax`` nor the reference package and skips
without a CUDA device; on a GPU host run
``pytest tests/test_torch_dryrun_cuda.py``.  A small forward (phi4-mini's
smoke config at head dim 64, one of the attention kernel's, 2 x 256 tokens)
is traced on a fake one-rank world on ``CardTrace`` fake tensors (as the dry
run traces the card's program) and then run once on the card: the kernel
launches the walk predicts are the ones every wrapper counts, and its peak memory above its inputs is the allocator's
within 2 MiB (blocks the caching allocator hands out whole).
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core.dist import init_fake_world
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import gemm, relayout
from repro_torch.kernels.fake import card_trace
from repro_torch.launch.op_walk import OpWalk
from repro_torch.models import lm
from repro_torch.models.weights import cast_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the GPU)")
    yield torch.device("cuda")


def test_forward_prediction_matches_the_card(cuda):
    cfg = dataclasses.replace(configs.get("phi4-mini-3.8b", smoke=True), head_dim=64)
    B, S = 2, 256
    init_fake_world(1, 0, "cuda")
    try:
        mode, dev = card_trace("cuda")
        with mode:
            fparams = cast_params(lm.abstract_model(cfg, device=dev), cfg.act_dtype)
            fbatch = {"tokens": torch.empty((B, S), dtype=torch.int64, device=dev)}
            with OpWalk() as walk:
                out = lm.forward(fparams, fbatch, cfg)
            del out
    finally:
        dist.destroy_process_group()
    st = walk.stats()

    params = cast_params(lm.init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                                       device=cuda), cfg.act_dtype)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), device=cuda)}
    lm.forward(params, batch, cfg)  # warm-up: cuBLAS maps its workspace once
    torch.cuda.synchronize()
    counters = {"flash_attention_kernel": fa.flash_attention_cuda,
                "flash_attention_carry_kernel": fa.flash_attention_carry_cuda,
                "flash_decode_kernel": fd.flash_decode_cuda,
                "layout_gemm_kernel": gemm.gemm_cuda,
                "layout_gemm_panel_kernel": gemm.gemm_panel_cuda,
                "layout_gemm_bf16_kernel": gemm.gemm_bf16_cuda,
                "layout_gemm_panel_bf16_kernel": gemm.gemm_panel_bf16_cuda,
                "transpose_kernel": relayout.transpose_cuda}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = lm.forward(params, batch, cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    assert st.kernel_launches == {"flash_attention_kernel": cfg.n_layers}
    assert {k: fn.launches for k, fn in counters.items() if fn.launches} == st.kernel_launches
    assert abs(st.peak_live_bytes - peak) <= 2 << 20, (st.peak_live_bytes, peak)
    assert out[0].shape == (B, S, cfg.vocab_padded)
