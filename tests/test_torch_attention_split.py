"""The arithmetic and the launch plan of the port's tensor-core attention, on the CPU.

The bf16 bodies of ``src/repro_torch/kernels/csrc/flash_attention.cu`` and
``flash_decode.cu`` run only on the card.  What the forward computes: scores
``q . k`` as float32 sums of exact bf16 products, scaled afterwards, the
online softmax over 64-key tiles, and ``p @ v`` with the float32 ``p`` split
into bf16 pieces (hi = bf16(p), lo = bf16(p - hi), ...), each multiplied into
one float32 sum.  These tests emulate that arithmetic in plain PyTorch and
hold its accuracy against a float64 computation (at most 10x the plain
version's error, the port's rule for split products), and check the decode
wrapper's launch plan and the key tile's fit to the ring's chunks.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels.flash_attention import KEY_TILE, P_PIECES
from repro_torch.kernels.ref import NEG_INF, flash_attention_ref
from repro_torch.models.sharding import ragged_seq_extents

ACCURACY_RATIO = 10  # error vs float64 at most this times the plain version's
H100_SMS = 132


def split_pieces(p: torch.Tensor, pieces: int) -> list[torch.Tensor]:
    """float32 ``p`` as ``pieces`` bf16 tensors, each the nearest bf16 of
    what the earlier ones leave (the kernel's ``pack_bf16`` loop)."""
    out, rest = [], p
    for _ in range(pieces):
        piece = rest.to(torch.bfloat16)
        out.append(piece)
        rest = rest - piece.float()  # exact: piece is within half an ulp of rest
    return out


def _bf16_values(rng, shape) -> torch.Tensor:
    """Seeded normals rounded to bf16, held in float32."""
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16().float()


@pytest.mark.parametrize("pieces", [1, 2, 3])
def test_pieces_are_bf16_and_sum_back(pieces):
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.random(4096).astype(np.float32))  # probabilities in [0, 1)
    parts = split_pieces(p, pieces)
    assert all(part.dtype == torch.bfloat16 for part in parts)
    total = sum(part.double() for part in parts)
    rel = ((total - p.double()).abs() / p.double().clamp_min(1e-30)).max().item()
    # each piece rounds what is left to bf16's 8 significant bits, within
    # 2^-8 of it: at worst 2^-8 of p after one piece, 2^-16 after two, 2^-24
    # after three; these probabilities sum back within 2^-17 after two
    assert rel <= 2.0 ** (-8 * pieces)
    if pieces == 2:
        assert rel <= 2.0 ** -17


def emulate_forward(q, k, v, *, pieces: int, scale: float) -> torch.Tensor:
    """One head's causal forward as the bf16 kernel computes it: q (Sq, D),
    k, v (Skv, D) float32 holding bf16 values; 64-key tiles."""
    Sq, Skv = q.shape[0], k.shape[0]
    m = torch.full((Sq,), NEG_INF)
    l = torch.zeros(Sq)
    o = torch.zeros((Sq, v.shape[1]))
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, KEY_TILE):
        kt, vt = k[k0:k0 + KEY_TILE], v[k0:k0 + KEY_TILE]
        s = (q @ kt.T) * scale  # exact bf16 products, float32 sums; the scale after
        s = torch.where(rows >= k0 + torch.arange(kt.shape[0])[None, :], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[:, None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = sum(part.float() @ vt for part in reversed(split_pieces(p, pieces)))
        o = o * alpha[:, None] + pv
        m = m_new
    return o / l[:, None]


def exact_forward(q, k, v, *, scale: float) -> torch.Tensor:
    s = (q.double() @ k.double().T) * scale
    causal = torch.ones(s.shape, dtype=torch.bool).tril()
    p = torch.softmax(torch.where(causal, s, torch.full_like(s, NEG_INF)), dim=-1)
    return p @ v.double()


@pytest.mark.parametrize("pieces", [1, 2, 3])
def test_emulated_forward_tile_against_float64(pieces):
    """One head of 256 query rows over 256 keys at D = 128: one bf16 piece of
    p misses the 10x rule by far; the kernel's two pieces, and three, keep
    it."""
    rng = np.random.default_rng(1)
    S, D = 256, 128
    q, k, v = (_bf16_values(rng, (S, D)) for _ in range(3))
    scale = D ** -0.5
    exact = exact_forward(q, k, v, scale=scale)
    plain = flash_attention_ref(q[None, None], k[None, None], v[None, None], causal=True)[0, 0]
    plain_err = (plain.double() - exact).abs().max().item()
    err = (emulate_forward(q, k, v, pieces=pieces, scale=scale).double() - exact).abs().max().item()
    ratio = err / plain_err
    if pieces == 1:
        assert ratio > ACCURACY_RATIO, ratio
    else:
        assert ratio <= ACCURACY_RATIO, ratio
    assert P_PIECES == 2


@pytest.mark.parametrize("case,shape,want", [
    # (rows = Hq/G * S, groups = B * G, KV blocks, D, bk): (tr, splits, per)
    ("decode_step", (3, 32, 8, 128, 512), (1, 8, 1)),         # 4 slots, cache 4096
    ("prefill_chunk", (6144, 32, 8, 128, 512), (4, 1, 8)),    # 4 x 2048 queries
    ("T_not_divided", (3, 32, 8, 128, 512), (1, 8, 1)),       # cache 4000: 8 blocks, the last 416
    ("rows_16_to_64", (24, 4, 3, 128, 128), (1, 3, 1)),
    ("head_dim_64", (6144, 32, 8, 64, 512), (4, 1, 8)),
])
def test_plan_launch_at_the_paths_shapes(case, shape, want):
    rows, groups, nb, D, bk = shape
    assert fd.plan_launch(rows, groups, nb, D, bk, H100_SMS, fd.smem_bytes) == want


def test_plan_launch_takes_16_row_tiles_where_64_do_not_fit():
    # 1024-key blocks: 64 rows of scores need 256 KB, 16 rows 64 KB
    assert fd.smem_bytes(128, 4, 1024) > fd.MAX_SMEM >= fd.smem_bytes(128, 1, 1024)
    assert fd.plan_launch(6144, 32, 4, 128, 1024, H100_SMS, fd.smem_bytes)[0] == 1


def test_plan_launch_refuses_a_block_that_does_not_fit():
    assert fd.smem_bytes(128, 1, 4096) > fd.MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        fd.plan_launch(3, 32, 1, 128, 4096, H100_SMS, fd.smem_bytes)


def test_smem_bytes_of_the_bf16_body():
    """The figures the source note gives (D = 128, 512-key blocks): 209 KB
    at 64 rows, 101 KB at 16, so that two 16-row blocks share an SM's
    228 KB; the float32 body needs less."""
    ring = 4 * 64 * 128 * 2
    assert fd.smem_bytes(128, 4, 512) == 1024 + 64 * 256 + ring + 4 * 64 * 512 + 4 * 16 + 16
    assert fd.smem_bytes(128, 1, 512) == 1024 + 16 * 256 + ring + 4 * 16 * 512 + 4 * 16 + 16
    assert round(fd.smem_bytes(128, 4, 512) / 1024) == 209
    assert round(fd.smem_bytes(128, 1, 512) / 1024) == 101
    assert 2 * (fd.smem_bytes(128, 1, 512) + 1024) <= 228 * 1024


@pytest.mark.parametrize("S", [4096, 4095])
def test_key_tile_divides_every_chunk_start_of_the_ring(S):
    """The carry chain equals the single-shot kernel bitwise when every KV
    chunk starts on a key tile: the 4-rank ring's chunks start at multiples
    of its capacity (1024 for 4096 and for the ragged 4095)."""
    cap, extents = ragged_seq_extents(S, 4)
    starts = [r * cap for r in range(len(extents))]
    assert cap == 1024 and sum(extents) == S
    assert all(start % KEY_TILE == 0 for start in starts)
