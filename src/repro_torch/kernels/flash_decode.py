"""The split-KV flash-decode kernel for Hopper and its wrapper.

``csrc/flash_decode.cu`` replaces the reference's Pallas kernel
``flash_decode_pallas`` (``src/repro/kernels/flash_decode.py``) and its
log-sum-exp combine: attention of new queries q (B, Hq, S, D) over the KV
caches k (B, G, T, D) and v (B, G, T, Dv), giving (B, Hq, S, Dv), with
per-row ``cache_len`` (B,) and optional per-query
``q_positions`` (B, S), the probabilities of each KV block of ``block``
keys rounded to the cache dtype relative to that block's own max.  Its
plain version is :func:`repro_torch.kernels.ref.flash_decode_ref`.

The wrapper picks the row tile (16 or 64 rows of the rep*S stacked query
rows, by how many rows there are and what fits in shared memory) and the
number of splits of the KV blocks (enough blocks to cover the card twice),
allocates the splits' float32 partials, and launches the kernel on
PyTorch's current stream.  Rows with no visible key at all (idle slots)
give the reference's mean of v over the padded cache.
``flash_decode_cuda.launches`` counts calls.  Head dims ``(D, Dv)`` are
the pairs of :data:`DECODE_HEAD_DIMS`: one width for q, k and v, or MLA's
q/k of 96 with v of 64.

bf16 caches run the tensor-core body (both products on ``wgmma``, 64-key
tiles by TMA into a ring of :data:`STAGES`), which merges the splits itself
(the last block of each row tile, found with the :func:`arrivals` counts);
float32 caches run the first port's float32 body and a second, combine
kernel.  One plan serves both: :func:`smem_bytes` is the larger of the two
bodies' shared memory.  The bf16 body keeps the TMA maps it encodes in a
cache of 16 (:func:`map_cache_stats` counts its hits and misses).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .fake import address, is_fake, report
from .flash_attention import KERNEL_DTYPES, KEY_TILE, check_on_card, refuse_grad
from .work import flash_decode_work

__all__ = ["flash_decode_cuda", "check_decode", "load_library", "bind", "plan_launch",
           "smem_bytes", "arrivals", "map_cache_stats", "DECODE_HEAD_DIMS"]

# the card's (D, Dv) instances (112: zamba2's shared block; (96, 64): MLA's widths)
DECODE_HEAD_DIMS = ((64, 64), (112, 112), (128, 128), (96, 64))
MAX_SMEM = 232448 - 1024  # bytes one block may opt into on Hopper, less static shared memory
ROW_TILES = (4, 1)  # row-tile factors: 64 or 16 rows per block
STAGES = 4  # K or V tiles in flight in the bf16 body's ring
H100_SMS = 132  # the H100 SXM's SMs: the split plan of a fake call (no card to ask)


def smem_bytes(D: int, tr: int, bk: int, Dv: int | None = None) -> int:
    """Shared memory of one block of the decode kernel at head dims (D, Dv)
    (``Dv`` defaults to D), ``flash_decode_smem_bytes`` of
    ``csrc/flash_decode.cu`` (the card tests hold the two equal): the
    larger of the bf16 body's (alignment slack, the block's 16*tr rows of Q,
    the ring of stages each as large as a K or a V tile, whichever is
    larger, the block's float32 scores for those rows, barriers) and the
    float32 body's (float32 Q, K/V and score tiles, rows padded by 4).  A
    bf16 row takes whole 64-column boxes of 128 bytes, and the float32
    body's V tile is padded to a multiple of 64 columns (112 -> 128), its
    K/V tile as wide as the wider of K's row and V's padded row."""
    Dv = D if Dv is None else Dv
    keys = -(-bk // KEY_TILE) * KEY_TILE
    rows = 16 * tr
    row_bytes = -(-D // 64) * 128  # bf16 bytes a row takes in the boxed layout
    stage = KEY_TILE * max(row_bytes, -(-Dv // 64) * 128)
    kv_cols = max(D, -(-Dv // 64) * 64)
    bf16 = (1024 + rows * row_bytes + STAGES * stage + 4 * rows * keys + 2 * STAGES * 8 + 16)
    fp32 = 4 * (16 * tr * (D + 4) + KEY_TILE * (kv_cols + 4) + 16 * tr * (keys + 4))
    return max(bf16, fp32)


def check_decode(q, k_cache, v_cache, cache_len,
                 q_positions) -> tuple[int, int, int, int, int, int, int]:
    """``(B, Hq, G, S, T, D, Dv)`` of a decode call (v's head dim Dv may
    differ from D, as the reference's); raises ``ValueError`` on shapes
    that do not fit together."""
    if q.ndim != 4 or k_cache.ndim != 4 or v_cache.ndim != 4:
        raise ValueError("q and the caches must be (B, H, S, D)")
    B, Hq, S, D = q.shape
    Bk, G, T, Dk = k_cache.shape
    if Bk != B or Dk != D or tuple(v_cache.shape[:3]) != (B, G, T):
        raise ValueError(f"caches {tuple(k_cache.shape)}, {tuple(v_cache.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if G == 0 or Hq % G:
        raise ValueError(f"Hq={Hq} not a multiple of G={G}")
    if tuple(cache_len.shape) != (B,):
        raise ValueError(f"cache_len must be ({B},), got {tuple(cache_len.shape)}")
    if q_positions is not None and tuple(q_positions.shape) != (B, S):
        raise ValueError(f"q_positions must be ({B}, {S}), got {tuple(q_positions.shape)}")
    return B, Hq, G, S, T, D, v_cache.shape[-1]


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    return bind(build.load("flash_decode"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument types of its entry points set."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_decode_fwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i,
                                     i, ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, p, p]
    lib.flash_decode_fwd.restype = i
    lib.flash_decode_smem_bytes.argtypes = [i, i, i, i]
    lib.flash_decode_smem_bytes.restype = ctypes.c_longlong
    lib.flash_decode_map_cache_stats.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.flash_decode_map_cache_stats.restype = None
    lib.flash_decode_error_string.argtypes = [i]
    lib.flash_decode_error_string.restype = ctypes.c_char_p
    return lib


def map_cache_stats(lib: ctypes.CDLL | None = None) -> dict[str, int]:
    """``{"hits": n, "misses": n}``: lookups of the bf16 body's TMA map
    cache since ``lib`` (default :func:`load_library`) was loaded."""
    out = (ctypes.c_longlong * 2)()
    (lib or load_library()).flash_decode_map_cache_stats(out)
    return {"hits": int(out[0]), "misses": int(out[1])}


_arrivals: dict[torch.device, torch.Tensor] = {}


def arrivals(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros on ``device``, kept across calls: the bf16
    kernel counts its blocks' arrivals there to find the last block of each
    row tile, which merges the splits and sets its count back to zero.
    Launches on one stream never overlap, so they can share them."""
    buf = _arrivals.get(device)
    if buf is None or buf.numel() < n:
        buf = _arrivals[device] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return buf


def plan_launch(rows: int, groups: int, nb: int, D: int, bk: int, sms: int,
                smem_bytes) -> tuple[int, int, int]:
    """``(tr, splits, per)``: the row-tile factor (64 rows when there are at
    least 64 and they fit, else 16), and the KV-block splits, each of
    ``per`` consecutive blocks, that give at least two blocks per SM.
    ``smem_bytes(D, tr, bk)`` sizes a block (a v head dim of its own is
    bound into it by the caller)."""
    fits = [tr for tr in ROW_TILES if 0 < smem_bytes(D, tr, bk) <= MAX_SMEM]
    if not fits:
        raise ValueError(f"KV block of {bk} keys needs more shared memory than a block has "
                         f"(D={D}); use a smaller block")
    tr = fits[0] if rows >= 64 else fits[-1]
    tiles = -(-rows // (16 * tr)) * groups
    splits = max(1, min(nb, -(-2 * sms // tiles)))
    per = -(-nb // splits)
    return tr, -(-nb // per), per


def flash_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      cache_len: torch.Tensor, *, q_positions: torch.Tensor | None = None,
                      scale: float | None = None, block: int = 512,
                      lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """Split-KV decode attention on the card; returns (B, Hq, S, Dv)
    contiguous in q's dtype.  Caches must have a contiguous head dim and
    16-byte aligned rows (a layer slice of a stacked cache does).  ``lib``
    is the kernel library (default :func:`load_library`; the A/B timer
    passes another build, bound by :func:`bind`)."""
    refuse_grad("flash_decode_kernel", q=q, k_cache=k_cache, v_cache=v_cache)
    B, Hq, G, S, T, D, Dv = check_decode(q, k_cache, v_cache, cache_len, q_positions)
    device = check_on_card(KERNEL_DTYPES, None, q=q, k_cache=k_cache, v_cache=v_cache)
    if (D, Dv) not in DECODE_HEAD_DIMS:
        raise ValueError(f"the decode kernel takes head dims (D, Dv) in {DECODE_HEAD_DIMS}, "
                         f"got ({D}, {Dv})")
    out = torch.empty((B, Hq, S, Dv), dtype=q.dtype, device=device)
    if out.numel() == 0:
        return out
    per_row = 16 // k_cache.element_size()
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if c.stride(-1) != 1 or address(c) % 16 or any(s % per_row for s in c.stride()[:3]):
            raise ValueError(f"{name} needs a contiguous head dim and 16-byte aligned rows, "
                             f"got strides {c.stride()}")
    if cache_len.device != device or q_positions is not None and q_positions.device != device:
        raise ValueError(f"cache_len and q_positions must lie on {device}")
    q = q.contiguous()
    lens = cache_len.to(torch.int32).contiguous()
    pos = None if q_positions is None else q_positions.to(torch.int32).contiguous()
    rep = Hq // G
    bk = min(block, T)
    nb = -(-T // bk)
    fake = is_fake(q)
    if fake:  # the plan from the Python twins of the card's queries
        sms, smem = H100_SMS, lambda D, tr, bk: smem_bytes(D, tr, bk, Dv)
    else:
        lib = lib or load_library()
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        smem = lambda D, tr, bk: lib.flash_decode_smem_bytes(D, tr, bk, Dv)  # noqa: E731
    tr, splits, per = plan_launch(rep * S, B * G, nb, D, bk, sms, smem)
    o_part = torch.empty((B * G, splits, rep * S, Dv), dtype=torch.float32, device=device)
    m_part = torch.empty((B * G, splits, rep * S), dtype=torch.float32, device=device)
    l_part = torch.empty_like(m_part)
    if fake:
        # a fake length has no value: every row is charged its whole cache,
        # the dry run's cell (one token against the full cache)
        report("flash_decode_kernel", (q, k_cache, v_cache, lens, pos),
               (out, o_part, m_part, l_part), flash_decode_work(
                   B, Hq, G, S, B * S * T, B * T, D, Dv, dtype=q.dtype))
        return out
    strides = (ctypes.c_longlong * 6)(*k_cache.stride()[:3], *v_cache.stride()[:3])
    scale = float(scale if scale is not None else D ** -0.5)
    stream = torch.cuda.current_stream(device).cuda_stream
    code = lib.flash_decode_fwd(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                                lens.data_ptr(), None if pos is None else pos.data_ptr(),
                                o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
                                out.data_ptr(), KERNEL_DTYPES[q.dtype], B, Hq, G, S, T, D, Dv,
                                bk, splits, per, tr, strides, scale, stream,
                                arrivals(device, B * G * -(-rep * S // (16 * tr))).data_ptr())
    if code != 0:
        msg = lib.flash_decode_error_string(code).decode()
        raise RuntimeError(f"flash_decode_kernel launch failed: {msg} (cudaError {code})")
    flash_decode_cuda.launches += 1  # type: ignore[attr-defined]
    return out


flash_decode_cuda.launches = 0  # type: ignore[attr-defined]
