"""The flash-attention kernel for Hopper and its wrappers.

``csrc/flash_attention.cu`` replaces the reference's Pallas kernels
``flash_attention_pallas`` and ``flash_attention_carry_pallas``
(``src/repro/kernels/flash_attention.py``): blockwise online-softmax
attention of q (B, Hq, Sq, D) over k (B, G, Skv, D) and v (B, G, Skv, Dv),
causal (top-left aligned) or not, all arithmetic float32, output
(B, Hq, Sq, Dv) in q's dtype (:func:`flash_attention_cuda`); and one step of
the sequence-parallel ring, the same body threading the unnormalized float32
state ``(acc, m, l)`` through the call in place, at global offsets
(:func:`flash_attention_carry_cuda`).
Their plain versions are :func:`repro_torch.kernels.ref.flash_attention_ref`
and :func:`repro_torch.kernels.ref.flash_carry_ref`.

bfloat16 inputs run the tensor-core body: ``q k^T`` and ``p @ v`` on
``wgmma`` with float32 accumulators, p in :data:`P_PIECES` bf16 pieces,
:data:`KEY_TILE`-key tiles of K and V by TMA (see the note in the source).
float32 inputs run the first port's float32 body on the CUDA cores.

The forward takes float32 or bfloat16 with head dims ``(D, Dv)`` of
:data:`FORWARD_HEAD_DIMS`: 64, 112 (zamba2's shared attention) or 128 for
q, k and v, or q/k of 96 with v of 64 (MLA's forward).  The carry form takes
the pairs of :data:`CARRY_HEAD_DIMS`, the same four (MLA's (96, 64) under
the sequence-parallel recipes; :func:`check_carry_head_dims`), its state
``acc`` as wide as v.  It reads each operand through its
batch, head and sequence strides, so the transposed views of the
projections need no copy.
It launches on PyTorch's current stream and never synchronises; a build or
launch failure raises.  On fake tensors (``FakeTensorMode``: shapes, no
data) a wrapper runs its checks, allocates what its launch would, reports
the launch's work and returns without loading the library, touching the
card or reading an address (:mod:`repro_torch.kernels.fake`): the dry
run's trace of the card's program.  The wrappers write through ``ctypes``, so their results carry no
autograd history: with grad mode on, an input that requires grad raises
``TypeError`` (:func:`refuse_grad`), and the gradient goes through the
``autograd.Function`` classes of :mod:`repro_torch.kernels.ops`.
``flash_attention_cuda.launches`` and ``flash_attention_carry_cuda.launches``
count real launches only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .fake import address, is_fake, on_card, report
from .work import flash_attention_work, flash_carry_work

__all__ = ["flash_attention_cuda", "flash_attention_carry_cuda", "check_attention",
           "check_carry", "check_carry_head_dims", "refuse_grad", "load_library", "bind",
           "KERNEL_DTYPES", "FORWARD_HEAD_DIMS", "CARRY_HEAD_DIMS", "KEY_TILE", "P_PIECES"]

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
FORWARD_HEAD_DIMS = ((64, 64), (128, 128), (96, 64), (112, 112))  # the forward's (D, Dv)
CARRY_HEAD_DIMS = ((64, 64), (128, 128), (112, 112), (96, 64))  # the carry form's (D, Dv)
KEY_TILE = 64  # keys per tile of both bodies: carry chunks starting on its multiples chain bitwise
P_PIECES = 2  # bf16 pieces of p in the bf16 body's p @ v (hi = bf16(p), lo = bf16(p - hi))


def check_attention(q, k, v) -> tuple[int, int, int, int, int, int]:
    """``(B, Hq, G, Sq, Skv, D)`` of an attention call (v's head dim may
    differ from D); raises ``ValueError`` on shapes that do not fit
    together."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q, k, v must be (B, H, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    Bk, G, Skv, Dk = k.shape
    if Bk != B or Dk != D or tuple(v.shape[:3]) != (B, G, Skv):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if G == 0 or Hq % G:
        raise ValueError(f"Hq={Hq} not a multiple of G={G}")
    return B, Hq, G, Sq, Skv, D


def check_carry_head_dims(D: int, Dv: int) -> None:
    """Raises ``ValueError`` unless the card's carry form has an instance
    at ``(D, Dv)`` (:data:`CARRY_HEAD_DIMS`); its plain version takes any."""
    if (D, Dv) not in CARRY_HEAD_DIMS:
        raise ValueError(f"the carry kernel takes head dims (D, Dv) in {CARRY_HEAD_DIMS}, "
                         f"got ({D}, {Dv})")


def refuse_grad(kernel: str, **tensors) -> None:
    """Raises ``TypeError`` when grad mode is on and one of ``tensors``
    requires grad: a kernel's wrapper writes its result through ``ctypes``,
    so the result would silently cut the autograd graph."""
    if not torch.is_grad_enabled():
        return
    wanted = [name for name, t in tensors.items() if t is not None and t.requires_grad]
    if wanted:
        raise TypeError(f"{kernel} has no gradient, but {', '.join(wanted)} requires grad: "
                        "call it under torch.no_grad(), or through kernels.ops where the op "
                        "has an autograd.Function")


def _row_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its head dim is contiguous and every row starts on
    16 bytes, else a contiguous copy."""
    per = 16 // t.element_size()
    if (t.stride(-1) == 1 and address(t) % 16 == 0
            and all(s % per == 0 for s in t.stride()[:-1])):
        return t
    return t.contiguous()


def check_on_card(dtypes, head_dims, **tensors) -> torch.device:
    """The common device of ``tensors``; raises unless all lie on one CUDA
    device with one dtype the kernel takes and a head dim it takes.
    ``head_dims`` is a tuple of head dims for every operand, or ``None``
    (the caller checks them)."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if not on_card(t) or t.device != first.device:
            raise ValueError(f"{name} must be a CUDA tensor on {first.device}, got {t.device}")
        if t.dtype != first.dtype or t.dtype not in dtypes:
            raise TypeError(f"{name}: the kernel takes one of {list(dtypes)} for all operands, "
                            f"got {t.dtype} (q is {first.dtype})")
        if head_dims is not None and t.shape[-1] not in head_dims:
            raise ValueError(f"{name}: the kernel takes head dims {head_dims}, got {t.shape[-1]}")
    return first.device


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    return bind(build.load("flash_attention"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument types of its entry points set."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i,
                                        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i, p]
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_carry_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                                              ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                                              i, i, i, i, p]
    lib.flash_attention_carry_fwd.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, scale: float | None = None,
                         lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """Attention of q (B, Hq, Sq, D) over k (B, G, Skv, D) and v
    (B, G, Skv, Dv) on the card, ``(D, Dv)`` one of
    :data:`FORWARD_HEAD_DIMS`; returns (B, Hq, Sq, Dv) contiguous in q's
    dtype.  ``scale`` defaults to ``D ** -0.5``.  ``lib`` is the kernel
    library (default :func:`load_library`; the A/B timer passes another
    build, bound by :func:`bind`)."""
    refuse_grad("flash_attention_kernel", q=q, k=k, v=v)
    B, Hq, G, Sq, Skv, D = check_attention(q, k, v)
    Dv = v.shape[-1]
    device = check_on_card(KERNEL_DTYPES, None, q=q, k=k, v=v)
    if (D, Dv) not in FORWARD_HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims (D, Dv) in {FORWARD_HEAD_DIMS}, "
                         f"got ({D}, {Dv})")
    out = torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=device)
    if out.numel() == 0:
        return out
    if Skv == 0:
        raise ValueError("attention over an empty key sequence")
    q, k, v = _row_aligned(q), _row_aligned(k), _row_aligned(v)
    if is_fake(q):
        report("flash_attention_kernel", (q, k, v), (out,), flash_attention_work(
            B, Hq, G, Sq, Skv, D, Dv, causal=causal, dtype=q.dtype, pieces=P_PIECES))
        return out
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    scale = float(scale if scale is not None else D ** -0.5)
    lib = lib or load_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    code = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                   KERNEL_DTYPES[q.dtype], B, Hq, G, Sq, Skv, D, Dv, strides,
                                   scale, int(causal), stream)
    if code != 0:
        msg = lib.flash_attention_error_string(code).decode()
        raise RuntimeError(f"flash_attention_kernel launch failed: {msg} (cudaError {code})")
    flash_attention_cuda.launches += 1  # type: ignore[attr-defined]
    return out


flash_attention_cuda.launches = 0  # type: ignore[attr-defined]

INT32_MAX = 2**31 - 1


def check_carry(carry, B: int, Hq: int, Sq: int, Dv: int) -> None:
    """Raises unless ``carry`` is ``(acc (B, Hq, Sq, Dv), m (B, Hq, Sq),
    l (B, Hq, Sq))``."""
    if len(carry) != 3:
        raise ValueError("carry must be (acc, m, l)")
    acc, m, l = carry
    if tuple(acc.shape) != (B, Hq, Sq, Dv) or tuple(m.shape) != (B, Hq, Sq) \
            or tuple(l.shape) != (B, Hq, Sq):
        raise ValueError(f"carry shapes {tuple(acc.shape)}, {tuple(m.shape)}, {tuple(l.shape)} "
                         f"do not fit q ({B}, {Hq}, {Sq}, ·) and v (·, ·, ·, {Dv})")


def flash_attention_carry_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, carry, *,
                               q_offset: int = 0, k_offset: int = 0,
                               valid_len: int | None = None, causal: bool = True,
                               scale: float | None = None, lib: ctypes.CDLL | None = None):
    """One ring step on the card: merges the attention of q (B, Hq, Sq, D),
    rows at global positions ``q_offset + i``, over the held block k, v
    (B, G, Skv, D | Dv), keys at ``k_offset + j`` (those at or past
    ``valid_len`` masked), into ``carry = (acc, m, l)``, float32 contiguous
    tensors on q's device (``acc`` as wide as v, (B, Hq, Sq, Dv)), **in
    place**; returns the carry.  ``(D, Dv)`` is one of
    :data:`CARRY_HEAD_DIMS`.  The kernel does
    nothing for query tiles that lie wholly before the block (causal).
    ``lib`` as for :func:`flash_attention_cuda`."""
    refuse_grad("flash_attention_kernel (carry)", q=q, k=k, v=v,
                **dict(zip(("acc", "m", "l"), carry)))
    B, Hq, G, Sq, Skv, D = check_attention(q, k, v)
    Dv = v.shape[-1]
    device = check_on_card(KERNEL_DTYPES, None, q=q, k=k, v=v)
    check_carry_head_dims(D, Dv)
    check_carry(carry, B, Hq, Sq, Dv)
    for name, t in zip(("acc", "m", "l"), carry):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != device:
            raise ValueError(f"carry {name} must be a contiguous float32 tensor on {device}, "
                             f"got {t.dtype} on {t.device}")
    if q.numel() == 0:
        return carry
    if Skv == 0:
        raise ValueError("attention over an empty key sequence")
    valid_len = INT32_MAX if valid_len is None else min(max(int(valid_len), 0), INT32_MAX)
    for name, val in (("q_offset", q_offset), ("k_offset", k_offset)):
        if not 0 <= int(val) <= INT32_MAX - Sq - Skv:
            raise ValueError(f"{name}={val} outside the kernel's int32 positions")
    q, k, v = _row_aligned(q), _row_aligned(k), _row_aligned(v)
    if is_fake(q):
        report("flash_attention_carry_kernel", (q, k, v, *carry), carry, flash_carry_work(
            B, Hq, G, Sq, Skv, D, Dv, q_offset=int(q_offset), k_offset=int(k_offset),
            valid_len=None if valid_len == INT32_MAX else valid_len, causal=causal,
            dtype=q.dtype, pieces=P_PIECES))
        return carry
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    scale = float(scale if scale is not None else D ** -0.5)
    lib = lib or load_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    acc, m, l = carry
    code = lib.flash_attention_carry_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        KERNEL_DTYPES[q.dtype], B, Hq, G, Sq, Skv, D, Dv, strides, scale, int(causal),
        int(q_offset), int(k_offset), valid_len, stream)
    if code != 0:
        msg = lib.flash_attention_error_string(code).decode()
        raise RuntimeError(f"flash_attention_kernel (carry) launch failed: {msg} (cudaError {code})")
    flash_attention_carry_cuda.launches += 1  # type: ignore[attr-defined]
    return carry


flash_attention_carry_cuda.launches = 0  # type: ignore[attr-defined]
