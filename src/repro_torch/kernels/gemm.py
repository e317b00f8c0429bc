"""The layout-parametric GEMM kernels for Hopper and their loader.

Two CUDA C++ kernels in ``csrc/gemm.cu`` replace the reference's Pallas
kernels ``gemm_pallas`` and ``gemm_panel_pallas`` (``src/repro/kernels/
gemm.py``): ``C = A @ B (+ acc)`` with each operand's orientation given by
``majors="C/A/B"``, and the SUMMA ring's in-place ``panel[j-block jb] +=
A @ B``.  Orientation encoding (the paper's Fig. 3 labels):

  * A is logically (i, k):  major 'I' -> buffer (i, k);  major 'K' -> buffer (k, i)
  * B is logically (k, j):  major 'K' -> buffer (k, j);  major 'J' -> buffer (j, k)
  * C is logically (i, j):  major 'I' -> buffer (i, j);  major 'J' -> buffer (j, i)

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, at first use, into ``build/torch_kernels/`` of the
checkout (``kernels/build.py``), and bound with ``ctypes``.  Kernels launch
on PyTorch's current stream and never synchronise.  A build or launch
failure raises; nothing falls back to the plain version
(``repro_torch.kernels.ref``).

The kernels run on the tensor cores in split TF32 (each operand split into
two TF32 parts, three TF32 products, float32-class accuracy; see the note at
the head of ``csrc/gemm.cu``).
Their k-tiles are loaded through TMA (one tensor map per operand when its
rows are 16-byte aligned, four strided ones otherwise) or, for shapes under
4 in a dimension, through ``cp.async``; the wrapper chooses with
:func:`loader_path` and passes the choice on.

bf16 operands run two other kernels, in ``csrc/gemm_bf16.cu`` (their own
library): one bf16 tensor-core product, accumulated in float32, ``acc``
(bf16 or float32) added in float32 and the output (``out_dtype or
a.dtype``, bf16 or float32) rounded once, as the reference's kernels do;
the panel may be bf16 or float32.  Their k-tiles come through TMA when
A's and B's bases are 16-byte aligned and their rows multiples of 8
elements, else through plain loads (:func:`loader_path_bf16`); their
output tiles go out through shared memory and a TMA store when the loads
are TMA's and the output's (and acc's) tensor map is legal, else by direct
stores (:func:`store_path_bf16`).  On the
card :func:`check_dtypes` refuses what neither takes (float16, operands of
two dtypes) with a ``TypeError`` that names it.

Each wrapper counts its launches in its ``launches`` attribute, and by loader
in ``launches_by_path`` (``{"tma": n, "tma_strided": n, "async": n}``, or
``{"tma": n, "plain": n}`` for the bf16 wrappers, summing to ``launches``),
so a run can show that it went through the kernel and which loader it took;
the bf16 wrappers count their stores too, in ``launches_by_store``
(``{"tma": n, "direct": n}``).  On fake tensors (``FakeTensorMode``) a
wrapper runs its checks, allocates its output, reports the launch's work
and launches nothing (:mod:`repro_torch.kernels.fake`); its counts stay as
they are.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .fake import is_fake, on_card, report
from .flash_attention import refuse_grad
from .work import gemm_work, peak_seconds

__all__ = ["gemm_cuda", "gemm_panel_cuda", "gemm_bf16_cuda", "gemm_panel_bf16_cuda",
           "gemm_shape", "check_gemm", "check_panel", "check_dtypes", "parse_majors",
           "loader_path", "loader_path_bf16", "store_path_bf16", "reset_launches", "load_library",
           "load_bf16_library", "bind_bf16"]


def parse_majors(majors: str) -> tuple[bool, bool, bool]:
    """``(a_trans, b_trans, c_trans)`` of a ``"C/A/B"`` majors string."""
    c_major, a_major, b_major = majors.upper().split("/")
    return a_major == "K", b_major == "J", c_major == "J"


def gemm_shape(a_shape, b_shape, majors: str) -> tuple[int, int, int]:
    """Logical ``(M, N, K)`` of ``A @ B`` from the two buffers' shapes;
    raises ``ValueError`` on a contraction mismatch."""
    a_trans, b_trans, _ = parse_majors(majors)
    K_, M = a_shape if a_trans else a_shape[::-1]
    N, Kb = b_shape if b_trans else b_shape[::-1]
    if K_ != Kb:
        raise ValueError(
            f"contraction mismatch: {tuple(a_shape)} vs {tuple(b_shape)} (majors={majors})"
        )
    return int(M), int(N), int(K_)


def check_gemm(a, b, acc, majors: str) -> tuple[int, int, int]:
    """``(M, N, K)`` of ``A @ B (+ acc)``; raises ``ValueError`` on a
    contraction mismatch, an ``acc`` not in the output's shape, or a buffer
    that is not contiguous (a buffer is its layout's physical order)."""
    M, N, K = gemm_shape(a.shape, b.shape, majors)
    out_shape = (N, M) if parse_majors(majors)[2] else (M, N)
    if acc is not None and tuple(acc.shape) != out_shape:
        raise ValueError(f"acc shape {tuple(acc.shape)} != output shape {out_shape} (majors={majors})")
    _check_contiguous(a=a, b=b, acc=acc)
    return M, N, K


def check_panel(a, b, panel, majors: str) -> tuple[int, int, int, int]:
    """``(M, N, K, nb)`` of ``panel[j-block jb] += A @ B``; raises
    ``ValueError`` unless the panel holds whole j-blocks of width N in the
    C orientation of ``majors``, and on non-contiguous buffers."""
    M, N, K = gemm_shape(a.shape, b.shape, majors)
    c_trans = parse_majors(majors)[2]
    NJ, MP = (panel.shape[0], panel.shape[1]) if c_trans else (panel.shape[1], panel.shape[0])
    if MP != M or N == 0 or NJ % N:
        raise ValueError(
            f"panel shape {tuple(panel.shape)} incompatible with block ({M},{N}) (majors={majors})"
        )
    _check_contiguous(a=a, b=b, panel=panel)
    return M, N, K, NJ // N


LOADERS = {"async": 0, "tma": 1, "tma_strided": 2}  # the C entry points' loader codes


def loader_path(M: int, N: int, K: int, majors: str, a_address: int, b_address: int) -> str:
    """The loader the kernel takes for the operands it loads, A and B (the
    output is written by plain stores):

    * ``"tma"`` when K > 0, both byte addresses are 16-byte aligned and both
      float32 row strides multiples of 16 bytes, the rules of a TMA tensor map;
    * else ``"tma_strided"`` when M, N and K are at least 4: each operand's
      rows as 4 tensor maps of every 4th row, 16 * ld bytes apart;
    * else ``"async"`` (``cp.async``, any shape)."""
    a_trans, b_trans, _ = parse_majors(majors)
    lda, ldb = (M if a_trans else K), (K if b_trans else N)
    aligned = a_address % 16 == 0 and b_address % 16 == 0 and lda % 4 == 0 and ldb % 4 == 0
    if K > 0 and aligned:
        return "tma"
    return "tma_strided" if min(M, N, K) >= 4 else "async"


BF16_LOADERS = {"plain": 0, "tma": 1}  # the bf16 entry points' loader codes


def loader_path_bf16(M: int, N: int, K: int, majors: str, a_address: int,
                     b_address: int) -> str:
    """The loader the bf16 kernels take for A and B: ``"tma"`` when K > 0,
    both byte addresses are 16-byte aligned and both row strides multiples
    of 8 bf16 elements (16 bytes), the rules of a TMA tensor map; else
    ``"plain"`` (plain loads, any shape and alignment)."""
    a_trans, b_trans, _ = parse_majors(majors)
    lda, ldb = (M if a_trans else K), (K if b_trans else N)
    aligned = a_address % 16 == 0 and b_address % 16 == 0 and lda % 8 == 0 and ldb % 8 == 0
    return "tma" if K > 0 and aligned else "plain"


BF16_STORES = {"direct": 0, "tma": 1}  # the bf16 entry points' store codes


def store_path_bf16(M: int, N: int, majors: str, c_address: int, c_itemsize: int,
                    acc_address: int | None = None, acc_itemsize: int = 0, *,
                    nb: int = 1, loader: str) -> str:
    """The store the bf16 kernels take for the output, C or a panel of
    ``nb`` j-blocks of width N: ``"tma"`` (tiles staged in shared memory,
    written by a TMA store; acc loaded by TMA the same way) when the
    operands come through the TMA loader (``loader``, from
    :func:`loader_path_bf16`) and every tensor map the store needs is
    legal, else ``"direct"`` (stores from the accumulators, any shape and
    alignment).  Behind the plain loads the kernel is paced by the loader
    threads' copies, and the TMA store gained nothing there (measured on an
    H100 at EXTRALARGE; a float32 panel ran 11% slower).  A map is legal
    when its base is 16-byte aligned and its strides are multiples of 16
    bytes: the buffer's rows (M values when C is j-major, ``nb * N`` when
    i-major) and the step from one j-block to the next (N rows of M values,
    or N values).  So M (j-major) or N (i-major) times the item size must
    be a multiple of 16, for C and for ``acc`` (same shape, its own item
    size)."""
    if loader != "tma":
        return "direct"
    c_trans = parse_majors(majors)[2]
    extent = M if c_trans else N

    def legal(address: int, itemsize: int) -> bool:
        return address % 16 == 0 and extent * itemsize % 16 == 0

    ok = M > 0 and N > 0 and nb > 0 and legal(c_address, c_itemsize)
    if acc_address is not None:
        ok = ok and legal(acc_address, acc_itemsize)
    return "tma" if ok else "direct"


def check_dtypes(a, b, other=None, out_dtype=None) -> torch.dtype:
    """The dtype of A and B for the card's kernels; raises ``TypeError``
    naming what they do not take.  A and B are float32 or bfloat16, both of
    one dtype.  float32 operands take a float32 ``other`` (acc or panel)
    and output only; bfloat16 operands take ``other`` and ``out_dtype`` in
    bfloat16 or float32."""
    for name, t in (("a", a), ("b", b)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: the GEMM kernels take float32 or bfloat16 operands, "
                            f"got {t.dtype}")
    if a.dtype != b.dtype:
        raise TypeError(f"a and b must have one dtype for the GEMM kernels, got {a.dtype} "
                        f"and {b.dtype}")
    takes = (torch.float32,) if a.dtype == torch.float32 else (torch.bfloat16, torch.float32)
    if other is not None and other.dtype not in takes:
        raise TypeError(f"acc/panel: the GEMM kernels on {a.dtype} operands take "
                        f"{list(takes)}, got {other.dtype}")
    if out_dtype is not None and out_dtype not in takes:
        raise TypeError(f"out_dtype: the GEMM kernels on {a.dtype} operands write "
                        f"{list(takes)}, got {out_dtype}")
    return a.dtype


def _check_contiguous(**tensors) -> None:
    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous buffer, got strides {t.stride()}")


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    lib = build.load("gemm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.layout_gemm_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.layout_gemm_f32.restype = i
    lib.layout_gemm_panel_f32.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p, i, i, p]
    lib.layout_gemm_panel_f32.restype = i
    lib.layout_gemm_smem_bytes.argtypes = []
    lib.layout_gemm_smem_bytes.restype = i
    lib.layout_gemm_error_string.argtypes = [i]
    lib.layout_gemm_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_bf16_library() -> ctypes.CDLL:
    """Build (if needed) and load the bf16 kernels' library; raises on
    failure."""
    return bind_bf16(build.load("gemm_bf16"))


def bind_bf16(lib: ctypes.CDLL, *, takes_store: bool = True) -> ctypes.CDLL:
    """``lib``, a build of ``csrc/gemm_bf16.cu``, with the argument types of
    its entry points set; ``takes_store=False`` for a build whose entry
    points take no store argument (before the TMA store)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    store = [i] if takes_store else []
    lib.layout_gemm_bf16.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, *store, p]
    lib.layout_gemm_bf16.restype = i
    lib.layout_gemm_panel_bf16.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p, i, i, i, *store,
                                           p]
    lib.layout_gemm_panel_bf16.restype = i
    lib.layout_gemm_bf16_smem_bytes.argtypes = store
    lib.layout_gemm_bf16_smem_bytes.restype = i
    lib.layout_gemm_bf16_error_string.argtypes = [i]
    lib.layout_gemm_bf16_error_string.restype = ctypes.c_char_p
    return lib


def _check_on_card(device: torch.device, operands: torch.dtype, a, b, other=None,
                   out_dtype=None) -> None:
    """Raises unless every tensor lies on ``device`` (``ValueError``) and
    :func:`check_dtypes` finds A and B of the wrapper's ``operands`` dtype
    (``TypeError``)."""
    for name, t in (("a", a), ("b", b), ("acc/panel", other)):
        if t is not None and (not on_card(t) or t.device != device):
            raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
    if check_dtypes(a, b, other, out_dtype) != operands:
        raise TypeError(f"this kernel takes {operands} operands, got {a.dtype}")


def _raise_if_failed(code: int, what: str, error_string) -> None:
    if code != 0:
        msg = error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {code})")


def gemm_cuda(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor | None = None, *,
              majors: str = "I/I/K", out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``C = A @ B (+ acc)`` on the card; ``acc`` is a previous C buffer in
    the output orientation.  Float32 operands and output only."""
    refuse_grad("layout_gemm_kernel", a=a, b=b, acc=acc)
    a_trans, b_trans, c_trans = parse_majors(majors)
    M, N, K = check_gemm(a, b, acc, majors)
    _check_on_card(a.device, torch.float32, a, b, acc, out_dtype)
    out = torch.empty((N, M) if c_trans else (M, N), dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return out
    if is_fake(a):
        _report("layout_gemm_kernel", a, b, acc, out, M, N, K)
        return out
    lib = load_library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    acc_ptr = acc.data_ptr() if acc is not None else 0
    path = loader_path(M, N, K, majors, a.data_ptr(), b.data_ptr())
    code = lib.layout_gemm_f32(a.data_ptr(), b.data_ptr(), acc_ptr or None, out.data_ptr(),
                               M, N, K, a_trans, b_trans, c_trans, LOADERS[path], stream)
    _raise_if_failed(code, "layout_gemm_kernel", lib.layout_gemm_error_string)
    gemm_cuda.launches += 1  # type: ignore[attr-defined]
    gemm_cuda.launches_by_path[path] += 1  # type: ignore[attr-defined]
    return out


def gemm_panel_cuda(a: torch.Tensor, b: torch.Tensor, panel: torch.Tensor, jb, *,
                    majors: str = "I/I/K") -> torch.Tensor:
    """``panel[j-block jb] += A @ B`` in place on the card; returns ``panel``.

    ``jb`` is a Python int or a one-element int32 CUDA tensor that the
    kernel reads on the device (no host sync).  It is clamped to the panel's
    blocks like the reference's ``dynamic_slice``.
    """
    refuse_grad("layout_gemm_panel_kernel", a=a, b=b, panel=panel)
    a_trans, b_trans, c_trans = parse_majors(majors)
    M, N, K, nb = check_panel(a, b, panel, majors)
    _check_on_card(a.device, torch.float32, a, b, panel)
    jb_dev, jb_host = _jb_arg(jb, a.device)
    if M == 0:
        return panel
    if is_fake(a):
        _report("layout_gemm_panel_kernel", a, b, panel, panel, M, N, K, jb=jb)
        return panel
    lib = load_library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    ldp = panel.shape[1]
    path = loader_path(M, N, K, majors, a.data_ptr(), b.data_ptr())
    code = lib.layout_gemm_panel_f32(a.data_ptr(), b.data_ptr(), panel.data_ptr(), M, N, K,
                                     a_trans, b_trans, c_trans, ldp, nb, jb_dev, jb_host,
                                     LOADERS[path], stream)
    _raise_if_failed(code, "layout_gemm_panel_kernel", lib.layout_gemm_error_string)
    gemm_panel_cuda.launches += 1  # type: ignore[attr-defined]
    gemm_panel_cuda.launches_by_path[path] += 1  # type: ignore[attr-defined]
    return panel


def _jb_arg(jb, device: torch.device) -> tuple[int | None, int]:
    """``(device pointer or None, host value)`` of a panel's block index."""
    if isinstance(jb, torch.Tensor):
        if jb.device != device or jb.dtype != torch.int32 or jb.numel() != 1:
            raise ValueError(f"jb must be one int32 on {device}, got {jb.dtype} "
                             f"{tuple(jb.shape)} on {jb.device}")
        return (None if is_fake(jb) else jb.data_ptr()), 0
    return None, int(jb)


def _report(kernel: str, a, b, acc, out, M: int, N: int, K: int, jb=None) -> None:
    """A fake call's report of its launch: A and B (and acc, or the panel's
    block) read, the output (or the panel) written, and the GEMM kernels'
    work (:func:`repro_torch.kernels.work.gemm_work`): a panel call reads
    and writes its one (M, N) block."""
    other = 4 if acc is None else acc.element_size()
    flops, nbytes = gemm_work(M, N, K, acc=acc is not None, dtype=a.dtype,
                              out_bytes=out.element_size(), acc_bytes=other)
    kind = "split_tf32" if a.dtype == torch.float32 else a.dtype
    seconds = peak_seconds(2 * M * N * K, kind) + peak_seconds(M * N if acc is not None else 0,
                                                               torch.float32)
    report(kernel, (a, b, acc, jb if isinstance(jb, torch.Tensor) else None), (out,),
           (flops, nbytes, seconds))


def gemm_bf16_cuda(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor | None = None, *,
                   majors: str = "I/I/K", out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``C = A @ B (+ acc)`` on the card for bf16 A and B: float32 sums,
    ``acc`` (bf16 or float32) added after the product, the output in
    ``out_dtype or a.dtype`` (bf16 or float32), rounded once."""
    refuse_grad("layout_gemm_bf16_kernel", a=a, b=b, acc=acc)
    a_trans, b_trans, c_trans = parse_majors(majors)
    M, N, K = check_gemm(a, b, acc, majors)
    _check_on_card(a.device, torch.bfloat16, a, b, acc, out_dtype)
    out_dtype = out_dtype or a.dtype
    out = torch.empty((N, M) if c_trans else (M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    if is_fake(a):
        _report("layout_gemm_bf16_kernel", a, b, acc, out, M, N, K)
        return out
    lib = load_bf16_library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    path = loader_path_bf16(M, N, K, majors, a.data_ptr(), b.data_ptr())
    store = store_path_bf16(M, N, majors, out.data_ptr(), out.element_size(),
                            None if acc is None else acc.data_ptr(),
                            0 if acc is None else acc.element_size(), loader=path)
    code = lib.layout_gemm_bf16(a.data_ptr(), b.data_ptr(),
                                acc.data_ptr() if acc is not None else None, out.data_ptr(),
                                M, N, K, a_trans, b_trans, c_trans,
                                acc is not None and acc.dtype == torch.bfloat16,
                                out_dtype == torch.bfloat16, BF16_LOADERS[path],
                                BF16_STORES[store], stream)
    _raise_if_failed(code, "layout_gemm_bf16_kernel", lib.layout_gemm_bf16_error_string)
    gemm_bf16_cuda.launches += 1  # type: ignore[attr-defined]
    gemm_bf16_cuda.launches_by_path[path] += 1  # type: ignore[attr-defined]
    gemm_bf16_cuda.launches_by_store[store] += 1  # type: ignore[attr-defined]
    return out


def gemm_panel_bf16_cuda(a: torch.Tensor, b: torch.Tensor, panel: torch.Tensor, jb, *,
                         majors: str = "I/I/K") -> torch.Tensor:
    """``panel[j-block jb] += A @ B`` in place on the card for bf16 A and B;
    the panel (bf16 or float32) is read, added to in float32 and written
    back rounded once to its dtype.  ``jb`` as for :func:`gemm_panel_cuda`."""
    refuse_grad("layout_gemm_panel_bf16_kernel", a=a, b=b, panel=panel)
    a_trans, b_trans, c_trans = parse_majors(majors)
    M, N, K, nb = check_panel(a, b, panel, majors)
    _check_on_card(a.device, torch.bfloat16, a, b, panel)
    jb_dev, jb_host = _jb_arg(jb, a.device)
    if M == 0:
        return panel
    if is_fake(a):
        _report("layout_gemm_panel_bf16_kernel", a, b, panel, panel, M, N, K, jb=jb)
        return panel
    lib = load_bf16_library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    path = loader_path_bf16(M, N, K, majors, a.data_ptr(), b.data_ptr())
    store = store_path_bf16(M, N, majors, panel.data_ptr(), panel.element_size(), nb=nb,
                            loader=path)
    code = lib.layout_gemm_panel_bf16(a.data_ptr(), b.data_ptr(), panel.data_ptr(), M, N, K,
                                      a_trans, b_trans, c_trans, panel.shape[1], nb, jb_dev,
                                      jb_host, panel.dtype == torch.bfloat16,
                                      BF16_LOADERS[path], BF16_STORES[store], stream)
    _raise_if_failed(code, "layout_gemm_panel_bf16_kernel", lib.layout_gemm_bf16_error_string)
    gemm_panel_bf16_cuda.launches += 1  # type: ignore[attr-defined]
    gemm_panel_bf16_cuda.launches_by_path[path] += 1  # type: ignore[attr-defined]
    gemm_panel_bf16_cuda.launches_by_store[store] += 1  # type: ignore[attr-defined]
    return panel


def reset_launches() -> None:
    """Set every launch count of the four wrappers to 0."""
    for fn, loaders in ((gemm_cuda, LOADERS), (gemm_panel_cuda, LOADERS),
                        (gemm_bf16_cuda, BF16_LOADERS), (gemm_panel_bf16_cuda, BF16_LOADERS)):
        fn.launches = 0  # type: ignore[attr-defined]
        fn.launches_by_path = dict.fromkeys(loaders, 0)  # type: ignore[attr-defined]
    for fn in (gemm_bf16_cuda, gemm_panel_bf16_cuda):
        fn.launches_by_store = dict.fromkeys(BF16_STORES, 0)  # type: ignore[attr-defined]


reset_launches()
