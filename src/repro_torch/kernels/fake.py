"""The kernels' wrappers on fake tensors: the dry run's trace of the card's
program (:mod:`repro_torch.launch.dryrun`).

A fake tensor (``FakeTensorMode``) has a shape, a dtype and a device and no
data.  Given fake operands, a kernel's wrapper runs its checks, allocates
what its launch would and reports the launch's work
(:mod:`repro_torch.kernels.work`) to the observer of this process's
launches (:func:`set_observer`: the running op walk), and launches
nothing: there is nothing to compute on.  It loads no library, touches no
card and reads no address.

The card's program is traced on fake CPU tensors made under
:class:`CardTrace`, which stand for the card's (:func:`on_card`): the
wrappers and every choice between the card's path and the plain one take
them as CUDA tensors.  It is the one way, with or without a card: a build
of PyTorch without CUDA cannot run autograd's engine on fake CUDA tensors
(the engine asks for an accelerator).  :func:`card_trace` gives the mode
and device of a trace.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

__all__ = ["CardTrace", "card_trace", "is_fake", "on_card", "address", "report",
           "set_observer"]

# The walk observing this process's fake launches
# (``repro_torch.launch.op_walk``), ``None`` unless one runs: each fake call
# reports its launch (``observer.launched(kernel, reads, writes, flops,
# bytes, seconds)``).
_OBSERVER = None


def set_observer(observer):
    """Make ``observer`` (or ``None``) the one that sees every launch a
    fake call stands for; returns the one it replaces."""
    global _OBSERVER
    previous, _OBSERVER = _OBSERVER, observer
    return previous


class CardTrace(FakeTensorMode):
    """A ``FakeTensorMode`` whose tensors, made on the CPU, stand for
    tensors on the card (see the module docstring)."""


def card_trace(device="cuda") -> tuple[FakeTensorMode, torch.device]:
    """``(mode, device)`` of a trace of ``device``'s program: for ``cuda``
    a :class:`CardTrace` (fake CPU tensors that stand for the card's), for
    ``cpu`` (the plain versions) fake CPU tensors."""
    if torch.device(device).type == "cuda":
        return CardTrace(), torch.device("cpu")
    return FakeTensorMode(), torch.device(device)


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor: a wrapper given one stands for its
    launch and launches nothing."""
    return isinstance(t, FakeTensor)


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on the card: a CUDA tensor, or a fake tensor of a
    :class:`CardTrace`."""
    return t.is_cuda or (isinstance(t, FakeTensor) and isinstance(t.fake_mode, CardTrace))


def address(t: torch.Tensor) -> int:
    """``t``'s address for the kernels' alignment rules: its data pointer,
    or for a fake tensor its byte offset into its storage (the caching
    allocator's blocks start 512-byte aligned)."""
    return t.storage_offset() * t.element_size() if is_fake(t) else t.data_ptr()


def report(kernel: str, reads, writes, work: tuple[float, float, float]) -> None:
    """Report one launch a fake call stands for to the observer, if any:
    the tensors it reads and writes and its ``(flops, bytes, seconds at the
    card's peak)``."""
    if _OBSERVER is not None:
        _OBSERVER.launched(kernel, [t for t in reads if t is not None],
                           [t for t in writes if t is not None], *work)
