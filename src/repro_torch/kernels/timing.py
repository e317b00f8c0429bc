"""Device time of calls on the card, the one method the port's measurements use.

``queued_ms`` enqueues a run of calls behind a sleep kernel that outlasts the
host's enqueueing, so the card runs them back to back, and times the run
between two CUDA events.  Every launch of the calls lies inside the window,
and the host's time between launches does not, so a reading can be neither
below the device time (as a profiler that drops launches can be) nor the
host's pace (as an event pair around one short call is).
"""
from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["queued_ms"]

# sleep cycles a second of host time: above the card's top clock (H100 SXM:
# 1.98 GHz), so the sleep lasts at least as long as the enqueueing it covers
SLEEP_CYCLES_PER_S = 2.0e9


def queued_ms(fn, *, iters: int = 20, reps: int = 5, warmup: int = 3) -> float:
    """Milliseconds of device time per call of ``fn``: ``iters`` calls
    enqueued behind a sleep twice as long as their enqueueing took, between
    two CUDA events, over ``iters``; the median of ``reps``.  A call that
    waits for the card (a host sync) makes the reading include the wait."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    cycles = int(2 * (time.perf_counter() - t0) * SLEEP_CYCLES_PER_S) + 100_000
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))
