"""How the port's kernels are timed on a CUDA card: one method, shared by
``chip_smoke.py`` and ``histogram_probe``, so that numbers from either
compare.

- ``time_ms``: the call time, CUDA events around back-to-back calls.
  Where a call's host work outlasts its kernel, this is the host's time
  per call.
- ``kernel_device_ms``: the kernel's own device time, from
  ``torch.profiler``, without the host's work around each launch.
"""

from __future__ import annotations

import time

import torch


def time_ms(fn, reps: int, warmup_s: float = 0.0) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls, by CUDA events,
    after one warm-up call, or after calling it for ``warmup_s`` seconds:
    on the H100 the first few thousand calls of a small kernel after a
    pause ran several times slower than the calls after them, which a call
    time of a few microseconds would read as its own."""
    t = time.perf_counter()
    fn()
    while time.perf_counter() - t < warmup_s:
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def kernel_device_ms(fn, reps: int, name: str, windows: int = 8) -> float:
    """Mean device duration of the kernels whose name holds ``name``, over
    ``reps`` calls of ``fn`` under ``torch.profiler``.  The mean is over
    the launches the profiler recorded: on the H100's machine it can miss
    some of a window's kernel events, and now and then all of them, so a
    window that saw none is profiled again, up to ``windows`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, count = 0.0, 0
        for e in prof.key_averages():
            if name in e.key and e.device_type != DeviceType.CPU:
                us += e.self_device_time_total
                count += e.count
        if count:
            return us / count / 1e3
    raise AssertionError(f"the profiler saw no launch of {name} in "
                         f"{windows} windows of {reps} calls")
