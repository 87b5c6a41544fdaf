"""Profiler integration (``nufhe_tpu/utils/profiling.py``'s counterpart).

Any region can be captured to a trace that Chrome's ``about:tracing``,
Perfetto or TensorBoard reads, with one context manager or by setting
``NUFHE_PROFILE_DIR``; ``annotate`` names a span inside it, and on CUDA
also an NVTX range.  ``time_ms`` times a call on the card by CUDA events.
"""

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def profile_trace(logdir=None):
    """Capture a ``torch.profiler`` trace of the enclosed region (host
    operations, and the card's kernels when CUDA is available), written as
    a Chrome trace (``*.pt.trace.json``) into ``logdir``.

    >>> with profile_trace("traces/nand"):
    ...     vm.gate_nand(a, b)

    A no-op when ``logdir`` is None and ``NUFHE_PROFILE_DIR`` is unset, so
    call sites can wrap their hot region unconditionally.
    """
    logdir = logdir or os.environ.get("NUFHE_PROFILE_DIR")
    if not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


@contextlib.contextmanager
def annotate(name):
    """A named span inside a profiled trace (``torch.profiler.
    record_function``), and on CUDA an NVTX range of the same name.

    >>> with annotate("blind_rotate"):
    ...     ...
    """
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def time_ms(fn, reps, device="cuda", warmup=0):
    """Mean milliseconds a call of ``fn`` over ``reps`` calls after
    ``warmup`` untimed ones: by CUDA events on a CUDA ``device`` (the
    card's own time, launch gaps included), by the host clock elsewhere."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps
