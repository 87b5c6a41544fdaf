"""Profiler integration (``nufhe_tpu/utils/profiling.py``'s counterpart).

Any region can be captured to a trace that Chrome's ``about:tracing``,
Perfetto or TensorBoard reads, with one context manager or by setting
``NUFHE_PROFILE_DIR``; ``annotate`` names a span inside it.  The port's
layers open their spans with ``annotate`` (``nufhe.vm.<op>``, ``nufhe.gate``,
``nufhe.bootstrap`` and the others of the README's profiling paragraph).
``time_ms`` times a call on the card by CUDA events.
"""

import contextlib
import functools
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


_OFF = contextlib.nullcontext()


def annotate(name):
    """A named span inside a profiled trace: ``torch.profiler.
    record_function`` while a profiler records, on the same clock as the
    card's kernels; under ``torch.autograd.profiler.emit_nvtx()`` that is
    also an NVTX range.  With no profiler recording it costs one check, so
    the port's layers call it on every gate.

    >>> with annotate("blind_rotate"):
    ...     ...
    """
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name):
    """Decorator: every call of the function runs inside ``annotate(name)``."""
    def decorate(fn):
        @functools.wraps(fn)
        def call(*args, **kwds):
            with annotate(name):
                return fn(*args, **kwds)
        return call
    return decorate


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
