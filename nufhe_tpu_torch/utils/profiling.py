"""Profiler integration (``nufhe_tpu/utils/profiling.py``'s counterpart).

Any region can be captured to a trace that Chrome's ``about:tracing``,
Perfetto or TensorBoard reads, with one context manager or by setting
``NUFHE_PROFILE_DIR``; ``annotate`` names a span inside it, and on CUDA
also an NVTX range.
"""

import contextlib
import os

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
