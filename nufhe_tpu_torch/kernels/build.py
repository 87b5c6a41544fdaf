"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source in ``csrc/`` becomes one shared library with a plain C
interface (pointers and the stream as ``c_void_p``; the launcher selects
the device ordinal it is given, launches, and returns
``cudaGetLastError()``), compiled for ``sm_90a`` into ``_build/``
(git-ignored) the first time it is needed.  The library's file name
carries a hash of its source and of the shared ``*.cuh`` headers, so an
edited source is rebuilt and a stale library is never loaded.
:func:`build_all` starts one ``nvcc`` per source at once and waits for all.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from ..utils.profiling import annotate

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# name -> (source file, C entry point, ctypes argument types)
_P = ctypes.c_void_p
_I = ctypes.c_int
KERNELS = {
    "cmux_step": ("cmux_step.cu", "cmux_step_launch",
                  [_P, _P, _P, _P, _I, _I, _I, ctypes.c_uint, _I, _I, _I, _P]),
    "blind_rotate_chunk": ("blind_rotate_chunk.cu", "blind_rotate_chunk_launch",
                           [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_uint,
                            _I, _I, _I, _P]),
    "keyswitch": ("keyswitch.cu", "keyswitch_launch",
                  [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "lanes_step": ("lanes_step.cu", "lanes_step_launch",
                   [_P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_uint, _I,
                    _I, _I, _I, _I, _I, _I, _I, _P]),
    "step_parts": ("step_parts.cu", "step_parts_launch",
                   [_P, _P, _P, _P, _I, _I, ctypes.c_uint, _I, _I, _P]),
    "step_context": ("step_context.cu", "step_context_launch",
                     [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_uint, _I, _I,
                      _I, _P]),
    "mac_dot": ("mac_dot.cu", "mac_dot_launch",
                [_P, _P, _P, _I, _I, _I, _I, _P]),
    "step_overlap": ("step_overlap.cu", "step_overlap_launch",
                     [_P, _P, _P, _P, _I, ctypes.c_uint, _I, _I, _P]),
    "step_profile": ("step_profile.cu", "step_profile_launch",
                     [_P, _P, _P, _P, _I, _I, ctypes.c_uint, _I, _I, _I, _P]),
    "step_schedules": ("step_schedules.cu", "step_schedules_launch",
                       [_P, _P, _P, _P, _I, _I, ctypes.c_uint, _I, _I, _I,
                        _P]),
    "step_tricks": ("step_tricks.cu", "step_tricks_launch",
                    [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_uint, _I, _I,
                     _I, _P]),
    "rotate_forms": ("rotate_forms.cu", "rotate_forms_launch",
                     [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_uint, _I, _I,
                      _I, _P]),
    "inverse_probe": ("inverse_probe.cu", "inverse_probe_launch",
                      [_P, _P, _I, _I, _I, _P]),
    "key_rows": ("key_rows.cu", "key_rows_launch",
                 [_P, _P, _I, _I, _I, _I, _P]),
}

# every kernel's nvcc flags (``-Xptxas -v`` for the build log)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libraries = {}
_loaded = {}
# wall seconds this process spent waiting on nvcc (0 when every library it
# loaded was already in _build/)
nvcc_seconds = 0.0


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(name):
    source = CSRC / KERNELS[name][0]
    digest = hashlib.sha1(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # the shared headers
        digest.update(header.read_bytes())
    return source, BUILD_DIR / ("lib%s_%s.so" % (name, digest.hexdigest()[:12]))


def _compile(name):
    """Start ``nvcc`` for one kernel; returns (process, temp path, final
    path), or None when the library is already built."""
    source, lib = _library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path()] + NVCC_FLAGS + ["-o", tmp, str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name, job):
    proc, tmp, lib = job
    log, _ = proc.communicate()
    (BUILD_DIR / ("%s.log" % name)).write_text(log)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed for %s:\n%s" % (name, log))
    os.replace(tmp, lib)


def build_all():
    """Compile every kernel that is not built yet, all in parallel."""
    global nvcc_seconds
    with _lock:
        t0 = time.time()
        jobs = {name: _compile(name) for name in KERNELS}
        errors = []
        for name, job in jobs.items():
            if job is not None:
                try:
                    _finish(name, job)
                except RuntimeError as exc:
                    errors.append(str(exc))
        if any(jobs.values()):
            nvcc_seconds += time.time() - t0
        if errors:
            raise RuntimeError("\n".join(errors))


def build_log(name):
    """``nvcc -Xptxas -v`` output of the last build of ``name`` ('' if the
    library was built by an earlier process)."""
    path = BUILD_DIR / ("%s.log" % name)
    return path.read_text() if path.exists() else ""


def _library(name):
    """Kernel ``name``'s library, built first if needed and loaded once
    (inside the span ``nufhe.kernels.load``); the caller holds ``_lock``."""
    global nvcc_seconds
    lib = _libraries.get(name)
    if lib is None:
        with annotate("nufhe.kernels.load"):
            _, lib_path = _library_path(name)
            if not lib_path.exists():
                t0 = time.time()
                job = _compile(name)
                if job is not None:
                    _finish(name, job)
                    nvcc_seconds += time.time() - t0
            lib = _libraries[name] = ctypes.CDLL(str(lib_path))
    return lib


def function(name, symbol, argtypes):
    """The C function ``symbol`` of kernel ``name``'s library, returning a C
    int, building and loading the library first if needed."""
    with _lock:
        fn = getattr(_library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def entry(name):
    """The C entry point of kernel ``name`` (:func:`function` of its
    ``KERNELS`` symbol)."""
    fn = _loaded.get(name)
    if fn is None:
        _, symbol, argtypes = KERNELS[name]
        fn = _loaded[name] = function(name, symbol, argtypes)
    return fn


def check(name, code):
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        raise RuntimeError("CUDA error %d in kernel %s" % (code, name))
