"""The host numerics of key preparation in C++: the exact Nussbaumer forward
transform over Z/2^64 and the two-sided limb split mod 2^38
(``kernels/csrc/nussbaumer_host.cc``, threads across polynomials), the
counterpart of ``nufhe_tpu/native.py``.

The library is compiled at first use with the system C++ compiler (``$CXX``,
else ``g++``) into the git-ignored ``kernels/_build/``, named by a hash of
its source, the compiler and the flags, and loaded with ``ctypes``.  It is
built without ``-march=native``, so one library serves any x86-64 host,
and without OpenMP, whose runtime not every toolchain has: the source
splits the polynomials over ``std::thread``.
The numpy oracle (``ref/transform_ref.forward``,
``ops/transform.key_limbs_host``) defines the result and gives the same
bits; it runs where no compiler exists.  A compiler that is there but
fails, or a library that does not load, raises with the command and its
output: nothing falls back then.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from .kernels.build import BUILD_DIR, CSRC

SOURCE = CSRC / "nussbaumer_host.cc"
FLAGS = ("-O3", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_libs = {}      # compiler -> loaded library


def compiler():
    """The C++ compiler to build with: ``$CXX`` where set, else ``g++`` on
    the ``PATH``, else None (the numpy fallback)."""
    return os.environ.get("CXX") or shutil.which("g++")


def library_path(cxx):
    digest = hashlib.sha1(SOURCE.read_bytes())
    digest.update(" ".join((cxx,) + FLAGS).encode())
    return BUILD_DIR / ("libnussbaumer_host_%s.so" % digest.hexdigest()[:12])


def _build(cxx, lib):
    """Compile into a per-process temporary file and move it into place, so
    that processes building at once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *FLAGS, str(SOURCE), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        os.unlink(tmp)
        raise RuntimeError("cannot run %s: %s" % (" ".join(cmd), exc)) from exc
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("%s failed (exit %d):\n%s%s" % (
            " ".join(cmd), proc.returncode, proc.stdout, proc.stderr))
    os.replace(tmp, lib)


def _load():
    """The loaded library, or None where there is no compiler."""
    cxx = compiler()
    if cxx is None:
        return None
    with _lock:
        lib = _libs.get(cxx)
        if lib is None:
            path = library_path(cxx)
            if not path.exists():
                _build(cxx, path)
            lib = ctypes.CDLL(str(path))
            lib.nussbaumer_forward_u64.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
            lib.bootstrap_key_limbs.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_int]
            lib.nussbaumer_forward_u64.restype = None
            lib.bootstrap_key_limbs.restype = None
            _libs[cxx] = lib
        return lib


def available():
    """True where the library is built and loaded (False without a
    compiler; a failing build raises)."""
    return _load() is not None


def forward_u64(a):
    """Exact forward Nussbaumer transform, (..., 1024) int -> (..., 64, 32)
    uint64 mod 2^64, in C++ where there is a compiler, else the numpy
    oracle."""
    from .ref import transform_ref as tr

    lib = _load()
    a = np.ascontiguousarray(np.asarray(a), dtype=np.int32)
    if lib is None:
        return tr.forward(a)
    flat = a.reshape(-1, tr.N)
    out = np.empty((flat.shape[0], tr.L, tr.R), np.uint64)
    lib.nussbaumer_forward_u64(flat.ctypes.data, out.ctypes.data,
                               flat.shape[0])
    return out.reshape(a.shape[:-1] + (tr.L, tr.R))


def bootstrap_key_limbs(bk_coeff_flat, exact=True):
    """(n_polys, 1024) int32 -> (n_polys, 64, 32, KL, 2) int8 two-sided
    transformed-key limbs (the forward transform, then the splits of +v and
    of -v mod 2^38; ``ops/transform.key_limbs_host``).  KL = 5 exact, 4 in
    the rounded-key ('FFT') form."""
    from .ops import transform as tf
    from .ref import transform_ref as tr

    lib = _load()
    flat = np.ascontiguousarray(bk_coeff_flat, dtype=np.int32)
    if lib is None:
        return tf.key_limbs_host(tr.forward(flat), exact=exact)
    kl = tf.KEY_LIMBS if exact else tf.KEY_LIMBS_APPROX
    out = np.empty((flat.shape[0], tr.L, tr.R, kl, 2), np.int8)
    lib.bootstrap_key_limbs(flat.ctypes.data, out.ctypes.data, flat.shape[0],
                            1 if exact else 0)
    return out
