"""Ciphertext arrays (``nufhe_tpu/ciphertext.py``'s counterpart).

``LweSampleArray`` is an array of LWE samples with a numpy-style ``shape``:
``a`` is shape+(n,) int32, ``b`` shape int32 and ``current_variances``
shape float32, all torch tensors on one device.  It supports indexing,
item assignment, ``roll``, ``concatenate`` and serialization with the JAX
package's value semantics: a ciphertext taken by indexing never changes
when its source is assigned into, and the other way round.
"""

import io

import numpy as np
import torch

from .numeric import Torus32, ErrorFloat
from .params import LweParams
from . import serialization
from .utils import arrays_equal


def _host_index(ix):
    """A component of an index with torch tensors taken to numpy."""
    if torch.is_tensor(ix):
        return ix.detach().cpu().numpy()
    if isinstance(ix, tuple):
        return tuple(_host_index(i) for i in ix)
    return ix


class LweSampleArray:
    """A ciphertext object: an array of LWE samples (reference:
    ``nufhe/lwe.py:135-251``).

    No method writes into the tensors it holds: indexing gathers new
    tensors, and assignment, ``roll`` and the gates bind new ones.  So a
    tensor may be shared between ciphertexts (``broadcast_to`` shares its
    source's storage) without either seeing the other's updates.
    """

    def __init__(self, params: LweParams, a, b, current_variances):
        if a.shape[:-1] != b.shape or b.shape != current_variances.shape:
            raise ValueError(
                "Inconsistent shapes: {a}, {b}, {cv}".format(
                    a=tuple(a.shape), b=tuple(b.shape),
                    cv=tuple(current_variances.shape)))
        self.params = params
        self.a = a
        self.b = b
        self.current_variances = current_variances

    @classmethod
    def empty(cls, params: LweParams, shape, device):
        if isinstance(shape, int):
            shape = (shape,)
        shape = tuple(shape)
        return cls(
            params,
            torch.zeros(shape + (params.size,), dtype=torch.int32, device=device),
            torch.zeros(shape, dtype=torch.int32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device))

    @property
    def shape(self):
        return tuple(self.b.shape)

    @property
    def device(self):
        return self.b.device

    def _normalize_index(self, index):
        """The message-shape coordinates that ``index`` selects: numpy's
        indexing of an array of the *message* shape, so Ellipsis resolves
        against it and indexing never touches the trailing LWE axis of
        ``a``.  Takes every index numpy takes (negative steps, integer and
        boolean arrays, broadcasting), which torch's basic indexing does
        not.

        :returns: a tuple of int64 tensors on this ciphertext's device, one
            per message axis, each of the selection's shape.
        """
        shape = self.shape
        flat = np.arange(int(np.prod(shape, dtype=np.int64))).reshape(shape)
        picked = np.asarray(flat[_host_index(index)])
        return tuple(torch.from_numpy(np.array(c, np.int64)).to(self.device)
                     for c in np.unravel_index(picked, shape))

    def __getitem__(self, index):
        """The selected samples, as new tensors (indexes the message
        shape)."""
        coords = self._normalize_index(index)
        return LweSampleArray(self.params, self.a[coords], self.b[coords],
                              self.current_variances[coords])

    def __setitem__(self, index, value):
        """Assign ``value`` (broadcast to the selection) into fresh copies
        of this ciphertext's tensors, as ``.at[].set`` does in the JAX
        package: other ciphertexts that share the old tensors keep them."""
        if not isinstance(value, LweSampleArray):
            raise ValueError(
                "can only assign another LweSampleArray into a ciphertext "
                "view, got %r" % (type(value),))
        coords = self._normalize_index(index)
        sel = tuple(coords[0].shape) if coords else ()
        dev = self.device

        def put(dst, src, shape):
            out = dst.clone(memory_format=torch.contiguous_format)
            out[coords] = src.to(dev, out.dtype).broadcast_to(shape)
            return out

        self.a = put(self.a, value.a, sel + (self.params.size,))
        self.b = put(self.b, value.b, sel)
        self.current_variances = put(self.current_variances,
                                     value.current_variances, sel)

    def copy(self):
        return LweSampleArray(
            self.params, self.a.clone(), self.b.clone(),
            self.current_variances.clone())

    def broadcast_to(self, shape):
        """The ciphertext broadcast to the given message shape (numpy
        broadcasting rules; the LWE axis is untouched).  It shares its
        source's storage; assigning into it copies first."""
        shape = tuple(shape)
        return LweSampleArray(
            self.params,
            self.a.broadcast_to(shape + (self.params.size,)),
            self.b.broadcast_to(shape),
            self.current_variances.broadcast_to(shape))

    def roll(self, shift, axis=-1):
        """Cyclically shift encrypted bits along ``axis``, in place.

        Equivalent to ``numpy.roll`` (reference: ``nufhe/lwe.py:188-205``).
        """
        axis = axis % len(self.shape)
        self.a = torch.roll(self.a, shift, dims=axis)
        self.b = torch.roll(self.b, shift, dims=axis)
        self.current_variances = torch.roll(
            self.current_variances, shift, dims=axis)

    # --- serialization: the JAX package's container, byte for byte ---

    def dump(self, file_obj):
        serialization.dump(
            file_obj,
            {"kind": "LweSampleArray",
             "params": [self.params.size, self.params.min_noise,
                        self.params.max_noise]},
            {"a": self.a.cpu().numpy(), "b": self.b.cpu().numpy(),
             "cv": self.current_variances.cpu().numpy()})

    def dumps(self):
        buf = io.BytesIO()
        self.dump(buf)
        return buf.getvalue()

    @classmethod
    def load(cls, file_obj, device=None):
        """Read a ciphertext onto ``device`` (``None``: the CUDA device,
        raising when there is none)."""
        from .api import resolve_device
        device = resolve_device(device)
        meta, arrays = serialization.load(file_obj)
        if meta.get("kind") != "LweSampleArray":
            raise ValueError("not a ciphertext container: %r"
                             % (meta.get("kind"),))
        size, min_noise, max_noise = meta["params"]
        params = LweParams(int(size), float(min_noise), float(max_noise))
        return ciphertext_from_arrays(params, arrays["a"], arrays["b"],
                                      arrays["cv"], device)

    @classmethod
    def loads(cls, s: bytes, device=None):
        return cls.load(io.BytesIO(s), device)

    def __eq__(self, other):
        return (
            self.__class__ == other.__class__
            and self.params == other.params
            and arrays_equal(self.a, other.a)
            and arrays_equal(self.b, other.b)
            and arrays_equal(self.current_variances, other.current_variances))


def concatenate(lwe_sample_arrays, axis=0, out=None):
    """Concatenate ciphertext arrays along message axis ``axis``
    (reference: ``nufhe/lwe.py:425-447``).

    ``axis`` must be >= 0: the JAX package's ``concatenate`` joins ``a``
    along the same axis number as ``b``, so a negative axis lands on ``a``'s
    LWE axis there and raises; this port raises for it too rather than
    take a meaning the JAX package lacks.
    """
    if len(lwe_sample_arrays) == 0:
        raise ValueError("concatenate() requires a non-empty ciphertext list")
    if axis < 0:
        raise ValueError(
            "concatenate() takes a message axis >= 0, got axis=%d (the JAX "
            "package raises for a negative axis)" % axis)
    params = lwe_sample_arrays[0].params
    a = torch.cat([c.a for c in lwe_sample_arrays], dim=axis)
    b = torch.cat([c.b for c in lwe_sample_arrays], dim=axis)
    cv = torch.cat([c.current_variances for c in lwe_sample_arrays], dim=axis)
    if out is None:
        return LweSampleArray(params, a, b, cv)
    out.a, out.b, out.current_variances = a, b, cv
    return out


def ciphertext_from_arrays(params: LweParams, a, b, cv, device):
    """A ciphertext holding the given numpy arrays, on ``device``."""
    return LweSampleArray(
        params,
        torch.from_numpy(np.array(a, Torus32)).to(device),
        torch.from_numpy(np.array(b, Torus32)).to(device),
        torch.from_numpy(np.array(cv, ErrorFloat)).to(device))
