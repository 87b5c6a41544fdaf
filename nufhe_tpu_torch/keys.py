"""Key objects, key generation and key containers (``nufhe_tpu/keys.py``).

Keys are generated on the CUDA card by default (``ops/keygen``), or on the
host with the numpy oracles (``on_device=False``), or by the same torch
code on CPU tensors (``device='cpu'``).  The RNG runs on the host in both
placements, in the reference's call order, so one ``DeterministicRNG`` seed
gives the same keys either way and in ``nufhe_tpu``.  A key generated on a
device keeps its tables there (``bk_coeff``, ``ks_a``, ``ks_b`` are
tensors); the variance tables stay numpy.  ``device(dev)`` prepares each
key for the kernels, on ``dev``.  ``dump``/``load`` write and read the JAX
package's containers byte for byte (``serialization.py``): a key written
by either package loads in the other.
"""

import io

import numpy as np
import torch

from .numeric import Torus32, ErrorFloat
from .params import LweParams, TLweParams, TGswParams, NuFHEParameters
from .rng import rand_uniform_bool, rand_uniform_torus32, rand_gaussian_torus32
from .ref import tlwe_ref, tgsw_ref, lwe_ref
from .ops import lwe as dlwe
from .ops import key_rows, keygen, tgsw, transform
from . import serialization
from .utils import to_device, to_numpy
from .utils.profiling import annotate


def _keygen_device(on_device=None, device=None):
    """Where keygen runs: None for the host numpy oracle (``on_device=
    False``), else a ``torch.device``: ``device``, or the current CUDA
    device when it is None.  Without CUDA and without ``device`` it
    raises: there is no quiet host fallback."""
    if on_device is False:
        return None
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "keygen runs on a CUDA device by default and none is available; "
            "pass on_device=False for the host numpy keygen or device='cpu' "
            "for the PyTorch keygen on CPU tensors")
    return torch.device("cuda", torch.cuda.current_device())


def _int32(x):
    """An int32 tensor stays where it is; anything else becomes numpy."""
    if torch.is_tensor(x):
        if x.dtype != torch.int32:
            raise TypeError("expected an int32 tensor, got %s" % x.dtype)
        return x
    return np.asarray(x, Torus32)


def _check_kind(meta, kind):
    if meta.get("kind") != kind:
        raise ValueError("expected a %s container, got %r"
                         % (kind, meta.get("kind")))


class LweKey:
    """Binary LWE secret key.  Reference: ``nufhe/lwe.py:71-106``."""

    def __init__(self, params: LweParams, key):
        self.params = params
        self.key = np.asarray(key, Torus32)

    @classmethod
    def from_rng(cls, params: LweParams, rng):
        return cls(params, rand_uniform_bool(rng, (params.size,)))

    @classmethod
    def from_tlwe_key(cls, params: LweParams, tlwe_key: 'TLweKey'):
        poly_degree = tlwe_key.params.polynomial_degree
        mask_size = tlwe_key.params.mask_size
        if params.size != poly_degree * mask_size:
            raise ValueError("LWE size %d != N * mask_size" % params.size)
        return cls(params, tlwe_key.key.ravel())

    def dump(self, file_obj):
        serialization.dump(
            file_obj,
            {"kind": "LweKey",
             "params": [self.params.size, self.params.min_noise,
                        self.params.max_noise]},
            {"key": self.key})

    @classmethod
    def load(cls, file_obj):
        meta, arrays = serialization.load(file_obj)
        _check_kind(meta, "LweKey")
        size, min_noise, max_noise = meta["params"]
        return cls(LweParams(int(size), float(min_noise), float(max_noise)),
                   arrays["key"])

    def __eq__(self, other):
        return (self.__class__ == other.__class__
                and self.params == other.params
                and np.array_equal(self.key, other.key))


class TLweKey:
    """mask_size binary polynomials.  Reference: ``nufhe/tlwe.py:77-91``."""

    def __init__(self, params: TLweParams, key):
        self.params = params
        self.key = np.asarray(key, np.int32)  # (mask_size, N)

    @classmethod
    def from_rng(cls, params: TLweParams, rng):
        key = rand_uniform_bool(
            rng, (params.mask_size, params.polynomial_degree))
        return cls(params, key)


class TGswKey:
    """Reference: ``nufhe/tgsw.py:70-78``."""

    def __init__(self, params: TGswParams, tlwe_key: TLweKey):
        self.params = params
        self.tlwe_key = tlwe_key

    @classmethod
    def from_rng(cls, params: TGswParams, rng):
        return cls(params, TLweKey.from_rng(params.tlwe_params, rng))


class BootstrapKey:
    """n TGSW encryptions of the LWE key bits.  Reference:
    ``nufhe/bootstrap.py:44-92``.

    Holds the coefficient-domain samples (``bk_coeff``: (n, mask_size+1,
    decomp_length, mask_size+1, N) int32; a tensor after device keygen,
    numpy after host keygen or a format-1 container), or else only the
    transformed int8 limbs that formats 2-4 carry, which is all either
    engine needs.  Format 4 (what ``dump`` writes) stores the +v side and,
    for the rounded form, one bit a residue (``compact()``).  A tensor key
    is transformed where it lies (``ops/keygen.bootstrap_key_limbs_device``)
    and both engines' keys are built from that compact form on the target
    device, as they are for a loaded format-4 key: neither runs the numpy
    transform, ``two_sided_limbs_host`` or the host limb split.
    """

    def __init__(self, in_out_params: LweParams, bk_params: TGswParams,
                 bk_coeff, cv, limbs=None, compact=None):
        self.in_out_params = in_out_params
        self.bk_params = bk_params
        self.accum_params = bk_params.tlwe_params
        self.bk_coeff = None if bk_coeff is None else _int32(bk_coeff)
        self.cv = np.asarray(cv, ErrorFloat)
        self._limbs = limbs
        self._compact = compact      # (pos_limbs, delta): the one-sided form
        self._device = {}
        self._mac_rhs = {}
        self._mac_rhs_host = None

    @classmethod
    def from_rng(cls, rng, lwe_key: LweKey, tgsw_key: TGswKey,
                 on_device=None, device=None):
        """Keygen on ``device`` (default: the current CUDA device) or, with
        ``on_device=False``, with the host numpy oracles; the same key
        either way (:func:`_keygen_device`)."""
        dev = _keygen_device(on_device, device)
        bk_params = tgsw_key.params
        tlwe_params = bk_params.tlwe_params
        mask_size = tlwe_params.mask_size
        poly_n = tlwe_params.polynomial_degree
        noise = tlwe_params.min_noise
        n = lwe_key.params.size

        # reference call order (``nufhe/tlwe.py:185-196``): uniform mask
        # noise first, then gaussian body noise; drawn on the host in both
        # placements
        shape = (n, mask_size + 1, bk_params.decomp_length)
        noises1 = rand_uniform_torus32(rng, shape + (mask_size, poly_n))
        noises2 = rand_gaussian_torus32(rng, 0, noise, shape + (poly_n,))
        if dev is not None:
            w = keygen.negacyclic_key_matrix(tgsw_key.tlwe_key.key)
            a = keygen.bootstrap_key_device(
                *(to_device(x, dev) for x in (w, lwe_key.key, noises1,
                                              noises2)),
                bk_params.base_powers)
            return cls(lwe_key.params, bk_params, a,
                       np.full(shape, noise**2, ErrorFloat))
        a, cv = tlwe_ref.tlwe_encrypt_zero(
            tgsw_key.tlwe_key.key, noises1, noises2, noise)
        # message * gadget onto the diagonal (``nufhe/tgsw.py:142-161``)
        a = tgsw_ref.tgsw_add_message(a, lwe_key.key, bk_params)
        return cls(lwe_key.params, bk_params, a.astype(Torus32), cv)

    @property
    def _exact(self):
        return self.accum_params.transform_type != 'FFT'

    def limbs(self):
        """The two-sided limb form as numpy (cached): 5 limbs (exact) for
        'NTT' parameters, 4 (rounded) for 'FFT'.  A container of the other
        form keeps its own: the limb count selects the engine's form, as in
        the JAX package.  A tensor key's come from its device compact form."""
        if self._limbs is None:
            if self._compact is None and torch.is_tensor(self.bk_coeff):
                self.compact()
            if self._compact is not None:
                pos, delta = self._compact
                self._limbs = transform.two_sided_limbs_host(
                    to_numpy(pos), None if delta is None else to_numpy(delta))
            else:
                self._limbs = tgsw.bootstrap_key_limbs_host(
                    self.bk_coeff, exact=self._exact)
        return self._limbs

    def compact(self):
        """The one-sided form ``(pos_limbs, delta)`` that format 4 stores
        (``ops/transform.one_sided_limbs_host``).  For a tensor key it is
        computed on the key's device and stays there
        (``ops/keygen.bootstrap_key_limbs_device``)."""
        if self._compact is None:
            if self._limbs is None and torch.is_tensor(self.bk_coeff):
                self._compact = keygen.bootstrap_key_limbs_device(
                    self.bk_coeff, exact=self._exact)
            else:
                self._compact = transform.one_sided_limbs_host(self.limbs())
        return self._compact

    def _from_compact(self):
        """True where both engines' keys are built from the compact form on
        the target device: a tensor key, or a key without ``bk_coeff`` that
        has its compact form (a format-4 container)."""
        return torch.is_tensor(self.bk_coeff) or (
            self.bk_coeff is None and self._compact is not None)

    def _two_sided_on(self, dev):
        pos, delta = self.compact()
        return transform.two_sided_limbs_device(
            to_device(pos, dev),
            None if delta is None else to_device(delta, dev))

    def device(self, dev):
        """The rows engine's key on ``dev`` (cached), in the one form that
        the rotation reads there (``ops/key_rows.key_form``).  First the
        int64 key: (n, G, O, L, R) for the exact form, the two-sided (n, 2,
        G, O, L, R) for the rounded one.  From a numpy ``bk_coeff`` the
        form is ``transform_type``'s, by the host transform; from the
        compact form (a tensor key, a format-4 container) the -v side and
        the key are derived on ``dev``
        (``ops/transform.two_sided_limbs_device``, ``rows_key_from_limbs``),
        equal to the transform of the same key.  On the CPU that key is the
        result; on a CUDA device the row kernel makes its int8 limb rows,
        (n, L, G, O, 6, 64) exact or (n, L, G, O, 4, 64) rounded
        (``ops/key_rows``), which K1 and K3 read, and the int64 key is
        released."""
        dev = torch.device(dev)
        if dev not in self._device:
            with annotate("nufhe.keys.prepare"):
                if self._from_compact():
                    key = transform.rows_key_from_limbs(
                        self._two_sided_on(dev), dev)
                elif self.bk_coeff is not None:
                    key = transform.bootstrap_key_transformed(
                        self.bk_coeff, dev, self.accum_params.transform_type)
                else:
                    key = transform.rows_key_from_limbs(self.limbs(), dev)
                self._device[dev] = key_rows.prepare(key, key.dim() == 6)
        return self._device[dev]

    def mac_rhs(self, dev):
        """The lanes engine's key on ``dev`` (cached): the TPU's MAC
        operand, (n, L, C, Q) int8 (``ops/tgsw.expand_bootstrap_key_device``),
        exact (Q = 5*O*R) or rounded (Q = 4*O*R); from the compact form
        through ``ops/tgsw.expand_bootstrap_key_device_compact`` on ``dev``,
        else from :meth:`limbs`.  A prepared array given to
        :meth:`set_mac_rhs` is uploaded as it is."""
        dev = torch.device(dev)
        if dev not in self._mac_rhs:
            with annotate("nufhe.keys.prepare"):
                if self._mac_rhs_host is not None:
                    key = torch.from_numpy(self._mac_rhs_host).to(dev)
                elif self._from_compact():
                    key = tgsw.expand_bootstrap_key_device_compact(
                        *self.compact(), dev, chunk=50)
                else:
                    key = tgsw.expand_bootstrap_key_device(self.limbs(), dev,
                                                           chunk=50)
            self._mac_rhs[dev] = key
        return self._mac_rhs[dev]

    def set_mac_rhs(self, mac_rhs):
        """Take a prepared (n, L, C, Q) int8 array — the JAX package's
        ``bootstrap_key.device()`` as numpy — as the lanes engine's key.
        It must have this key's rows and ``transform_type``'s form."""
        mac_rhs = np.array(mac_rhs)     # an own, writable copy
        mask1 = self.accum_params.mask_size + 1
        groups = 4 if self.accum_params.transform_type == 'FFT' else 5
        want = (self.in_out_params.size, transform.L,
                mask1 * self.bk_params.decomp_length * 2 * transform.R,
                groups * mask1 * transform.R)
        if mac_rhs.dtype != np.int8 or mac_rhs.shape != want:
            raise ValueError("a %s lanes key must be int8 %s, got %s %s"
                             % (self.accum_params.transform_type, want,
                                mac_rhs.dtype, mac_rhs.shape))
        self._mac_rhs_host = mac_rhs
        self._mac_rhs = {}

    def dump(self, file_obj):
        """Format 4: the +v limbs, the variances and, rounded form only,
        the packed delta bits."""
        pos, delta = self.compact()
        arrays = {"limbs_pos": to_numpy(pos), "cv": self.cv}
        if delta is not None:
            arrays["delta_bits"] = np.packbits(to_numpy(delta).reshape(-1))
        serialization.dump(
            file_obj, {"kind": "BootstrapKey", "format": 4}, arrays)

    @classmethod
    def load(cls, file_obj, in_out_params, bk_params):
        """Formats 1 (coefficient domain), 2 (radix-2^8 limbs), 3 (A/B
        limbs, both sides) and 4 (one-sided)."""
        meta, arrays = serialization.load(file_obj)
        _check_kind(meta, "BootstrapKey")
        if "limbs_pos" in arrays:        # format 4
            pos = arrays["limbs_pos"]
            delta = None
            if "delta_bits" in arrays:
                delta = np.unpackbits(
                    arrays["delta_bits"],
                    count=int(np.prod(pos.shape[:-1]))).reshape(pos.shape[:-1])
            return cls(in_out_params, bk_params, None, arrays["cv"],
                       compact=(pos, delta))
        if "limbs" in arrays:            # formats 2 and 3
            limbs = arrays["limbs"]
            if meta.get("format", 2) < 3:
                limbs = transform.relimb_from_radix8(limbs)
            return cls(in_out_params, bk_params, None, arrays["cv"],
                       limbs=limbs)
        return cls(in_out_params, bk_params, arrays["bk_coeff"], arrays["cv"])

    def __eq__(self, other):
        # the limb form is what both engines run on
        return (self.__class__ == other.__class__
                and self.in_out_params == other.in_out_params
                and self.bk_params == other.bk_params
                and np.array_equal(self.limbs(), other.limbs()))


class LweKeyswitchKey:
    """Keyswitch key: (input_size, decomp_length, base) LWE samples.
    ``ks_a`` and ``ks_b`` are int32 tensors after device keygen (they stay
    on their device), numpy otherwise; ``ks_cv`` is numpy.

    Reference: ``nufhe/lwe.py:254-308``.
    """

    def __init__(self, ks_a, ks_b, ks_cv, log2_base: int):
        self.ks_a = _int32(ks_a)
        self.ks_b = _int32(ks_b)
        self.ks_cv = np.asarray(ks_cv, ErrorFloat)
        self.input_size = self.ks_a.shape[0]
        self.decomp_length = self.ks_a.shape[1]
        self.output_size = self.ks_a.shape[-1]
        self.log2_base = log2_base
        self._device = {}

    @classmethod
    def from_tgsw_key(cls, rng, ks_decomp_length: int, ks_log2_base: int,
                      lwe_key: LweKey, tgsw_key: TGswKey, on_device=None,
                      device=None):
        """Keygen on ``device`` (default: the current CUDA device) or, with
        ``on_device=False``, with the host numpy oracle; the same key either
        way (:func:`_keygen_device`)."""
        dev = _keygen_device(on_device, device)
        extract_params = tgsw_key.params.tlwe_params.extracted_lweparams
        in_key = LweKey.from_tlwe_key(extract_params, tgsw_key.tlwe_key)
        out_key = lwe_key
        input_size = in_key.params.size
        output_size = out_key.params.size
        noise = out_key.params.min_noise
        base = 2**ks_log2_base

        # reference order (``nufhe/lwe.py:285-288``): centred gaussian
        # b-noise first, then uniform a-noise; drawn on the host in both
        # placements
        noises_b = rand_gaussian_torus32(
            rng, 0, noise, (input_size, ks_decomp_length, base - 1),
            centered=True)
        noises_a = rand_uniform_torus32(
            rng, (input_size, ks_decomp_length, base - 1, output_size))
        if dev is not None:
            ks_a, ks_b = keygen.make_keyswitch_key_device(
                *(to_device(x, dev) for x in (in_key.key, out_key.key,
                                              noises_a, noises_b)),
                ks_decomp_length, ks_log2_base)
            ks_cv = np.zeros((input_size, ks_decomp_length, base), ErrorFloat)
            ks_cv[:, :, 1:] = noise**2
            return cls(ks_a, ks_b, ks_cv, ks_log2_base)
        ks_a, ks_b, ks_cv = lwe_ref.make_keyswitch_key(
            in_key.key, out_key.key, noises_a, noises_b,
            ks_decomp_length, ks_log2_base, noise)
        return cls(ks_a, ks_b, ks_cv, ks_log2_base)

    def device(self, dev):
        """``(arrays, meta)`` of ``ops/lwe.prepare_keyswitch_device`` on
        ``dev`` (cached): packed on ``dev``, but for numpy tables on the CPU,
        which the numpy oracle packs."""
        dev = torch.device(dev)
        if dev not in self._device:
            with annotate("nufhe.keys.prepare"):
                self._device[dev] = dlwe.prepare_keyswitch_device(
                    self.ks_a, self.ks_b, self.ks_cv, self.log2_base, dev)
        return self._device[dev]

    def dump(self, file_obj):
        """Format 2: without the digit-0 slices, which keygen makes trivial
        zero encryptions (the reference zeroes them too,
        ``lwe_gpu.mako:18-56``).  A key whose slice 0 is not zero raises
        rather than change in a dump/load round trip."""
        ks_a, ks_b = to_numpy(self.ks_a), to_numpy(self.ks_b)
        if np.any(ks_a[:, :, 0]) or np.any(ks_b[:, :, 0]):
            raise ValueError(
                "keyswitch key digit-0 slice is not the trivial zero "
                "encryption; refusing the lossy format-2 dump")
        serialization.dump(
            file_obj,
            {"kind": "LweKeyswitchKey", "log2_base": self.log2_base,
             "format": 2},
            {"ks_a_nz": ks_a[:, :, 1:],
             "ks_b_nz": ks_b[:, :, 1:],
             "ks_cv_nz": self.ks_cv[:, :, 1:]})

    @classmethod
    def load(cls, file_obj):
        """Formats 1 (whole tables) and 2 (without digit 0)."""
        meta, arrays = serialization.load(file_obj)
        _check_kind(meta, "LweKeyswitchKey")
        log2_base = int(meta["log2_base"])
        if meta.get("format", 1) >= 2:
            pad = [(0, 0), (0, 0), (1, 0)]
            return cls(np.pad(arrays["ks_a_nz"], pad + [(0, 0)]),
                       np.pad(arrays["ks_b_nz"], pad),
                       np.pad(arrays["ks_cv_nz"], pad), log2_base)
        return cls(arrays["ks_a"], arrays["ks_b"], arrays["ks_cv"], log2_base)

    def __eq__(self, other):
        return (self.__class__ == other.__class__
                and np.array_equal(to_numpy(self.ks_a), to_numpy(other.ks_a))
                and np.array_equal(to_numpy(self.ks_b), to_numpy(other.ks_b)))


def _params_meta(params: NuFHEParameters):
    return list(params._key)


def _params_from_meta(meta):
    (transform_type, tlwe_mask_size, tlwe_polynomial_degree, lwe_size,
     bs_decomp_length, bs_log2_base, ks_decomp_length, ks_log2_base) = meta
    return NuFHEParameters(
        transform_type=transform_type, tlwe_mask_size=int(tlwe_mask_size),
        tlwe_polynomial_degree=int(tlwe_polynomial_degree),
        lwe_size=int(lwe_size), bs_decomp_length=int(bs_decomp_length),
        bs_log2_base=int(bs_log2_base),
        ks_decomp_length=int(ks_decomp_length),
        ks_log2_base=int(ks_log2_base))


class NuFHESecretKey:
    """Reference: ``nufhe/api_low_level.py:90-154``."""

    def __init__(self, params: NuFHEParameters, lwe_key: LweKey):
        self.params = params
        self.lwe_key = lwe_key

    @classmethod
    def from_rng(cls, params: NuFHEParameters, rng):
        return cls(params, LweKey.from_rng(params.in_out_params, rng))

    def dump(self, file_obj):
        serialization.dump(
            file_obj, {"kind": "NuFHESecretKey",
                       "params": _params_meta(self.params)}, {})
        self.lwe_key.dump(file_obj)

    def dumps(self):
        buf = io.BytesIO()
        self.dump(buf)
        return buf.getvalue()

    @classmethod
    def load(cls, file_obj):
        meta, _ = serialization.load(file_obj)
        _check_kind(meta, "NuFHESecretKey")
        return cls(_params_from_meta(meta["params"]), LweKey.load(file_obj))

    @classmethod
    def loads(cls, s: bytes):
        return cls.load(io.BytesIO(s))

    def __eq__(self, other):
        return (self.__class__ == other.__class__
                and self.params == other.params
                and self.lwe_key == other.lwe_key)


class NuFHECloudKey:
    """Reference: ``nufhe/api_low_level.py:157-239``."""

    def __init__(self, params: NuFHEParameters,
                 bootstrap_key: BootstrapKey, keyswitch_key: LweKeyswitchKey):
        self.params = params
        self.bootstrap_key = bootstrap_key
        self.keyswitch_key = keyswitch_key

    @classmethod
    def from_rng(cls, params: NuFHEParameters, rng, secret_key: NuFHESecretKey,
                 on_device=None, device=None):
        """Keygen on ``device`` (default: the current CUDA device; raises
        without one) or, with ``on_device=False``, on the host
        (:func:`_keygen_device`)."""
        dev = _keygen_device(on_device, device)
        place = dict(on_device=dev is not None, device=dev)
        tgsw_key = TGswKey.from_rng(params.tgsw_params, rng)
        bk = BootstrapKey.from_rng(rng, secret_key.lwe_key, tgsw_key, **place)
        ks = LweKeyswitchKey.from_tgsw_key(
            rng, params.ks_decomp_length, params.ks_log2_base,
            secret_key.lwe_key, tgsw_key, **place)
        return cls(params, bk, ks)

    def dump(self, file_obj):
        serialization.dump(
            file_obj, {"kind": "NuFHECloudKey",
                       "params": _params_meta(self.params)}, {})
        self.bootstrap_key.dump(file_obj)
        self.keyswitch_key.dump(file_obj)

    def dumps(self):
        buf = io.BytesIO()
        self.dump(buf)
        return buf.getvalue()

    @classmethod
    def load(cls, file_obj):
        """A cloud key from its container.  From formats 2-4 its bootstrap
        key holds limbs only; both engines' keys are prepared from them on
        first use on a device."""
        meta, _ = serialization.load(file_obj)
        _check_kind(meta, "NuFHECloudKey")
        params = _params_from_meta(meta["params"])
        bk = BootstrapKey.load(file_obj, params.in_out_params,
                               params.tgsw_params)
        return cls(params, bk, LweKeyswitchKey.load(file_obj))

    @classmethod
    def loads(cls, s: bytes):
        return cls.load(io.BytesIO(s))

    def __eq__(self, other):
        return (self.__class__ == other.__class__
                and self.params == other.params
                and self.bootstrap_key == other.bootstrap_key
                and self.keyswitch_key == other.keyswitch_key)


def make_key_pair(rng, on_device=None, device=None, **params):
    """Create a (secret key, cloud key) pair.
    Reference: ``nufhe/api_low_level.py:242-250``.

    The cloud key is generated on ``device``, by default the current CUDA
    device (it raises when there is none); ``device='cpu'`` runs the same
    PyTorch code on CPU tensors, and ``on_device=False`` the host numpy
    oracle.  All give the same keys for a seeded ``DeterministicRNG``.
    """
    dev = _keygen_device(on_device, device)
    nufhe_params = NuFHEParameters(**params)
    secret_key = NuFHESecretKey.from_rng(nufhe_params, rng)
    cloud_key = NuFHECloudKey.from_rng(nufhe_params, rng, secret_key,
                                       on_device=dev is not None, device=dev)
    return secret_key, cloud_key


def secret_key_from_array(params: NuFHEParameters, lwe_key):
    """A secret key holding the given (n,) binary key array."""
    return NuFHESecretKey(params, LweKey(params.in_out_params, lwe_key))


def cloud_key_from_arrays(params: NuFHEParameters, bk_coeff, bk_cv,
                          ks_a, ks_b, ks_cv, log2_base: int, mac_rhs=None):
    """A cloud key holding the given arrays: the coefficient-domain
    bootstrap key and its variances, and the keyswitch key tables (numpy,
    or int32 tensors for ``bk_coeff``, ``ks_a`` and ``ks_b``, which stay on
    their device).
    ``mac_rhs``, if given, is the prepared lanes-engine key (the JAX
    package's ``bootstrap_key.device()``; :meth:`BootstrapKey.set_mac_rhs`)."""
    bk = BootstrapKey(params.in_out_params, params.tgsw_params, bk_coeff, bk_cv)
    if mac_rhs is not None:
        bk.set_mac_rhs(mac_rhs)
    ks = LweKeyswitchKey(ks_a, ks_b, ks_cv, log2_base)
    return NuFHECloudKey(params, bk, ks)
