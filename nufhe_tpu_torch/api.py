"""User API (``nufhe_tpu/api.py``'s counterpart): ``encrypt``,
``decrypt``, ``Context``, which binds a device and an RNG, and
``VirtualMachine``, which binds a cloud key and runs the gates and the
integer circuits.  Everything runs on the CUDA card unless the caller
passes ``device='cpu'`` (or a ``DeviceID`` of the CPU)."""

import numpy as np
import torch

from .numeric import bool_to_t32, t32_to_bool
from .params import NuFHEParameters
from .keys import NuFHESecretKey, NuFHECloudKey, make_key_pair
from .ciphertext import LweSampleArray
from .performance import PerformanceParameters
from .rng import DeterministicRNG, rand_gaussian_torus32, rand_uniform_torus32
from .ops import lwe as dlwe
from .models import gates
from .models.gates import get_shape, result_shape
from .utils.profiling import annotate


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device, and raises when there is
    none: the CPU is used only when the caller names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "nufhe_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def empty_ciphertext(params: NuFHEParameters, shape, device=None):
    """An all-zero ciphertext of the given message shape.
    Reference: ``nufhe/api_low_level.py:298-302``."""
    return LweSampleArray.empty(params.in_out_params, shape,
                                resolve_device(device))


def encrypt(rng, key: NuFHESecretKey, message, device=None):
    """Encrypt an array of bits.  Reference: ``nufhe/api_low_level.py:266-281``.

    RNG order matches the reference (``nufhe/lwe.py:325-333``): gaussian
    b-noise first, then uniform mask rows.
    """
    device = resolve_device(device)
    message = np.asarray(message)
    params = key.params
    lwe_size = params.in_out_params.size
    noise = params.in_out_params.min_noise

    mus = bool_to_t32(message)
    noises_b = rand_gaussian_torus32(rng, 0, noise, message.shape)
    noises_a = rand_uniform_torus32(rng, message.shape + (lwe_size,))

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)

    a, b, cv = dlwe.lwe_encrypt(t(mus), t(key.lwe_key.key), t(noises_a),
                                t(noises_b), noise)
    return LweSampleArray(params.in_out_params, a, b, cv)


def decrypt_phase(key: NuFHESecretKey, ciphertext: LweSampleArray):
    """The raw phase b - a.s as an int32 numpy array."""
    k = torch.from_numpy(np.asarray(key.lwe_key.key, np.int32)).to(
        ciphertext.device)
    return dlwe.lwe_decrypt_phase(ciphertext.a, ciphertext.b, k).cpu().numpy()


def decrypt(key: NuFHESecretKey, ciphertext: LweSampleArray):
    """Decrypt to a boolean numpy array.
    Reference: ``nufhe/api_low_level.py:284-295``."""
    return t32_to_bool(decrypt_phase(key, ciphertext))


class DeviceID:
    """Picklable identifier of a torch device: ``platform`` is ``'cuda'``
    or ``'cpu'``.  Reference analogue: ``nufhe/api_high_level.py:85-127``."""

    def __init__(self, platform: str, device_id: int, device_kind: str = ""):
        self.platform = platform
        self.device_id = device_id
        self.device_kind = device_kind

    @classmethod
    def from_device(cls, device):
        device = torch.device(device)
        if device.type == 'cuda':
            index = torch.cuda.current_device() if device.index is None \
                else device.index
            return cls('cuda', index, torch.cuda.get_device_name(index))
        return cls(device.type, device.index or 0, device.type)

    def get_device(self):
        """The ``torch.device``; raises when this process has no such
        device."""
        if self.platform == 'cpu':
            return torch.device('cpu')
        if (self.platform == 'cuda' and torch.cuda.is_available()
                and 0 <= self.device_id < torch.cuda.device_count()):
            return torch.device('cuda', self.device_id)
        raise ValueError("Device not found: " + str(self))

    @property
    def api_name(self):
        return self.platform.upper()

    @property
    def device_name(self):
        return self.device_kind or "{}:{}".format(self.platform, self.device_id)

    def __str__(self):
        return "DeviceID({}, {}, {})".format(
            self.platform, self.device_id, self.device_kind)


def find_devices(api=None, include_devices=None, exclude_devices=None,
                 include_platforms=None, exclude_platforms=None):
    """List computation devices.  Reference: ``nufhe/api_high_level.py:45-82``.

    :param api: ``None`` or ``'cuda'`` lists the CUDA devices, ``'cpu'``
        the CPU.  Raises ``ValueError`` when nothing matches: with no CUDA
        device, ``find_devices()`` raises.
    """
    api = 'cuda' if api is None else api.lower()
    if api == 'cuda':
        devices = [DeviceID.from_device(torch.device('cuda', i))
                   for i in range(torch.cuda.device_count())
                   ] if torch.cuda.is_available() else []
    elif api == 'cpu':
        devices = [DeviceID.from_device('cpu')]
    else:
        raise ValueError("api must be 'cuda' or 'cpu', got %r" % (api,))

    def _match(name, masks):
        return masks is None or any(m.lower() in name.lower() for m in masks)

    out = [d for d in devices
           if _match(d.device_kind, include_devices)
           and not (exclude_devices and _match(d.device_kind, exclude_devices))
           and _match(d.platform, include_platforms)
           and not (exclude_platforms
                    and _match(d.platform, exclude_platforms))]
    if not out:
        raise ValueError("No devices found satisfying the given criteria")
    return out


class Context:
    """An execution environment: a device plus an RNG.  The device is the
    first CUDA device unless ``device_id`` or ``api='cpu'`` says otherwise;
    with no CUDA device and neither, it raises.
    Reference: ``nufhe/api_high_level.py:130-299``."""

    def __init__(self, rng=None, device_id: DeviceID = None, api=None,
                 interactive=False, **filters):
        if rng is None:
            rng = DeterministicRNG()
        if device_id is None:
            candidates = find_devices(api=api, **{
                k: v for k, v in filters.items() if v is not None})
            if interactive and len(candidates) > 1:
                device_id = self._ask_device(candidates)
            else:
                device_id = candidates[0]
        self.rng = rng
        self.device_id = device_id
        self.device = device_id.get_device()

    @staticmethod
    def _ask_device(candidates):
        """Prompt on stdin for one of several matching devices.
        Reference: ``nufhe/api_high_level.py:130-181``."""
        print("Available devices:")
        for i, dev in enumerate(candidates):
            print("  [{}] {} ({})".format(i, dev.device_name, dev.api_name))
        while True:
            choice = input(
                "Choose device [0-{}]: ".format(len(candidates) - 1)).strip()
            try:
                idx = int(choice)
            except ValueError:
                continue
            if 0 <= idx < len(candidates):
                return candidates[idx]

    def make_secret_key(self, **params):
        return NuFHESecretKey.from_rng(NuFHEParameters(**params), self.rng)

    def make_cloud_key(self, secret_key: NuFHESecretKey):
        """Keygen on this context's CUDA device; a CPU context uses the
        host numpy oracle."""
        on_device = self.device.type != 'cpu'
        return NuFHECloudKey.from_rng(
            secret_key.params, self.rng, secret_key, on_device=on_device,
            device=self.device if on_device else None)

    def make_key_pair(self, **params):
        secret_key = self.make_secret_key(**params)
        return secret_key, self.make_cloud_key(secret_key)

    def encrypt(self, secret_key: NuFHESecretKey, message):
        return encrypt(self.rng, secret_key, message, device=self.device)

    def decrypt(self, secret_key: NuFHESecretKey, ciphertext: LweSampleArray):
        return decrypt(secret_key, ciphertext)

    def make_virtual_machine(self, cloud_key: NuFHECloudKey,
                             perf_params: PerformanceParameters = None):
        return VirtualMachine(cloud_key, perf_params=perf_params,
                              device=self.device)

    def load_ciphertext(self, file_or_bytestring):
        """A ciphertext container (a file or bytes), onto this device."""
        if isinstance(file_or_bytestring, bytes):
            return LweSampleArray.loads(file_or_bytestring, self.device)
        return LweSampleArray.load(file_or_bytestring, self.device)

    def load_secret_key(self, file_or_bytestring):
        if isinstance(file_or_bytestring, bytes):
            return NuFHESecretKey.loads(file_or_bytestring)
        return NuFHESecretKey.load(file_or_bytestring)

    def load_cloud_key(self, file_or_bytestring):
        if isinstance(file_or_bytestring, bytes):
            return NuFHECloudKey.loads(file_or_bytestring)
        return NuFHECloudKey.load(file_or_bytestring)


class VirtualMachine:
    """Executes gates and integer circuits on ciphertexts with an
    encapsulated cloud key.

    ``vm.gate_<op>(*args, dest=None)`` mirrors the reference
    (``nufhe/api_high_level.py:302-363``) for the 14 gates;
    ``vm.uint_<op>(a, b, dest=None, parallel=None)`` and ``vm.int_<op>``
    run the integer circuits (``models/integer.py``) with the result shape
    derived from the operands (comparisons give one bit per integer,
    ``uint_divmod`` a (quotient, remainder) pair).  ``perf_params`` (a
    ``PerformanceParameters``; unset: the defaults) is resolved for
    ``device`` once, here.  Each call runs inside the span
    ``nufhe.vm.<op>`` (``utils/profiling.annotate``), the root of the gate
    and bootstrap spans below it.
    """

    def __init__(self, cloud_key: NuFHECloudKey,
                 perf_params: PerformanceParameters = None, device=None):
        if perf_params is None:
            perf_params = PerformanceParameters(cloud_key.params)
        self.params = cloud_key.params
        self.cloud_key = cloud_key
        self.device = resolve_device(device)
        self.perf_params = perf_params.for_device(self.device)

    def empty_ciphertext(self, shape):
        return empty_ciphertext(self.params, shape, self.device)

    def load_ciphertext(self, file):
        return LweSampleArray.load(file, self.device)

    def _gate(self, name, *args, dest: LweSampleArray = None):
        with annotate("nufhe.vm." + name):
            if dest is None:
                dest = self.empty_ciphertext(
                    result_shape(*[get_shape(arg) for arg in args]))
            getattr(gates, name)(self.cloud_key, dest, *args,
                                 device=self.device,
                                 perf_params=self.perf_params)
        return dest

    # these produce one encrypted bit per integer, not a full bit array
    _UINT_BIT_RESULT = frozenset(
        ('uint_gt', 'uint_lt', 'uint_eq', 'int_gt', 'int_lt', 'int_eq'))

    def _uint(self, name, *args, dest: LweSampleArray = None, **kwds):
        from .models import integer
        with annotate("nufhe.vm." + name):
            shape = result_shape(*[get_shape(x) for x in args])
            # the integer circuits size their temporaries from the operand
            # shapes, so broadcasting must happen here, not inside a gate
            args = tuple(x if get_shape(x) == shape
                         else x.broadcast_to(shape) for x in args)
            kwds = dict(kwds, perf_params=self.perf_params,
                        device=self.device)
            if name == 'uint_divmod':  # two results: (quotient, remainder)
                q, r = (dest if dest is not None
                        else (self.empty_ciphertext(shape),
                              self.empty_ciphertext(shape)))
                return integer.uint_divmod(self.cloud_key, q, r, *args,
                                           **kwds)
            if dest is None:
                dest = self.empty_ciphertext(
                    shape[:-1] + (1,) if name in self._UINT_BIT_RESULT
                    else shape)
            getattr(integer, name)(self.cloud_key, dest, *args, **kwds)
        return dest

    def __getattr__(self, name):
        if name in gates.GATES:
            return lambda *args, **kwds: self._gate(name, *args, **kwds)
        if name.startswith(('uint_', 'int_')):
            from .models import integer
            if callable(getattr(integer, name, None)):
                return lambda *args, **kwds: self._uint(name, *args, **kwds)
        raise AttributeError(name)


__all__ = ['empty_ciphertext', 'encrypt', 'decrypt', 'decrypt_phase',
           'make_key_pair', 'PerformanceParameters', 'VirtualMachine',
           'Context', 'DeviceID', 'find_devices']
