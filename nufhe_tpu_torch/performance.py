"""Performance configuration (``nufhe_tpu/performance.py``'s counterpart).

As in the JAX package, a device-independent ``PerformanceParameters`` is
specialised with ``for_device()`` into a ``PerformanceParametersForDevice``,
and the constructor keeps the JAX package's signature, so user code carries
over.  On the card the knobs mean:

- ``chunk_steps``: CMUX steps per launch of the chunked blind rotation
  (kernel K3, ``ops/blind_rotate.py``); a chunk that does not divide the
  number of steps ends with one launch of the steps left, and 1 runs one
  K1 launch a step.  Unset, it comes from the
  ``NUFHE_TPU_CHUNK_STEPS`` environment variable, else 50 on a CUDA device
  and 1 on the CPU — the JAX package's "50 on the accelerator, 1
  elsewhere".  The 50 is the JAX package's value; it is not tuned for the
  card.
- ``coarse_phase_bits``: round the rotation amounts to multiples of
  2^bits (``ops/bootstrap.round_phase_coarse``), an opt-in noise-for-speed
  trade.  Unset, it comes from ``NUFHE_TPU_COARSE_PHASE_BITS``, else 0;
  clamped to 0..4.
- ``single_kernel_bootstrap``: the blind rotation's engine.  True is the
  rows engine (K3 chunks or K1 steps, ``ops/cmux.py``); False is the
  lanes engine of the JAX package's ``ops/flat_engine`` on the TPU's int8
  key operand (n launches of K4, ``ops/lanes_step.py``), on every device.
  Unset, it is True on every device.  This departs from the JAX package,
  whose unset value is False off the TPU only because its rows kernel
  cannot run under XLA:CPU; gate results are bit-equal either way.
- ``batch_tile`` and ``vmem_mb``: the TPU's memory knobs.  They are kept as
  attributes so that user code carries over, and select nothing here.
"""

import os


class PerformanceParameters:

    def __init__(self, nufhe_params=None,
                 single_kernel_bootstrap=None,
                 batch_tile=None,
                 vmem_mb=None,
                 chunk_steps=None,
                 coarse_phase_bits=None):
        self.nufhe_params = nufhe_params
        self.single_kernel_bootstrap = single_kernel_bootstrap
        self.batch_tile = batch_tile
        self.vmem_mb = vmem_mb
        self.chunk_steps = chunk_steps
        self.coarse_phase_bits = coarse_phase_bits

    def for_device(self, device=None):
        """Resolve the knobs for ``device`` (a ``torch.device`` or its
        name; only its type is read).  ``None`` is the current CUDA device,
        and raises when there is none."""
        return PerformanceParametersForDevice(self, device)

    def _key(self):
        return (self.single_kernel_bootstrap, self.batch_tile, self.vmem_mb,
                self.chunk_steps, self.coarse_phase_bits)

    def __hash__(self):
        return hash((self.__class__,) + self._key())

    def __eq__(self, other):
        return self.__class__ == other.__class__ and self._key() == other._key()


class PerformanceParametersForDevice:

    def __init__(self, perf_params: PerformanceParameters, device=None):
        from .api import resolve_device
        device_type = resolve_device(device).type
        on_cuda = device_type == 'cuda'

        skb = perf_params.single_kernel_bootstrap
        self.single_kernel_bootstrap = True if skb is None else bool(skb)
        self.batch_tile = perf_params.batch_tile
        self.vmem_mb = perf_params.vmem_mb
        chunk = perf_params.chunk_steps
        if chunk is None:
            chunk = int(os.environ.get(
                "NUFHE_TPU_CHUNK_STEPS", "50" if on_cuda else "1"))
        self.chunk_steps = max(1, int(chunk))
        coarse = perf_params.coarse_phase_bits
        if coarse is None:
            coarse = int(os.environ.get("NUFHE_TPU_COARSE_PHASE_BITS", "0"))
        self.coarse_phase_bits = max(0, min(4, int(coarse)))
        self.device_type = device_type

    def _key(self):
        return (self.single_kernel_bootstrap, self.batch_tile, self.vmem_mb,
                self.chunk_steps, self.coarse_phase_bits, self.device_type)

    def __hash__(self):
        return hash((self.__class__,) + self._key())

    def __eq__(self, other):
        return self.__class__ == other.__class__ and self._key() == other._key()
