"""The system under test, ``nufhe_tpu_torch``, as the benchmark drives it.

The one module of the harness that imports the program: its key and
ciphertext containers, ``VirtualMachine``, the data-parallel mesh, the
kernels' launch counters, the program counters that per-layer readers
declare, and the CUDA function names of its kernels.
"""

import importlib

import numpy as np
import torch

import nufhe_tpu_torch as nft

PARAM_KEYS = ('transform_type', 'tlwe_mask_size', 'tlwe_polynomial_degree',
              'lwe_size', 'bs_decomp_length', 'bs_log2_base',
              'ks_decomp_length', 'ks_log2_base')

# launch counters of the port's kernels: the benchmark's name -> the
# program counter's dotted name
LAUNCHES = {'k3': 'ops.blind_rotate.launches', 'k1': 'ops.cmux.launches',
            'k2': 'ops.keyswitch.launches', 'k4': 'ops.lanes_step.launches'}

# CUDA function -> the kernel it belongs to; K1 is K3's function at a
# chunk of one step, told apart by the counters
PORT_FUNCTIONS = {'blind_rotate_kernel': 'k3', 'keyswitch_kernel': 'k2',
                  'lanes_forward_kernel': 'k4', 'lanes_mac_kernel': 'k4',
                  'lanes_inverse_kernel': 'k4'}


def program_counter(name, metric):
    """(module, attribute) of the program counter ``name``, the dotted name
    of a module-level int under ``nufhe_tpu_torch`` (``ops.blind_rotate.
    steps``) that ``metric`` declares: a per-layer metric, or the harness
    for the launch counters."""
    path, _, attr = name.rpartition('.')
    try:
        module = importlib.import_module('nufhe_tpu_torch.' + path)
    except ImportError:
        module = None
    if not path or type(getattr(module, attr, None)) is not int:
        raise ValueError("%r declares the counter %r, "
                         "which is no module-level int of nufhe_tpu_torch"
                         % (metric, name))
    return module, attr


class Program:
    """One cell's program state: parameters, cloud key, virtual machine.

    The configuration's ``performance`` entry goes to
    ``PerformanceParameters`` as it is.  ``control`` (the configuration's
    ``control`` entry, or None) switches on the program's own path of lower
    precision: keys of ``PARAM_KEYS`` change the parameters the key is
    prepared with, the others are performance settings.  ``counters``
    maps the program counters that the cell's per-layer readers declare to
    the metric that declares each (``manifest.Cell.counters``); they are
    reset and read with the launch counters (``LAUNCHES``).
    """

    def __init__(self, cfg, raw, device, control=None, counters=None):
        self.counters = {key: program_counter(name, 'the harness')
                         for key, name in LAUNCHES.items()}
        self.counters.update((name, program_counter(name, metric))
                             for name, metric in (counters or {}).items())
        control = dict(control or {})
        kwargs = {k: control.pop(k, cfg[k]) for k in PARAM_KEYS}
        self.params = nft.NuFHEParameters(**kwargs)
        self.perf = nft.PerformanceParameters(
            self.params, **dict(cfg.get('performance', {}), **control))
        n, k1 = cfg['lwe_size'], cfg['tlwe_mask_size'] + 1
        l, t = cfg['bs_decomp_length'], cfg['ks_decomp_length']
        base = 1 << cfg['ks_log2_base']
        bk_cv = np.full((n, k1, l), raw['bk_var'], np.float32)
        ks_cv = np.zeros(tuple(raw['ks_a'].shape[:2]) + (base,), np.float32)
        ks_cv[:, :, 1:] = raw['ks_var']
        self.cloud = nft.cloud_key_from_arrays(
            self.params, raw['bk_coeff'], bk_cv, raw['ks_a'], raw['ks_b'],
            ks_cv, cfg['ks_log2_base'])
        self.device = torch.device(device)
        self.noise_var = raw['ks_var']

    def reset_counters(self):
        for module, attr in self.counters.values():
            setattr(module, attr, 0)

    def read_counters(self):
        """The launch counters by the benchmark's names, and the declared
        program counters by their dotted names."""
        return {key: getattr(module, attr)
                for key, (module, attr) in self.counters.items()}

    def prepare_keys(self, lanes=False):
        """The port's preparation of the cloud key on the device: the
        blind rotation's key (the rows engine's, or the lanes engine's
        int8 operand) and the keyswitch operand; cached on the key."""
        bk = self.cloud.bootstrap_key
        key = bk.mac_rhs(self.device) if lanes else bk.device(self.device)
        return key, self.cloud.keyswitch_key.device(self.device)

    def virtual_machine(self):
        return nft.VirtualMachine(self.cloud, perf_params=self.perf,
                                  device=self.device)

    def ciphertext(self, a, b):
        """A ciphertext holding the benchmark's (a, b) int64 samples."""
        cv = torch.full(b.shape, self.noise_var, dtype=torch.float32,
                        device=b.device)
        return nft.LweSampleArray(self.params.in_out_params,
                                  a.to(torch.int32).contiguous(),
                                  b.to(torch.int32).contiguous(), cv)


class Mesh:
    """Data parallelism over the default process group: one card a rank,
    the batch split over 'data' (``nufhe_tpu_torch.parallel.mesh``).

    The sharded bootstrap has no setting for the program's coarse modulus
    switch (``coarse_phase_bits``, from ``performance`` or a control), so
    the gate rounds its mask to that many phase bits fewer in front of it:
    the program's modulus switch then gives the coarse rotation amounts,
    on the same timed path.
    """

    def __init__(self, program, world):
        from nufhe_tpu_torch.numeric import phase_to_t32
        from nufhe_tpu_torch.parallel import mesh as pmesh
        self.pmesh = pmesh
        self.program = program
        self.mesh = pmesh.make_mesh(n_data=world, n_model=1,
                                    device=program.device.type)
        self.mu = int(phase_to_t32(1, 8))
        coarse = program.perf.coarse_phase_bits or 0
        n_poly = program.params.tgsw_params.tlwe_params.polynomial_degree
        self.mask_step = (2**32 // (2 * n_poly)) << coarse if coarse else 0

    def prepare_keys(self):
        """The lanes engine's key and the keyswitch operand on this rank's
        card, and the sharded bootstrap."""
        self.bk, (self.ks_arrays, ks_meta) = self.program.prepare_keys(
            lanes=True)
        self.fn = self.pmesh.sharded_bootstrap_fn(
            self.mesh, ks_meta, self.mu, self.program.params.tgsw_params)

    def gate(self, const, coeffs, x, y):
        """A bootstrapped two-input gate on this rank's shards: the linear
        part, then the sharded bootstrap; (a, b) int32 tensors."""
        from nufhe_tpu_torch.numeric import wrap_i32
        a = sum(c * v[0].to(torch.int64) for c, v in zip(coeffs, (x, y)))
        b = const + sum(c * v[1].to(torch.int64)
                        for c, v in zip(coeffs, (x, y)))
        if self.mask_step:
            step = self.mask_step
            a = torch.div(a + step // 2, step, rounding_mode='floor') * step
        out_a, out_b, _ = self.fn(wrap_i32(a), wrap_i32(b), self.bk,
                                  self.ks_arrays)
        return out_a, out_b

    def gather(self, a, b):
        """The whole batch of a sharded (a, b) on every rank."""
        ct = self.program.ciphertext(a, b)
        full = self.pmesh.gather_ciphertext(ct, self.mesh)
        return full.a, full.b
