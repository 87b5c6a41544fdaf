"""The bootstrapped two-input gates (``nufhe_tpu/models/gates.py``'s
counterpart; NOT, COPY, CONSTANT and MUX are not ported yet).

Every gate is the reference pattern (``nufhe/gates.py``): a noiseless
trivial constant plus a +-1/+-2 linear combination of the inputs, then one
bootstrap with mu = 1/8.

Gate constants (reference lines):
  NAND (0, 1/8) - a - b      gates.py:110-121
  OR   (0, 1/8) + a + b      gates.py:152-163
  AND  (0,-1/8) + a + b      gates.py:194-205
  XOR  (0, 1/4) + 2a + 2b    gates.py:236-247
  XNOR (0,-1/4) - 2a - 2b    gates.py:278-289
  NOR  (0,-1/8) - a - b      gates.py:418-429
  ANDNY(0,-1/8) - a + b      gates.py:460-471
  ANDYN(0,-1/8) + a - b      gates.py:502-513
  ORNY (0, 1/8) - a + b      gates.py:544-555
  ORYN (0, 1/8) + a - b      gates.py:586-597
"""

import numpy as np
import torch

from ..numeric import phase_to_t32, wrap_i32
from ..ops import bootstrap as dboot

_MU = int(phase_to_t32(1, 8))


def get_shape(obj):
    """Batch shape of a gate argument: a ciphertext, an array, or a plain
    (nested) list of booleans.  Reference behavior: nufhe/gates.py:42-48."""
    shape = getattr(obj, 'shape', None)
    if shape is not None:
        return tuple(shape)
    if isinstance(obj, list):
        return np.asarray(obj).shape
    raise ValueError("not an array-like gate argument: %r" % (type(obj),))


def result_shape(*shapes):
    """Numpy-style broadcast of batch shapes.  Reference behavior:
    nufhe/gates.py:51-69."""
    try:
        return np.broadcast_shapes(*shapes)
    except ValueError:
        raise ValueError("gate argument shapes do not broadcast: %s"
                         % (list(map(tuple, shapes)),))


def check_shape(result, *args):
    """The broadcast of the argument shapes must equal a trailing slice of
    the destination shape.  Reference behavior: nufhe/gates.py:72-78."""
    derived = result_shape(*map(get_shape, args))
    dest = tuple(result.shape)
    if dest[max(len(dest) - len(derived), 0):] != derived:
        raise ValueError(
            "gate result shape %s does not accept the broadcast "
            "argument shape %s" % (dest, derived))


def _broadcast_flat(ct, shape, lwe_size, device):
    """Broadcast a ciphertext's tensors to ``shape``, flatten the batch."""
    a = ct.a.to(device).broadcast_to(shape + (lwe_size,)).reshape(-1, lwe_size)
    b = ct.b.to(device).broadcast_to(shape).reshape(-1)
    cv = ct.current_variances.to(device).broadcast_to(shape).reshape(-1)
    return a, b, cv


def _linear_bootstrap(inputs, const, coeffs, bk_dev, ks_arrays, *, mu,
                      tgsw_params, ks_meta):
    """temp = (0, const) + sum_i coeffs[i] * inputs[i]; bootstrap(temp)."""
    ta = torch.zeros_like(inputs[0][0], dtype=torch.int64)
    tb = torch.full(inputs[0][1].shape, int(const), dtype=torch.int64,
                    device=ta.device)
    tcv = torch.zeros_like(inputs[0][2])
    for (ia, ib, icv), c in zip(inputs, coeffs):
        ta = ta + int(c) * ia.to(torch.int64)
        tb = tb + int(c) * ib.to(torch.int64)
        tcv = tcv + torch.tensor(float(c), dtype=torch.float32) ** 2 * icv
    return dboot.bootstrap_device(
        wrap_i32(ta), wrap_i32(tb), bk_dev, ks_arrays, ks_meta, mu,
        tgsw_params)


def _bootstrap_gate(cloud_key, result, sources, const, coeffs, device):
    params = cloud_key.params
    lwe_size = params.in_out_params.size
    shape = tuple(result.shape)
    inputs = tuple(_broadcast_flat(src, shape, lwe_size, device)
                   for src in sources)
    ks_arrays, ks_meta = cloud_key.keyswitch_key.device(device)
    ra, rb, rcv = _linear_bootstrap(
        inputs, const, coeffs, cloud_key.bootstrap_key.device(device),
        ks_arrays, mu=_MU, tgsw_params=params.tgsw_params, ks_meta=ks_meta)
    out_size = ra.shape[-1]
    result.a = ra.reshape(shape + (out_size,))
    result.b = rb.reshape(shape)
    result.current_variances = rcv.reshape(shape)
    return result


def _make_gate2(name, const_num, const_den, ca, cb, doc):
    def gate(cloud_key, result, a, b, device):
        check_shape(result, a, b)
        return _bootstrap_gate(
            cloud_key, result, (a, b), phase_to_t32(const_num, const_den),
            (ca, cb), device)
    gate.__name__ = name
    gate.__doc__ = doc
    return gate


# name: (constant numerator, denominator, coefficient of a, of b)
GATES2 = {
    'gate_nand': (1, 8, -1, -1),
    'gate_or': (1, 8, 1, 1),
    'gate_and': (-1, 8, 1, 1),
    'gate_xor': (1, 4, 2, 2),
    'gate_xnor': (-1, 4, -2, -2),
    'gate_nor': (-1, 8, -1, -1),
    'gate_andny': (-1, 8, -1, 1),
    'gate_andyn': (-1, 8, 1, -1),
    'gate_orny': (1, 8, -1, 1),
    'gate_oryn': (1, 8, 1, -1),
}

for _name, (_num, _den, _ca, _cb) in GATES2.items():
    globals()[_name] = _make_gate2(
        _name, _num, _den, _ca, _cb,
        "Bootstrapped %s: (0, %d/%d) %+d*a %+d*b."
        % (_name[5:].upper(), _num, _den, _ca, _cb))
