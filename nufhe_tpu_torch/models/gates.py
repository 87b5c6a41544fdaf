"""The 14 homomorphic gates (``nufhe_tpu/models/gates.py``'s counterpart).

Every bootstrapped gate is the reference pattern (``nufhe/gates.py``): a
noiseless trivial constant plus a +-1/+-2 linear combination of the inputs,
then one bootstrap with mu = 1/8.  Each gate takes the device it runs on
and, optionally, a ``PerformanceParametersForDevice`` (unset: the
defaults for that device).

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
  NOT/COPY/CONSTANT: linear only; MUX: two no-keyswitch bootstraps run as
  one rotation over 2B samples, a sum, one keyswitch (gates.py:600-664).

Every gate opens the span ``nufhe.gate``, a bootstrapped one also
``nufhe.gate.linear`` around its broadcast and linear combination
(``utils/profiling.annotate``).
"""

import numpy as np
import torch

from ..numeric import bool_to_t32, phase_to_t32, wrap_i32
from ..ops import bootstrap as dboot
from ..ops import lwe as dlwe
from ..performance import PerformanceParameters
from ..utils.profiling import annotate, spanned

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
    """Broadcast a ciphertext's (a, b) to ``shape``, flatten the batch."""
    a = ct.a.to(device).broadcast_to(shape + (lwe_size,)).reshape(-1, lwe_size)
    b = ct.b.to(device).broadcast_to(shape).reshape(-1)
    return a, b


def _perf_kwargs(perf_params, device):
    """The bootstrap's knobs from ``perf_params`` (unset: the defaults for
    ``device``); ``single_kernel_bootstrap`` picks the engine (True: rows,
    False: lanes)."""
    if perf_params is None:
        perf_params = PerformanceParameters().for_device(device)
    return dict(chunk_steps=perf_params.chunk_steps,
                coarse_phase_bits=perf_params.coarse_phase_bits,
                lanes=not perf_params.single_kernel_bootstrap)


def _bootstrap_key(cloud_key, device, lanes):
    """The bootstrap key in the engine's form on ``device``."""
    bk = cloud_key.bootstrap_key
    return bk.mac_rhs(device) if lanes else bk.device(device)


def _linear(inputs, const, coeffs):
    """temp = (0, const) + sum_i coeffs[i] * inputs[i], as int32 (a, b)."""
    ta = torch.zeros_like(inputs[0][0], dtype=torch.int64)
    tb = torch.full(inputs[0][1].shape, int(const), dtype=torch.int64,
                    device=ta.device)
    for (ia, ib), c in zip(inputs, coeffs):
        ta = ta + int(c) * ia.to(torch.int64)
        tb = tb + int(c) * ib.to(torch.int64)
    return wrap_i32(ta), wrap_i32(tb)


def _store(result, shape, ra, rb, rcv):
    out_size = ra.shape[-1]
    result.a = ra.reshape(shape + (out_size,))
    result.b = rb.reshape(shape)
    result.current_variances = rcv.reshape(shape)
    return result


def _bootstrap_gate(cloud_key, result, sources, const, coeffs, device,
                    perf_params=None):
    """temp = (0, const) + sum_i coeffs[i] * sources[i]; bootstrap(temp)."""
    params = cloud_key.params
    lwe_size = params.in_out_params.size
    shape = tuple(result.shape)
    with annotate("nufhe.gate.linear"):
        inputs = tuple(_broadcast_flat(src, shape, lwe_size, device)
                       for src in sources)
        ta, tb = _linear(inputs, const, coeffs)
    ks_arrays, ks_meta = cloud_key.keyswitch_key.device(device)
    perf = _perf_kwargs(perf_params, device)
    bk_dev = _bootstrap_key(cloud_key, device, perf.pop("lanes"))
    ra, rb, rcv = dboot.bootstrap_device(
        ta, tb, bk_dev, ks_arrays, ks_meta, _MU, params.tgsw_params, **perf)
    return _store(result, shape, ra, rb, rcv)


def _make_gate2(name, const_num, const_den, ca, cb, doc):
    @spanned("nufhe.gate")
    def gate(cloud_key, result, a, b, device, perf_params=None):
        check_shape(result, a, b)
        return _bootstrap_gate(
            cloud_key, result, (a, b), phase_to_t32(const_num, const_den),
            (ca, cb), device, perf_params)
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


# --- linear gates ---

def _linear_gate(result, source, coeff, device):
    """result = coeff * source (broadcast); no bootstrap."""
    shape = tuple(result.shape)
    lwe_size = source.a.shape[-1]
    src = (source.a.to(device).broadcast_to(shape + (lwe_size,)),
           source.b.to(device).broadcast_to(shape),
           source.current_variances.to(device).broadcast_to(shape))
    result.a, result.b, result.current_variances = dlwe.lwe_linear(src, coeff)
    return result


@spanned("nufhe.gate")
def gate_not(cloud_key, result, a, device, perf_params=None):
    """Homomorphic NOT (negation; not bootstrapped).
    Reference: nufhe/gates.py:292-317."""
    check_shape(result, a)
    return _linear_gate(result, a, -1, device)


@spanned("nufhe.gate")
def gate_copy(cloud_key, result, a, device, perf_params=None):
    """Copy a ciphertext (not bootstrapped).
    Reference: nufhe/gates.py:320-344."""
    check_shape(result, a)
    return _linear_gate(result, a, 1, device)


@spanned("nufhe.gate")
def gate_constant(cloud_key, result, vals, device, perf_params=None):
    """Trivial (noiseless) encryption of plaintext bits.
    Reference: nufhe/gates.py:352-387."""
    mus = bool_to_t32(np.asarray(vals))
    check_shape(result, mus)
    shape = tuple(result.shape)
    mus_dev = torch.from_numpy(np.ascontiguousarray(mus)).to(device)
    result.a, result.b, result.current_variances = dlwe.lwe_noiseless_trivial(
        mus_dev.broadcast_to(shape).contiguous(), result.params.size)
    return result


# --- MUX ---

def _i64(x):
    return x.to(torch.int64)


@spanned("nufhe.gate")
def gate_mux(cloud_key, result, a, b, c, device, perf_params=None):
    """Bootstrapped MUX: b if a else c.  Two keyswitch-free bootstraps,
    u1 = BS((0,-1/8) + a + b) and u2 = BS((0,-1/8) - a + c), run as one
    blind rotation over 2B samples (the reference runs them one after the
    other, nufhe/gates.py:638-655); then (0, 1/8) + u1 + u2 in the
    extracted space and one keyswitch.  Reference: nufhe/gates.py:600-664.
    """
    check_shape(result, a, b, c)
    params = cloud_key.params
    lwe_size = params.in_out_params.size
    shape = tuple(result.shape)
    and_const = int(phase_to_t32(-1, 8))
    mux_const = int(phase_to_t32(1, 8))
    with annotate("nufhe.gate.linear"):
        (aa, ab), (ba, bb), (ca, cb) = (
            _broadcast_flat(src, shape, lwe_size, device)
            for src in (a, b, c))
        bsz = ab.shape[0]
        lwe_a = wrap_i32(torch.cat([_i64(aa) + _i64(ba),
                                    _i64(ca) - _i64(aa)]))
        lwe_b = wrap_i32(torch.cat([and_const + _i64(ab) + _i64(bb),
                                    and_const - _i64(ab) + _i64(cb)]))
    ks_arrays, ks_meta = cloud_key.keyswitch_key.device(device)
    perf = _perf_kwargs(perf_params, device)
    bk_dev = _bootstrap_key(cloud_key, device, perf.pop("lanes"))
    ex_a, ex_b, ex_cv = dboot.bootstrap_device(
        lwe_a, lwe_b, bk_dev, ks_arrays, ks_meta, _MU, params.tgsw_params,
        no_keyswitch=True, **perf)
    ta = wrap_i32(_i64(ex_a[:bsz]) + _i64(ex_a[bsz:]))
    tb = wrap_i32(mux_const + _i64(ex_b[:bsz]) + _i64(ex_b[bsz:]))
    ra, rb, rcv = dlwe.lwe_keyswitch(ks_arrays, ks_meta, ta, tb,
                                     source_cv=ex_cv[:bsz] + ex_cv[bsz:])
    return _store(result, shape, ra, rb, rcv)


# the gates a VirtualMachine dispatches by name
GATES = tuple(GATES2) + ('gate_not', 'gate_copy', 'gate_constant', 'gate_mux')
