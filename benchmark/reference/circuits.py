"""What the reference's encrypted-integer circuits share
(``benchmark/reference/ops/<circuit>.py``).

An encrypted integer is a pair (a (batch, w, n), b (batch, w)) of int64
Torus32 samples, big-endian (index 0 the most significant bit).
"""

from . import tfhe


def gate(keys, name, *args):
    """A gate on equal-shaped (a, b) pairs of any batch shape."""
    shape = args[0][1].shape
    flat = [(x[0].reshape(-1, x[0].shape[-1]), x[1].reshape(-1))
            for x in args]
    if name == 'mux':
        a, b = tfhe.gate_mux(keys, *flat)
    else:
        a, b = tfhe.gate2(keys, name, *flat)
    return a.view(shape + (a.shape[-1],)), b.view(shape)


def cols(x, lo, hi):
    return x[0][:, lo:hi], x[1][:, lo:hi]


def set_cols(x, lo, hi, y):
    a, b = x[0].clone(), x[1].clone()
    a[:, lo:hi], b[:, lo:hi] = y
    return a, b
