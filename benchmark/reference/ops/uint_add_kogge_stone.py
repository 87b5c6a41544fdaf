"""x + y mod 2^w by the Kogge-Stone adder, on the reference gates.

p = x XOR y, g = x AND y, then ceil(log2 w) levels of G' = P_hi ? G_lo :
G_hi (one MUX) and P' = P_hi AND P_lo (one AND, but on the last level),
and sum = p XOR carry: the gates of ``VirtualMachine.uint_add(...,
parallel=True)`` (``nufhe_tpu_torch/models/integer.py``'s description of
the circuit), so the same inputs give the same ciphertexts.
"""

from ..circuits import cols, gate, set_cols


def plain(x, y, w):
    return (x + y) % 2**w


def circuit(keys, x, y):
    w = x[1].shape[1]
    p0 = gate(keys, 'xor', x, y)
    big_g = gate(keys, 'and', x, y)
    big_p = p0
    d = 1
    while d < w:
        m = w - d
        tg = gate(keys, 'mux', cols(big_p, 0, m), cols(big_g, d, w),
                  cols(big_g, 0, m))
        if 2 * d < w:
            big_p = set_cols(big_p, 0, m, gate(
                keys, 'and', cols(big_p, 0, m), cols(big_p, d, w)))
        big_g = set_cols(big_g, 0, m, tg)
        d *= 2
    s = gate(keys, 'xor', cols(p0, 0, w - 1), cols(big_g, 1, w))
    return set_cols(p0, 0, w - 1, s)
