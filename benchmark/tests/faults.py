"""Faults planted in the program under the harness, for the tests that see
``correct`` come out false: each replaces one function of
``nufhe_tpu_torch`` by a broken one, through ``setattr`` on its module."""

import torch

from nufhe_tpu_torch import api
from nufhe_tpu_torch.ops import bootstrap
from nufhe_tpu_torch.parallel import mesh


def unchanged_state():
    """The blind rotation returns its accumulator as it came."""
    return bootstrap, "blind_rotate", lambda accum_a, *a, **k: accum_a


def half_batch():
    """The bootstrap runs the first half of the batch; the second half
    gets the first half's answers."""
    real = bootstrap.bootstrap_device

    def broken(lwe_a, lwe_b, *args, **kwds):
        h = (lwe_b.shape[0] + 1) // 2
        outs = real(lwe_a[:h], lwe_b[:h], *args, **kwds)
        n = lwe_b.shape[0]
        return tuple(torch.cat([x, x])[:n] for x in outs)
    return bootstrap, "bootstrap_device", broken


def _flip_first(ct):
    """``ct`` with the answer of its first sample flipped: that sample
    negated, a valid encryption of the other bit."""
    a, b = ct.a.clone(), ct.b.clone()
    a.view(-1, a.shape[-1])[0] *= -1
    b.view(-1)[0] *= -1
    ct.a, ct.b = a, b
    return ct


def altered_answer():
    """Every request's answer altered where it is produced: the first
    sample of what a ``VirtualMachine`` gate or circuit returns, or of the
    gathered batch, flipped."""
    gate, uint, gather = api.VirtualMachine._gate, api.VirtualMachine._uint, \
        mesh.gather_ciphertext

    def patch():
        api.VirtualMachine._gate = lambda *a, **k: _flip_first(gate(*a, **k))
        api.VirtualMachine._uint = lambda *a, **k: _flip_first(uint(*a, **k))
        mesh.gather_ciphertext = lambda *a: _flip_first(gather(*a))
    return patch


def no_exchange():
    """The gather leaves out the exchange: each rank's shard, repeated."""
    def broken(ct, m):
        world = m.size()
        return type(ct)(ct.params, *(torch.cat([x] * world) for x in
                                     (ct.a, ct.b, ct.current_variances)))
    return mesh, "gather_ciphertext", broken


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer, "no_exchange": no_exchange}


def plant(name):
    fault = FAULTS[name]()
    if callable(fault):
        fault()
    else:
        module, attr, broken = fault
        setattr(module, attr, broken)
