"""Gate bootstrap in PyTorch: modulus switch, blind rotation, extraction,
keyswitch (``nufhe_tpu/ops/bootstrap.py``'s counterpart), in both engine
modes.  The key's form selects the blind rotation's engine:

- the rows engine (``BootstrapKey.device``: the int8 limb rows of
  ``ops/key_rows`` on CUDA, the int64 key of
  ``ops/transform.bootstrap_key_transformed`` on the CPU): with
  ``chunk_steps > 1``, ``n // chunk_steps`` launches of the chunked kernel
  K3 and, where the chunk does not divide n, one more of the
  ``n % chunk_steps`` steps left; with ``chunk_steps == 1``, n launches of
  the step kernel K1;
- the lanes engine (the (n, L, C, Q) int8 key of
  ``ops/tgsw.prepare_bootstrap_key_device``, the JAX package's
  ``flat_engine`` path, ``bootstrap.py:249-262``): the accumulator in
  q-layout and n launches of the lanes step K4; ``chunk_steps`` does not
  apply.

Tensor parallelism (the JAX package's ``axis_name``/``slot_axis_name``,
``bootstrap.py:124-173``) runs the lanes engine with each step split around
a collective (``ops/lanes_step.lanes_step_sharded``): ``group`` splits the
key's g-blocks over the process group (``mode='limbs'``), ``slot_group`` its
slots (``mode='slots'``).  The keyswitch stays local.

A bootstrap runs inside the span ``nufhe.bootstrap`` and, within it,
``nufhe.bootstrap.switch``, ``nufhe.blind_rotate`` and ``nufhe.extract``
(``utils/profiling.annotate``), each once and never a step.
"""

import torch

from . import blind_rotate as brc
from . import cmux
from . import flat_engine as fe
from . import key_rows as kr
from . import lanes_step as lanes
from . import lwe as dlwe
from . import tlwe as dtlwe
from ..ref.bootstrap_ref import blind_rotate_variance
from ..utils.profiling import annotate, spanned


def t32_to_phase(phase, mspace_size: int):
    """Modulus switch of int32 torus values to [0, mspace_size): the
    nearest multiple of 1/mspace_size, computed as uint32 in int64.
    Reference: ``nufhe/numeric_functions_gpu.py:39-77``."""
    interv = 2**32 // mspace_size
    half = interv // 2
    phase_u = phase.to(torch.int64) & 0xFFFFFFFF
    return (((phase_u + half) & 0xFFFFFFFF) // interv).to(torch.int32)


def round_phase_coarse(bara, bits: int, n_poly: int):
    """Coarse modulus switch: round [0, 2N) rotation amounts to multiples
    of 2^bits with a zero-mean tie rule (an exact tie goes the way of the
    next-higher phase bit), wrapping mod 2N.  The extra phase noise is
    tracked in ``blind_rotate_variance(coarse_phase_bits=bits)``.  The
    kernels rotate by direct index, so the rounding saves them nothing; it
    is kept so that the port computes the JAX package's function."""
    if not bits:
        return bara
    step = 1 << bits
    half = step >> 1
    rem = bara & (step - 1)
    up = (rem > half) | ((rem == half) & (((bara >> bits) & 1) == 1))
    out = bara - rem + torch.where(up, step, 0).to(bara.dtype)
    return (out & (2 * n_poly - 1)).to(torch.int32)


@spanned("nufhe.blind_rotate")
def blind_rotate(accum_a, bk_dev, bara, tgsw_params, chunk_steps=1,
                 exact=True, group=None, slot_group=None):
    """ACC <- BK_i (x) [(X^{bara_i}-1) ACC] + ACC over all n key bits.

    :param accum_a: (B, mask_size+1, N) int32.
    :param bk_dev: the rows engine's key in its device's form
        (``ops/key_rows.key_form``: on CUDA the int8 rows, (n, L, G, O, 6,
        64) when ``exact``, else (n, L, G, O, 4, 64); on the CPU the int64
        key, (n, G, O, L, R) or (n, 2, G, O, L, R)); or the lanes engine's
        (n, L, C, Q) int8 key (``ops/tgsw.prepare_bootstrap_key_device``).
    :param bara: (B, n) int32 in [0, 2N).
    :param chunk_steps: steps per K3 launch, the last launch taking the
        ``n % chunk_steps`` steps left if any; 1 runs one K1 launch a step.
        The lanes engine ignores it.
    :param group: limbs tensor parallelism: ``bk_dev`` is this rank's
        C-slice of whole g-blocks of the lanes key (n, L, C/size, Q), and each
        step's channels are summed over the process group.
    :param slot_group: slots tensor parallelism: ``bk_dev`` is this rank's
        slot slice (n, L/size, C, Q); each step's channels are gathered.
    """
    n = bara.shape[-1]
    lanes_key = bk_dev.dtype == torch.int8 and bk_dev.dim() == 4
    if group is not None and slot_group is not None:
        raise ValueError("group (limbs) and slot_group (slots) exclude each "
                         "other")
    tp_group, mode = (group, 'limbs') if slot_group is None \
        else (slot_group, 'slots')
    if tp_group is not None:
        if not lanes_key:
            raise ValueError("tensor parallelism (mode=%r) takes the lanes "
                             "engine's int8 key, not the rows key" % mode)
        return _blind_rotate_tp(accum_a, bk_dev, bara, tgsw_params, exact,
                                tp_group, mode)
    if lanes_key:
        rounded = lanes.check_key(bk_dev, (n,), "blind_rotate")
    else:
        rounded = kr.key_form(bk_dev, (n,), "blind_rotate",
                              accum_a.shape[-2])[0]
    if rounded == exact:
        raise ValueError("the key's form does not match the %s engine"
                         % ("exact" if exact else "rounded-key"))
    kw = dict(offset=int(tgsw_params.offset),
              log2_base=tgsw_params.bs_log2_base)
    bara_t = bara.t().contiguous()              # (n, B): one row per step
    if lanes_key:
        acc_q = fe.q_from_n(accum_a).reshape(accum_a.shape[0], -1).contiguous()
        acc_q = lanes.blind_rotate_lanes(acc_q, bk_dev, bara_t, **kw)
        return fe.n_from_q(acc_q.reshape(accum_a.shape))
    acc = accum_a.contiguous()
    chunk = int(chunk_steps)
    if chunk > 1:
        for start in range(0, n, chunk):
            acc = brc.blind_rotate_chunk(acc, bara_t, bk_dev, start,
                                         min(chunk, n - start), **kw)
    else:
        for i in range(n):
            acc = cmux.cmux_step(acc, bara_t[i], bk_dev[i], **kw)
    return acc


def _blind_rotate_tp(accum_a, bk_shard, bara, tgsw_params, exact, group,
                     mode):
    """The tensor-parallel blind rotation: n steps of
    ``lanes_step.lanes_step_sharded`` on this rank's key shard."""
    import torch.distributed as dist
    n = bara.shape[-1]
    shard, n_shards = dist.get_rank(group), dist.get_world_size(group)
    rounded = lanes.check_key(bk_shard, (n,), "blind_rotate", mode, n_shards)
    if rounded == exact:
        raise ValueError("the key's form does not match the %s engine"
                         % ("exact" if exact else "rounded-key"))
    bara_t = bara.t().contiguous()
    acc_q = fe.q_from_n(accum_a).reshape(accum_a.shape[0], -1).contiguous()
    for i in range(n):
        acc_q = lanes.lanes_step_sharded(
            acc_q, bara_t[i], bk_shard[i], shard=shard, n_shards=n_shards,
            mode=mode, group=group, offset=int(tgsw_params.offset),
            log2_base=tgsw_params.bs_log2_base)
    return fe.n_from_q(acc_q.reshape(accum_a.shape))


@spanned("nufhe.bootstrap")
def bootstrap_device(lwe_a, lwe_b, bk_dev, ks_arrays, ks_meta, mu,
                     tgsw_params, no_keyswitch=False, chunk_steps=1,
                     coarse_phase_bits=0, group=None, slot_group=None):
    """Full gate bootstrap: LWE(mu) if phase > 0 else LWE(-mu), fresh noise.
    Reference: ``nufhe/bootstrap.py:154-229``.  The engine mode comes from
    ``tgsw_params.tlwe_params.transform_type``, the engine (rows or lanes)
    from the key's form (:func:`blind_rotate`); ``group``/``slot_group``
    split the lanes engine's steps over a process group.

    :param lwe_a: (B, n_in) int32; ``lwe_b``: (B,) int32.
    :returns: (a, b, cv) in the keyswitched (or extracted) LWE space.
    """
    tlwe_params = tgsw_params.tlwe_params
    n_poly = tlwe_params.polynomial_degree
    mask_size = tlwe_params.mask_size
    exact = tlwe_params.transform_type != 'FFT'

    with annotate("nufhe.bootstrap.switch"):
        barb = t32_to_phase(lwe_b, 2 * n_poly)
        bara = t32_to_phase(lwe_a, 2 * n_poly)
        bara = round_phase_coarse(bara, coarse_phase_bits, n_poly)

        # testvector = X^{2N - barb} * (mu, ..., mu): for a constant vector
        # the shift is a sign pattern, +mu iff (k + barb) mod 2N < N
        k = torch.arange(n_poly, device=lwe_b.device)
        pos = (k + barb[..., None].to(torch.int64)) & (2 * n_poly - 1)
        mu_t = torch.tensor(int(mu), dtype=torch.int32, device=lwe_b.device)
        testvect = torch.where(pos < n_poly, mu_t, -mu_t)

        accum, _ = dtlwe.tlwe_noiseless_trivial(testvect, mask_size)
    accum = blind_rotate(accum, bk_dev, bara, tgsw_params,
                         chunk_steps=chunk_steps, exact=exact, group=group,
                         slot_group=slot_group)
    with annotate("nufhe.extract"):
        ex_a, ex_b = dtlwe.tlwe_extract_lwe_samples(accum)

        # fresh-noise estimate through the blind rotation (CGGI16 bound)
        var_br = blind_rotate_variance(tgsw_params, lwe_a.shape[-1],
                                       exact=exact,
                                       coarse_phase_bits=coarse_phase_bits)
        ex_cv = torch.full(ex_b.shape, var_br, dtype=torch.float32,
                           device=ex_b.device)
    if no_keyswitch:
        return ex_a, ex_b, ex_cv
    return dlwe.lwe_keyswitch(ks_arrays, ks_meta, ex_a, ex_b, source_cv=ex_cv)
