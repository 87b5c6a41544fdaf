#!/usr/bin/env python3
"""Drive nufhe_tpu_torch on one CUDA card and check every kernel it runs.

    python3 chip_smoke.py
    python3 chip_smoke.py --shapes [TREE]    # K3 at the kS = 2 shapes alone

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line; ``--shapes`` runs ``k3_shape_times`` alone,
on ``TREE``'s ``nufhe_tpu_torch`` where one is given, and prints one
``k3_shapes`` JSON line):

1. the card's name and power limit (``nvidia-smi``) and the versions of
   Python, PyTorch and CUDA;
2. build every kernel from ``nufhe_tpu_torch/kernels/csrc`` (one ``nvcc``
   per source, all at once) and print ``ptxas``'s register/spill lines;
3. each kernel against its plain PyTorch version on the card, bit for bit,
   at a small or ragged batch and at the gate paths' batch (4096): K1 (CMUX
   step, K3's template at a chunk of one step) with the exact and the
   rounded key, K2 (keyswitch, int8 tensor cores, on the JAX package's
   ``ab_limbs``, at base 4 and base 8; batch 100 leaves a partial sample
   tile), K3 (chunked rotation on the int8 tensor cores, 4 steps from step
   2, both key forms, batch 101 leaves a partial sample group) also
   against 4 K1 launches, and K4 (lanes-layout CMUX step on the TPU's int8
   key operand, MAC on the int8 tensor cores, both key forms, also at a
   batch of 100 that leaves a partial MAC tile) also as 4 steps against 4
   K1 launches on the same coefficient key; then K1, K3 and K4 at the
   non-default (mask1, l) = (3, 2) and (2, 3), both key forms, at batch 64
   and 101, each against its plain version, K3 against its chunk of K1
   launches and K4's steps against as many K1 launches; K3 and K1 (one MAC
   form, both digit limbs on the mma's N) in all three shapes and both key
   forms at batches 1, 3, 4, 5, 64, 65, 67, 128, 2^14 and 2^14 + 4, K3 at
   chunks 1, 7 and 50 (1 and 7 at the two large batches), against their
   plain versions on every row, with the MAC's ``mma.sync`` a slot and the
   share of their N columns that carry work (``mac_issue``), K3's clusters
   the card holds at once, and every launch at (3, 2) and (2, 3) counted
   as a pair of blocks (``paired_launches``), none at (2, 2); K5 (the exact
   step's stage parts, ``ops/step_parts``): every part against its plain
   version at batch 256 and 101, its FULL step also against K1; at the
   same batches K6 (``ops/step_context``, K3 with one stage of each step
   swapped for a stand-in): every variant in both key forms, 4 steps; K9
   (``ops/step_profile``, the rotation-family profile): every part in
   both forms, its FULL step also against K1; K8 (``ops/step_overlap``,
   the split-halves step) against its plain version and K1; K7
   (``ops/mac_dot``, the MAC dot alone) in its int8 and bf16 forms, at
   batch 101 and 256 and at 16388 (aligned, not a multiple of the 64-sample
   tile: the TMA path and a ragged tile), and at 256 with x at a 4-byte
   offset (the masked path at an aligned batch); at
   batch 101 and 256 K10 (``ops/step_schedules``, K1 in seven schedules)
   in both key forms against its plain version and K1, K11
   (``ops/step_tricks``) and K12 (``ops/rotate_forms``), K3 with a stage
   in another form, 3 steps in both forms against their plain versions
   and K3 (K11's t8 and t8+t9 on the evened powers), and K13
   (``ops/inverse_probe``, the inverse alone) every probe; then
   ``prepared_rows``: the row kernel (``ops/key_rows``, the key's int8
   limb rows that K1 and K3 copy) against its plain version byte for byte
   at (mask1, l) = (2, 2), (3, 2) and (2, 3), both key forms; K1 and K3
   on rows prepared once for the whole key, K3 from step 1 at chunks 1, 7
   and 50 and on an n = 630 key's tail of 30 steps at (2, 3), against the
   plain steps; the row kernel at the n = 500 and n = 630 keys' sizes
   against its plain version, timed beside its bound; ``rows_prepared``
   1 a key and CUDA device after ``BootstrapKey.device``, which holds the
   rows there and no int64 key (the card's allocated memory grows by the
   rows alone), none for the CPU, whose key is the int64 one, and 0 across
   the gates after it (NAND and MUX on K3, NAND on K1);
   ``ptxas``'s registers and spills of every K3 instantiation.  Every
   launch of K1, K3 and their variants in this script reads rows prepared
   once for its key;
4. keygen at the default parameters (n=500, N=1024): ``make_key_pair``
   with its default placement, on the card, and with ``on_device=False``,
   on the host, from one seed, each synchronised, the card's split by a
   step-by-step replay into host RNG draws, upload and work on the card;
   the tables (``bk_coeff``, ``ks_a``, ``ks_b``), the compact form and the
   containers equal bit for bit; then, in both engines ('FFT' keys built
   from each keygen's arrays), each key prepared on the card (the card-made
   key's transform and limb split there; the host-made key's on the host)
   and timed part by part: the rows key, the keyswitch ``ab_limbs`` and the
   lanes key of the card-made key equal the host path's, and its
   ``ab_limbs`` the numpy packing's; ``native_keygen``: the host C++
   transform and limb split (``nufhe_tpu_torch/native.py``) must load,
   and the host keygen's limbs, forward transform and rows key through it
   equal the numpy oracle's and the card-made key's, each timed beside
   numpy;
5. the gate paths at the default parameters, from the card-made keys, on
   4096 random inputs, through the entry points, each with the launch
   counts set to 0 just before the gate and read just after:
   - the default path, ``VirtualMachine(cloud)`` with no performance
     parameters: NAND through 10 K3 launches of 50 steps and 1 K2;
   - the same NAND with the rounded-key ('FFT') engine, its cloud key built
     from the same keygen arrays: 10 K3 and 1 K2;
   - MUX on the default path: one rotation over 8192 samples, 10 K3, 1 K2;
   - the per-step path, ``PerformanceParameters(chunk_steps=1)``: NAND
     through 500 K1 launches and 1 K2;
   - the lanes path, ``PerformanceParameters(single_kernel_bootstrap=
     False)``: NAND in both engines and MUX through 500 K4 launches and
     1 K2; each NAND equals the default path's NAND bit for bit;
   each decrypts to its truth table and prints its largest phase error;
   the two NANDs of the default path and of the lanes path also equal the
   same gate run on the CPU through the plain versions on 8 of the inputs,
   bit for bit; ``oracle``: 8 NAND inputs at n=500 on the default, the
   per-step and the lanes path, both modes, equal in a and b, bit for bit,
   to the numpy oracle ``ref/bootstrap_ref.bootstrap`` (which shares no
   code with the kernels' paths), cv within ``utils.errors_allclose``, and
   the default NAND with ``coarse_phase_bits=1`` (even rotation amounts)
   to ``bootstrap_ref.bootstrap(..., coarse_phase_bits=1)``; the
   oracle runs in a worker process started at the top of ``main`` (host
   keygen of the same seed, the encryptions, both modes) and is joined
   after phase 8, so that it overlaps the card phases;
   the host-made keys' NAND on the default and the lanes path, both
   engines, equals the card-made keys' bit for bit; keygen on the card
   with ``SecureRNG``: its NAND on 4096 inputs (10 K3 + 1 K2) decrypts to
   the truth table; then NAND at each of
   the JAX package's one-knob variants (``tlwe_mask_size=2``,
   ``bs_decomp_length=3``, ``ks_log2_base=3``), keys made on the card, in
   both engines, on the default path (2 K3 + 1 K2) and the lanes path (100
   K4 + 1 K2) at ``lwe_size=100`` (to keep the run short), each checked
   the same way; then the TFHE library's default 128-bit set (n=630,
   ``bs_decomp_length=3`` at ``bs_log2_base=7``): K3 at (2, 3) and base
   2^7 at batch 2^14, both key forms, a chunk of 50 and the tail of 30
   against the plain steps on 64 sampled rows, one launch and its steps
   each by the counters (``ops/blind_rotate.steps``), and its NAND on the
   4096 inputs, keys made on the card, both engines: 13 K3 launches of
   630 steps in all, each a pair of blocks, no K1, 1 K2;
6. containers: each cloud key (both engines) through ``dumps()`` and
   ``NuFHECloudKey.loads`` (format 4: the one-sided limbs only), with its
   bytes and its seconds of load and of each part of the key preparation
   on the card (the -v side, the rows key and the lanes key derived there;
   each equal to the host path's); the loaded key's NAND on the 4096
   inputs equals the original key's bit for bit on the default path (10
   K3 + 1 K2) and the lanes path (500 K4 + 1 K2); the ciphertext and
   secret-key round trips;
7. the integer circuits at the default parameters through
   ``VirtualMachine.uint_*``/``int_*`` on the default path: 16-bit
   ``uint_add`` (4096 integers ripple, 1024 Kogge-Stone, 4096 against a
   broadcast (1, 16) operand), ``uint_sub`` (1024, both forms),
   ``uint_lt``/``uint_eq``/``uint_min`` (4096), ``uint_min`` in 'FFT'
   (1024), ``int_add``/``int_gt``/``int_neg`` (1024), 8-bit ``uint_mul``
   (1024, ripple) and ``uint_divmod`` (256, some divisors 0); each
   decrypts to numpy's answer on every integer with its largest phase
   error inside the margin, and each 16-bit addition and subtraction has
   the K3 and K2 launches its circuit implies (10 K3 + 1 K2 a
   bootstrapped call: 3w calls ripple, ``kogge_stone_calls`` more);
8. the ripple / Kogge-Stone crossover: ``uint_add`` at batch {1, 16, 128,
   1024} x width {8, 16} through ``tools/adder_crossover_torch.sweep``,
   one synchronised host-clock time a form after a first call that must
   decrypt to numpy's sum, printed as one ``adder_crossover`` JSON line;
9. ``multi_device``: ``nufhe_tpu_torch.parallel`` in a world-1 NCCL
   process group (a FileStore in a temp dir, destroyed at the end), with
   the n=500 keys made on the card, each path with the launch counts set to
   0 just before it and read just after:
   - data parallel: the 4096-input NAND over ``shard_ciphertext`` on a
     (1, 1) mesh, through ``VirtualMachine.gate_nand`` and
     ``gather_ciphertext``: equal to the default NAND bit for bit, 10 K3 +
     1 K2;
   - tensor parallel: ``sharded_bootstrap_fn(force_tp=True)`` in
     ``mode='limbs'`` and ``'slots'``, both engines, on the NAND's linear
     part of the 4096 inputs: equal to the lanes NAND bit for bit, 500 K4
     launches, each split around a collective (500 collectives), 1 K2;
   - K4's MAC grid on each shard of a 2-way and a 4-way limbs split and
     slots split of a key row, both forms, batch 2^14: the shards' channels
     summed (mod 2^32) or stacked on the card, then grid 3, equal to the
     unsplit K4 step and to the plain version bit for bit;
   - ms/bit at 2^14 of the data-parallel NAND and of each tensor-parallel
     mode, both engines, and the share of the gate that its 500
     collectives take alone (CUDA events), as one ``multi_device`` JSON
     line;
10. timing at batch 2^14: warm ms/bit of the NAND in both engines on the
   default path, the per-step path and the lanes path, and of MUX; each
   kernel's ms per launch beside its plain version (whose output it
   equals there too), a PyTorch library call where one computes the same
   function, and its bound (K3's with its MAC's ``mma.sync`` a slot and
   the share of their N columns that carry work); K4's three grids timed
   apart; K3 at (2, 3) and (3, 2), 'NTT', a chunk of 50 at 2^14, ms a
   launch beside its bound (``k3_shape_times``);
11. ``step_parts``: ``tools/microbench_torch.py parts`` at 2^14 with the
   launch counts set to 0 just before it and read just after (K5's
   launches in the ``kernels`` line), then every part on the same inputs
   against its plain version, and each part's ms, plain ms and bound as
   one JSON line; ``microbench``: its
   ``rotation`` (100 K1 launches against K3 at chunks 10, 25 and 50, both
   engines, each equal to the per-step rotation) and ``keyswitch`` at
   2^14, as one JSON line; ``examples``: each ``examples/*_torch.py`` in a
   process of its own on the card, exit 0 and its OK line;
12. ``step_experiments``, at 2^14, each tool's run with the launch counts
   set to 0 just before it and read just after, one JSON line a tool with
   ms, plain ms, bound and the card: T3 (K6) in both engines, "FULL" at
   100 steps in one launch against two K3 launches of 50, every variant
   at 4 steps against its plain version, then ``tools/exp_round4_torch.py
   context`` (100 steps a launch; the in-loop cost of each stage); T2
   (K9) in both engines, every part against its plain version and the
   FULL step against K1, then ``exp_round4_torch.py profile``; T7 (K7)
   both forms on the tool's inputs against their plain versions, then
   ``tools/exp_int8_torch.py`` (chained calls, the library's products
   alone beside them); T9 (K8) against its plain version and K1, then
   ``tools/exp_overlap_torch.py`` (K1 serial, K8 split);
13. ``step_variants``, at 2^14 in both engines, the same way: T5 (K10)
   every schedule against K1 and "v3" against its plain version, then
   ``tools/exp_round3_torch.py``; T4 (K11) and T6 (K12) every variant at
   100 steps in one launch against one K3 launch of 100 steps (t8 and
   t8+t9 on the evened powers), the first variant at 4 steps against its
   plain version, then ``tools/exp_round4_torch.py tricks`` and
   ``tools/exp_round5_torch.py``; T8 (K13) every probe against its plain
   version, then ``tools/exp_inverse_torch.py``; each part's seconds;
14. ``bench_ports``: ``bench_torch.py``'s six cells
   (``tools/bench_cells_torch.py``: NAND 'FFT' and 'NTT', MUX in both, NAND
   'FFT' at batch 65536 and at ``NUFHE_TPU_COARSE_PHASE_BITS=1``) at RUNS 1,
   INNER 2, each a process of its own: each chain decrypts right, its
   measured device idle share lies in [0, 1] and a gate call launches 10
   K3 + 1 K2; then ``bench_scaling_torch.py --devices 1`` (one NCCL rank,
   500 K4 + 1 K2 a call, its output bit-equal to ``bootstrap_device``);
   one ``bench_ports`` JSON line;
15. a ``kernels`` JSON line (K3 at (2, 3) and (3, 2) as entries of their
   own after the kernels), then the ``nvidia-smi`` line, then the result
   line ``{"ok": true, "device": {...}}``.

The bound of a kernel is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its operations over the
card's peak rate for their type.  K1's, K3's and K4's MAC is int8 x int8
-> int32, which the data sheet rates at 1979e12 operations/s dense on the
tensor cores (K1's first design's 64-bit count is printed beside it).
K2's function is an int32 add a nonzero digit and column; the data sheet
states no rate for integer units outside the tensor cores, so it is
counted at 67e12/s, its float32 rate there, the highest it states for
such units (its tensor-core form's int8 operations are printed beside
it: they take longer).  A kernel's ``launches`` in the JSON line is its
count in the gate of the path that runs it (K1: the per-step path; K2
and K3: the default path; K4: the lanes path); K5's is its count on the
microbenchmark's path (``parts``), which is where it runs, and K6-K13's
theirs on their tools' paths ('NTT'; K7 both forms).  K6's, K11's and
K12's ms, plain ms and bound in that line are at 4 steps, the length at
which their plain versions run at 2^14 (K11's and K12's of their first
variant, t10 and t11); their 100-step times are in their own lines.
K10's are its "v3" schedule's (K1's code), K13's its "sliced" probe's
(K3's DIT).  K7's ms, plain ms, bound and library ms are its int8
form's; its ``forms`` key holds both forms' (and their tera-operations a
second); its library time is its products alone (64 ``torch._int_mm`` for
int8, one ``torch.bmm`` with a float32 result for bf16), a part of its
work.  The collectives between the grids of a tensor-parallel step are
counted apart (``lanes_step.collectives``).
"""

import json
import multiprocessing
import os
import re
import subprocess
import sys
import time
from fractions import Fraction

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
SEED = 2026
MAIN_BATCH = 4096
TIMING_BATCH = 1 << 14
N_LWE = 500                # n: the blind rotation's steps
CHUNK = 50                 # the default path's steps per K3 launch
KERNEL_NAMES = ("cmux_step", "keyswitch", "blind_rotate_chunk",
                "lanes_step", "step_parts", "step_context", "mac_dot",
                "step_overlap", "step_profile", "step_schedules",
                "step_tricks", "rotate_forms", "inverse_probe")
# K5-K13 run on the experiment tools' paths, not on a gate's
GATE_KERNELS = KERNEL_NAMES[:4]
# the kernels of the ``kernels`` line: the launched ones and the row
# kernel, which runs with key preparation (``rows_prepared``), never in a
# gate or a tool's timed launch
LINE_KERNELS = KERNEL_NAMES + ("key_rows",)
CONTEXT_STEPS = 100        # K6's timed rotation (tools/exp_round4.py:181)
CHECK_STEPS = 4            # K6's, K11's and K12's steps against their plain
                           # versions at 2^14
BF16_OPS_PER_S = 989e12
ORACLE_INPUTS = 8          # inputs of the n=500 bootstrap held to the oracle
COARSE_BITS = 1            # the coarse modulus switch held to the oracle
EXAMPLES = ("gate_nand_torch.py", "gate_nand_low_level_torch.py",
            "integer_adder_torch.py", "serialization_torch.py",
            "transform_modes_torch.py")
# the kernels' non-default (mask1, l): tlwe_mask_size=2, bs_decomp_length=3
VARIANT_SHAPES = ((3, 2), (2, 3))
# K3's and K1's batches against their plain versions in every shape and key
# form: one sample, ragged and whole blocks of 4 and 2 samples, small
# calls (at kS = 2, 65 and 67: an odd and an even count of blocks, each
# with a partial last block, so 65 rounds the pairs' grid up by a block of
# no sample), the gate's 2^14 and 2^14 + 4 (a ragged last block of 4
# samples)
K3_BATCHES = (1, 3, 4, 5, 64, 65, 67, 128, 1 << 14, (1 << 14) + 4)
K3_CHUNKS = (1, 7, 50)
# the chunks at the two large batches (50 steps of the plain version there
# take tens of seconds; the timing phase holds 2^14 x 50 at (2, 2))
K3_LARGE_CHUNKS = (1, 7)
# the gates at the JAX package's one-knob variant parameters run at this
# LWE size, to keep the run short
VARIANT_LWE = 100
VARIANTS = (dict(tlwe_mask_size=2), dict(bs_decomp_length=3),
            dict(ks_log2_base=3))
# the TFHE library's default 128-bit gate bootstrapping set
# (new_default_gate_bootstrapping_parameters; keyswitch 8 x 2 bits, N = 1024
# and k = 1 as the defaults): 12 chunks of 50 and a tail of 30
TFHE_LIB = dict(lwe_size=630, bs_decomp_length=3, bs_log2_base=7)
TFHE_ROWS = 64             # K3's sampled rows against the plain steps at 2^14
# K3 timed at its kS = 2 shapes beside the default one ('NTT', a chunk of
# CHUNK steps at 2^14): (2, 3) at the TFHE library's base 2^7, (3, 2) at
# tlwe_mask_size=2; each a ``blind_rotate_chunk (mask1, l)`` entry of the
# ``kernels`` line
K3_SHAPE_TIMES = (((2, 3), TFHE_LIB), ((3, 2), dict(tlwe_mask_size=2)))
INT_BATCH = 1024           # integers of the smaller integer circuits
DIV_BATCH = 256            # integers of the divider
CROSSOVER_BATCHES = (1, 16, 128, 1024)
CROSSOVER_WIDTHS = (8, 16)


def cuda_ms(fn, reps):
    """Mean ms per call of ``fn`` on the card, by CUDA events."""
    from nufhe_tpu_torch.utils.profiling import time_ms
    return time_ms(fn, reps)


def bound_ms(n_bytes, n_ops, ops_per_s=OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cmux_ops(batch):
    """Integer operations of one CMUX step on ``batch`` samples: two per
    64-bit multiply-add of the MAC, plus the transform adds."""
    macs = batch * 64 * 2 * 32 * 32 * 4
    transform_adds = batch * (4 + 2) * 6 * 32 * 32 * 2
    return 2 * macs + transform_adds


def mac_ops(batch, mode):
    """Operations of the int8 MAC of one CMUX step at the default shape:
    two per multiply-add, 64 slots x 256 inputs x Q outputs a sample (Q =
    320 exact, 256 rounded)."""
    q_size = (4 if mode == "FFT" else 5) * 2 * 32
    return 2 * batch * 64 * 256 * q_size


def max_abs_err(x, y):
    return int((x.to(torch.int64) - y.to(torch.int64)).abs().max().item())


def counters():
    from nufhe_tpu_torch.ops import (blind_rotate, cmux, inverse_probe,
                                     keyswitch, lanes_step, mac_dot,
                                     rotate_forms, step_context,
                                     step_overlap, step_parts, step_profile,
                                     step_schedules, step_tricks)
    return {"cmux_step": cmux, "keyswitch": keyswitch,
            "blind_rotate_chunk": blind_rotate, "lanes_step": lanes_step,
            "step_parts": step_parts, "step_context": step_context,
            "mac_dot": mac_dot, "step_overlap": step_overlap,
            "step_profile": step_profile, "step_schedules": step_schedules,
            "step_tricks": step_tricks, "rotate_forms": rotate_forms,
            "inverse_probe": inverse_probe}


def reset_counts():
    from nufhe_tpu_torch.ops import blind_rotate, cmux, key_rows, lanes_step
    for mod in counters().values():
        mod.launches = 0
    lanes_step.collectives = 0
    blind_rotate.steps = 0
    blind_rotate.paired_launches = cmux.paired_launches = 0
    key_rows.rows_prepared = 0


def read_counts():
    return {name: mod.launches for name, mod in counters().items()}


def random_bk(rng, rows, mask1, decomp_length):
    return rng.randint(-2**31, 2**31, (rows, mask1, decomp_length, mask1,
                                       1024)).astype(np.int32)


def random_key(rng, rows, tp, dev, transform_type, mask1=2):
    from nufhe_tpu_torch.ops import transform as tf
    return tf.bootstrap_key_transformed(
        random_bk(rng, rows, mask1, tp.decomp_length), dev, transform_type)


def int64_key(bk, dev):
    """The int64 key that ``BootstrapKey`` ``bk``'s rows are made from,
    made on ``dev`` by ``ops/transform`` from its compact form: the
    operand of the plain versions that the kernels are held against."""
    from nufhe_tpu_torch.ops import transform as tf
    pos, delta = bk.compact()
    return tf.rows_key_from_limbs(tf.two_sided_limbs_device(
        torch.as_tensor(pos).to(dev),
        None if delta is None else torch.as_tensor(delta).to(dev)), dev)


def rows_of(key, transform_type):
    """The int8 limb rows that K1 and K3 read for ``key`` (a key or one key
    row), prepared once by the row kernel (``ops/key_rows``)."""
    from nufhe_tpu_torch.ops import key_rows as kr
    return kr.key_rows(key, transform_type == "FFT")


def random_lanes_key(rng, rows, tp, dev, mode, mask1=2):
    """The lanes engine's int8 key (the port's ``build_mac_rhs``) and the
    rows engine's int64 key of one random coefficient key."""
    from nufhe_tpu_torch.ops import tgsw, transform as tf
    bk = random_bk(rng, rows, mask1, tp.decomp_length)
    return (tgsw.prepare_bootstrap_key_device(bk, dev, exact=mode == "NTT"),
            tf.bootstrap_key_transformed(bk, dev, mode))


def random_acc(rng, batch, dev, mask1=2):
    return torch.from_numpy(rng.randint(
        -2**31, 2**31, (batch, mask1, 1024)).astype(np.int32)).to(dev)


def random_powers(rng, shape, dev):
    return torch.from_numpy(rng.randint(0, 2048, shape).astype(np.int32)).to(dev)


def keyswitch_inputs(rng, batch, dev, log2_base=2, out=500):
    from nufhe_tpu_torch.ops import lwe as dlwe
    in_size, l, base = 1024, 8, 2**log2_base
    ks_a = rng.randint(-2**31, 2**31, (in_size, l, base, out)).astype(np.int32)
    ks_b = rng.randint(-2**31, 2**31, (in_size, l, base)).astype(np.int32)
    ks_a[:, :, 0] = 0
    ks_b[:, :, 0] = 0
    ks_cv = np.full((in_size, l, base), 3e-9, np.float32)
    arrays, meta = dlwe.prepare_keyswitch_device(ks_a, ks_b, ks_cv, log2_base,
                                                 dev)
    a = torch.from_numpy(
        rng.randint(-2**31, 2**31, (batch, in_size)).astype(np.int32)).to(dev)
    return a, arrays["ab_limbs"], meta


def record_err(results, name, label, err):
    print("%s: max_abs_err %d" % (label, err))
    if err:
        raise AssertionError("%s disagrees" % label)
    results[name]["max_abs_err"] = max(results[name].get("max_abs_err", 0), err)


def check_kernels(nft, dev, rng, results):
    from nufhe_tpu_torch.ops import blind_rotate as brc, cmux, keyswitch as ks
    tp = nft.NuFHEParameters().tgsw_params
    kw = dict(offset=int(tp.offset), log2_base=tp.bs_log2_base)
    for mode in ("NTT", "FFT"):
        for batch in (64, MAIN_BATCH):
            acc, p = random_acc(rng, batch, dev), random_powers(rng, (batch,), dev)
            key_row = random_key(rng, 1, tp, dev, mode)[0].contiguous()
            got = cmux.cmux_step(acc, p, rows_of(key_row, mode),
                                 **kw)
            want = cmux.cmux_step_plain(acc, p, key_row, **kw)
            torch.cuda.synchronize()
            record_err(results, "cmux_step", "K1 cmux_step %s vs plain, batch %d"
                       % (mode, batch), max_abs_err(got, want))
    for log2_base in (2, 3):            # base 4 (default) and base 8
        for batch in (100, MAIN_BATCH):     # 100: a partial sample tile
            a, ab_limbs, meta = keyswitch_inputs(rng, batch, dev, log2_base)
            kkw = dict(out_size=meta.output_size,
                       decomp_length=meta.decomp_length,
                       log2_base=meta.log2_base)
            got = ks.keyswitch_totals(a, ab_limbs, **kkw)
            want = ks.keyswitch_totals_plain(a, ab_limbs, **kkw)
            torch.cuda.synchronize()
            record_err(results, "keyswitch", "K2 keyswitch base %d vs plain, "
                       "batch %d" % (2**log2_base, batch),
                       max_abs_err(got, want))
    steps, start, chunk = 8, 2, 4
    for mode in ("NTT", "FFT"):
        key = random_key(rng, steps, tp, dev, mode)
        rows = rows_of(key, mode)
        for batch in (101, MAIN_BATCH):     # 101: a partial sample group
            acc = random_acc(rng, batch, dev)
            bara_t = random_powers(rng, (steps, batch), dev)
            got = brc.blind_rotate_chunk(acc, bara_t, rows, start, chunk, **kw)
            want = brc.blind_rotate_chunk_plain(acc, bara_t, key, start, chunk,
                                                **kw)
            by_k1 = acc
            for i in range(start, start + chunk):
                by_k1 = cmux.cmux_step(by_k1, bara_t[i], rows[i],
                                       **kw)
            torch.cuda.synchronize()
            record_err(results, "blind_rotate_chunk",
                       "K3 blind_rotate_chunk %s vs plain, batch %d, steps "
                       "[%d, %d)" % (mode, batch, start, start + chunk),
                       max_abs_err(got, want))
            record_err(results, "blind_rotate_chunk",
                       "K3 blind_rotate_chunk %s vs %d K1 launches, batch %d"
                       % (mode, chunk, batch), max_abs_err(got, by_k1))
    check_k4(dev, rng, results, tp, kw)
    for mask1, decomp_length in VARIANT_SHAPES:
        check_variant_shape(nft, dev, rng, results, mask1, decomp_length)
    check_k3_batches(nft, dev, rng, results)


def k3_ptxas(name="blind_rotate_chunk"):
    """``ptxas``'s registers and spill bytes of each kernel function in the
    build log of ``name``: {function: (registers, spill stores, spill
    loads)}."""
    from nufhe_tpu_torch.kernels import build
    out, fn = {}, None
    for line in build.build_log(name).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out.setdefault(fn, [0, 0, 0])[1:] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.setdefault(fn, [0, 0, 0])[0] = int(m.group(1))
    return {fn: tuple(v) for fn, v in out.items()}


def prepared_rows(nft, dev, rng, results):
    """K1 and K3 on the key rows prepared once with the key: the row kernel
    against its plain version, K1 and K3 against the plain steps on rows
    prepared for the whole key, ``rows_prepared`` across key preparation
    and gates, and K3's ``ptxas`` lines."""
    from nufhe_tpu_torch.ops import blind_rotate as brc, cmux
    from nufhe_tpu_torch.ops import key_rows as kr
    t0 = time.time()
    for mask1, decomp_length in ((2, 2),) + VARIANT_SHAPES:
        tp = nft.NuFHEParameters(tlwe_mask_size=mask1 - 1,
                                 bs_decomp_length=decomp_length).tgsw_params
        kw = dict(offset=int(tp.offset), log2_base=tp.bs_log2_base)
        shape = "(mask1, l) = (%d, %d)" % (mask1, decomp_length)
        steps, start = max(K3_CHUNKS) + 1, 1
        for mode in ("NTT", "FFT"):
            rounded = mode == "FFT"
            key = random_key(rng, steps, tp, dev, mode, mask1)
            kr.rows_prepared = 0
            rows = kr.key_rows(key, rounded)
            torch.cuda.synchronize()
            if kr.rows_prepared != 1:
                raise AssertionError("the row kernel: %d preparations"
                                     % kr.rows_prepared)
            record_err(results, "key_rows", "row kernel %s %s vs "
                       "plain, %d steps" % (shape, mode, steps),
                       max_abs_err(rows, kr.key_rows_plain(key, rounded)))
            for batch in (1, 130):
                acc = random_acc(rng, batch, dev, mask1)
                bara_t = random_powers(rng, (steps, batch), dev)
                got = cmux.cmux_step(acc, bara_t[start], rows[start], **kw)
                want = cmux.cmux_step_plain(acc, bara_t[start], key[start],
                                            **kw)
                record_err(results, "cmux_step", "K1 %s %s on prepared rows "
                           "vs plain, batch %d" % (shape, mode, batch),
                           max_abs_err(got, want))
                for chunk in K3_CHUNKS:
                    got = brc.blind_rotate_chunk(acc, bara_t, rows, start,
                                                 chunk, **kw)
                    want = brc.blind_rotate_chunk_plain(acc, bara_t, key,
                                                        start, chunk, **kw)
                    record_err(results, "blind_rotate_chunk", "K3 %s %s on "
                               "prepared rows vs plain, batch %d, steps "
                               "[%d, %d)" % (shape, mode, batch, start,
                                             start + chunk),
                               max_abs_err(got, want))
            if kr.rows_prepared != 1:
                raise AssertionError("K1/K3 on given rows prepared rows")
            del key, rows

    # the n = 630 key's tail: rows prepared for all 630 steps, K3 from 600
    tp = nft.NuFHEParameters(**TFHE_LIB).tgsw_params
    kw = dict(offset=int(tp.offset), log2_base=tp.bs_log2_base)
    n, start = TFHE_LIB["lwe_size"], TFHE_LIB["lwe_size"] // CHUNK * CHUNK
    for mode in ("NTT", "FFT"):
        key = random_key(rng, n, tp, dev, mode)
        rows = kr.key_rows(key, mode == "FFT")
        acc = random_acc(rng, 64, dev)
        bara_t = random_powers(rng, (n, 64), dev)
        got = brc.blind_rotate_chunk(acc, bara_t, rows, start, n - start, **kw)
        want = brc.blind_rotate_chunk_plain(acc, bara_t, key, start,
                                            n - start, **kw)
        record_err(results, "blind_rotate_chunk", "K3 (2, 3) %s on prepared "
                   "rows vs plain, n = %d, the tail [%d, %d)"
                   % (mode, n, start, n), max_abs_err(got, want))
        del key, rows

    # the row kernel at the gate keys' sizes against its plain version,
    # timed beside its bound (the int64 key read and the rows written once)
    for (mask1, decomp_length), n in (((2, 2), N_LWE),
                                      ((2, 3), TFHE_LIB["lwe_size"])):
        tp = nft.NuFHEParameters(tlwe_mask_size=mask1 - 1,
                                 bs_decomp_length=decomp_length).tgsw_params
        for mode in ("NTT", "FFT"):
            rounded = mode == "FFT"
            key = random_key(rng, n, tp, dev, mode, mask1)
            rows = kr.key_rows(key, rounded)
            ms = cuda_ms(lambda: kr.key_rows(key, rounded), 10)
            want, plain = timed_plain(lambda: kr.key_rows_plain(key, rounded))
            record_err(results, "key_rows", "row kernel (%d, %d) %s vs plain, "
                       "n = %d" % (mask1, decomp_length, mode, n),
                       max_abs_err(rows, want))
            n_bytes = key.numel() * key.element_size() + rows.numel()
            bound, by = bound_ms(n_bytes, 0)
            print("row kernel (%d, %d) %s, n = %d: %.4f ms (bound %.4f ms by "
                  "%s, %d B; plain %.2f ms), rows %d B a step"
                  % (mask1, decomp_length, mode, n, ms, bound, by, n_bytes,
                     plain, rows[0].numel()))
            if (mask1, decomp_length, mode) == (2, 2, "NTT"):
                results["key_rows"].update(ms=ms, plain_ms=plain,
                                           bound_ms=bound, bound_by=by,
                                           library_ms=None)
            del key, rows, want

    # one preparation a key and device, none in the gates
    inputs = [random_powers(rng, (MAIN_BATCH,), "cpu").numpy() & 1
              for _ in range(3)]
    for mode in ("NTT", "FFT"):
        secret, cloud = nft.make_key_pair(nft.DeterministicRNG(SEED),
                                          transform_type=mode)
        bk = cloud.bootstrap_key
        bk.compact()                    # the card-made key's limbs, kept
        torch.cuda.synchronize()
        kr.rows_prepared = 0
        before = torch.cuda.memory_allocated(dev)
        rows = bk.device(dev)
        held = torch.cuda.memory_allocated(dev) - before
        cpu_key = bk.device("cpu")      # the int64 key off CUDA
        counted = {"key": kr.rows_prepared, "held_bytes": held}
        if bk.device(dev) is not rows or rows.dtype != torch.int8 \
                or cpu_key.dtype != torch.int64 \
                or held > rows.numel() + (1 << 20):
            raise AssertionError("the key on the card: %s %s, %d bytes held "
                                 "for %d bytes of rows" % (
                                     rows.dtype, tuple(rows.shape), held,
                                     rows.numel()))
        bits = [b.astype(bool) for b in inputs]
        cts = [nft.encrypt(nft.DeterministicRNG(SEED + 1), secret, b,
                           device=dev) for b in bits]
        for label, perf in (("chunk 50", None), ("chunk 1", dict(
                chunk_steps=1))):
            vm = nft.VirtualMachine(cloud, device=dev, perf_params=None
                                    if perf is None else
                                    nft.PerformanceParameters(
                                        cloud.params, **perf))
            torch.cuda.synchronize()
            reset_counts()
            nand = vm.gate_nand(cts[0], cts[1])
            mux = vm.gate_mux(cts[0], cts[1], cts[2])
            torch.cuda.synchronize()
            counted[label] = dict(rows_prepared=kr.rows_prepared,
                                  k1=read_counts()["cmux_step"],
                                  k3=read_counts()["blind_rotate_chunk"])
            n = cloud.params.in_out_params.size
            expect = dict(rows_prepared=0, k1=0, k3=2 * n // CHUNK) \
                if perf is None else dict(rows_prepared=0, k1=2 * n, k3=0)
            if counted[label] != expect or not np.array_equal(
                    nft.decrypt(secret, nand), ~(bits[0] & bits[1])) \
                    or not np.array_equal(nft.decrypt(secret, mux),
                                          np.where(bits[0], bits[1], bits[2])):
                raise AssertionError("gates on prepared rows (%s %s): %s"
                                     % (mode, label, counted))
        print("rows_prepared %s: %s" % (mode, json.dumps(counted)))
        if counted["key"] != 1:
            raise AssertionError("rows_prepared %s: one a key and CUDA "
                                 "device expected, got %d" % (mode,
                                                             counted["key"]))
        if mode == "NTT":
            results["key_rows"]["launches"] = counted["key"]
        del secret, cloud, bk, cts, rows, cpu_key
    for fn, (regs, stores, loads) in sorted(k3_ptxas().items()):
        print("K3 ptxas %s: %d registers, spill stores %d, loads %d bytes"
              % (fn, regs, stores, loads))
    print("prepared_rows phase: %.1f s" % (time.time() - t0))


def block_samples(mask1, decomp_length):
    """kS, the samples a block of K1 and K3 holds, read from the one place
    the port sets it (``Shape::kS`` in ``blind_rotate_body.cuh``)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "nufhe_tpu_torch", "kernels", "csrc",
                        "blind_rotate_body.cuh")
    with open(path) as f:
        m = re.search(r"int kS = \(M == (\d+) && D == (\d+)\) \? (\d+) : (\d+);",
                      f.read())
    if m is None:
        raise RuntimeError("no Shape::kS of the form (M == a && D == b) ? x "
                           ": y in " + path)
    a, b, x, y = map(int, m.groups())
    return x if (mask1, decomp_length) == (a, b) else y


def pair_blocks(mask1, decomp_length):
    """Blocks a cluster of K1 and K3 (``Shape::kPair`` in
    ``blind_rotate_body.cuh``, which pairs the blocks of kS = 2 samples),
    read from the source as :func:`block_samples` reads kS; on the card
    the launcher's own answer is ``cmux.cluster_size``."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "nufhe_tpu_torch", "kernels", "csrc",
                        "blind_rotate_body.cuh")
    with open(path) as f:
        m = re.search(r"int kPair = kS == (\d+) \? (\d+) : 1;", f.read())
    if m is None:
        raise RuntimeError("no Shape::kPair of the form kS == a ? b : 1 in "
                           + path)
    k_s, pair = map(int, m.groups())
    return pair if block_samples(mask1, decomp_length) == k_s else 1


def mac_issue(mask1, decomp_length, rounded):
    """How K1's and K3's MAC (``mac_slot``) issues on the tensor cores: the
    ``mma.sync`` m16n8k32 of one slot and the share of their N columns that
    carry work.  Both int8 limbs of the kS digit samples of the block, or
    of the cluster's pair of blocks (:func:`pair_blocks`), lie on the
    mma's N (2kS of its 8 columns, or 4kS), and each key limb row (6
    exact: vlo, vhi_0..3, 4*vlo; 4 rounded) feeds one mma a digit
    polynomial, output polynomial and M tile; a row's product with a digit
    limb carries work where ``ops/transform._mac_limb_table`` pairs them.

    :returns: (``mma.sync`` a slot, :class:`fractions.Fraction` of the
        columns that carry work).
    """
    from nufhe_tpu_torch.ops import transform as tf
    if (mask1, decomp_length) not in tf.KERNEL_SHAPES:
        raise ValueError("K3 takes (mask1, l) in %s, not (%d, %d)"
                         % (tf.KERNEL_SHAPES, mask1, decomp_length))
    key_limbs = tf.KEY_LIMBS_APPROX if rounded else tf.KEY_LIMBS
    rows = key_limbs if rounded else key_limbs + 1       # exact: and 4*vlo
    # the table's pairs that meet a key limb, not its zero (index key_limbs)
    pairs = int((tf._mac_limb_table(not rounded) != key_limbs).sum())
    mma = 2 * mask1 * (mask1 * decomp_length) * rows
    on_n = block_samples(mask1, decomp_length) * pair_blocks(mask1,
                                                            decomp_length)
    return mma, Fraction(pairs * on_n, rows * 8)


def check_k3_batches(nft, dev, rng, results):
    """K3 and K1, whose MAC has one form (both digit limbs on the mma's N,
    :func:`mac_issue`), against their plain versions in every
    kernel shape and both key forms, on every row: K1 at each of
    ``K3_BATCHES``, K3 at each of those batches and chunks
    (``K3_LARGE_CHUNKS`` above 128), from step 1 of a random key.  Every
    launch at a kS = 2 shape runs as a pair of blocks (``paired_launches``
    equal to the launches, and ``cmux.cluster_size`` 2), none at (2, 2);
    the clusters of K3 the card holds at once
    (``cudaOccupancyMaxActiveClusters``) are printed for each shape."""
    from nufhe_tpu_torch.ops import blind_rotate as brc, cmux
    steps, start = max(K3_CHUNKS) + 1, 1
    for mask1, decomp_length in ((2, 2),) + VARIANT_SHAPES:
        tp = nft.NuFHEParameters(tlwe_mask_size=mask1 - 1,
                                 bs_decomp_length=decomp_length).tgsw_params
        kw = dict(offset=int(tp.offset), log2_base=tp.bs_log2_base)
        shape = "(mask1, l) = (%d, %d)" % (mask1, decomp_length)
        torch.cuda.synchronize()
        reset_counts()
        for mode in ("NTT", "FFT"):
            key = random_key(rng, steps, tp, dev, mode, mask1)
            rows = rows_of(key, mode)
            for batch in K3_BATCHES:
                acc = random_acc(rng, batch, dev, mask1)
                bara_t = random_powers(rng, (steps, batch), dev)
                got = cmux.cmux_step(acc, bara_t[start], rows[start], **kw)
                want = cmux.cmux_step_plain(acc, bara_t[start], key[start],
                                            **kw)
                torch.cuda.synchronize()
                record_err(results, "cmux_step", "K1 %s %s vs plain, batch %d"
                           % (shape, mode, batch), max_abs_err(got, want))
                for chunk in K3_CHUNKS if batch <= 128 else K3_LARGE_CHUNKS:
                    got = brc.blind_rotate_chunk(acc, bara_t, rows, start,
                                                 chunk, **kw)
                    want = brc.blind_rotate_chunk_plain(acc, bara_t, key,
                                                        start, chunk, **kw)
                    torch.cuda.synchronize()
                    record_err(results, "blind_rotate_chunk", "K3 %s %s vs "
                               "plain, batch %d, chunk %d"
                               % (shape, mode, batch, chunk),
                               max_abs_err(got, want))
                del acc, bara_t, got, want
            mma, share = mac_issue(mask1, decomp_length, mode == "FFT")
            print("K1/K3 %s %s MAC: %d mma.sync a slot, %s of their N "
                  "columns carry work; %d clusters of %d blocks at once"
                  % (shape, mode, mma, share,
                     k3_clusters(mask1, decomp_length, mode == "FFT", dev),
                     cmux.cluster_size("blind_rotate_chunk", mask1,
                                       decomp_length)))
        pair = cmux.cluster_size("blind_rotate_chunk", mask1, decomp_length)
        counted = dict(k1=cmux.launches, k1_paired=cmux.paired_launches,
                       k3=brc.launches, k3_paired=brc.paired_launches)
        print("K1/K3 %s launches: %s" % (shape, json.dumps(counted)))
        if pair != pair_blocks(mask1, decomp_length) \
                or cmux.cluster_size("cmux_step", mask1, decomp_length) \
                != pair or not counted["k1"] or not counted["k3"] \
                or counted["k1_paired"] != (counted["k1"] if pair > 1 else 0) \
                or counted["k3_paired"] != (counted["k3"] if pair > 1 else 0):
            raise AssertionError("K1/K3 %s: clusters of %d blocks, launches %s"
                                 % (shape, pair, counted))


def k3_clusters(mask1, decomp_length, rounded, dev):
    """The clusters of K3 at (mask1, l) that the card holds at once
    (``cudaOccupancyMaxActiveClusters``, through the kernel's library)."""
    import ctypes
    from nufhe_tpu_torch.kernels import build
    fn = build.function("blind_rotate_chunk", "blind_rotate_chunk_clusters",
                        [ctypes.c_int] * 4 + [ctypes.c_void_p])
    out = ctypes.c_int(0)
    build.check("blind_rotate_chunk_clusters",
                fn(mask1, decomp_length, int(rounded), dev.index or 0,
                   ctypes.addressof(out)))
    return out.value


def check_variant_shape(nft, dev, rng, results, mask1, decomp_length):
    """K1, K3 and K4 at a non-default (mask1, l), both key forms, each
    against its plain version at batch 64 and 101 (a ragged block and MAC
    tile); K3 also against its chunk of K1 launches, K4 also as its steps
    against as many K1 launches on the same coefficient key."""
    from nufhe_tpu_torch.ops import blind_rotate as brc, cmux
    from nufhe_tpu_torch.ops import flat_engine as fe, lanes_step as k4
    tp = nft.NuFHEParameters(tlwe_mask_size=mask1 - 1,
                             bs_decomp_length=decomp_length).tgsw_params
    kw = dict(offset=int(tp.offset), log2_base=tp.bs_log2_base)
    shape = "(mask1, l) = (%d, %d)" % (mask1, decomp_length)
    steps, start, chunk = 6, 1, 4
    for mode in ("NTT", "FFT"):
        lanes_key, key = random_lanes_key(rng, steps, tp, dev, mode, mask1)
        rows = rows_of(key, mode)
        for batch in (64, 101):
            acc = random_acc(rng, batch, dev, mask1)
            bara_t = random_powers(rng, (steps, batch), dev)
            got = cmux.cmux_step(acc, bara_t[0], rows[0], **kw)
            want = cmux.cmux_step_plain(acc, bara_t[0], key[0], **kw)
            torch.cuda.synchronize()
            record_err(results, "cmux_step", "K1 %s %s vs plain, batch %d"
                       % (shape, mode, batch), max_abs_err(got, want))
            got = brc.blind_rotate_chunk(acc, bara_t, rows, start, chunk, **kw)
            want = brc.blind_rotate_chunk_plain(acc, bara_t, key, start, chunk,
                                                **kw)
            by_k1 = acc
            for i in range(start, start + chunk):
                by_k1 = cmux.cmux_step(by_k1, bara_t[i], rows[i],
                                       **kw)
            torch.cuda.synchronize()
            record_err(results, "blind_rotate_chunk", "K3 %s %s vs plain, "
                       "batch %d, steps [%d, %d)" % (shape, mode, batch, start,
                                                     start + chunk),
                       max_abs_err(got, want))
            record_err(results, "blind_rotate_chunk", "K3 %s %s vs %d K1 "
                       "launches, batch %d" % (shape, mode, chunk, batch),
                       max_abs_err(got, by_k1))
            acc_q = fe.q_from_n(acc).reshape(batch, -1).contiguous()
            got = k4.lanes_step(acc_q, bara_t[0], lanes_key[0], **kw)
            want = k4.lanes_step_plain(acc_q, bara_t[0], lanes_key[0], **kw)
            torch.cuda.synchronize()
            record_err(results, "lanes_step", "K4 %s %s vs plain, batch %d"
                       % (shape, mode, batch), max_abs_err(got, want))
            by_k4 = k4.blind_rotate_lanes(acc_q, lanes_key[start:start + chunk],
                                          bara_t[start:start + chunk], **kw)
            torch.cuda.synchronize()
            record_err(results, "lanes_step", "K4 %s %s: %d launches vs %d K1 "
                       "launches, batch %d" % (shape, mode, chunk, chunk, batch),
                       max_abs_err(fe.n_from_q(by_k4.reshape(acc.shape)),
                                   by_k1))


def check_k4(dev, rng, results, tp, kw):
    from nufhe_tpu_torch.ops import cmux, flat_engine as fe, lanes_step as k4
    steps = 4
    for mode in ("NTT", "FFT"):
        lanes_key, rows_key = random_lanes_key(rng, steps, tp, dev, mode)
        rows = rows_of(rows_key, mode)
        for batch in (64, 100, MAIN_BATCH):     # 100: a ragged MAC tile
            acc = random_acc(rng, batch, dev)
            acc_q = fe.q_from_n(acc).reshape(batch, -1).contiguous()
            p = random_powers(rng, (batch,), dev)
            got = k4.lanes_step(acc_q, p, lanes_key[0], **kw)
            want = k4.lanes_step_plain(acc_q, p, lanes_key[0], **kw)
            torch.cuda.synchronize()
            record_err(results, "lanes_step", "K4 lanes_step %s vs plain, "
                       "batch %d" % (mode, batch), max_abs_err(got, want))
        bara_t = random_powers(rng, (steps, MAIN_BATCH), dev)
        by_k4 = k4.blind_rotate_lanes(
            fe.q_from_n(acc).reshape(MAIN_BATCH, -1).contiguous(), lanes_key,
            bara_t, **kw)
        by_k1 = acc
        for i in range(steps):
            by_k1 = cmux.cmux_step(by_k1, bara_t[i], rows[i], **kw)
        torch.cuda.synchronize()
        record_err(results, "lanes_step", "K4 %s: %d launches vs %d K1 "
                   "launches on the same coefficient key, batch %d"
                   % (mode, steps, steps, MAIN_BATCH),
                   max_abs_err(fe.n_from_q(by_k4.reshape(acc.shape)), by_k1))


def phase_error_frac(nft, secret, out, want):
    """Largest distance of the phase from +-1/8, as a fraction of the 1/16
    decryption margin."""
    phase = nft.decrypt_phase(secret, out).astype(np.int64)
    mu = 2**29   # 1/8 of the torus
    err = (phase - np.where(want, mu, -mu) + 2**31) % 2**32 - 2**31
    return float(np.abs(err).max()) / 2**32 / (1 / 16)


def run_gate(nft, label, secret, vm, gate, args, want, expect):
    """One gate through the entry points with the launch counts set to 0
    just before it and read just after; checks counts, shape, cv and the
    truth table.  Returns the output and the counts."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    out = getattr(vm, gate)(*args)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    counts = read_counts()
    print("%s: %s on %d inputs in %.3f s (first call), launches %s"
          % (label, gate, len(want), elapsed, json.dumps(counts)))
    if counts != expect:
        raise AssertionError("%s: expected launches %s" % (label, expect))
    n_lwe = vm.params.in_out_params.size
    if not (np.isfinite(out.current_variances.cpu().numpy()).all()
            and tuple(out.a.shape) == (len(want), n_lwe)):
        raise AssertionError("%s: unexpected output shape or non-finite cv"
                             % label)
    got = nft.decrypt(secret, out)
    if not np.array_equal(got, want):
        raise AssertionError("%s decrypts wrong on %d of %d bits"
                             % (label, int((got != want).sum()), len(want)))
    frac = phase_error_frac(nft, secret, out, want)
    print("%s decrypts to the truth table on all %d bits; largest phase "
          "error %.6f of the 1/16 margin" % (label, len(want), frac))
    if not frac < 1:
        raise AssertionError("%s: phase error beyond the margin" % label)
    return out, counts


def same_on_cpu(nft, label, cloud, gate, args, out, perf=None):
    """The same gate on 8 of the inputs on the CPU, through the plain
    versions, equals the card's output bit for bit."""
    vm_cpu = nft.VirtualMachine(cloud, perf, device="cpu")
    t0 = time.time()
    sub = [nft.LweSampleArray(c.params, c.a[:8].cpu(), c.b[:8].cpu(),
                              c.current_variances[:8].cpu()) for c in args]
    ref = getattr(vm_cpu, gate)(*sub)
    same = (torch.equal(ref.a, out.a[:8].cpu())
            and torch.equal(ref.b, out.b[:8].cpu()))
    print("%s: card output vs plain CPU gate on 8 inputs: %s (%.1f s)"
          % (label, "bit-equal" if same else "DIFFERENT", time.time() - t0))
    if not same:
        raise AssertionError("%s: card output differs from the plain CPU gate"
                             % label)


def fft_cloud(nft, cloud, **params):
    """The rounded-key ('FFT') cloud key from the same keygen arrays (the
    card's tensors for a card-made key, numpy for a host-made one)."""
    bk, ks = cloud.bootstrap_key, cloud.keyswitch_key
    return nft.cloud_key_from_arrays(
        nft.NuFHEParameters(transform_type='FFT', **params),
        bk.bk_coeff, bk.cv,
        ks.ks_a, ks.ks_b, ks.ks_cv, ks.log2_base)


def cpu_lanes_cloud(nft, cloud, dev):
    """A cloud key for the CPU that carries the card's lanes key across as
    a prepared array (``cloud_key_from_arrays(..., mac_rhs=...)``)."""
    bk, ks = cloud.bootstrap_key, cloud.keyswitch_key
    return nft.cloud_key_from_arrays(
        cloud.params, bk.bk_coeff, bk.cv, ks.ks_a, ks.ks_b, ks.ks_cv,
        ks.log2_base, mac_rhs=bk.mac_rhs(dev).cpu().numpy())


def synced(fn):
    """``fn()`` and its seconds, the card synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def card_keygen_phases(nft, dev, params):
    """The card keygen of ``make_key_pair(DeterministicRNG(SEED))`` replayed
    step by step through ``ops/keygen``, each step synchronised: the host
    RNG draws in the reference's order, the key matrix built on the host,
    the one upload of each array, then the work on the card.  Returns
    ``(seconds by phase, bk_coeff, ks_a, ks_b)``."""
    from nufhe_tpu_torch import rng as nrng
    from nufhe_tpu_torch.ops import keygen
    tp = params.tgsw_params
    mask_size = tp.tlwe_params.mask_size
    n = params.in_out_params.size
    base = 2 ** params.ks_log2_base
    in_size = mask_size * 1024
    rng = nft.DeterministicRNG(SEED)
    shape = (n, mask_size + 1, tp.decomp_length)
    t0 = time.time()
    lwe_key = nrng.rand_uniform_bool(rng, (n,))
    tlwe_key = nrng.rand_uniform_bool(rng, (mask_size, 1024))
    noises1 = nrng.rand_uniform_torus32(rng, shape + (mask_size, 1024))
    noises2 = nrng.rand_gaussian_torus32(rng, 0, tp.tlwe_params.min_noise,
                                         shape + (1024,))
    noises_b = nrng.rand_gaussian_torus32(
        rng, 0, params.in_out_params.min_noise,
        (in_size, params.ks_decomp_length, base - 1), centered=True)
    noises_a = nrng.rand_uniform_torus32(
        rng, (in_size, params.ks_decomp_length, base - 1, n))
    t_rng = time.time() - t0
    w, t_matrix = synced(lambda: keygen.negacyclic_key_matrix(tlwe_key))
    host = (w, lwe_key, noises1, noises2, tlwe_key.reshape(-1), noises_a,
            noises_b)
    up, t_up = synced(lambda: [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                               for x in host])
    (bk, (ks_a, ks_b)), t_dev = synced(lambda: (
        keygen.bootstrap_key_device(up[0], up[1], up[2], up[3],
                                    tp.base_powers),
        keygen.make_keyswitch_key_device(up[4], up[1], up[5], up[6],
                                         params.ks_decomp_length,
                                         params.ks_log2_base)))
    seconds = dict(rng=t_rng, key_matrix=t_matrix, upload=t_up, device=t_dev,
                   upload_mb=sum(x.nbytes for x in host) / 1e6)
    return seconds, bk, ks_a, ks_b


def check_equal(label, got, want):
    """Bit-for-bit equality of two tensors or arrays, printed; raises."""
    if torch.is_tensor(got):
        got = got.cpu().numpy()
    if torch.is_tensor(want):
        want = want.cpu().numpy()
    same = got.shape == want.shape and np.array_equal(got, want)
    print("%s: %s" % (label, "bit-equal" if same else "DIFFERENT"))
    if not same:
        raise AssertionError("%s differs" % label)


def prepare_timed(key, dev):
    """Both engines' keys and the keyswitch operand of ``key`` on ``dev``,
    each synchronised: returns ({part: tensor}, {part: seconds}).  A card-
    made key's transform and limb split (``compact()``) is timed apart."""
    bk, ks = key.bootstrap_key, key.keyswitch_key
    seconds = {}
    if torch.is_tensor(bk.bk_coeff):
        _, seconds["transform"] = synced(bk.compact)
    out = {}
    out["rows"], seconds["rows"] = synced(lambda: bk.device(dev))
    out["ab_limbs"], seconds["ab_limbs"] = synced(
        lambda: ks.device(dev)[0]["ab_limbs"])
    out["lanes"], seconds["lanes"] = synced(lambda: bk.mac_rhs(dev))
    return out, seconds


def keygen_on_card(nft, dev):
    """Keygen at n=500 on the card (the default) and on the host
    (``on_device=False``) from one seed: the tables, the compact form and
    the containers equal bit for bit, in both engines; both keys prepared on
    the card (rows key, ``ab_limbs``, lanes key) equal.  Returns the card
    keys and the host keys' prepared tensors."""
    from nufhe_tpu_torch.ops import lwe as dlwe
    (secret, cloud), t_card = synced(
        lambda: nft.make_key_pair(nft.DeterministicRNG(SEED), lwe_size=N_LWE))
    if not torch.is_tensor(cloud.bootstrap_key.bk_coeff) or \
            cloud.bootstrap_key.bk_coeff.device != dev:
        raise AssertionError("make_key_pair() did not generate on the card")
    phases, bk, ks_a, ks_b = card_keygen_phases(nft, dev, cloud.params)
    (h_secret, h_cloud), t_host = synced(lambda: nft.make_key_pair(
        nft.DeterministicRNG(SEED), on_device=False, lwe_size=N_LWE))
    print("keygen (n=%d, N=1024), synchronised: on the card %.3f s "
          "(make_key_pair() with the default placement), on the host %.3f s "
          "(on_device=False)" % (N_LWE, t_card, t_host))
    print("card keygen by phase (a replay of the same steps): host RNG draws "
          "%.3f s, key matrix on the host %.3f s, upload of %.1f MB %.3f s, "
          "work on the card %.3f s" % (phases["rng"], phases["key_matrix"],
                                       phases["upload_mb"], phases["upload"],
                                       phases["device"]))
    bkey, kkey = cloud.bootstrap_key, cloud.keyswitch_key
    check_equal("replayed card keygen bk_coeff vs make_key_pair()", bk,
                bkey.bk_coeff)
    check_equal("replayed card keygen ks_a vs make_key_pair()", ks_a,
                kkey.ks_a)
    check_equal("replayed card keygen ks_b vs make_key_pair()", ks_b,
                kkey.ks_b)
    del bk, ks_a, ks_b
    hb, hk = h_cloud.bootstrap_key, h_cloud.keyswitch_key
    check_equal("card vs host keygen: bk_coeff", bkey.bk_coeff, hb.bk_coeff)
    check_equal("card vs host keygen: ks_a", kkey.ks_a, hk.ks_a)
    check_equal("card vs host keygen: ks_b", kkey.ks_b, hk.ks_b)
    clouds = {"NTT": (cloud, h_cloud),
              "FFT": (fft_cloud(nft, cloud, lwe_size=N_LWE),
                      fft_cloud(nft, h_cloud, lwe_size=N_LWE))}
    host_prepared = {}
    for mode, (card_key, host_key) in clouds.items():
        got, t_got = prepare_timed(card_key, dev)
        want, t_want = prepare_timed(host_key, dev)
        print("key preparation %s on the card from the card-made key: "
              "transform and limb split %.3f s, rows key %.3f s, ab_limbs "
              "%.3f s, lanes key %.3f s; from the host-made key (host "
              "transform; tables uploaded and packed on the card; host limbs "
              "+ expansion on the card): rows key %.3f s, ab_limbs %.3f s, "
              "lanes key %.3f s"
              % (mode, t_got["transform"], t_got["rows"], t_got["ab_limbs"],
                 t_got["lanes"], t_want["rows"], t_want["ab_limbs"],
                 t_want["lanes"]))
        for part in ("rows", "ab_limbs", "lanes"):
            check_equal("%s %s: card-made key vs host path" % (mode, part),
                        got[part], want[part])
        hk = host_key.keyswitch_key
        oracle, _ = dlwe.prepare_keyswitch_device(hk.ks_a, hk.ks_b, hk.ks_cv,
                                                  hk.log2_base, "cpu")
        check_equal("%s ab_limbs: card-made key vs the numpy packing" % mode,
                    got["ab_limbs"], oracle["ab_limbs"])
        pos, delta = card_key.bootstrap_key.compact()
        hpos, hdelta = host_key.bootstrap_key.compact()
        if pos.device != dev:
            raise AssertionError("the compact form did not stay on the card")
        check_equal("%s compact pos: card vs host" % mode, pos, hpos)
        if mode == "FFT":
            check_equal("%s compact delta: card vs host" % mode, delta, hdelta)
        if card_key.dumps() != host_key.dumps():
            raise AssertionError("%s cloud key containers differ" % mode)
        print("%s cloud key containers (dumps()): byte-equal" % mode)
        host_prepared[mode] = (host_key, want)
    if secret.dumps() != h_secret.dumps():
        raise AssertionError("secret key containers differ")
    return secret, cloud, clouds["FFT"][0], host_prepared


def host_key_gates(nft, dev, secret, host_prepared, nand):
    """The NAND of the host-made key on the default path (10 K3 + 1 K2) and
    the lanes path (500 K4 + 1 K2), both modes, equals the card-made key's
    bit for bit on the gate paths' 4096 inputs."""
    none = dict.fromkeys(KERNEL_NAMES, 0)
    lanes = nft.PerformanceParameters(single_kernel_bootstrap=False)
    x, y, cx, cy = nand["x"], nand["y"], nand["cx"], nand["cy"]
    for mode, (host_key, _) in host_prepared.items():
        for path, perf, expect in (
                ("default", None, dict(none, blind_rotate_chunk=N_LWE // CHUNK,
                                       keyswitch=1)),
                ("lanes", lanes, dict(none, lanes_step=N_LWE, keyswitch=1))):
            label = "host-made %s key, %s path" % (mode, path)
            out, _ = run_gate(nft, label, secret,
                              nft.VirtualMachine(host_key, perf, device=dev),
                              "gate_nand", (cx, cy), ~(x & y), expect)
            ref = nand["out"][mode]
            same = torch.equal(out.a, ref.a) and torch.equal(out.b, ref.b)
            print("%s: NAND vs the card-made key's NAND on %d inputs: %s"
                  % (label, len(x), "bit-equal" if same else "DIFFERENT"))
            if not same:
                raise AssertionError("%s differs from the card-made key"
                                     % label)


def gate_paths(nft, dev, rng, secret, cloud, cloud_fft):
    """The gate paths at batch 4096 from the card-made keys; returns each
    kernel's launches and the machines and NAND outputs for the later
    phases."""
    lanes = nft.PerformanceParameters(single_kernel_bootstrap=False)
    vms = {
        "default NTT": nft.VirtualMachine(cloud, device=dev),
        "default FFT": nft.VirtualMachine(cloud_fft, device=dev),
        "per-step NTT": nft.VirtualMachine(
            cloud, nft.PerformanceParameters(chunk_steps=1), device=dev),
        "lanes NTT": nft.VirtualMachine(cloud, lanes, device=dev),
        "lanes FFT": nft.VirtualMachine(cloud_fft, lanes, device=dev),
    }
    if vms["default NTT"].perf_params.chunk_steps != CHUNK:
        raise AssertionError("the default chunk on the card is not %d" % CHUNK)

    crng = nft.DeterministicRNG(SEED + 1)
    x, y, z = (rng.randint(0, 2, MAIN_BATCH).astype(bool) for _ in range(3))
    cx, cy, cz = (nft.encrypt(crng, secret, v, device=dev) for v in (x, y, z))
    n_chunks = N_LWE // CHUNK
    none = dict.fromkeys(KERNEL_NAMES, 0)
    chunked = dict(none, keyswitch=1, blind_rotate_chunk=n_chunks)
    launches = dict(none)
    default_out = {}
    for label, c in (("default NTT", cloud), ("default FFT", cloud_fft)):
        out, counts = run_gate(nft, label, secret, vms[label], "gate_nand",
                               (cx, cy), ~(x & y), chunked)
        same_on_cpu(nft, label, c, "gate_nand", (cx, cy), out)
        launches = {k: max(launches[k], n) for k, n in counts.items()}
        default_out[c.params.transform_type] = out
    run_gate(nft, "default NTT", secret, vms["default NTT"], "gate_mux",
             (cx, cy, cz), np.where(x, y, z), chunked)
    _, counts = run_gate(
        nft, "per-step NTT", secret, vms["per-step NTT"], "gate_nand",
        (cx, cy), ~(x & y), dict(none, cmux_step=N_LWE, keyswitch=1))
    launches = {k: max(launches[k], n) for k, n in counts.items()}

    lanes_counts = dict(none, lanes_step=N_LWE, keyswitch=1)
    for label, c in (("lanes NTT", cloud), ("lanes FFT", cloud_fft)):
        out, counts = run_gate(nft, label, secret, vms[label], "gate_nand",
                               (cx, cy), ~(x & y), lanes_counts)
        launches = {k: max(launches[k], n) for k, n in counts.items()}
        ref = default_out[c.params.transform_type]
        same = torch.equal(out.a, ref.a) and torch.equal(out.b, ref.b)
        print("%s: NAND vs the default path's NAND on %d inputs: %s"
              % (label, MAIN_BATCH, "bit-equal" if same else "DIFFERENT"))
        if not same:
            raise AssertionError("%s differs from the default path" % label)
        same_on_cpu(nft, label, cpu_lanes_cloud(nft, c, dev), "gate_nand",
                    (cx, cy), out, lanes)
    run_gate(nft, "lanes NTT", secret, vms["lanes NTT"], "gate_mux",
             (cx, cy, cz), np.where(x, y, z), lanes_counts)
    nand = dict(x=x, y=y, cx=cx, cy=cy, out=default_out)
    return launches, vms, nand


def containers_on_card(nft, dev, secret, cloud, cloud_fft, nand,
                       host_prepared):
    """The cloud key's container (format 4) in both modes, loaded and
    prepared on the card (rows key, ``ab_limbs``, lanes key, each equal to
    the host path's), and run on the default path (10 K3 + 1 K2) and the
    lanes path (500 K4 + 1 K2): the NAND on the gate paths' 4096 inputs
    equals the original key's bit for bit.  Then the ciphertext and
    secret-key round trips."""
    none = dict.fromkeys(KERNEL_NAMES, 0)
    paths = (("default", None,
              dict(none, blind_rotate_chunk=N_LWE // CHUNK, keyswitch=1)),
             ("lanes", nft.PerformanceParameters(single_kernel_bootstrap=False),
              dict(none, lanes_step=N_LWE, keyswitch=1)))
    x, y, cx, cy = nand["x"], nand["y"], nand["cx"], nand["cy"]
    for mode, c in (("NTT", cloud), ("FFT", cloud_fft)):
        data = c.dumps()
        loaded, t_load = synced(lambda: nft.NuFHECloudKey.loads(data))
        got, t_prep = prepare_timed(loaded, dev)
        print("%s cloud key container: %d bytes; load %.3f s, then on the "
              "card the rows key %.3f s, the keyswitch key %.3f s, the lanes "
              "key %.3f s; %.3f s in all"
              % (mode, len(data), t_load, t_prep["rows"], t_prep["ab_limbs"],
                 t_prep["lanes"], t_load + sum(t_prep.values())))
        if loaded.bootstrap_key.bk_coeff is not None:
            raise AssertionError("a loaded key should hold limbs only")
        for part in ("rows", "ab_limbs", "lanes"):
            check_equal("loaded %s %s vs host path" % (mode, part), got[part],
                        host_prepared[mode][1][part])
        del got
        for path, perf, expect in paths:
            label = "loaded %s key, %s path" % (mode, path)
            vm = nft.VirtualMachine(loaded, perf, device=dev)
            out, _ = run_gate(nft, label, secret, vm, "gate_nand", (cx, cy),
                              ~(x & y), expect)
            ref = nand["out"][mode]
            same = torch.equal(out.a, ref.a) and torch.equal(out.b, ref.b)
            print("%s: NAND vs the original key's NAND on %d inputs: %s"
                  % (label, len(x), "bit-equal" if same else "DIFFERENT"))
            if not same:
                raise AssertionError("%s differs from the original key" % label)
    data = cx.dumps()
    back = nft.LweSampleArray.loads(data, dev)
    if not (back.device == cx.device and back == cx):
        raise AssertionError("the ciphertext round trip differs")
    again = nft.NuFHESecretKey.loads(secret.dumps())
    if not (again == secret and np.array_equal(nft.decrypt(again, back), x)):
        raise AssertionError("the secret key round trip decrypts otherwise")
    print("ciphertext container (%d inputs): %d bytes, loads onto %s equal; "
          "secret key round trip decrypts the same" % (len(x), len(data), dev))


def kogge_stone_calls(width, keep_last_p):
    """Bootstrapped gate calls of ``models/integer._kogge_stone``: a MUX a
    level, and an AND unless it is the last level (or ``keep_last_p``)."""
    calls, d = 0, 1
    while d < width:
        calls += 1 + int(keep_last_p or 2 * d < width)
        d *= 2
    return calls


def gate_launches(calls):
    """K3 and K2 launches of ``calls`` bootstrapped gate calls on the
    default path (a MUX is one rotation too)."""
    return dict.fromkeys(KERNEL_NAMES, 0) | dict(
        blind_rotate_chunk=N_LWE // CHUNK * calls, keyswitch=calls)


def uint_bits(nft, values, width):
    return nft.uintarray_to_bitarray(np.asarray(values, np.uint64), width)


def int_bits(nft, values, width):
    return nft.intarray_to_bitarray(np.asarray(values, np.int64), width)


def run_circuit(nft, label, secret, vm, name, args, want, expect=None, **kw):
    """One integer circuit through ``vm`` with the launch counts set to 0
    just before it and read just after; every output bit must decrypt to
    ``want`` (a tuple for ``uint_divmod``) with its phase inside the
    margin, and the counts must be ``expect`` where it is given."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    out = getattr(vm, name)(*args, **kw)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    counts = read_counts()
    outs = out if isinstance(out, tuple) else (out,)
    wants = want if isinstance(out, tuple) else (want,)
    frac = 0.0
    for o, w in zip(outs, wants):
        got = nft.decrypt(secret, o)
        if got.shape != w.shape or not np.array_equal(got, w):
            raise AssertionError("%s decrypts wrong" % label)
        frac = max(frac, phase_error_frac(nft, secret, o, w))
    print("%s: %s in %.3f s (first call), launches %s; decrypts to numpy's "
          "answer on every integer, largest phase error %.6f of the 1/16 "
          "margin" % (label, name, elapsed, json.dumps(counts), frac))
    if not frac < 1:
        raise AssertionError("%s: phase error beyond the margin" % label)
    if expect is not None and counts != expect:
        raise AssertionError("%s: expected launches %s" % (label, expect))
    return elapsed


def integer_circuits(nft, dev, rng, secret, vms):
    """The integer circuits at the default parameters through
    ``VirtualMachine.uint_*``/``int_*`` on the default path ('NTT'; the
    last ``uint_min`` in 'FFT'); the 16-bit additions and subtractions
    with the K3 and K2 launches their circuits imply."""
    vm, vm_fft = vms["default NTT"], vms["default FFT"]
    crng = nft.DeterministicRNG(SEED + 3)

    def enc(bits):
        return nft.encrypt(crng, secret, bits, device=dev)

    def uints(batch, width, shape=None):
        v = rng.randint(0, 2**width, shape or batch).astype(np.int64)
        return v, enc(uint_bits(nft, v, width))

    w, big, small = 16, MAIN_BATCH, INT_BATCH
    ripple = gate_launches(3 * w)
    a, ca = uints(big, w)
    b, cb = uints(big, w)
    run_circuit(nft, "uint_add 16-bit ripple, %d integers" % big, secret, vm,
                "uint_add", (ca, cb), uint_bits(nft, (a + b) % 2**w, w),
                ripple, parallel=False)
    run_circuit(nft, "uint_lt 16-bit, %d integers" % big, secret, vm,
                "uint_lt", (ca, cb), (a < b)[:, None])
    run_circuit(nft, "uint_eq 16-bit, %d integers" % big, secret, vm,
                "uint_eq", (ca, cb), (a == b)[:, None])
    run_circuit(nft, "uint_min 16-bit, %d integers" % big, secret, vm,
                "uint_min", (ca, cb), uint_bits(nft, np.minimum(a, b), w))
    r, cr = uints(1, w, (1,))
    run_circuit(nft, "uint_add 16-bit, %d integers + one broadcast (1, 16)"
                % big, secret, vm, "uint_add", (ca, cr),
                uint_bits(nft, (a + r) % 2**w, w), ripple)

    a, ca = uints(small, w)
    b, cb = uints(small, w)
    run_circuit(nft, "uint_add 16-bit Kogge-Stone, %d integers" % small,
                secret, vm, "uint_add", (ca, cb),
                uint_bits(nft, (a + b) % 2**w, w),
                gate_launches(3 + kogge_stone_calls(w, False)), parallel=True)
    for form, parallel, calls in (
            ("ripple", False, 3 * w),
            ("Kogge-Stone", True, 4 + kogge_stone_calls(w, True))):
        run_circuit(nft, "uint_sub 16-bit %s, %d integers" % (form, small),
                    secret, vm, "uint_sub", (ca, cb),
                    uint_bits(nft, (a - b) % 2**w, w), gate_launches(calls),
                    parallel=parallel)
    run_circuit(nft, "uint_min 16-bit 'FFT', %d integers" % small, secret,
                vm_fft, "uint_min", (ca, cb),
                uint_bits(nft, np.minimum(a, b), w))
    a8, ca8 = uints(small, 8)
    b8, cb8 = uints(small, 8)
    run_circuit(nft, "uint_mul 8-bit ripple, %d integers" % small, secret, vm,
                "uint_mul", (ca8, cb8), uint_bits(nft, a8 * b8 % 2**8, 8),
                parallel=False)

    sa = rng.randint(-2**15, 2**15, small).astype(np.int64)
    sb = rng.randint(-2**15, 2**15, small).astype(np.int64)
    csa, csb = enc(int_bits(nft, sa, w)), enc(int_bits(nft, sb, w))
    run_circuit(nft, "int_add 16-bit, %d integers" % small, secret, vm,
                "int_add", (csa, csb), int_bits(nft, sa + sb, w), ripple)
    run_circuit(nft, "int_gt 16-bit, %d integers" % small, secret, vm,
                "int_gt", (csa, csb), (sa > sb)[:, None])
    run_circuit(nft, "int_neg 16-bit, %d integers" % small, secret, vm,
                "int_neg", (csa,), int_bits(nft, -sa, w))

    n_div = DIV_BATCH
    a, ca = uints(n_div, 8)
    b = rng.randint(0, 2**8, n_div).astype(np.int64)
    b[::8] = 0                    # quotient 2^8 - 1, remainder a
    cb = enc(uint_bits(nft, b, 8))
    nz = np.maximum(b, 1)
    q = np.where(b == 0, 2**8 - 1, a // nz)
    rem = np.where(b == 0, a, a % nz)
    run_circuit(nft, "uint_divmod 8-bit, %d integers (%d divisors 0)"
                % (n_div, int((b == 0).sum())), secret, vm, "uint_divmod",
                (ca, cb), (uint_bits(nft, q, 8), uint_bits(nft, rem, 8)))


def adder_crossover(nft, dev, secret, cloud, smi):
    """``uint_add`` in both forms over a grid of batch and width on the
    default path, through ``tools/adder_crossover_torch.sweep``: one
    synchronised host-clock time each, after a first call at that shape
    whose decryption must equal numpy's sum."""
    import adder_crossover_torch as crossover
    grid = crossover.sweep(cloud, secret, nft.DeterministicRNG(SEED + 4),
                           CROSSOVER_BATCHES, CROSSOVER_WIDTHS, dev, reps=1)
    wrong = [(e["batch"], e["width"], form) for e in grid
             for form in ("ripple", "kogge_stone") if not e[form + "_ok"]]
    if wrong:
        raise AssertionError("uint_add decrypts wrong at %s" % wrong)
    print(json.dumps({"adder_crossover": grid, "card": smi,
                      "path": "default NTT, n=500, N=1024"}))


def secure_rng_gate(nft, dev, rng):
    """Keygen on the card with ``SecureRNG`` (n=500): the NAND of 4096
    inputs, encrypted with it too, decrypts to the truth table through
    10 K3 + 1 K2."""
    srng = nft.SecureRNG()
    (secret, cloud), t_keygen = synced(
        lambda: nft.make_key_pair(srng, lwe_size=N_LWE))
    if cloud.bootstrap_key.bk_coeff.device != dev:
        raise AssertionError("SecureRNG keygen did not run on the card")
    print("SecureRNG keygen on the card (n=%d): %.3f s" % (N_LWE, t_keygen))
    x, y = (rng.randint(0, 2, MAIN_BATCH).astype(bool) for _ in range(2))
    cx, cy = (nft.encrypt(srng, secret, v, device=dev) for v in (x, y))
    run_gate(nft, "SecureRNG keys, default NTT", secret,
             nft.VirtualMachine(cloud, device=dev), "gate_nand", (cx, cy),
             ~(x & y), gate_launches(1))


def variant_gates(nft, dev, rng):
    """NAND at each of the JAX package's one-knob variant parameters
    (``tlwe_mask_size=2``, ``bs_decomp_length=3``, ``ks_log2_base=3``), in
    both engines, on the default path (n / 50 K3 launches and 1 K2) and the
    lanes path (n K4 launches and 1 K2), 4096 inputs, at n = VARIANT_LWE;
    each decrypts to its truth table with exactly those launches and
    equals the plain CPU gate on 8 inputs."""
    none = dict.fromkeys(KERNEL_NAMES, 0)
    lanes = nft.PerformanceParameters(single_kernel_bootstrap=False)
    print("variant parameters run at lwe_size=%d (not 500) to keep the run "
          "short" % VARIANT_LWE)
    for i, knob in enumerate(VARIANTS):
        t0 = time.time()
        secret, cloud = nft.make_key_pair(nft.DeterministicRNG(SEED + 10 + i),
                                          lwe_size=VARIANT_LWE, **knob)
        clouds = (("NTT", cloud),
                  ("FFT", fft_cloud(nft, cloud, lwe_size=VARIANT_LWE, **knob)))
        print("%s: keygen (on the card, n=%d): %.1f s"
              % (knob, VARIANT_LWE, time.time() - t0))
        crng = nft.DeterministicRNG(SEED + 20 + i)
        x, y = (rng.randint(0, 2, MAIN_BATCH).astype(bool) for _ in range(2))
        cx, cy = (nft.encrypt(crng, secret, v, device=dev) for v in (x, y))
        for mode, c in clouds:
            for path, perf, expect in (
                    ("default", None,
                     dict(none, blind_rotate_chunk=-(-VARIANT_LWE // CHUNK),
                          keyswitch=1)),
                    ("lanes", lanes,
                     dict(none, lanes_step=VARIANT_LWE, keyswitch=1))):
                label = "%s %s %s" % (knob, path, mode)
                vm = nft.VirtualMachine(c, perf, device=dev)
                out, _ = run_gate(nft, label, secret, vm, "gate_nand",
                                  (cx, cy), ~(x & y), expect)
                cpu_cloud = c if perf is None else cpu_lanes_cloud(nft, c, dev)
                same_on_cpu(nft, label, cpu_cloud, "gate_nand", (cx, cy), out,
                            perf)


def tfhe_lib_params(nft, dev, rng, results):
    """The TFHE library's default 128-bit set (``TFHE_LIB``: n = 630, l = 3
    at base 2^7).  K3 at (mask1, l) = (2, 3) and base 2^7 at batch 2^14, both
    key forms: a chunk of 50 from step 0 and the tail of 30 from step 600,
    each one launch of its steps by the counters, against the plain steps on
    ``TFHE_ROWS`` sampled rows; K2 at output width 630 (640 padded) and
    base 4 at batch 2^14 against its plain version; then the NAND through
    ``VirtualMachine`` on 4096 pairs, keys made on the card, both engines:
    13 K3 launches (12 chunks and the tail) of 630 steps, no K1 and one K2,
    decrypting to the truth table and equal to the plain CPU gate on 8
    inputs, every K3 launch a pair of blocks (``paired_launches`` 13).
    Prints one ``tfhe_lib_params`` JSON line."""
    from nufhe_tpu_torch.ops import blind_rotate as brc, keyswitch as ks
    n = TFHE_LIB["lwe_size"]
    tail = n % CHUNK
    tp = nft.NuFHEParameters(**TFHE_LIB).tgsw_params
    kw = dict(offset=int(tp.offset), log2_base=tp.bs_log2_base)
    rows = torch.from_numpy(np.sort(rng.choice(
        TIMING_BATCH, TFHE_ROWS, replace=False))).to(dev)
    line = {"k3": [], "gates": []}
    for mode in ("NTT", "FFT"):
        key = random_key(rng, n, tp, dev, mode)
        key_rows = rows_of(key, mode)
        acc = random_acc(rng, TIMING_BATCH, dev)
        bara_t = random_powers(rng, (n, TIMING_BATCH), dev)
        sub_acc, sub_bara = acc[rows], bara_t[:, rows].contiguous()
        for start, chunk in ((0, CHUNK), (n - tail, tail)):
            torch.cuda.synchronize()
            reset_counts()
            got = brc.blind_rotate_chunk(acc, bara_t, key_rows, start, chunk,
                                         **kw)
            torch.cuda.synchronize()
            counted = (brc.launches, brc.steps)
            want = brc.blind_rotate_chunk_plain(sub_acc, sub_bara, key, start,
                                                chunk, **kw)
            label = ("K3 (mask1, l) = (2, 3) base 2^7 %s vs plain, batch %d "
                     "(%d sampled rows), steps [%d, %d)"
                     % (mode, TIMING_BATCH, TFHE_ROWS, start, start + chunk))
            record_err(results, "blind_rotate_chunk", label,
                       max_abs_err(got[rows], want))
            if counted != (1, chunk):
                raise AssertionError("%s: launches and steps %s, not (1, %d)"
                                     % (label, counted, chunk))
            line["k3"].append([mode, start, chunk, counted[1]])
        del key, key_rows, acc, bara_t, got, want
    a, ab_limbs, meta = keyswitch_inputs(rng, TIMING_BATCH, dev, out=n)
    kkw = dict(out_size=meta.output_size, decomp_length=meta.decomp_length,
               log2_base=meta.log2_base)
    got = ks.keyswitch_totals(a, ab_limbs, **kkw)
    want = ks.keyswitch_totals_plain(a, ab_limbs, **kkw)
    torch.cuda.synchronize()
    record_err(results, "keyswitch", "K2 keyswitch base 4, output width %d, "
               "vs plain, batch %d" % (n, TIMING_BATCH), max_abs_err(got, want))
    line["k2"] = {"batch": TIMING_BATCH, "out": meta.output_size,
                  "n_pad": int(ab_limbs.shape[3])}
    del a, ab_limbs, got, want
    t0 = time.time()
    secret, cloud = nft.make_key_pair(nft.DeterministicRNG(SEED + 30),
                                      **TFHE_LIB)
    clouds = (("NTT", cloud), ("FFT", fft_cloud(nft, cloud, **TFHE_LIB)))
    print("TFHE library set: keygen (on the card, n=%d): %.1f s"
          % (n, time.time() - t0))
    crng = nft.DeterministicRNG(SEED + 31)
    x, y = (rng.randint(0, 2, MAIN_BATCH).astype(bool) for _ in range(2))
    cx, cy = (nft.encrypt(crng, secret, v, device=dev) for v in (x, y))
    expect = dict(dict.fromkeys(KERNEL_NAMES, 0),
                  blind_rotate_chunk=-(-n // CHUNK), keyswitch=1)
    for mode, c in clouds:
        label = "TFHE library set (n=%d, l=3, base 2^7) default %s" % (n, mode)
        out, counts = run_gate(nft, label, secret,
                               nft.VirtualMachine(c, device=dev), "gate_nand",
                               (cx, cy), ~(x & y), expect)
        if brc.steps != n or brc.paired_launches != expect[
                "blind_rotate_chunk"]:
            raise AssertionError("%s: K3 ran %d steps, not %d, in %d paired "
                                 "launches" % (label, brc.steps, n,
                                               brc.paired_launches))
        line["gates"].append({"mode": mode, "k3": counts["blind_rotate_chunk"],
                              "steps": brc.steps,
                              "k3_paired": brc.paired_launches,
                              "k1": counts["cmux_step"],
                              "k2": counts["keyswitch"]})
        same_on_cpu(nft, label, c, "gate_nand", (cx, cy), out)
    print(json.dumps({"tfhe_lib_params": line}))


def k3_shape_times(nft, dev, rng, results):
    """K3 at each of ``K3_SHAPE_TIMES``, 'NTT', batch 2^14: one launch of
    ``CHUNK`` steps from step 0 of a random key, against the plain steps on
    ``TFHE_ROWS`` sampled rows, then its ms a launch by CUDA events beside
    its bound (the int8 MAC's operations, 2 * 64 * 64G * Q a sample and
    step, or the accumulators, rotation amounts and key rows once), and
    K1's ms a launch (one step of the same key, ``k1_ms``); adds a
    ``blind_rotate_chunk (mask1, l)`` entry to ``results`` for each.  Reads
    nothing that a checkout without the pair lacks, so that
    ``chip_smoke.py --shapes TREE`` times another tree's K3 the same way."""
    from nufhe_tpu_torch.ops import blind_rotate as brc, cmux
    b = TIMING_BATCH
    sample = torch.from_numpy(np.sort(rng.choice(
        b, TFHE_ROWS, replace=False))).to(dev)
    for (mask1, decomp_length), params in K3_SHAPE_TIMES:
        name = "blind_rotate_chunk (%d, %d)" % (mask1, decomp_length)
        tp = nft.NuFHEParameters(**params).tgsw_params
        kw = dict(offset=int(tp.offset), log2_base=tp.bs_log2_base)
        key = random_key(rng, CHUNK, tp, dev, "NTT", mask1)
        rows = rows_of(key, "NTT")
        acc = random_acc(rng, b, dev, mask1)
        bara_t = random_powers(rng, (CHUNK, b), dev)
        got = brc.blind_rotate_chunk(acc, bara_t, rows, 0, CHUNK, **kw)
        want = brc.blind_rotate_chunk_plain(
            acc[sample], bara_t[:, sample].contiguous(), key, 0, CHUNK, **kw)
        results[name] = dict(
            name=name, route="cuda",
            source="nufhe_tpu_torch/kernels/csrc/blind_rotate_chunk.cu",
            replaces="nufhe_tpu/ops/pallas/blind_rotate.py:83")
        record_err(results, name, "K3 %s NTT vs plain, batch %d (%d sampled "
                   "rows), chunk %d" % (name, b, TFHE_ROWS, CHUNK),
                   max_abs_err(got[sample], want))
        del got, want
        ms = cuda_ms(lambda: brc.blind_rotate_chunk(acc, bara_t, rows, 0,
                                                    CHUNK, **kw), 5)
        g_size, q_size = mask1 * decomp_length, 5 * 32 * mask1
        n_ops = 2 * b * CHUNK * 64 * (64 * g_size) * q_size
        n_bytes = 2 * acc.numel() * 4 + bara_t.numel() * 4 + rows.numel()
        bound, by = bound_ms(n_bytes, n_ops, INT8_OPS_PER_S)
        cmux.cmux_step(acc, bara_t[0], rows[0], **kw)     # K1 built, warm
        k1_ms = cuda_ms(lambda: cmux.cmux_step(acc, bara_t[0], rows[0],
                                               **kw), 20)
        print("K3 %s NTT batch %d chunk %d: %.4f ms/launch (%.4f a step), "
              "bound %.4f ms (%s; int8 MAC), %.2f%% of it; K1 %.4f ms/launch"
              % (name, b, CHUNK, ms, ms / CHUNK, bound, by,
                 100 * bound / ms, k1_ms))
        results[name].update(launches=None, ms=ms, plain_ms=None,
                             bound_ms=bound, bound_by=by, library_ms=None,
                             k1_ms=k1_ms)
        del key, rows, acc, bara_t


def gate_ms_bit(nft, secret, vm, gate, args, want):
    out = getattr(vm, gate)(*args)                   # warm-up
    torch.cuda.synchronize()
    if not np.array_equal(nft.decrypt(secret, out), want):
        raise AssertionError("%s at batch 2^14 decrypts wrong" % gate)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        getattr(vm, gate)(*args)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    return [t * 1e3 / len(want) for t in times], times


def timing(nft, dev, rng, secret, cloud, cloud_fft, vms, results):
    from nufhe_tpu_torch.ops import blind_rotate as brc, cmux, keyswitch as ks
    b = TIMING_BATCH
    crng = nft.DeterministicRNG(SEED + 2)
    x, y, z = (rng.randint(0, 2, b).astype(bool) for _ in range(3))
    cx, cy, cz = (nft.encrypt(crng, secret, v, device=dev) for v in (x, y, z))
    for label in ("default NTT", "default FFT", "per-step NTT", "lanes NTT",
                  "lanes FFT"):
        ms_bit, times = gate_ms_bit(nft, secret, vms[label], "gate_nand",
                                    (cx, cy), ~(x & y))
        print("%s NAND warm, batch %d: %s ms/bit (gate %s s)"
              % (label, b, ms_bit, times))
    ms_bit, times = gate_ms_bit(nft, secret, vms["default NTT"], "gate_mux",
                                (cx, cy, cz), np.where(x, y, z))
    print("default NTT MUX warm, batch %d: %s ms/bit (gate %s s)"
          % (b, ms_bit, times))

    # K1 at the timing batch: the gate's own key rows, random accumulator
    tp = cloud.params.tgsw_params
    kw = dict(offset=int(tp.offset), log2_base=tp.bs_log2_base)
    acc = random_acc(rng, b, dev)
    p = random_powers(rng, (b,), dev)
    k1_ms = {}
    for mode, c in (("NTT", cloud), ("FFT", cloud_fft)):
        rows = c.bootstrap_key.device(dev)[0]
        key_row = int64_key(c.bootstrap_key, dev)[0]
        got = cmux.cmux_step(acc, p, rows, **kw)
        want = cmux.cmux_step_plain(acc, p, key_row, **kw)
        torch.cuda.synchronize()
        record_err(results, "cmux_step", "K1 %s vs plain, batch %d"
                   % (mode, b), max_abs_err(got, want))
        del got, want
        k1_ms[mode] = cuda_ms(lambda: cmux.cmux_step(acc, p, rows, **kw), 20)
        plain = cuda_ms(lambda: cmux.cmux_step_plain(acc, p, key_row, **kw), 2)
        # the step's key limb rows, int8, which the kernel reads
        n_bytes = 2 * acc.numel() * 4 + p.numel() * 4 + rows.numel()
        # the design's own operations: the int8 multiply-adds of K3's MAC
        # for one step; beside it the int64 count of the first design
        bound, by = bound_ms(n_bytes, mac_ops(b, mode), INT8_OPS_PER_S)
        old_bound, old_by = bound_ms(n_bytes, cmux_ops(b))
        print("K1 %s batch %d: %.4f ms/launch, plain %.2f ms, bound %.4f ms "
              "(%s; int8 MAC), bound by the int64 count of the first design "
              "%.4f ms (%s)" % (mode, b, k1_ms[mode], plain, bound, by,
                                old_bound, old_by))
        if mode == "NTT":
            results["cmux_step"].update(ms=k1_ms[mode], plain_ms=plain,
                                        bound_ms=bound, bound_by=by,
                                        library_ms=None)

    # K3 at the timing batch and the default chunk: the gate's key, random
    # accumulator and rotation amounts
    bara_t = random_powers(rng, (N_LWE, b), dev)
    for mode, c in (("NTT", cloud), ("FFT", cloud_fft)):
        rows = c.bootstrap_key.device(dev)
        key = int64_key(c.bootstrap_key, dev)
        got = brc.blind_rotate_chunk(acc, bara_t, rows, 0, CHUNK,
                                     **kw)
        k3_ms = cuda_ms(lambda: brc.blind_rotate_chunk(
            acc, bara_t, rows, 0, CHUNK, **kw), 3)
        plain_out = []
        plain = cuda_ms(lambda: plain_out.append(brc.blind_rotate_chunk_plain(
            acc, bara_t, key, 0, CHUNK, **kw)), 1)
        record_err(results, "blind_rotate_chunk", "K3 %s vs plain, batch %d, "
                   "chunk %d" % (mode, b, CHUNK),
                   max_abs_err(got, plain_out[0]))
        del got, plain_out
        n_bytes = (2 * acc.numel() * 4 + CHUNK * b * 4
                   + CHUNK * rows[0].numel())
        # the design's own operations: int8 multiply-adds of the MAC, 64
        # slots x 256 inputs x Q outputs a sample and step (K4's count x
        # CHUNK); beside it the int64 count of the first design
        bound, by = bound_ms(n_bytes, mac_ops(b, mode) * CHUNK,
                             INT8_OPS_PER_S)
        old_bound, old_by = bound_ms(n_bytes, CHUNK * cmux_ops(b))
        mma, share = mac_issue(2, 2, mode == "FFT")
        print("K3 %s batch %d chunk %d: %.4f ms/launch (%d x K1 = %.4f ms, "
              "ratio %.4f), plain %.2f ms, bound %.4f ms (%s; int8 MAC), "
              "bound by the int64 count of the first design %.4f ms (%s); "
              "MAC %d mma.sync a slot, %s of their N columns carry work"
              % (mode, b, CHUNK, k3_ms, CHUNK, CHUNK * k1_ms[mode],
                 k3_ms / (CHUNK * k1_ms[mode]), plain, bound, by, old_bound,
                 old_by, mma, share))
        if mode == "NTT":
            results["blind_rotate_chunk"].update(
                ms=k3_ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=None)

    timing_k4(dev, rng, cloud, cloud_fft, results, kw)

    # K2 at the timing batch: the gate's keyswitch operand, random input
    ks_arrays, meta = cloud.keyswitch_key.device(dev)
    ab_limbs = ks_arrays["ab_limbs"]
    a = torch.from_numpy(
        rng.randint(-2**31, 2**31, (b, meta.input_size)).astype(np.int32)).to(dev)
    kkw = dict(out_size=meta.output_size, decomp_length=meta.decomp_length,
               log2_base=meta.log2_base)
    got = ks.keyswitch_totals(a, ab_limbs, **kkw)
    want = ks.keyswitch_totals_plain(a, ab_limbs, **kkw)
    torch.cuda.synchronize()
    record_err(results, "keyswitch", "K2 keyswitch vs plain, batch %d" % b,
               max_abs_err(got, want))
    k2_ms = cuda_ms(lambda: ks.keyswitch_totals(a, ab_limbs, **kkw), 5)
    k2_plain = cuda_ms(lambda: ks.keyswitch_totals_plain(a, ab_limbs, **kkw),
                       1)
    # library yardstick: float64 product of the one-hot digit matrix with
    # the key entries recombined from the limbs (exact: every sum stays
    # below 2^53), one-hot built outside
    digits = ks.keyswitch_digits(a, meta.decomp_length, meta.log2_base)
    table = ks.key_table(ab_limbs, meta.output_size)     # (rows, 3, out+2)
    rows, width = table.shape[0], table.shape[2]
    onehot = torch.zeros((b, rows * 3), dtype=torch.float64, device=dev)
    nz = digits != 0
    cols = (torch.arange(rows, device=dev) * 3)[None, :] + digits - 1
    onehot.scatter_add_(1, torch.where(nz, cols, 0), nz.to(torch.float64))
    table64 = table.reshape(rows * 3, width).to(torch.float64)
    del table
    lib = torch.mm(onehot, table64)
    lib_ms = cuda_ms(lambda: torch.mm(onehot, table64), 3)
    lib_i32 = ((lib.to(torch.int64) + 2**31) % 2**32 - 2**31)
    if not torch.equal(lib_i32, got.to(torch.int64)):
        raise AssertionError("library yardstick disagrees with K2")
    count = int(got[:, -1].to(torch.int64).sum().item())
    # the function's own work: an int32 add a nonzero digit and column
    # [a | b], against the tensor-core form's int8 operations
    k2_bound, k2_by = bound_ms(a.numel() * 4 + ab_limbs.numel()
                               + got.numel() * 4, count * (width - 1))
    mma_ops = 2 * b * 3 * rows * ab_limbs.shape[1] * ab_limbs.shape[3]
    results["keyswitch"].update(ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_bound,
                                bound_by=k2_by, library_ms=lib_ms)
    print("K2 batch %d: %.4f ms/launch, plain %.2f ms, torch.mm f64 one-hot "
          "%.4f ms, bound %.4f ms (%s); the tensor-core form's %.4g int8 "
          "operations take %.4f ms at the dense int8 rate"
          % (b, k2_ms, k2_plain, lib_ms, k2_bound, k2_by, mma_ops,
             mma_ops / INT8_OPS_PER_S * 1e3))
    del onehot, table64, lib
    # K2's other form: base 8, a stage a digit value (7 of them)
    a8, ab8, meta8 = keyswitch_inputs(rng, b, dev, log2_base=3)
    kw8 = dict(out_size=meta8.output_size, decomp_length=meta8.decomp_length,
               log2_base=meta8.log2_base)
    got = ks.keyswitch_totals(a8, ab8, **kw8)
    want = ks.keyswitch_totals_plain(a8, ab8, **kw8)
    torch.cuda.synchronize()
    record_err(results, "keyswitch", "K2 keyswitch base 8 vs plain, batch %d"
               % b, max_abs_err(got, want))
    print("K2 base 8 batch %d: %.4f ms/launch"
          % (b, cuda_ms(lambda: ks.keyswitch_totals(a8, ab8, **kw8), 5)))


def timing_k4(dev, rng, cloud, cloud_fft, results, kw):
    """K4 at the timing batch: the gate's key rows (both forms), a random
    q-layout accumulator and powers.  Beside it, as a part of its work and
    not its function, the MAC alone as 64 ``torch._int_mm`` calls."""
    from nufhe_tpu_torch.ops import lanes_step as k4
    b = TIMING_BATCH
    acc_q = random_acc(rng, b, dev).reshape(b, -1)
    p = random_powers(rng, (b,), dev)
    for mode, c in (("NTT", cloud), ("FFT", cloud_fft)):
        key_row = c.bootstrap_key.mac_rhs(dev)[0]
        got = k4.lanes_step(acc_q, p, key_row, **kw)
        want = k4.lanes_step_plain(acc_q, p, key_row, **kw)
        torch.cuda.synchronize()
        record_err(results, "lanes_step", "K4 %s vs plain, batch %d"
                   % (mode, b), max_abs_err(got, want))
        del got, want
        ms = cuda_ms(lambda: k4.lanes_step(acc_q, p, key_row, **kw), 20)
        plain = cuda_ms(lambda: k4.lanes_step_plain(acc_q, p, key_row, **kw),
                        2)
        n_ops = 2 * b * key_row.numel()         # int8 multiply-adds x 2
        bound, by = bound_ms(2 * acc_q.numel() * 4 + p.numel() * 4
                             + key_row.numel(), n_ops, INT8_OPS_PER_S)
        lhs = torch.randint(-128, 128, (key_row.shape[0], b, key_row.shape[1]),
                            dtype=torch.int8, device=dev)
        mac = torch._int_mm(lhs[0], key_row[0])
        if not torch.equal(mac.to(torch.float64),
                           lhs[0].to(torch.float64) @ key_row[0].to(
                               torch.float64)):
            raise AssertionError("torch._int_mm disagrees with float64")
        mac_ms = cuda_ms(lambda: [torch._int_mm(lhs[t], key_row[t])
                                  for t in range(key_row.shape[0])], 10)
        print("K4 %s batch %d: %.4f ms/launch, plain %.2f ms, bound %.4f ms "
              "(%s); a part of its work, not its function: the MAC alone as "
              "%d torch._int_mm (%d x %d)(%d x %d) %.4f ms"
              % (mode, b, ms, plain, bound, by, key_row.shape[0], b,
                 key_row.shape[1], key_row.shape[1], key_row.shape[2], mac_ms))
        del lhs, mac
        if mode == "NTT":
            results["lanes_step"].update(ms=ms, plain_ms=plain, bound_ms=bound,
                                         bound_by=by, library_ms=None)
    k4_grid_split(dev, rng, cloud.params.tgsw_params, kw)


def k4_grid_split(dev, rng, tp, kw):
    """K4's three grids (forward, MAC, inverse) timed apart with CUDA
    events at the timing batch, in both forms, on a random key row and
    accumulator; the sum beside the whole launch.  Returns {mode: {grid:
    ms}}."""
    from nufhe_tpu_torch.ops import lanes_step as k4
    b = TIMING_BATCH
    acc_q = random_acc(rng, b, dev).reshape(b, -1)
    p = random_powers(rng, (b,), dev)
    split = {}
    for mode in ("NTT", "FFT"):
        key_row = random_lanes_key(rng, 1, tp, dev, mode)[0][0].contiguous()
        k4.lanes_step_grids(acc_q, p, key_row, 7, **kw)
        ms = {name: cuda_ms(lambda: k4.lanes_step_grids(acc_q, p, key_row,
                                                        grids, **kw), 20)
              for name, grids in (("forward", 1), ("mac", 2), ("inverse", 4),
                                  ("all", 7))}
        print("K4 %s batch %d, grids apart: forward %.4f ms, MAC %.4f ms, "
              "inverse %.4f ms, sum %.4f ms, the three in one launch %.4f ms"
              % (mode, b, ms["forward"], ms["mac"], ms["inverse"],
                 ms["forward"] + ms["mac"] + ms["inverse"], ms["all"]))
        split[mode] = ms
    return split


def nand_linear(cx, cy):
    """The NAND's linear part, (0, 1/8) - x - y, as the gate computes it."""
    from nufhe_tpu_torch.numeric import phase_to_t32, wrap_i32
    a = wrap_i32(-(cx.a.to(torch.int64) + cy.a.to(torch.int64)))
    b = wrap_i32(int(phase_to_t32(1, 8)) - cx.b.to(torch.int64)
                 - cy.b.to(torch.int64))
    return a, b


def tp_counts():
    from nufhe_tpu_torch.ops import lanes_step
    return dict(read_counts(), collectives=lanes_step.collectives)


def multi_device(nft, dev, rng, secret, cloud, cloud_fft, nand, results,
                 smi):
    """Phase 9: ``nufhe_tpu_torch.parallel`` in a world-1 NCCL group."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from nufhe_tpu_torch.numeric import phase_to_t32
    from nufhe_tpu_torch.ops import flat_engine as fe
    from nufhe_tpu_torch.parallel import distributed as pdist, mesh as pmesh
    t0 = time.time()
    store = tempfile.mkdtemp(prefix="nufhe_pg_")
    pdist.initialize("file://" + os.path.join(store, "store"), 1, 0)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError("the process group is not NCCL")
        mesh = pmesh.make_mesh(1, 1)
        report = dict(card=smi, backend="nccl", world=1)
        clouds = {"NTT": cloud, "FFT": cloud_fft}
        none = dict.fromkeys(KERNEL_NAMES, 0)

        # data parallel: the default NAND on the rank's shard
        vm = nft.VirtualMachine(cloud, device=dev)
        cx, cy = (pmesh.shard_ciphertext(c.copy(), mesh)
                  for c in (nand["cx"], nand["cy"]))
        torch.cuda.synchronize()
        reset_counts()
        out = vm.gate_nand(cx, cy)
        torch.cuda.synchronize()
        counts = tp_counts()
        whole = pmesh.gather_ciphertext(out, mesh)
        want = nand["out"]["NTT"]
        same = torch.equal(whole.a, want.a) and torch.equal(whole.b, want.b)
        print("multi_device DP NAND on %d inputs, (1, 1) mesh: launches %s, "
              "vs the default NAND: %s" % (MAIN_BATCH, json.dumps(counts),
                                           "bit-equal" if same else
                                           "DIFFERENT"))
        expect = dict(none, keyswitch=1, blind_rotate_chunk=N_LWE // CHUNK,
                      collectives=0)
        if counts != expect or not same:
            raise AssertionError("multi_device DP NAND: expected launches %s "
                                 "and the default NAND" % expect)

        # tensor parallel, world 1: every step split around a collective
        lin_a, lin_b = nand_linear(nand["cx"], nand["cy"])
        fns = {}
        for mode in pmesh.MODES:
            for engine, c in clouds.items():
                bk = pmesh.shard_bootstrap_key(c.bootstrap_key.mac_rhs(dev),
                                               mesh, mode)
                ks_arrays, ks_meta = c.keyswitch_key.device(dev)
                ks = pmesh.replicate(ks_arrays, mesh)
                fn = pmesh.sharded_bootstrap_fn(
                    mesh, ks_meta, int(phase_to_t32(1, 8)),
                    c.params.tgsw_params, mode=mode, force_tp=True)
                fns[mode, engine] = (fn, bk, ks)
                torch.cuda.synchronize()
                reset_counts()
                a, b, cv = fn(lin_a, lin_b, bk, ks)
                torch.cuda.synchronize()
                counts = tp_counts()
                want = nand["out"][engine]
                same = torch.equal(a, want.a) and torch.equal(b, want.b)
                print("multi_device TP %s %s NAND on %d inputs: launches %s, "
                      "vs the lanes NAND: %s"
                      % (mode, engine, MAIN_BATCH, json.dumps(counts),
                         "bit-equal" if same else "DIFFERENT"))
                # each of the 500 K4 launches split around a collective
                expect = dict(none, keyswitch=1, lanes_step=N_LWE,
                              collectives=N_LWE)
                if counts != expect or not same \
                        or not torch.isfinite(cv).all():
                    raise AssertionError(
                        "multi_device TP %s %s: expected launches %s and the "
                        "lanes NAND" % (mode, engine, expect))

        k4_shards(dev, rng, cloud.params.tgsw_params, results)

        # timing at 2^14
        b = TIMING_BATCH
        crng = nft.DeterministicRNG(SEED + 5)
        x, y = (rng.randint(0, 2, b).astype(bool) for _ in range(2))
        tx, ty = (nft.encrypt(crng, secret, v, device=dev) for v in (x, y))
        sx, sy = (pmesh.shard_ciphertext(c.copy(), mesh) for c in (tx, ty))
        report["dp_nand_ms_bit"], _ = gate_ms_bit(nft, secret, vm,
                                                  "gate_nand", (sx, sy),
                                                  ~(x & y))
        lin_a, lin_b = nand_linear(tx, ty)
        group = mesh.get_group("model")
        for (mode, engine), (fn, bk, ks) in fns.items():
            out = fn(lin_a, lin_b, bk, ks)          # warm-up, checked
            got = nft.decrypt(secret, nft.LweSampleArray(
                clouds[engine].params.in_out_params, *out))
            if not np.array_equal(got, ~(x & y)):
                raise AssertionError("TP %s %s at 2^14 decrypts wrong"
                                     % (mode, engine))
            del out
            gate_ms = [cuda_ms(lambda: fn(lin_a, lin_b, bk, ks), 1)
                       for _ in range(2)]
            n_ch = 1 if engine == "FFT" else 2
            chan = torch.zeros((b, n_ch, 2, 64, 32), dtype=torch.int32,
                               device=dev)
            collective = (fe.sum_channels if mode == "limbs"
                          else fe.gather_slots)
            collective(chan, group)
            coll_ms = cuda_ms(lambda: collective(chan, group), N_LWE) * N_LWE
            del chan
            report["tp_%s_%s" % (mode, engine)] = dict(
                ms_bit=[t / b for t in gate_ms], collectives_ms=coll_ms,
                collective_share=coll_ms / min(gate_ms))
            print("multi_device TP %s %s batch %d: %s ms/bit; its %d "
                  "collectives alone %.3f ms, %.4f of the gate"
                  % (mode, engine, b, [t / b for t in gate_ms], N_LWE,
                     coll_ms, coll_ms / min(gate_ms)))
        print("multi_device DP NAND batch %d: %s ms/bit"
              % (b, report["dp_nand_ms_bit"]))
        print(json.dumps({"multi_device": report}))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    print("multi_device phase: %.1f s" % (time.time() - t0))


def k4_shards(dev, rng, tp, results):
    """K4's grids 1 and 2 on each shard of every split the kernel is built
    for (``lanes_step.KERNEL_SPLITS``: limbs 2- and 4-way where they divide
    G, slots 2-, 4- and 8-way), both forms, at the timing batch and the
    defaults, and at the variant shapes (mask1, l) = (3, 2) and (2, 3) at a
    ragged batch of 101; the shards' channels summed mod 2^32 (limbs) or
    stacked (slots) on the card, then grid 3: equal to the unsplit K4 step
    and its plain version."""
    import nufhe_tpu_torch as nft
    from nufhe_tpu_torch.numeric import wrap_i32
    from nufhe_tpu_torch.ops import lanes_step as k4
    shapes = [(2, 2, TIMING_BATCH, tp)] + [
        (mask1, l, 101, nft.NuFHEParameters(
            tlwe_mask_size=mask1 - 1, bs_decomp_length=l).tgsw_params)
        for mask1, l in VARIANT_SHAPES]
    for mask1, l, b, tgsw in shapes:
        kw = dict(offset=int(tgsw.offset), log2_base=tgsw.bs_log2_base)
        acc_q = random_acc(rng, b, dev, mask1).reshape(b, -1)
        p = random_powers(rng, (b,), dev)
        for mode in ("NTT", "FFT"):
            key_row = random_lanes_key(rng, 1, tgsw, dev, mode,
                                       mask1)[0][0].contiguous()
            whole = k4.lanes_step(acc_q, p, key_row, **kw)
            plain = k4.lanes_step_plain(acc_q, p, key_row, **kw)
            for split, ways in k4.KERNEL_SPLITS.items():
                for n in ways:
                    if n == 1 or (split == "limbs" and (mask1 * l) % n):
                        continue
                    axis = 1 if split == "limbs" else 0
                    width = key_row.shape[axis] // n
                    parts = [k4.lanes_mac_shard(
                        acc_q, p, key_row.narrow(axis, s * width,
                                                 width).contiguous(),
                        shard=s, n_shards=n, mode=split, **kw)
                        for s in range(n)]
                    if split == "limbs":
                        chan = wrap_i32(sum(c.to(torch.int64) for c in parts))
                    else:
                        chan = torch.stack(parts)
                    got = k4.lanes_inverse(acc_q, chan)
                    torch.cuda.synchronize()
                    label = ("K4 (mask1, l) = (%d, %d) %s, %d-way %s split, "
                             "shards combined on the card, batch %d"
                             % (mask1, l, mode, n, split, b))
                    record_err(results, "lanes_step",
                               label + " vs unsplit K4",
                               max_abs_err(got, whole))
                    record_err(results, "lanes_step", label + " vs plain",
                               max_abs_err(got, plain))
                    del parts, chan, got


def check_step_parts(nft, dev, rng, results):
    """K5: every stage part against its plain version, bit for bit, on one
    random exact key row, at batch 256 and at a ragged 101; the FULL step
    also against K1.  These launches are comparisons: the counts are set
    to 0 afterwards."""
    from nufhe_tpu_torch.ops import cmux, step_parts as sp
    tp = nft.NuFHEParameters().tgsw_params
    kw = dict(offset=int(tp.offset), log2_base=tp.bs_log2_base)
    key_row = random_key(rng, 1, tp, dev, "NTT")[0].contiguous()
    rows = rows_of(key_row, "NTT")
    for batch in (101, 256):
        acc, p = random_acc(rng, batch, dev), random_powers(rng, (batch,), dev)
        for name in sp.PARTS:
            got = sp.step_part(name, acc, p, rows, **kw)
            want = sp.step_part_plain(name, acc, p, key_row, **kw)
            torch.cuda.synchronize()
            record_err(results, "step_parts", "K5 %r vs plain, batch %d"
                       % (name, batch), max_abs_err(got, want))
        record_err(results, "step_parts", "K5 'FULL step' vs K1, batch %d"
                   % batch, max_abs_err(
                       sp.step_part("FULL step", acc, p, rows,
                                    **kw),
                       cmux.cmux_step(acc, p, rows, **kw)))
    reset_counts()


def step_row_bytes(mode):
    """Bytes of one step's int8 key limb rows at the default shape, which
    K1, K3 and their variants read (``ops/key_rows``): 196,608 exact,
    131,072 rounded."""
    from nufhe_tpu_torch.ops import key_rows as kr, step_parts as sp
    return sp.L * sp.G * sp.MASK1 * kr.rows_per_pair(mode == "FFT") * 64


def part_bound(name, batch, mode="NTT", rotates=False):
    """(bound ms, by) of one K5 part (K9's rotating forms: ``rotates``):
    acc in, its output out, the powers where it rotates, the key rows where
    it reads them, and the MAC's int8 operations where it runs the MAC."""
    from nufhe_tpu_torch.ops import step_parts as sp
    n_bytes = batch * 2 * 1024 * 4 + batch * sp.out_polys(name) * 1024 * 4
    if name in ("rotate", "rot+decomp", "FULL step") or rotates:
        n_bytes += batch * 4
    if name in ("dec+fwd+key", "dec+fwd+mac", "dec+fwd+mac+inv", "FULL step"):
        n_bytes += step_row_bytes(mode)
    macs = name in ("dec+fwd+mac", "dec+fwd+mac+inv", "FULL step")
    return bound_ms(n_bytes, mac_ops(batch, mode) if macs else 0,
                    INT8_OPS_PER_S)


def profile_bound(name, batch, mode):
    """(bound ms, by) of one K9 part: the accumulator in and out (and the
    powers) for the no-op and the rotation families, else its K5 part's."""
    from nufhe_tpu_torch.ops import step_profile as spf
    if name in spf.K5_PART:
        return part_bound(spf.K5_PART[name], batch, mode, rotates=True)
    rot = name in spf.FAMILY_MASKS
    return bound_ms(2 * batch * 2 * 1024 * 4 + (batch * 4 if rot else 0), 0)


def context_bound(batch, mode, steps):
    """(bound ms, by) of ``steps`` steps of K6's "FULL" variant (K3): the
    accumulator in and out, the steps' powers and key rows, and the MAC's
    int8 operations."""
    n_bytes = (2 * batch * 2 * 1024 * 4
               + steps * (batch * 4 + step_row_bytes(mode)))
    return bound_ms(n_bytes, steps * mac_ops(batch, mode), INT8_OPS_PER_S)


def step_parts_timing(dev, results, microbench, smi):
    """Phase ``step_parts``: ``tools/microbench_torch.py parts`` at 2^14,
    the microbenchmark's path, with the launch counts set to 0 just before
    it and read just after; then every part on the same inputs against its
    plain version, the FULL step's plain time, and each part's bound."""
    from nufhe_tpu_torch.ops import step_parts as sp
    b = TIMING_BATCH
    torch.cuda.synchronize()
    reset_counts()
    ms = microbench.bench_parts(b, dev)
    torch.cuda.synchronize()
    counts = read_counts()
    print("microbench parts, batch %d: launches %s" % (b, json.dumps(counts)))
    if not counts["step_parts"] or any(
            n for k, n in counts.items() if k != "step_parts"):
        raise AssertionError("microbench parts did not run on K5 alone")
    results["step_parts"]["launches"] = counts["step_parts"]
    acc, p, row, kw = microbench._setup(b, dev, exact=True)
    rows = rows_of(row, "NTT")
    plain = {}
    for name in sp.PARTS:
        got = sp.step_part(name, acc, p, rows, **kw)
        plain_out = []
        plain[name] = cuda_ms(lambda: plain_out.append(
            sp.step_part_plain(name, acc, p, row, **kw)), 1)
        record_err(results, "step_parts", "K5 %r vs plain, batch %d"
                   % (name, b), max_abs_err(got, plain_out[0]))
        del got, plain_out
    bounds = {name: part_bound(name, b) for name in sp.PARTS}
    bound, by = bounds["FULL step"]
    results["step_parts"].update(ms=ms["FULL step"],
                                 plain_ms=plain["FULL step"], bound_ms=bound,
                                 bound_by=by, library_ms=None)
    print(json.dumps({"step_parts": {
        name: {"ms": ms[name], "plain_ms": plain[name],
               "bound_ms": bounds[name][0], "bound_by": bounds[name][1]}
        for name in sp.PARTS}, "batch": b, "engine": "exact", "card": smi}))


def random_mac_inputs(rng, batch, dev):
    """K7's inputs: x (64, 256, batch) int32 in [-128, 256) and a random rhs
    in both forms."""
    from nufhe_tpu_torch.ops import mac_dot as md
    x = torch.from_numpy(rng.randint(-128, 256, (64, md.C, batch)).astype(
        np.int32)).to(dev)
    r8 = torch.from_numpy(rng.randint(-127, 128, (64, md.C, md.Q)).astype(
        np.int8)).to(dev)
    return x, {"int8": r8, "bf16": r8.to(torch.bfloat16)}


def check_step_experiments(nft, dev, rng, results):
    """K6-K9 against their plain versions, bit for bit, at batch 101 (a
    partial sample group or tile) and 256: K6 every variant in both key
    forms, 4 steps from step 2 of an 8-step key; K9 every part in both
    forms, its FULL step also against K1; K8 also against K1; K7 both
    forms, also at 16388 (the TMA path with a ragged tile) and with x at a
    4-byte offset (the masked path at an aligned batch).  These launches
    are comparisons: the counts are set to 0 afterwards."""
    from nufhe_tpu_torch.ops import (cmux, mac_dot as md, step_context as sc,
                                     step_overlap as so, step_profile as spf)
    tp = nft.NuFHEParameters().tgsw_params
    kw = dict(offset=int(tp.offset), log2_base=tp.bs_log2_base)
    for mode in ("NTT", "FFT"):
        key = random_key(rng, 8, tp, dev, mode)
        key_row = key[0].contiguous()
        rows = rows_of(key, mode)
        for batch in (101, 256):
            acc = random_acc(rng, batch, dev)
            bara_t = random_powers(rng, (8, batch), dev)
            for v in sc.VARIANTS:
                got = sc.step_context(v, acc, bara_t, rows, 2, CHECK_STEPS,
                                      **kw)
                want = sc.step_context_plain(v, acc, bara_t, key, 2,
                                             CHECK_STEPS, **kw)
                torch.cuda.synchronize()
                record_err(results, "step_context", "K6 %r %s vs plain, "
                           "batch %d" % (v, mode, batch),
                           max_abs_err(got, want))
            p = bara_t[0].contiguous()
            for name in spf.PARTS:
                got = spf.step_profile(name, acc, p, rows[0],
                                       **kw)
                want = spf.step_profile_plain(name, acc, p, key_row, **kw)
                torch.cuda.synchronize()
                record_err(results, "step_profile", "K9 %r %s vs plain, "
                           "batch %d" % (name, mode, batch),
                           max_abs_err(got, want))
            k1 = cmux.cmux_step(acc, p, rows[0], **kw)
            record_err(results, "step_profile", "K9 'FULL step' %s vs K1, "
                       "batch %d" % (mode, batch), max_abs_err(
                           spf.step_profile("FULL step", acc, p, rows[0],
                                            **kw), k1))
            if mode == "NTT":
                got = so.step_overlap(acc, p, rows[0], **kw)
                record_err(results, "step_overlap", "K8 vs plain, batch %d"
                           % batch, max_abs_err(got, so.step_overlap_plain(
                               acc, p, key_row, **kw)))
                record_err(results, "step_overlap", "K8 vs K1, batch %d"
                           % batch, max_abs_err(got, k1))
    for batch in (101, 256, TIMING_BATCH + 4, "256, x at a 4-byte offset"):
        if batch == "256, x at a 4-byte offset":        # the masked path
            x, rhs = random_mac_inputs(rng, 256, dev)
            x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape)
        else:
            x, rhs = random_mac_inputs(rng, batch, dev)
        for form in md.FORMS:
            got = md.mac_dot(x, rhs[form])
            want = md.mac_dot_plain(x, rhs[form])
            torch.cuda.synchronize()
            record_err(results, "mac_dot", "K7 %s vs plain, batch %s"
                       % (form, batch), max_abs_err(got, want))
            del got, want
    reset_counts()


def timed_plain(fn):
    """(output, ms) of one call of a plain version on the card."""
    out = []
    ms = cuda_ms(lambda: out.append(fn()), 1)
    return out[0], ms


def tool_counts(label, kernel, run):
    """``run()`` (a tool's mode) with the launch counts set to 0 just before
    it and read just after; raises if ``kernel`` did not run.  Returns
    (run's result, counts)."""
    torch.cuda.synchronize()
    reset_counts()
    res = run()
    torch.cuda.synchronize()
    counts = read_counts()
    print("%s: launches %s" % (label, json.dumps(counts)))
    if not counts[kernel]:
        raise AssertionError("%s did not run %s" % (label, kernel))
    return res, counts


def context_phase(dev, results, e4, smi):
    """T3 on K6 at 2^14, both engines: "FULL" at 100 steps against two K3
    launches of 50; every variant at 4 steps against its plain version
    (timed, as the FULL variant's kernel is, for the ``kernels`` line);
    then ``tools/exp_round4_torch.py context`` (100 steps a launch)."""
    from nufhe_tpu_torch.ops import blind_rotate as brc, step_context as sc
    b = TIMING_BATCH
    line = {}
    for mode in ("NTT", "FFT"):
        acc, bara_t, key, kw = e4.context_inputs(b, dev, CONTEXT_STEPS,
                                                 mode == "NTT")
        rows = rows_of(key, mode)
        got = sc.step_context("FULL", acc, bara_t, rows, 0, CONTEXT_STEPS,
                              **kw)
        by_k3 = acc
        for start in range(0, CONTEXT_STEPS, CHUNK):
            by_k3 = brc.blind_rotate_chunk(by_k3, bara_t, rows, start, CHUNK,
                                           **kw)
        record_err(results, "step_context", "K6 'FULL' %s, %d steps in one "
                   "launch, vs %d K3 launches of %d, batch %d"
                   % (mode, CONTEXT_STEPS, CONTEXT_STEPS // CHUNK, CHUNK, b),
                   max_abs_err(got, by_k3))
        del got, by_k3
        plain = {}
        for v in sc.VARIANTS:
            got = sc.step_context(v, acc, bara_t, rows, 0, CHECK_STEPS, **kw)
            want, plain[v] = timed_plain(lambda: sc.step_context_plain(
                v, acc, bara_t, key, 0, CHECK_STEPS, **kw))
            record_err(results, "step_context", "K6 %r %s vs plain, %d "
                       "steps, batch %d" % (v, mode, CHECK_STEPS, b),
                       max_abs_err(got, want))
            del got, want
        ms_check = cuda_ms(lambda: sc.step_context(
            "FULL", acc, bara_t, rows, 0, CHECK_STEPS, **kw), 5)
        per_step, counts = tool_counts(
            "exp_round4_torch context %s, batch %d" % (mode, b),
            "step_context", lambda: e4.context(b, dev, n_steps=CONTEXT_STEPS,
                                               exact=mode == "NTT"))
        bound, by = context_bound(b, mode, CHECK_STEPS)
        step_bound = context_bound(b, mode, 1)[0]
        line[mode] = {
            "ms_per_step": per_step,
            "stage_cost": {v: per_step["FULL"] - t
                           for v, t in per_step.items() if v != "FULL"},
            "bound_ms_per_step": step_bound,
            "check_steps": CHECK_STEPS, "check_ms": ms_check,
            "check_plain_ms": plain, "check_bound_ms": bound}
        if mode == "NTT":
            results["step_context"].update(
                launches=counts["step_context"], ms=ms_check,
                plain_ms=plain["FULL"], bound_ms=bound, bound_by=by,
                library_ms=None)
    print(json.dumps({"step_context": line, "batch": b,
                      "steps": CONTEXT_STEPS, "card": smi}))


def profile_phase(dev, results, microbench, e4, smi):
    """T2 on K9 at 2^14, both engines: every part against its plain
    version (the FULL step also against K1), then
    ``tools/exp_round4_torch.py profile``; each part's bound."""
    from nufhe_tpu_torch.ops import cmux, step_profile as spf
    b = TIMING_BATCH
    line = {}
    for mode in ("NTT", "FFT"):
        acc, p, row, kw = microbench._setup(b, dev, exact=mode == "NTT")
        rows = rows_of(row, mode)
        plain = {}
        for name in spf.PARTS:
            got = spf.step_profile(name, acc, p, rows, **kw)
            want, plain[name] = timed_plain(lambda: spf.step_profile_plain(
                name, acc, p, row, **kw))
            record_err(results, "step_profile", "K9 %r %s vs plain, batch %d"
                       % (name, mode, b), max_abs_err(got, want))
            del want
        record_err(results, "step_profile", "K9 'FULL step' %s vs K1, batch "
                   "%d" % (mode, b), max_abs_err(
                       got, cmux.cmux_step(acc, p, rows, **kw)))
        ms, counts = tool_counts(
            "exp_round4_torch profile %s, batch %d" % (mode, b),
            "step_profile", lambda: e4.profile(b, dev, exact=mode == "NTT"))
        bounds = {name: profile_bound(name, b, mode) for name in spf.PARTS}
        line[mode] = {name: {"ms": ms[name], "plain_ms": plain[name],
                             "bound_ms": bounds[name][0],
                             "bound_by": bounds[name][1]}
                      for name in spf.PARTS}
        if mode == "NTT":
            results["step_profile"].update(
                launches=counts["step_profile"], ms=ms["FULL step"],
                plain_ms=plain["FULL step"],
                bound_ms=bounds["FULL step"][0],
                bound_by=bounds["FULL step"][1], library_ms=None)
    print(json.dumps({"step_profile": line, "batch": b, "card": smi}))


def mac_dot_phase(dev, results, e8, smi):
    """T7 on K7 at 2^14: both forms on the tool's inputs against their plain
    versions, then ``tools/exp_int8_torch.py`` (chained calls, and the
    library's products alone beside them); each form's bound."""
    from nufhe_tpu_torch.ops import mac_dot as md
    b = TIMING_BATCH
    rhs, x = e8.inputs(b, dev)
    plain = {}
    for form in md.FORMS:
        got = md.mac_dot(x, rhs[form])
        want, plain[form] = timed_plain(lambda: md.mac_dot_plain(x, rhs[form]))
        record_err(results, "mac_dot", "K7 %s vs plain, batch %d"
                   % (form, b), max_abs_err(got, want))
        del got, want
    res, counts = tool_counts("exp_int8_torch, batch %d" % b, "mac_dot",
                              lambda: e8.run(b, dev))
    line = {}
    for form in md.FORMS:
        if not res[form]["exact"]:
            raise AssertionError("exp_int8_torch: %s not exact" % form)
        n_bytes = 2 * x.numel() * 4 + rhs[form].numel() * rhs[
            form].element_size()
        bound, by = bound_ms(n_bytes, 2 * 64 * md.C * md.Q * b,
                             INT8_OPS_PER_S if form == "int8"
                             else BF16_OPS_PER_S)
        line[form] = dict(ms=res[form]["ms"], plain_ms=plain[form],
                          bound_ms=bound, bound_by=by,
                          library_ms=res[form]["library_ms"],
                          tops=res[form]["tops"])
    results["mac_dot"].update(launches=counts["mac_dot"], forms=line,
                              **{k: line["int8"][k] for k in (
                                  "ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")})
    print(json.dumps({"mac_dot": line, "batch": b, "card": smi}))


def overlap_phase(dev, results, microbench, eo, smi):
    """T9 on K8 at 2^14: against its plain version and K1, then
    ``tools/exp_overlap_torch.py`` (serial K1 and split K8)."""
    from nufhe_tpu_torch.ops import cmux, step_overlap as so
    b = TIMING_BATCH
    acc, p, row, kw = microbench._setup(b, dev, exact=True)
    rows = rows_of(row, "NTT")
    got = so.step_overlap(acc, p, rows, **kw)
    want, plain = timed_plain(lambda: so.step_overlap_plain(acc, p, row,
                                                            **kw))
    record_err(results, "step_overlap", "K8 vs plain, batch %d" % b,
               max_abs_err(got, want))
    record_err(results, "step_overlap", "K8 vs K1, batch %d" % b,
               max_abs_err(got, cmux.cmux_step(acc, p, rows, **kw)))
    del got, want
    res, counts = tool_counts("exp_overlap_torch, batch %d" % b,
                              "step_overlap", lambda: eo.run(b, dev))
    if not res["exact"]:
        raise AssertionError("exp_overlap_torch: split not exact")
    bound, by = part_bound("FULL step", b)
    results["step_overlap"].update(launches=counts["step_overlap"],
                                   ms=res["split"], plain_ms=plain,
                                   bound_ms=bound, bound_by=by,
                                   library_ms=None)
    print(json.dumps({"step_overlap": {
        "serial_ms": res["serial"], "split_ms": res["split"],
        "plain_ms": plain, "bound_ms": bound, "bound_by": by},
        "batch": b, "card": smi}))


def step_experiments(dev, results, microbench, smi):
    """Phase ``step_experiments``: T3, T2, T7 and T9 (K6-K9) at 2^14."""
    import exp_int8_torch as e8
    import exp_overlap_torch as eo
    import exp_round4_torch as e4
    t0 = time.time()
    context_phase(dev, results, e4, smi)
    profile_phase(dev, results, microbench, e4, smi)
    mac_dot_phase(dev, results, e8, smi)
    overlap_phase(dev, results, microbench, eo, smi)
    print("step_experiments phase: %.1f s" % (time.time() - t0))


def check_step_variants(nft, dev, rng, results):
    """K10-K13 against their plain versions, bit for bit, at batch 101 (a
    partial sample group) and 256: K10 every schedule in both key forms
    (also against K1), K11 every variant and K12 every form in both forms,
    3 steps from step 1 of a 4-step key (also against K3 on the same steps,
    t8 and t8+t9 on the evened powers), K13 every probe.  These launches
    are comparisons: the counts are set to 0 afterwards."""
    from nufhe_tpu_torch.ops import (blind_rotate as brc, cmux,
                                     inverse_probe as ip, rotate_forms as rf,
                                     step_schedules as ss, step_tricks as st)
    t0 = time.time()
    tp = nft.NuFHEParameters().tgsw_params
    kw = dict(offset=int(tp.offset), log2_base=tp.bs_log2_base)
    for mode in ("NTT", "FFT"):
        key = random_key(rng, 4, tp, dev, mode)
        key_row = key[0].contiguous()
        rows = rows_of(key, mode)
        for batch in (101, 256):
            acc = random_acc(rng, batch, dev)
            bara_t = random_powers(rng, (4, batch), dev)
            p = bara_t[0].contiguous()
            k1 = cmux.cmux_step(acc, p, rows[0], **kw)
            for name in ss.SCHEDULES:
                got = ss.step_schedule(name, acc, p, rows[0],
                                       **kw)
                record_err(results, "step_schedules", "K10 %r %s vs plain, "
                           "batch %d" % (name, mode, batch), max_abs_err(
                               got, ss.step_schedule_plain(name, acc, p,
                                                           key_row, **kw)))
                record_err(results, "step_schedules", "K10 %r %s vs K1, "
                           "batch %d" % (name, mode, batch),
                           max_abs_err(got, k1))
            k3 = {even: brc.blind_rotate_chunk(
                acc, st.even_powers(bara_t) if even else bara_t, rows, 1, 3,
                **kw) for even in (False, True)}
            for name in st.VARIANTS:
                got = st.step_trick(name, acc, bara_t, rows, 1, 3,
                                    **kw)
                record_err(results, "step_tricks", "K11 %r %s vs plain, "
                           "batch %d" % (name, mode, batch), max_abs_err(
                               got, st.step_trick_plain(name, acc, bara_t,
                                                        key, 1, 3, **kw)))
                record_err(results, "step_tricks", "K11 %r %s vs K3, batch "
                           "%d" % (name, mode, batch),
                           max_abs_err(got, k3[name in st.EVEN]))
            for form in rf.FORMS:
                got = rf.rotate_form(form, acc, bara_t, rows, 1, 3,
                                     **kw)
                record_err(results, "rotate_forms", "K12 %r %s vs plain, "
                           "batch %d" % (form, mode, batch), max_abs_err(
                               got, rf.rotate_form_plain(form, acc, bara_t,
                                                         key, 1, 3, **kw)))
                record_err(results, "rotate_forms", "K12 %r %s vs K3, batch "
                           "%d" % (form, mode, batch),
                           max_abs_err(got, k3[False]))
    for batch in (101, 256):
        a = torch.from_numpy(rng.randint(-2**31, 2**31, (batch, ip.ROWS))
                             .astype(np.int32)).to(dev)
        for name in ip.PROBES:
            record_err(results, "inverse_probe", "K13 %r vs plain, batch %d"
                       % (name, batch), max_abs_err(
                           ip.inverse_probe(name, a),
                           ip.inverse_probe_plain(name, a)))
    reset_counts()
    print("check_step_variants: %.1f s" % (time.time() - t0))


def schedules_phase(dev, results, microbench, e3, smi):
    """T5 on K10 at 2^14, both engines: every schedule bit-equal to K1 and
    the default one ("v3") to its plain version (timed), then
    ``tools/exp_round3_torch.py`` (ms a launch and ms/bit)."""
    from nufhe_tpu_torch.ops import cmux, step_schedules as ss
    b = TIMING_BATCH
    line = {}
    for mode in ("NTT", "FFT"):
        acc, p, row, kw = microbench._setup(b, dev, exact=mode == "NTT")
        rows = rows_of(row, mode)
        k1 = cmux.cmux_step(acc, p, rows, **kw)
        for name in ss.SCHEDULES:
            record_err(results, "step_schedules", "K10 %r %s vs K1, batch %d"
                       % (name, mode, b), max_abs_err(
                           ss.step_schedule(name, acc, p, rows,
                                            **kw), k1))
        want, plain = timed_plain(lambda: ss.step_schedule_plain(
            "v3", acc, p, row, **kw))
        record_err(results, "step_schedules", "K10 'v3' %s vs plain, batch "
                   "%d" % (mode, b), max_abs_err(k1, want))
        del k1, want
        res, counts = tool_counts(
            "exp_round3_torch %s, batch %d" % (mode, b), "step_schedules",
            lambda: e3.run(b, dev, exact=mode == "NTT"))
        bound, by = part_bound("FULL step", b, mode)
        line[mode] = {"schedules": res, "plain_ms_v3": plain,
                      "bound_ms": bound, "bound_by": by}
        if mode == "NTT":
            results["step_schedules"].update(
                launches=counts["step_schedules"], ms=res["v3"]["ms"],
                plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=None)
    print(json.dumps({"step_schedules": line, "batch": b, "card": smi}))


def chunk_variants_phase(dev, results, e4, kernel, label, variants, even,
                         run_one, run_plain, run_tool, smi):
    """T4 on K11 or T6 on K12 at 2^14, both engines: every variant at 100
    steps in one launch bit-equal to one K3 launch of 100 steps (those in
    ``even`` on the evened powers), the first at CHECK_STEPS steps against
    its plain version (timed, for the ``kernels`` line), then the tool."""
    from nufhe_tpu_torch.ops import blind_rotate as brc, step_tricks as st
    b = TIMING_BATCH
    line = {}
    for mode in ("NTT", "FFT"):
        acc, bara_t, key, kw = e4.context_inputs(b, dev, CONTEXT_STEPS,
                                                 mode == "NTT")
        rows = rows_of(key, mode)
        k3 = {}
        for v in variants:
            if (v in even) not in k3:
                k3[v in even] = brc.blind_rotate_chunk(
                    acc, st.even_powers(bara_t) if v in even else bara_t,
                    rows, 0, CONTEXT_STEPS, **kw)
            record_err(results, kernel, "%s %r %s, %d steps in one launch, "
                       "vs one K3 launch, batch %d" % (label, v, mode,
                                                      CONTEXT_STEPS, b),
                       max_abs_err(run_one(v, acc, bara_t, rows, 0,
                                           CONTEXT_STEPS, **kw),
                                   k3[v in even]))
        del k3
        first = variants[0]
        got = run_one(first, acc, bara_t, rows, 0, CHECK_STEPS,
                      **kw)
        want, plain = timed_plain(lambda: run_plain(
            first, acc, bara_t, key, 0, CHECK_STEPS, **kw))
        record_err(results, kernel, "%s %r %s vs plain, %d steps, batch %d"
                   % (label, first, mode, CHECK_STEPS, b),
                   max_abs_err(got, want))
        del got, want
        ms_check = cuda_ms(lambda: run_one(first, acc, bara_t, rows, 0,
                                           CHECK_STEPS, **kw), 5)
        res, counts = tool_counts("%s %s, batch %d" % (label, mode, b),
                                  kernel, lambda: run_tool(mode))
        bound, by = context_bound(b, mode, CHECK_STEPS)
        line[mode] = {"ms_per_step": {k: r["ms_per_step"]
                                      for k, r in res.items()},
                      "bound_ms_per_step": context_bound(b, mode, 1)[0],
                      "check_variant": first, "check_steps": CHECK_STEPS,
                      "check_ms": ms_check, "check_plain_ms": plain,
                      "check_bound_ms": bound}
        if mode == "NTT":
            results[kernel].update(launches=counts[kernel], ms=ms_check,
                                   plain_ms=plain, bound_ms=bound,
                                   bound_by=by, library_ms=None)
    print(json.dumps({kernel: line, "batch": b, "steps": CONTEXT_STEPS,
                      "card": smi}))


def probe_phase(dev, results, ei, smi):
    """T8 on K13 at 2^14: every probe against its plain version on the
    tool's input (the plain "sliced" timed), then
    ``tools/exp_inverse_torch.py``."""
    from nufhe_tpu_torch.ops import inverse_probe as ip
    b = TIMING_BATCH
    a = ei.inputs(b, dev)
    plain = {}
    for name in ip.PROBES:
        got = ip.inverse_probe(name, a)
        want, plain[name] = timed_plain(lambda: ip.inverse_probe_plain(name,
                                                                       a))
        record_err(results, "inverse_probe", "K13 %r vs plain, batch %d"
                   % (name, b), max_abs_err(got, want))
        del got, want
    res, counts = tool_counts("exp_inverse_torch, batch %d" % b,
                              "inverse_probe", lambda: ei.run(b, dev))
    if not res["sliced_exact"]:
        raise AssertionError("exp_inverse_torch: sliced is not base")
    bound, by = bound_ms(2 * a.numel() * 4, 0)
    results["inverse_probe"].update(launches=counts["inverse_probe"],
                                    ms=res["ms"]["sliced"],
                                    plain_ms=plain["sliced"], bound_ms=bound,
                                    bound_by=by, library_ms=None)
    print(json.dumps({"inverse_probe": {
        name: {"ms": res["ms"][name], "plain_ms": plain[name]}
        for name in ip.PROBES}, "bound_ms": bound, "bound_by": by,
        "batch": b, "card": smi}))


def step_variants(dev, results, microbench, smi):
    """Phase ``step_variants``: T5, T4, T6 and T8 (K10-K13) at 2^14."""
    import exp_inverse_torch as ei
    import exp_round3_torch as e3
    import exp_round4_torch as e4
    import exp_round5_torch as e5
    from nufhe_tpu_torch.ops import rotate_forms as rf, step_tricks as st
    t0 = time.time()
    schedules_phase(dev, results, microbench, e3, smi)
    print("step_variants: T5 %.1f s" % (time.time() - t0))
    t1 = time.time()
    chunk_variants_phase(
        dev, results, e4, "step_tricks", "K11", st.VARIANTS, st.EVEN,
        st.step_trick, st.step_trick_plain,
        lambda mode: e4.tricks(TIMING_BATCH, dev, n_steps=CONTEXT_STEPS,
                               exact=mode == "NTT"), smi)
    print("step_variants: T4 %.1f s" % (time.time() - t1))
    t1 = time.time()
    chunk_variants_phase(
        dev, results, e4, "rotate_forms", "K12", rf.FORMS, (),
        rf.rotate_form, rf.rotate_form_plain,
        lambda mode: e5.main(TIMING_BATCH, dev, n_steps=CONTEXT_STEPS,
                             exact=mode == "NTT"), smi)
    print("step_variants: T6 %.1f s" % (time.time() - t1))
    t1 = time.time()
    probe_phase(dev, results, ei, smi)
    print("step_variants: T8 %.1f s" % (time.time() - t1))
    print("step_variants phase: %.1f s" % (time.time() - t0))


def microbench_phase(dev, microbench, smi):
    """Phase ``microbench``: ``rotation`` at 2^14 in both engines (100 K1
    launches against K3 at chunks 10, 25 and 50, each chunked rotation
    equal to the per-step one) and ``keyswitch`` at 2^14."""
    b = TIMING_BATCH
    t0 = time.time()
    out = {}
    for mode in ("NTT", "FFT"):
        torch.cuda.synchronize()
        reset_counts()
        res = microbench.bench_rotation(b, dev, n_steps=100,
                                        chunks=(10, 25, 50),
                                        exact=mode == "NTT")
        counts = read_counts()
        if not (counts["cmux_step"] and counts["blind_rotate_chunk"]):
            raise AssertionError("rotation did not run K1 and K3")
        out["rotation " + mode] = {str(k): v for k, v in res.items()}
    reset_counts()
    out["keyswitch"] = microbench.bench_keyswitch(b, dev)
    if not read_counts()["keyswitch"]:
        raise AssertionError("keyswitch did not run K2")
    print(json.dumps({"microbench": out, "batch": b, "steps": 100,
                      "card": smi}))
    print("microbench phase: %.1f s" % (time.time() - t0))


def oracle_worker(seed):
    """The host half of phase ``oracle``, in a worker process: the n=500
    keys of ``DeterministicRNG(SEED)`` made on the host (equal to the
    card's, phase 4), ``ORACLE_INPUTS`` encrypted pairs of bits, and
    ``ref/bootstrap_ref.bootstrap`` of their NAND's linear part in both
    modes (numpy).  Returns numpy arrays only."""
    import nufhe_tpu_torch as nft
    from nufhe_tpu_torch.numeric import phase_to_t32
    from nufhe_tpu_torch.ref import bootstrap_ref
    secret, cloud = nft.make_key_pair(nft.DeterministicRNG(SEED),
                                      on_device=False, lwe_size=N_LWE)
    bits = np.random.RandomState(seed).randint(0, 2, (2, ORACLE_INPUTS)
                                               ).astype(bool)
    crng = nft.DeterministicRNG(seed)
    cx, cy = (nft.encrypt(crng, secret, v, device="cpu") for v in bits)
    lin_a, lin_b = (t.numpy() for t in nand_linear(cx, cy))
    bk, ks = cloud.bootstrap_key, cloud.keyswitch_key
    out = dict(bits=bits, secret=secret.dumps(),
               cx=[t.numpy() for t in (cx.a, cx.b, cx.current_variances)],
               cy=[t.numpy() for t in (cy.a, cy.b, cy.current_variances)])
    for mode, coarse in (("NTT", 0), ("FFT", 0), ("NTT", COARSE_BITS)):
        params = nft.NuFHEParameters(lwe_size=N_LWE, transform_type=mode)
        t0 = time.time()
        res = bootstrap_ref.bootstrap(
            lin_a, lin_b, bk.bk_coeff, (ks.ks_a, ks.ks_b, ks.ks_cv),
            phase_to_t32(1, 8), params.tgsw_params,
            (params.ks_decomp_length, params.ks_log2_base),
            exact=mode == "NTT", coarse_phase_bits=coarse)
        out["coarse" if coarse else mode] = (res, time.time() - t0)
    return out


def oracle_phase(nft, dev, secret, cloud, cloud_fft, oracle_job):
    """Phase ``oracle``: the worker's inputs on the card through NAND on
    the default path (K3 + K2), the per-step path (K1 + K2) and the lanes
    path (K4 + K2), both modes, each with its launch counts; a and b equal
    the numpy oracle's bit for bit and cv agrees within
    ``utils.errors_allclose``; then the default NAND with
    ``coarse_phase_bits=1`` against ``bootstrap_ref.bootstrap(...,
    coarse_phase_bits=1)`` the same way."""
    from nufhe_tpu_torch.utils import errors_allclose
    t0 = time.time()
    host = oracle_job.get()
    print("oracle: joined the worker after %.1f s of waiting; its n=500 "
          "bootstraps of %d inputs took %.1f s ('NTT') and %.1f s ('FFT')"
          % (time.time() - t0, ORACLE_INPUTS, host["NTT"][1], host["FFT"][1]))
    if host["secret"] != secret.dumps():
        raise AssertionError("the oracle's host keys are not the card's")
    cx, cy = (nft.LweSampleArray(cloud.params.in_out_params,
                                 *(torch.from_numpy(x).to(dev) for x in arrs))
              for arrs in (host["cx"], host["cy"]))
    want_bits = ~(host["bits"][0] & host["bits"][1])
    none = dict.fromkeys(KERNEL_NAMES, 0)
    n_chunks = N_LWE // CHUNK
    paths = (
        ("default", None, dict(none, blind_rotate_chunk=n_chunks,
                               keyswitch=1)),
        ("per-step", nft.PerformanceParameters(chunk_steps=1),
         dict(none, cmux_step=N_LWE, keyswitch=1)),
        ("lanes", nft.PerformanceParameters(single_kernel_bootstrap=False),
         dict(none, lanes_step=N_LWE, keyswitch=1)))
    for mode, c in (("NTT", cloud), ("FFT", cloud_fft)):
        want_a, want_b, want_cv = host[mode][0]
        for path, perf, expect in paths:
            label = "oracle %s %s path" % (mode, path)
            out, _ = run_gate(nft, label, secret,
                              nft.VirtualMachine(c, perf, device=dev),
                              "gate_nand", (cx, cy), want_bits, expect)
            same = (np.array_equal(out.a.cpu().numpy(), want_a)
                    and np.array_equal(out.b.cpu().numpy(), want_b))
            close = errors_allclose(out.current_variances, want_cv)
            print("%s: a, b vs ref/bootstrap_ref.bootstrap on %d inputs at "
                  "n=%d: %s; cv %s" % (label, ORACLE_INPUTS, N_LWE,
                                       "bit-equal" if same else "DIFFERENT",
                                       "allclose" if close else "DIFFERENT"))
            if not (same and close):
                raise AssertionError("%s differs from the oracle" % label)
    # the default NAND with the coarse modulus switch (even rotation
    # amounts, the ones K11's t8 prices) against the oracle's
    t0 = time.time()
    want_a, want_b, want_cv = host["coarse"][0]
    label = "oracle NTT default path, coarse_phase_bits=%d" % COARSE_BITS
    out, _ = run_gate(nft, label, secret, nft.VirtualMachine(
        cloud, nft.PerformanceParameters(coarse_phase_bits=COARSE_BITS),
        device=dev), "gate_nand", (cx, cy), want_bits, paths[0][2])
    same = (np.array_equal(out.a.cpu().numpy(), want_a)
            and np.array_equal(out.b.cpu().numpy(), want_b))
    close = errors_allclose(out.current_variances, want_cv)
    print("%s: a, b vs ref/bootstrap_ref.bootstrap(coarse_phase_bits=%d) on "
          "%d inputs at n=%d: %s; cv %s (its oracle %.1f s, the check %.1f s)"
          % (label, COARSE_BITS, ORACLE_INPUTS, N_LWE,
             "bit-equal" if same else "DIFFERENT",
             "allclose" if close else "DIFFERENT", host["coarse"][1],
             time.time() - t0))
    if not (same and close):
        raise AssertionError("%s differs from the oracle" % label)


def native_keygen(nft, dev, cloud):
    """Phase ``native_keygen``: the host C++ transform and limb split
    (``native.py``) must load; the host keygen of the card's seed, its
    limbs and its rows key through it, each timed beside the numpy oracle
    and equal to it and to the card-made key."""
    from nufhe_tpu_torch import native
    from nufhe_tpu_torch.ops import transform as tf
    from nufhe_tpu_torch.ref import transform_ref as tr
    t0 = time.time()
    if not native.available():
        raise AssertionError("native.available() is false on the card's host")
    t_build = time.time() - t0
    (_, h_cloud), t_keygen = synced(lambda: nft.make_key_pair(
        nft.DeterministicRNG(SEED), on_device=False, lwe_size=N_LWE))
    bk = h_cloud.bootstrap_key
    coeff = bk.bk_coeff
    t0 = time.time()
    limbs = bk.limbs()
    t_limbs = time.time() - t0
    t0 = time.time()
    hat_np = tr.forward(coeff)
    t_fwd_np = time.time() - t0
    limbs_np = tf.key_limbs_host(hat_np, exact=True).reshape(limbs.shape)
    t_limbs_np = time.time() - t0
    t0 = time.time()
    hat = native.forward_u64(coeff)
    t_fwd = time.time() - t0
    check_equal("native forward_u64 vs numpy forward", hat, hat_np)
    check_equal("native key limbs vs numpy", limbs, limbs_np)
    rows, t_rows = synced(lambda: bk.device(dev))
    check_equal("host rows key (native) vs card-made key", rows,
                cloud.bootstrap_key.device(dev))
    check_equal("host compact limbs (native) vs card-made key",
                bk.compact()[0], cloud.bootstrap_key.compact()[0])
    print("native_keygen (n=%d): library loaded in %.3f s; host keygen "
          "make_key_pair(on_device=False) %.3f s; "
          "key limbs %.3f s native vs %.3f s numpy; forward transform %.3f s "
          "native vs %.3f s numpy; rows key with upload %.3f s"
          % (N_LWE, t_build, t_keygen, t_limbs,
             t_limbs_np, t_fwd, t_fwd_np, t_rows))


def run_examples():
    """Phase ``examples``: each ``examples/*_torch.py`` of the five in a
    process of its own, on the card; it must exit 0 and print its OK
    line."""
    root = os.path.dirname(os.path.abspath(__file__))
    for name in EXAMPLES:
        t0 = time.time()
        proc = subprocess.run([sys.executable, os.path.join(root, "examples",
                                                            name)],
                              capture_output=True, text=True, timeout=300)
        lines = proc.stdout.strip().splitlines()
        last = lines[-1] if lines else ""
        print("example %s: exit %d in %.1f s: %s"
              % (name, proc.returncode, time.time() - t0, last))
        if proc.returncode != 0 or not last.endswith("OK"):
            raise AssertionError("example %s failed:\n%s\n%s"
                                 % (name, proc.stdout, proc.stderr))


def bench_ports(smi):
    """Phase ``bench_ports``: ``bench_torch.py``'s six cells
    (``tools/bench_cells_torch.py``) at RUNS 1, INNER 2, each a process of
    its own (its launch counts set to 0 just before its timed chains and
    read just after), and ``bench_scaling_torch.py`` on one card; each
    must be correct, with a measured idle share in [0, 1] and 10 K3 + 1 K2
    launches a gate call (500 K4 + 1 K2 on the scaling path)."""
    import bench_cells_torch as cells
    torch.cuda.empty_cache()
    want = {"blind_rotate_chunk": N_LWE // CHUNK, "keyswitch": 1}
    report = {}
    for name in cells.CELLS:
        t0 = time.time()
        out = cells.run_cell(name, {"NUFHE_BENCH_RUNS": "1",
                                    "NUFHE_BENCH_INNER": "2"}, timeout=300)
        metric, d = out["metric"], out["detail"]
        idle = d["device_idle_share"]
        if set(metric) != {"metric", "value", "unit", "vs_baseline"}:
            raise AssertionError("bench_torch %s: metric keys %s"
                                 % (name, sorted(metric)))
        if d["correct"] is not True:
            raise AssertionError("bench_torch %s: the chain decrypts wrong"
                                 % name)
        if not (isinstance(idle, float) and 0.0 <= idle <= 1.0):
            raise AssertionError("bench_torch %s: idle share %r"
                                 % (name, idle))
        if d["launches_per_call"] != want:
            raise AssertionError("bench_torch %s: launches a call %s, not %s"
                                 % (name, d["launches_per_call"], want))
        report[name] = {
            "metric": metric["metric"], "ms_bit": metric["value"],
            "correct": d["correct"], "max_noise_frac": d["max_noise_frac"],
            "idle_share": idle, "launches_per_call": d["launches_per_call"],
            "kernels_per_call": d["kernels_per_call"],
            "peak_memory_bytes": d["peak_memory_bytes"],
            "nvcc_s": d["nvcc_s"], "seconds": round(time.time() - t0, 1)}
        print("bench_torch %s: %s = %s, idle share %.4f, correct, %.1f s"
              % (name, metric["metric"], metric["value"], idle,
                 report[name]["seconds"]))
    t0 = time.time()
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "bench_scaling_torch.py"),
         "--devices", "1"], cwd=root, capture_output=True, text=True,
        timeout=300)
    if proc.returncode != 0:
        raise AssertionError("bench_scaling_torch.py failed (rc %d):\n%s"
                             % (proc.returncode, proc.stderr[-3000:]))
    line = cells.last_json(proc.stderr)
    summary = cells.last_json(proc.stdout)
    if not (line["bit_exact"] and line["launches_per_call"]
            == {"lanes_step": N_LWE, "keyswitch": 1}):
        raise AssertionError("bench_scaling_torch.py: %s" % line)
    line["seconds"] = round(time.time() - t0, 1)
    report["scaling_1_card"] = dict(line, summary=summary)
    print(json.dumps({"bench_ports": report, "card": smi}))


def build_kernels():
    from nufhe_tpu_torch.kernels import build
    t0 = time.time()
    build.build_all()
    print("kernels built in %.1f s" % (time.time() - t0))
    for name in build.KERNELS:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print("  %s: %s" % (name, line.strip()))


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    sys.path.append(os.path.join(root, "tools"))
    shapes = argv[:1] == ["--shapes"]
    if shapes and len(argv) > 1:        # another tree's package first
        sys.path.insert(0, os.path.abspath(argv[1]))
    import nufhe_tpu_torch as nft
    from bench_torch import nvidia_smi_line

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    print("card (name, power limit): %s" % smi)
    print("python %s, torch %s, CUDA %s" % (sys.version.split()[0],
                                            torch.__version__,
                                            torch.version.cuda))
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(SEED)
    if shapes:
        results = {}
        k3_shape_times(nft, dev, rng, results)
        print(json.dumps({"k3_shapes": list(results.values()),
                          "package": os.path.dirname(nft.__file__),
                          "card": smi}))
        return 0
    # the oracle's n=500 bootstraps (host numpy) overlap the card phases
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        oracle_job = pool.apply_async(oracle_worker, (SEED + 3,))
        return smoke(nft, smi, dev, rng, oracle_job)
    finally:
        pool.terminate()
        pool.join()


def smoke(nft, smi, dev, rng, oracle_job):
    build_kernels()

    results = {
        "cmux_step": dict(
            name="cmux_step", route="cuda",
            source="nufhe_tpu_torch/kernels/csrc/cmux_step.cu",
            replaces="nufhe_tpu/ops/pallas/blind_rotate.py:39"),
        "keyswitch": dict(
            name="keyswitch", route="cuda",
            source="nufhe_tpu_torch/kernels/csrc/keyswitch.cu",
            replaces="nufhe_tpu/ops/pallas/keyswitch.py:27"),
        "blind_rotate_chunk": dict(
            name="blind_rotate_chunk", route="cuda",
            source="nufhe_tpu_torch/kernels/csrc/blind_rotate_chunk.cu",
            replaces="nufhe_tpu/ops/pallas/blind_rotate.py:83"),
        "lanes_step": dict(
            name="lanes_step", route="cuda",
            source="nufhe_tpu_torch/kernels/csrc/lanes_step.cu",
            replaces="nufhe_tpu/ops/pallas/blind_rotate.py:175"),
        "step_parts": dict(
            name="step_parts", route="cuda",
            source="nufhe_tpu_torch/kernels/csrc/step_parts.cu",
            replaces="tools/microbench.py:128"),
        "step_context": dict(
            name="step_context", route="cuda",
            source="nufhe_tpu_torch/kernels/csrc/step_context.cu",
            replaces="tools/exp_round4.py:208"),
        "mac_dot": dict(
            name="mac_dot", route="cuda",
            source="nufhe_tpu_torch/kernels/csrc/mac_dot.cu",
            replaces="tools/exp_int8.py:50"),
        "step_overlap": dict(
            name="step_overlap", route="cuda",
            source="nufhe_tpu_torch/kernels/csrc/step_overlap.cu",
            replaces="tools/exp_overlap.py:118"),
        "step_profile": dict(
            name="step_profile", route="cuda",
            source="nufhe_tpu_torch/kernels/csrc/step_profile.cu",
            replaces="tools/exp_round4.py:70"),
        "step_schedules": dict(
            name="step_schedules", route="cuda",
            source="nufhe_tpu_torch/kernels/csrc/step_schedules.cu",
            replaces="tools/exp_round3.py:48"),
        "step_tricks": dict(
            name="step_tricks", route="cuda",
            source="nufhe_tpu_torch/kernels/csrc/step_tricks.cu",
            replaces="tools/exp_round4.py:604"),
        "rotate_forms": dict(
            name="rotate_forms", route="cuda",
            source="nufhe_tpu_torch/kernels/csrc/rotate_forms.cu",
            replaces="tools/exp_round5.py:152"),
        "inverse_probe": dict(
            name="inverse_probe", route="cuda",
            source="nufhe_tpu_torch/kernels/csrc/inverse_probe.cu",
            replaces="tools/exp_inverse.py:89"),
        "key_rows": dict(
            name="key_rows", route="cuda",
            source="nufhe_tpu_torch/kernels/csrc/key_rows.cu",
            replaces=None),
    }
    check_kernels(nft, dev, rng, results)
    prepared_rows(nft, dev, rng, results)
    check_step_parts(nft, dev, rng, results)
    check_step_experiments(nft, dev, rng, results)
    check_step_variants(nft, dev, rng, results)

    t0 = time.time()
    secret, cloud, cloud_fft, host_prepared = keygen_on_card(nft, dev)
    print("keygen and key preparation phase: %.1f s" % (time.time() - t0))
    native_keygen(nft, dev, cloud)
    launches, vms, nand = gate_paths(nft, dev, rng, secret, cloud, cloud_fft)
    host_key_gates(nft, dev, secret, host_prepared, nand)
    secure_rng_gate(nft, dev, rng)
    variant_gates(nft, dev, rng)
    tfhe_lib_params(nft, dev, rng, results)
    t0 = time.time()
    containers_on_card(nft, dev, secret, cloud, cloud_fft, nand, host_prepared)
    del host_prepared
    integer_circuits(nft, dev, rng, secret, vms)
    adder_crossover(nft, dev, secret, cloud, smi)
    print("containers, integer circuits and crossover: %.1f s"
          % (time.time() - t0))
    oracle_phase(nft, dev, secret, cloud, cloud_fft, oracle_job)
    multi_device(nft, dev, rng, secret, cloud, cloud_fft, nand, results, smi)
    for name in GATE_KERNELS:
        if not launches[name]:
            raise AssertionError("kernel %s was not launched on its path" % name)
        results[name]["launches"] = launches[name]
    timing(nft, dev, rng, secret, cloud, cloud_fft, vms, results)
    k3_shape_times(nft, dev, rng, results)
    import microbench_torch as microbench
    step_parts_timing(dev, results, microbench, smi)
    microbench_phase(dev, microbench, smi)
    step_experiments(dev, results, microbench, smi)
    step_variants(dev, results, microbench, smi)
    run_examples()
    bench_ports(smi)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    shape_lines = [name for name in results if name not in LINE_KERNELS]
    print(json.dumps({"kernels": [
        {k: results[name][k] for k in keys + ("forms",)
         if k in results[name]} for name in LINE_KERNELS + tuple(
             shape_lines)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
