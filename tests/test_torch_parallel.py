"""The port's multi-device layer (``nufhe_tpu_torch/parallel``, the
tensor-parallel external product) against the JAX package's
``nufhe_tpu/parallel``, on the CPU under gloo: integers bit-equal.

- the sharded bootstrap with ``force_tp=True`` in a world-1 gloo group, both
  modes and engines, against the JAX package's ``sharded_bootstrap_fn`` on
  the (4, 2) virtual CPU mesh and its unsharded ``bootstrap_device``;
- the plain tensor-parallel MAC on two virtual shards, summed (limbs, with
  lo sums that cross 2^31) or gathered (slots) by hand, against the
  unsharded MAC;
- four processes (2 data x 2 model) under gloo: every shard bit-exact, the
  gathered outputs equal to the JAX package's sharded outputs on the same
  ``RandomState(1234)`` state, and the data-parallel NAND equal to the JAX
  package's NAND from the same seed;
- ``make_global_mesh``'s checks, ``initialize()``'s refusal without CUDA,
  and no ``jax`` import in the port's ``parallel`` package.

The LWE size is 8 (8 CMUX steps) and the batch 8; polynomial and
transform sizes are full.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import nufhe_tpu as jnf
from nufhe_tpu.numeric import phase_to_t32
from nufhe_tpu.ops import bootstrap as jboot, lwe as jlwe, tgsw as jtgsw
from nufhe_tpu.ops import flat_engine as jfe
from nufhe_tpu.ops import transform as jtf
from nufhe_tpu.params import NuFHEParameters
from nufhe_tpu.parallel import mesh as jmesh

from nufhe_tpu_torch.ops import bootstrap as tboot, flat_engine as tfe
from nufhe_tpu_torch.ops import lanes_step as k4, lwe as tlwe, tgsw as ttgsw
from nufhe_tpu_torch.parallel import distributed as pdist, mesh as pmesh
from nufhe_tpu_torch.parallel import _mp_worker

LWE_SIZE = 8
BATCH = 8
MU = int(phase_to_t32(1, 8))
ENGINES = ("NTT", "FFT")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draws(transform_type):
    """The JAX package's ``_mp_worker._setup`` draws (RandomState(1234),
    five-limb key) for 'NTT'; the same draws with a four-limb (rounded)
    key from RandomState(1235) for 'FFT'."""
    exact = transform_type == "NTT"
    rng = np.random.RandomState(1234 if exact else 1235)
    limbs = rng.randint(-128, 128, (LWE_SIZE, 4, 2, 64, 32, 5 if exact else 4,
                                    2)).astype(np.int8)
    ks_a = rng.randint(-2**31, 2**31, (1024, 8, 4, LWE_SIZE)).astype(np.int32)
    ks_b = rng.randint(-2**31, 2**31, (1024, 8, 4)).astype(np.int32)
    ks_cv = np.full((1024, 8, 4), 3e-9, np.float32)
    ks_cv[:, :, 0] = 0
    lwe_a = rng.randint(-2**31, 2**31, (BATCH, LWE_SIZE)).astype(np.int32)
    lwe_b = rng.randint(-2**31, 2**31, (BATCH,)).astype(np.int32)
    return limbs, ks_a, ks_b, ks_cv, lwe_a, lwe_b


@pytest.fixture(scope="module")
def cases():
    """For each engine: the inputs, the port's key operands, and the JAX
    package's outputs: unsharded, and sharded in each mode on the (4, 2)
    mesh."""
    jax.clear_caches()
    mesh = jmesh.make_mesh(n_data=4, n_model=2)
    out = {}
    for engine in ENGINES:
        limbs, ks_a, ks_b, ks_cv, lwe_a, lwe_b = _draws(engine)
        tp = NuFHEParameters(lwe_size=LWE_SIZE,
                             transform_type=engine).tgsw_params
        bk = jtf.build_mac_rhs(jnp.asarray(limbs))
        ks_arrays, ks_meta = jlwe.prepare_keyswitch_device(ks_a, ks_b, ks_cv, 2)
        want = {"unsharded": jboot.bootstrap_device(
            jnp.asarray(lwe_a), jnp.asarray(lwe_b), bk, ks_arrays, ks_meta,
            MU, tp)}
        for mode in pmesh.MODES:
            fn = jmesh.sharded_bootstrap_fn(mesh, ks_meta, MU, tp, mode=mode)
            want[mode] = fn(
                jax.device_put(jnp.asarray(lwe_a),
                               NamedSharding(mesh, P('data', None))),
                jax.device_put(jnp.asarray(lwe_b),
                               NamedSharding(mesh, P('data'))),
                jmesh.shard_bootstrap_key(bk, mesh, mode=mode),
                jmesh.replicate(ks_arrays, mesh))
        tks, tmeta = tlwe.prepare_keyswitch_device(ks_a, ks_b, ks_cv, 2, "cpu")
        out[engine] = dict(
            tp=tp, lwe_a=torch.from_numpy(lwe_a), lwe_b=torch.from_numpy(lwe_b),
            bk=ttgsw.expand_bootstrap_key_device(limbs, "cpu"), jbk=bk,
            ks=tks, meta=tmeta,
            want={k: tuple(np.asarray(x) for x in v) for k, v in want.items()})
    return out


@pytest.fixture
def world1(tmp_path):
    """A world-1 gloo process group (a FileStore in a temp dir) and its
    (1, 1) mesh; destroyed afterwards."""
    assert not dist.is_initialized()
    pdist.initialize("file://" + str(tmp_path / "store"), 1, 0, device="cpu")
    try:
        yield pmesh.make_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture
def collective_calls(monkeypatch):
    """Calls of the two per-step collectives of the plain path."""
    calls = {"limbs": 0, "slots": 0}

    def spy(name, mode):
        real = getattr(tfe, name)

        def wrapped(*args, **kwds):
            calls[mode] += 1
            return real(*args, **kwds)
        monkeypatch.setattr(tfe, name, wrapped)

    spy("sum_channels", "limbs")
    spy("gather_slots", "slots")
    return calls


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", ["limbs", "slots"])
def test_sharded_bootstrap_force_tp_matches_jax(cases, world1,
                                                collective_calls, mode,
                                                engine):
    c = cases[engine]
    mesh = world1
    bk = pmesh.shard_bootstrap_key(c["bk"], mesh, mode)
    ks = pmesh.replicate(c["ks"], mesh)
    fn = pmesh.sharded_bootstrap_fn(mesh, c["meta"], MU, c["tp"], mode=mode,
                                    force_tp=True)
    a, b, cv = fn(c["lwe_a"], c["lwe_b"], bk, ks)
    assert collective_calls == dict({"limbs": 0, "slots": 0},
                                    **{mode: LWE_SIZE})
    for ref in (c["want"][mode], c["want"]["unsharded"]):
        assert np.array_equal(a.numpy(), ref[0])
        assert np.array_equal(b.numpy(), ref[1])
        np.testing.assert_allclose(cv.numpy(), ref[2], rtol=1e-6)


def test_size1_model_runs_the_plain_bootstrap(cases, world1,
                                              collective_calls):
    """No ``force_tp`` on a size-1 model dim: the plain bootstrap, no
    collectives, the same output."""
    c = cases["NTT"]
    fn = pmesh.sharded_bootstrap_fn(world1, c["meta"], MU, c["tp"])
    a, b, _ = fn(c["lwe_a"], c["lwe_b"],
                 pmesh.shard_bootstrap_key(c["bk"], world1), c["ks"])
    assert collective_calls == {"limbs": 0, "slots": 0}
    assert np.array_equal(a.numpy(), c["want"]["limbs"][0])
    assert np.array_equal(b.numpy(), c["want"]["limbs"][1])


def test_tp_external_mul_matches_jax(cases, world1):
    """``tgsw_transformed_external_mul(group=)`` on a world-1 group against
    the JAX package's unsharded external product."""
    c = cases["NTT"]
    acc = np.random.RandomState(5).randint(
        -2**31, 2**31, (BATCH, 2, 1024)).astype(np.int32)
    tp = c["tp"]
    args = (3, int(tp.offset), tp.decomp_length, tp.bs_log2_base)
    got = ttgsw.tgsw_transformed_external_mul(
        torch.from_numpy(acc), pmesh.shard_bootstrap_key(c["bk"], world1),
        *args, group=world1.get_group("model"))
    want = jtgsw.tgsw_transformed_external_mul(jnp.asarray(acc), c["jbk"],
                                               *args)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["limbs", "slots"])
def test_plain_tp_step_matches_jax(cases, world1, collective_calls, mode):
    """The plain TP step, ``flat_engine.external_step(group=)`` or
    ``(slot_group=)`` on a world-1 group (one collective), against the JAX
    package's unsharded ``flat_engine.external_step``."""
    c = cases["NTT"]
    tp = c["tp"]
    rng = np.random.RandomState(9)
    acc_q = rng.randint(-2**31, 2**31, (BATCH, 2048)).astype(np.int32)
    p = rng.randint(0, 2048, BATCH).astype(np.int32)
    fkw = dict(mask1=2, decomp_length=tp.decomp_length,
               log2_base=tp.bs_log2_base, offset=int(tp.offset))
    key = pmesh.shard_bootstrap_key(c["bk"], world1, mode)[0]
    group = world1.get_group("model")
    got = tfe.external_step(torch.from_numpy(acc_q), torch.from_numpy(p),
                            key, **fkw, **({"group": group} if mode == "limbs"
                                           else {"slot_group": group}))
    assert collective_calls == dict({"limbs": 0, "slots": 0}, **{mode: 1})
    want = jfe.external_step(jnp.asarray(acc_q), jnp.asarray(p)[:, None],
                             jnp.asarray(np.asarray(c["jbk"])[0]),
                             mac_dtype=jnp.float32, **fkw)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_tp_rejects_what_it_cannot_split(cases, world1):
    c = cases["NTT"]
    group = world1.get_group("model")
    rows_key = torch.zeros((LWE_SIZE, 4, 2, 64, 32), dtype=torch.int64)
    for kw in (dict(group=group), dict(slot_group=group)):
        mode = "limbs" if "group" in kw else "slots"
        with pytest.raises(ValueError, match=mode):
            tboot.bootstrap_device(c["lwe_a"], c["lwe_b"], rows_key, c["ks"],
                                   c["meta"], MU, c["tp"], **kw)
    with pytest.raises(ValueError, match="exclude"):
        tboot.bootstrap_device(c["lwe_a"], c["lwe_b"], c["bk"], c["ks"],
                               c["meta"], MU, c["tp"], group=group,
                               slot_group=group)
    with pytest.raises(ValueError, match="mode"):
        pmesh.sharded_bootstrap_fn(world1, c["meta"], MU, c["tp"],
                                   mode="rows")
    with pytest.raises(ValueError, match="int8"):
        pmesh.shard_bootstrap_key(rows_key, world1, "limbs")

    class Model3:          # a (1, 3) mesh, as this rank sees it
        mesh_dim_names = ("data", "model")
        device_type = "cpu"

        def size(self, dim):
            return (1, 3)[dim]

        def get_local_rank(self, name):
            return 0

    with pytest.raises(ValueError, match="n_model=3 must divide G=4"):
        pmesh.shard_bootstrap_key(c["bk"], Model3(), "limbs")
    with pytest.raises(ValueError, match="n_model=3 must divide"):
        pmesh.shard_bootstrap_key(c["bk"], Model3(), "slots")


@pytest.mark.parametrize("engine", ENGINES)
def test_plain_tp_mac_two_virtual_shards(cases, engine):
    """The plain TP MAC on two shards, combined by hand: the limbs' partial
    channels summed mod 2^32 (some lo sums cross 2^31), the slots' channels
    concatenated; then the inverse.  Also the K4 wrappers' CPU path
    (``lanes_mac_shard``, ``lanes_inverse``) against the plain step."""
    c = cases[engine]
    key = c["bk"][0]
    mask1, g_size = 2, 4
    rng = np.random.RandomState(7)
    digits = torch.from_numpy(rng.randint(
        -512, 512, (BATCH, g_size * 1024)).astype(np.int32))
    want = tfe.transformed_mac_flat(digits, key, mask1=mask1, g_total=g_size)

    half_c, half_g = key.shape[1] // 2, g_size // 2
    parts = [tfe.mac_channels(digits[:, s * half_g * 1024:
                                     (s + 1) * half_g * 1024],
                              key[:, s * half_c:(s + 1) * half_c],
                              mask1=mask1, g_total=half_g) for s in (0, 1)]
    lo_sum = parts[0][:, 0].to(torch.int64) + parts[1][:, 0].to(torch.int64)
    assert ((lo_sum >= 2**31) | (lo_sum < -2**31)).any()
    summed = ((parts[0].to(torch.int64) + parts[1].to(torch.int64)
               + 2**31) % 2**32 - 2**31).to(torch.int32)
    assert torch.equal(tfe.inverse_channels(summed, mask1), want)

    slots = [tfe.mac_channels(digits, key[s * 32:(s + 1) * 32], mask1=mask1,
                              g_total=g_size, slot_start=s * 32)
             for s in (0, 1)]
    gathered = torch.stack(slots)
    assert torch.equal(
        tfe.inverse_channels(tfe.slots_from_gathered(gathered), mask1), want)

    tp = c["tp"]
    kw = dict(offset=int(tp.offset), log2_base=tp.bs_log2_base)
    acc = torch.from_numpy(rng.randint(-2**31, 2**31, (BATCH, 2048))
                           .astype(np.int32))
    p = torch.from_numpy(rng.randint(0, 2048, BATCH).astype(np.int32))
    step = k4.lanes_step_plain(acc, p, key, **kw)
    limbs = [k4.lanes_mac_shard(acc, p, key[:, s * half_c:(s + 1) * half_c]
                                .contiguous(), shard=s, n_shards=2,
                                mode="limbs", **kw) for s in (0, 1)]
    limbs = ((limbs[0].to(torch.int64) + limbs[1].to(torch.int64) + 2**31)
             % 2**32 - 2**31).to(torch.int32)
    assert torch.equal(k4.lanes_inverse(acc, limbs), step)
    slots = [k4.lanes_mac_shard(acc, p, key[s * 32:(s + 1) * 32].contiguous(),
                                shard=s, n_shards=2, mode="slots", **kw)
             for s in (0, 1)]
    assert torch.equal(k4.lanes_inverse(acc, torch.stack(slots)), step)


@pytest.fixture(scope="module")
def mp_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mp") / "out.npz"
    lines = pdist.run_multiprocess_dryrun(nprocs=4, timeout=300,
                                          device="cpu", batch=BATCH,
                                          out_path=out)
    return lines, dict(np.load(out))


def test_multiprocess_gloo_matches_jax_sharded(cases, mp_run):
    """Four processes, 2 data x 2 model under gloo: every worker's shards
    bit-exact (checked in the workers), and the gathered limbs- and
    slots-sharded outputs equal the JAX package's sharded outputs on the
    same state."""
    lines, saved = mp_run
    assert len(lines) == 4
    assert all("bit-exact" in line and "'data': 2, 'model': 2" in line
               for line in lines), lines
    want = cases["NTT"]["want"]
    for mode in pmesh.MODES:
        assert np.array_equal(saved[mode + "_a"], want[mode][0])
        assert np.array_equal(saved[mode + "_b"], want[mode][1])


def test_data_parallel_gate_end_to_end(mp_run):
    """Encrypt, shard, ``gate_nand`` on each rank, gather (in the workers,
    which also decrypt it to the truth table): equal to the JAX package's
    NAND from the same seed."""
    _, saved = mp_run
    rng = jnf.DeterministicRNG(_mp_worker.NAND_SEED)
    secret, cloud = jnf.make_key_pair(rng, lwe_size=LWE_SIZE)
    bits_a = np.random.RandomState(0).randint(0, 2, BATCH).astype(bool)
    bits_b = np.random.RandomState(1).randint(0, 2, BATCH).astype(bool)
    ca = jnf.encrypt(rng, secret, bits_a)
    cb = jnf.encrypt(rng, secret, bits_b)
    want = jnf.VirtualMachine(cloud).gate_nand(ca, cb)
    assert np.array_equal(saved["nand_a"], np.asarray(want.a))
    assert np.array_equal(saved["nand_b"], np.asarray(want.b))
    assert np.array_equal(jnf.decrypt(secret, want), ~(bits_a & bits_b))


def test_global_mesh_checks(world1):
    with pytest.raises(ValueError, match="exceeds devices per host"):
        pdist.global_mesh_shape(8, 2, 4)
    with pytest.raises(ValueError, match="not divisible by n_model"):
        pdist.global_mesh_shape(6, 8, 4)
    with pytest.raises(ValueError, match="must not span hosts"):
        pdist.global_mesh_shape(12, 6, 4)
    assert pdist.global_mesh_shape(8, 4, 2) == (4, 2)
    with pytest.raises(ValueError, match="exceeds devices per host"):
        pdist.make_global_mesh(n_model=2, device="cpu")
    mesh = pdist.make_global_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.mesh.shape) == (1, 1)


def test_initialize_needs_a_card_or_cpu(tmp_path, monkeypatch):
    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdist.initialize("file://" + str(tmp_path / "a"), 1, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdist.initialize("file://" + str(tmp_path / "a"), 1, 0,
                         device="cuda")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        pmesh.make_mesh(device="cpu")
    pdist.initialize("file://" + str(tmp_path / "b"), 1, 0, device="cpu")
    try:
        assert dist.get_backend() == "gloo"
        pdist.initialize("file://" + str(tmp_path / "c"), 1, 0)  # a no-op
        assert dist.get_backend() == "gloo"
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pmesh.make_mesh()
    finally:
        dist.destroy_process_group()


def test_dryrun_needs_a_card_or_cpu(monkeypatch):
    """The dryrun's workers run NCCL on cards unless the caller asks for
    the CPU: without CUDA it raises before starting a process, as does a
    worker started without ``--device cpu``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, dict(device="cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pdist.run_multiprocess_dryrun(nprocs=2, **kw)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        pdist.run_multiprocess_dryrun(nprocs=2, device="meta")
    proc = subprocess.run(
        [sys.executable, "-m", "nufhe_tpu_torch.parallel._mp_worker",
         "127.0.0.1:1", "1", "0"], capture_output=True, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), cwd=REPO, timeout=120)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr


def test_parallel_imports_no_jax():
    code = (
        "import sys\n"
        "import nufhe_tpu_torch.parallel.mesh\n"
        "import nufhe_tpu_torch.parallel.distributed\n"
        "import nufhe_tpu_torch.parallel._mp_worker\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'nufhe_tpu'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
