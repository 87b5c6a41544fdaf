"""Multi-process distribution (``nufhe_tpu/parallel/distributed.py``'s
counterpart), on ``torch.distributed``.

- every process calls :func:`initialize`, which starts the default process
  group: NCCL between cards, one card a process, or gloo when the caller
  passes ``device='cpu'``;
- :func:`make_global_mesh` builds the (data, model) mesh so that each model
  group lies inside one node (its per-step collectives stay on the node's
  links) while 'data' spans nodes (only the batch crosses them);
- :func:`global_batch` turns each process's slice of the batch into its
  tensors on its device;
- the sharded functions of ``parallel.mesh`` run unchanged on that mesh.
"""

import os

import torch
import torch.distributed as dist

from .mesh import _tree_map, make_mesh, mesh_device


def _init_method(coordinator_address):
    if coordinator_address is None:
        return "env://"          # torchrun: MASTER_ADDR, MASTER_PORT
    if "://" in coordinator_address:
        return coordinator_address      # tcp://host:port or file:///path
    return "tcp://" + coordinator_address


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               local_device_ids=None, device=None):
    """Start the default process group; a no-op if one is running.

    :param coordinator_address: ``host:port`` (or ``tcp://``/``file://``
        URL) of the rendezvous; None reads torchrun's environment.
    :param num_processes, process_id: world size and rank; None reads
        ``WORLD_SIZE`` and ``RANK``.
    :param local_device_ids: the one card of this process (``[index]``);
        None reads ``LOCAL_RANK``.
    :param device: None or 'cuda' for NCCL on a card (raises without CUDA);
        'cpu' for gloo.
    """
    if dist.is_initialized():
        return
    kind = None if device is None else torch.device(device).type
    if kind not in (None, 'cuda', 'cpu'):
        raise ValueError("device must be 'cuda' or 'cpu', not %r" % (device,))
    if kind != 'cpu' and not torch.cuda.is_available():
        raise RuntimeError(
            "initialize() runs NCCL on a CUDA device and none is available; "
            "pass device='cpu' to run gloo on the CPU")
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", 0))
    kwargs = {}
    if kind != 'cpu':
        if local_device_ids is not None and len(local_device_ids) != 1:
            raise ValueError("one card a process, got local_device_ids=%r"
                             % (local_device_ids,))
        local = (local_device_ids[0] if local_device_ids is not None
                 else int(os.environ.get(
                     "LOCAL_RANK", rank % torch.cuda.device_count())))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group("gloo" if kind == 'cpu' else "nccl",
                            init_method=_init_method(coordinator_address),
                            world_size=world, rank=rank, **kwargs)


def global_mesh_shape(world, n_local, n_model):
    """(n_data, n_model) of the global mesh of ``world`` processes,
    ``n_local`` of them on each node, with the JAX package's checks."""
    if n_model > n_local:
        raise ValueError(
            "n_model=%d exceeds devices per host (%d): the model axis must "
            "stay inside a host so collectives ride the node's links"
            % (n_model, n_local))
    if world % n_model:
        raise ValueError("device count %d is not divisible by n_model=%d"
                         % (world, n_model))
    if n_local % n_model:
        # a model group would span nodes: right, but its collectives would
        # cross the network every step
        raise ValueError(
            "devices per host (%d) is not divisible by n_model=%d: a model "
            "group must not span hosts" % (n_local, n_model))
    return world // n_model, n_model


def make_global_mesh(n_model: int = 1, device=None):
    """The (data, model) mesh over every process of the default group, each
    model group n_model consecutive ranks of one node (torchrun numbers a
    node's processes consecutively; ``LOCAL_WORLD_SIZE`` gives their count,
    the whole world when unset)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize() first")
    world = dist.get_world_size()
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_data, n_model = global_mesh_shape(world, n_local, n_model)
    return make_mesh(n_data, n_model, device)


def global_batch(mesh, local_arrays):
    """This process's slice of the batch (numpy arrays or tensors, in dicts,
    lists or tuples) as tensors on its device.  Every process's slices must
    have the same leading size (checked across the mesh); the global batch
    is their concatenation over 'data'."""
    dev = mesh_device(mesh)
    sizes = []

    def put(x):
        x = torch.as_tensor(x).to(dev)
        sizes.append(x.shape[0])
        return x

    out = _tree_map(put, local_arrays)
    # [min, -max] of every slice's size, reduced by MIN over the world: the
    # same answer on every rank, so they all raise or none does
    sizes = torch.tensor([min(sizes), -max(sizes)], dtype=torch.int64,
                         device=dev)
    dist.all_reduce(sizes, op=dist.ReduceOp.MIN)
    if int(sizes[0]) != -int(sizes[1]):
        raise ValueError("the processes' batch slices differ in size")
    return out


def run_multiprocess_dryrun(nprocs: int = 4, timeout: float = 900.0,
                            device=None, lwe_size: int = 8, batch=None,
                            out_path=None):
    """Launch ``nprocs`` cooperating processes of ``parallel._mp_worker``
    (one device each: NCCL on ``nprocs`` cards, the default, which raises
    without CUDA; or gloo on the CPU with ``device='cpu'``), a (data, model)
    mesh with model 2 for an even
    ``nprocs``: each runs the limbs- and slots-sharded bootstrap and the
    data-parallel NAND and asserts its shard bit-exact against the unsharded
    computation.  Returns each worker's last output line; raises on any
    failure.  ``out_path``: rank 0 writes the gathered outputs there (npz).
    (The JAX package's ``local_devices`` has no counterpart: a process
    drives one device.)"""
    import sys

    kind = 'cuda' if device is None else torch.device(device).type
    if kind not in ('cuda', 'cpu'):
        raise ValueError("device must be 'cuda' or 'cpu', not %r" % (device,))
    if kind == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "run_multiprocess_dryrun runs NCCL on CUDA devices and none is "
            "available; pass device='cpu' to run gloo on the CPU")
    args = ["--device", kind, "--lwe-size", str(lwe_size)]
    if batch is not None:
        args += ["--batch", str(batch)]
    if out_path is not None:
        args += ["--out", str(out_path)]
    outs = run_processes(
        lambda coord, i: [sys.executable, "-m",
                          "nufhe_tpu_torch.parallel._mp_worker", coord,
                          str(nprocs), str(i)] + args,
        nprocs, timeout=timeout, name="mp_worker")
    return [out.strip().splitlines()[-1] for out in outs]


def run_processes(argv, nprocs, timeout=900.0, name="process"):
    """Start ``nprocs`` cooperating processes, ``argv(coordinator, rank)``
    each (``coordinator``: a free ``127.0.0.1:port`` for their process
    group), from the repo root with it on ``PYTHONPATH``, one torch thread
    and ``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` set; wait for all.  Returns
    each one's output (stdout and stderr); raises if any failed, after
    retrying a lost race for the port."""
    import socket
    import subprocess

    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env["LOCAL_WORLD_SIZE"] = str(nprocs)

    def attempt():
        # bind/close picks a free port; another process can take it before
        # rank 0 binds it, so a bind failure is retried, not ruled out
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        coord = "127.0.0.1:%d" % port
        procs = [subprocess.Popen(
            argv(coord, i), env=dict(env, LOCAL_RANK=str(i)), cwd=repo_root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i in range(nprocs)]
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=timeout)
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return procs, outs

    bind_markers = ("address already in use", "failed to bind", "eaddrinuse")
    last_error = None
    for _ in range(3):
        procs, outs = attempt()
        failed = [(i, p, out) for i, (p, out) in enumerate(zip(procs, outs))
                  if p.returncode != 0]
        if not failed:
            return outs
        i, p, out = failed[0]
        last_error = RuntimeError("%s %d failed (rc %d):\n%s"
                                  % (name, i, p.returncode, out[-3000:]))
        if not any(m in out.lower() for m in bind_markers):
            raise last_error
    raise last_error
