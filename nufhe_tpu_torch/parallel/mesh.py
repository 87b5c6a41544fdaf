"""Multi-device execution: the (data, model) mesh and the sharded bootstrap
(``nufhe_tpu/parallel/mesh.py``'s counterpart), on ``torch.distributed``.

One process drives one device.  Where the JAX package places global arrays
over a ``jax.sharding.Mesh``, each process here holds its own shard on its
own card, and a ``DeviceMesh`` with dims ``('data', 'model')`` names the
process groups:

- **data parallel**: the ciphertext batch is split over ``'data'``; gates
  are independent per sample, keys are replicated;
- **tensor parallel**: the lanes engine's int8 key (n, L, C, Q) is split
  over ``'model'``, along C in whole g-blocks (``mode='limbs'``: each rank
  MACs its digit limbs and the channels are summed over the model group
  before the replicated inverse) or along the slots L (``mode='slots'``:
  each rank MACs its slots and the channels are gathered), a collective each
  CMUX step (``ops/lanes_step.lanes_step_sharded``).

Where JAX passes a mesh axis name, the port passes the process group
``mesh.get_group('model')``.  :func:`gather_ciphertext` and :func:`replicate`
run inside the spans ``nufhe.mesh.gather`` and ``nufhe.mesh.replicate``
(``utils/profiling.annotate``).
"""

import numpy as np
import torch
import torch.distributed as dist

from ..ciphertext import LweSampleArray
from ..ops import bootstrap as dboot
from ..ops import flat_engine as fe
from ..ops import transform as tf
from ..ops.lanes_step import MODES
from ..utils.profiling import spanned


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError("mode must be 'limbs' or 'slots', got %r" % (mode,))


def _device_type(device):
    """'cuda' unless the caller names the CPU; raises without a card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "nufhe_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU (gloo)")
        return 'cuda'
    kind = torch.device(device).type
    if kind not in ('cuda', 'cpu'):
        raise ValueError("a mesh is of 'cuda' or 'cpu' devices, not %r"
                         % (device,))
    return kind


def make_mesh(n_data=None, n_model=1, device=None):
    """A (data, model) ``DeviceMesh`` over the ranks of the default process
    group (``parallel.distributed.initialize``), model dim fastest: rank r
    sits at (r // n_model, r % n_model), so a model group is n_model
    consecutive ranks.  ``device``: 'cuda' (the default; each rank's current
    card) or 'cpu'."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call nufhe_tpu_torch.parallel."
                           "distributed.initialize first")
    kind = _device_type(device)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError("a (%d, %d) mesh needs %d processes; the process "
                         "group has %d" % (n_data, n_model, n_data * n_model,
                                           world))
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(kind, (n_data, n_model),
                            mesh_dim_names=('data', 'model'))


def mesh_device(mesh):
    """The device this rank drives in ``mesh``."""
    if mesh.device_type == 'cuda':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _dim_size(mesh, name):
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def shard_ciphertext(ct, mesh):
    """Keep this rank's slice of the ciphertext's leading batch axis, split
    over ``'data'`` (the model ranks of one data shard hold the same slice),
    on this rank's device.  ``ct`` holds the whole batch on every rank, as
    the JAX package's host array does; like its ``shard_ciphertext`` this
    sets ``ct``'s arrays and returns ``ct``, which from then on holds the
    shard (:func:`gather_ciphertext` gives the whole batch back)."""
    n_data = _dim_size(mesh, 'data')
    bsz = ct.b.shape[0] if ct.b.dim() else 0
    if not bsz or bsz % n_data:
        raise ValueError("a batch of %d does not split over %d data shards"
                         % (bsz, n_data))
    per = bsz // n_data
    start = mesh.get_local_rank('data') * per
    dev = mesh_device(mesh)
    ct.a, ct.b, ct.current_variances = (
        x[start:start + per].to(dev).contiguous()
        for x in (ct.a, ct.b, ct.current_variances))
    return ct


def _gather_batch(x, group):
    """Every rank's ``x`` over ``group``, concatenated along the batch axis
    (the all-gather of ``ops/flat_engine.gather_slots``)."""
    return fe.gather_slots(x, group).reshape((-1,) + tuple(x.shape[1:]))


@spanned("nufhe.mesh.gather")
def gather_ciphertext(ct, mesh):
    """The whole batch of a data-sharded ciphertext, on every rank (an
    ``all_gather`` over ``'data'``).  Not in the JAX package, whose sharded
    arrays are global: here each process holds only its shard, and this is
    what ``decrypt`` of the whole result needs."""
    group = mesh.get_group('data')
    return LweSampleArray(ct.params, *(
        _gather_batch(x, group) for x in (ct.a, ct.b, ct.current_variances)))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, '_fields'):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


@spanned("nufhe.mesh.replicate")
def replicate(tree, mesh):
    """Key material on every rank: each tensor (or numpy array) of ``tree``
    (dicts, lists and tuples of them) broadcast from the mesh's first rank
    onto each rank's device; other leaves (Python numbers) stay as they are.
    Every rank passes a tree of the same shapes and dtypes; returns new
    tensors."""
    src = int(mesh.mesh.flatten()[0])
    dev = mesh_device(mesh)

    def put(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if not torch.is_tensor(x):
            return x
        x = x.to(dev, copy=True).contiguous()
        dist.broadcast(x, src)
        return x

    return _tree_map(put, tree)


def sharded_bootstrap_fn(mesh, ks_meta, mu, tgsw_params, no_keyswitch=False,
                         mode='limbs', force_tp=False):
    """A sharded bootstrap: each rank runs its 'data' shard of the batch;
    over 'model' either the external product's digit limbs (``mode=
    'limbs'``, the channels summed each step) or the transform slots
    (``mode='slots'``, the channels gathered each step); keyswitch local.

    A size-1 'model' dim means pure data parallelism: the fn runs the plain
    ``ops/bootstrap.bootstrap_device`` on the rank's shard (the lanes engine
    on the int8 key, one K4 launch a step).  ``force_tp`` keeps the
    tensor-parallel path, collectives and all, on a size-1 model group: the
    one-card proof that it runs.

    Returns ``fn(lwe_a, lwe_b, bk_dev, ks_arrays) -> (a, b, cv)`` on this
    rank's shards: ``lwe_a`` (B_local, n), ``lwe_b`` (B_local,), ``bk_dev``
    from :func:`shard_bootstrap_key` with the same ``mode``, ``ks_arrays``
    replicated (:func:`replicate`).
    """
    _check_mode(mode)
    use_tp = force_tp or _dim_size(mesh, 'model') > 1
    tp = {}
    if use_tp:
        group = mesh.get_group('model')
        tp = dict(group=group) if mode == 'limbs' else dict(slot_group=group)

    def fn(lwe_a, lwe_b, bk_dev, ks_arrays):
        return dboot.bootstrap_device(lwe_a, lwe_b, bk_dev, ks_arrays,
                                      ks_meta, mu, tgsw_params,
                                      no_keyswitch=no_keyswitch, **tp)

    return fn


def shard_bootstrap_key(bk_dev, mesh, mode='limbs'):
    """This rank's shard of the lanes engine's key (n, L, C, Q) int8 over
    'model', on its device: along the MAC contraction axis C in whole
    g-blocks of 2R (``mode='limbs'``; n_model must divide G), or along the
    transform slots L (``mode='slots'``; n_model must divide 64)."""
    _check_mode(mode)
    if not torch.is_tensor(bk_dev) or bk_dev.dtype != torch.int8 \
            or bk_dev.dim() != 4:
        raise ValueError("shard_bootstrap_key takes the lanes engine's "
                         "(n, L, C, Q) int8 key (mode=%r)" % (mode,))
    n_model = _dim_size(mesh, 'model')
    rank = mesh.get_local_rank('model') if n_model > 1 else 0
    if mode == 'limbs':
        g_size = bk_dev.shape[2] // (tf.ACC_LIMBS * tf.R)
        if g_size % n_model:
            raise ValueError("mode='limbs' splits the key in whole g-blocks: "
                             "n_model=%d must divide G=%d" % (n_model, g_size))
        width = bk_dev.shape[2] // n_model
        part = bk_dev[:, :, rank * width:(rank + 1) * width]
    else:
        if bk_dev.shape[1] % n_model:
            raise ValueError("mode='slots' splits the key's %d slots: "
                             "n_model=%d must divide them"
                             % (bk_dev.shape[1], n_model))
        width = bk_dev.shape[1] // n_model
        part = bk_dev[:, rank * width:(rank + 1) * width]
    return part.to(mesh_device(mesh)).contiguous()
