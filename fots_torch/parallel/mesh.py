"""Device mesh for multi-card training and serving (port of
``fots/parallel/mesh.py``).

``fots`` lays its devices out as a 2-axis ``jax.sharding.Mesh`` ('data',
'model'): the batch is sharded over 'data' and the vocabulary heads'
output channels (``conv11``, the CRNN ``embedding``) over 'model' where
they divide; XLA inserts the collectives, so a meshed run computes what one
device computes on the global batch.  Here the same mesh is a
``torch.distributed`` ``DeviceMesh`` over one process per card (torchrun):
DistributedDataParallel carries 'data' and a column-parallel head
(:class:`VocabShard`) carries 'model'.  What XLA would insert is written
out:

- every reduction over the batch (BatchNorm's statistics, the losses'
  sums) goes through :func:`all_reduce_sum`, whose backward all-reduces the
  gradient too.  Every data rank then computes the *global* loss, and
  autograd through the collectives gives each rank ``n_data`` times its
  share of the global gradient, which DDP's mean divides back;
- a sharded head computes its own output channels and gathers them over
  'model' (:func:`gather_columns`), whose backward hands each rank its own
  slice, while :func:`copy_to_group` sums the input's partial gradients
  over 'model': each model rank computes the whole loss and the true
  gradient of everything it holds;
- random draws (dropout masks, candidate priorities) are made at the global
  shape from the shared seed on every rank, which keeps its own rows
  (:class:`RowDraw`, :func:`global_draw`).

Host objects (batches, results, checkpoints) cross ranks over gloo groups
(:func:`object_group`) even when the tensor groups are NCCL.  A mesh covers
the whole world: rank ``d * n_model + m`` holds data shard ``d`` and model
shard ``m``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterable, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"

# parameter names whose dim 0 (torch's output channels, flax's last axis)
# shards over 'model': the vocabulary heads
_VOCAB_SHARDED_SUFFIXES = ("conv11.weight", "conv11.bias", "embedding.weight",
                           "embedding.bias")


def init_from_env(device=None) -> int:
    """Join the default process group that torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
    ``LOCAL_RANK``) describes, unless one is up already; returns the world
    size, 1 without either.  ``device`` (an entry point's: None is the card)
    picks NCCL on ``cuda:LOCAL_RANK`` or gloo for ``"cpu"``."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return 1
    from fots_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dist.get_world_size()


def make_mesh(n_data: Optional[int] = None, n_model: int = 1):
    """A ('data', 'model') ``DeviceMesh`` of shape (n_data, n_model) over the
    initialised process group, with gloo groups for host objects.
    ``n_data=None`` is ``world // n_model``.  Raises ``ValueError`` when the
    mesh needs more ranks than the world has, as ``fots`` does, and when it
    leaves ranks out (one process runs each card of the mesh).  The mesh's
    device type is ``cuda`` under NCCL and ``cpu`` under gloo (which moves
    CUDA tensors too)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("make_mesh needs a process group: run under torchrun "
                         "(--nproc-per-node N) or call init_from_env()")
    world = dist.get_world_size()
    if n_data is None:
        n_data = max(1, world // n_model)
    need = n_data * n_model
    if need > world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {need} devices, have {world}")
    if need != world:
        raise ValueError(f"mesh {n_data}x{n_model} covers {need} of {world} ranks; start "
                         f"{need} processes")
    backend = dist.get_backend()
    mesh = init_device_mesh("cuda" if backend == "nccl" else "cpu", (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    if backend == "gloo":
        groups = {None: dist.group.WORLD, DATA_AXIS: mesh.get_group(DATA_AXIS),
                  MODEL_AXIS: mesh.get_group(MODEL_AXIS)}
    else:  # every rank creates every group, in one order
        d, m = divmod(dist.get_rank(), n_model)
        groups = {None: dist.new_group(backend="gloo")}
        for mm in range(n_model):
            g = dist.new_group([dd * n_model + mm for dd in range(n_data)], backend="gloo")
            if mm == m:
                groups[DATA_AXIS] = g
        for dd in range(n_data):
            g = dist.new_group([dd * n_model + mm for mm in range(n_model)], backend="gloo")
            if dd == d:
                groups[MODEL_AXIS] = g
    mesh._fots_object_groups = groups
    return mesh


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def data_group(mesh):
    """The tensor group of this rank's data axis (None without a mesh)."""
    return None if mesh is None else mesh.get_group(DATA_AXIS)


def model_group(mesh):
    """The tensor group of this rank's model axis (None without a mesh)."""
    return None if mesh is None else mesh.get_group(MODEL_AXIS)


def object_group(mesh, axis: Optional[str] = None):
    """The gloo group for host objects along ``axis`` (None: the world)."""
    return mesh._fots_object_groups[axis]


def is_main(mesh) -> bool:
    """Whether this rank prints and writes (rank 0, or no mesh)."""
    return mesh is None or dist.get_rank() == 0


@dataclass(frozen=True)
class BatchShard:
    """How a global batch splits over the data axis: ``n`` shards of equal
    rows after padding, this rank's is ``index``."""

    n: int = 1
    index: int = 0

    def padded(self, b: int) -> int:
        """``b`` rounded up to a multiple of the shard count."""
        return -(-b // self.n) * self.n

    def rows(self, b: int) -> slice:
        """This rank's rows of the padded global batch of ``b``."""
        per = self.padded(b) // self.n
        return slice(self.index * per, (self.index + 1) * per)


def batch_sharding(mesh) -> BatchShard:
    """The leading (batch) dim over 'data', the rest replicated: this rank's
    :class:`BatchShard`."""
    return BatchShard(axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS))


def replicate(mesh) -> Tuple:
    """The placements of a tensor every rank holds whole (one per mesh dim)."""
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate())


def _named(model) -> Iterable[Tuple[str, torch.Tensor]]:
    return model.named_parameters() if isinstance(model, nn.Module) else model.items()


def param_shardings(model, mesh, shard_vocab: bool = True) -> Dict[str, Tuple]:
    """Placements over ('data', 'model') of each parameter of ``model`` (a
    module or a name -> tensor mapping): the vocabulary heads' output
    channels (dim 0) ``Shard(0)`` over 'model' where the model axis divides
    them, everything else replicated; every parameter is replicated over
    'data'."""
    from torch.distributed.tensor import Replicate, Shard

    n_model = axis_size(mesh, MODEL_AXIS)
    out = {}
    for name, t in _named(model):
        shard = (shard_vocab and n_model > 1 and name.endswith(_VOCAB_SHARDED_SUFFIXES)
                 and t.ndim >= 1 and t.shape[0] % n_model == 0)
        out[name] = (Replicate(), Shard(0) if shard else Replicate())
    return out


def sharded_names(model: nn.Module) -> Tuple[str, ...]:
    """The parameters of ``model`` that hold one model rank's rows (those of
    its :class:`VocabShard` modules)."""
    return tuple(f"{name}.{p}" for name, mod in model.named_modules()
                 if isinstance(mod, VocabShard) for p in ("weight", "bias")
                 if getattr(mod, p, None) is not None)


def shard_init(model: nn.Module, mesh, shard_vocab: bool = True) -> nn.Module:
    """Put ``model`` on the mesh as :func:`param_shardings` says (in place;
    returns it): each sharded vocabulary head becomes a :class:`VocabShard`
    that keeps this model rank's rows of its weight and bias."""
    from torch.distributed.tensor import Shard

    placements = param_shardings(model, mesh, shard_vocab)
    n, index = axis_size(mesh, MODEL_AXIS), axis_index(mesh, MODEL_AXIS)
    for mod_name, mod in list(model.named_modules()):
        if isinstance(mod, VocabShard) or not mod_name:
            continue
        if placements.get(f"{mod_name}.weight", (None, None))[1] == Shard(0):
            parent_name, _, child = mod_name.rpartition(".")
            parent = model.get_submodule(parent_name) if parent_name else model
            setattr(parent, child, VocabShard(mod, model_group(mesh), n, index))
    return model


# --------------------------------------------------------------------------
# collectives with their gradients
# --------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks; its gradient is the sum of
    the ranks' gradients (the adjoint of a sum that every rank reads).
    ``group=None`` returns ``x``."""
    return x if group is None else _AllReduceSum.apply(x, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over ``group`` (the input of a
    column-parallel layer, each rank of which reaches it through its own
    columns only)."""
    return _CopyToGroup.apply(x, group)


def _all_gather(x: torch.Tensor, group, n: int):
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, index):
        ctx.dim, ctx.index, ctx.n = dim, index, n
        wide = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
        return torch.cat(_all_gather(wide, group, n), dim).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, ctx.dim)[ctx.index].contiguous(), None, None, None, None


def gather_columns(x: torch.Tensor, dim: int, group, n: int, index: int) -> torch.Tensor:
    """The model ranks' equal slices of a tensor concatenated along ``dim``
    (half-precision slices travel as f32); its gradient is this rank's
    slice of the whole tensor's."""
    return _GatherColumns.apply(x, dim, group, n, index)


def gather_rows(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """``group``'s ranks' ``x`` concatenated along dim 0, in rank order (no
    gradient)."""
    return torch.cat(_all_gather(x, group, n), 0)


def gather_data_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every data shard's ``x`` in shard order, as model rank 0 of each shard
    holds it, so every rank of the world gets the same tensor."""
    n_model = axis_size(mesh, MODEL_AXIS)
    parts = _all_gather(x, None, dist.get_world_size())
    return torch.cat(parts[::n_model], 0)


def all_gather_objects(obj, mesh, axis: Optional[str] = None) -> list:
    """The ranks' ``obj`` along ``axis`` (None: the world), in rank order,
    over the gloo object group."""
    group = object_group(mesh, axis)
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def barrier(mesh) -> None:
    """Wait for every rank of the world (over gloo)."""
    dist.barrier(group=object_group(mesh))


class VocabShard(nn.Module):
    """A vocabulary head (a bias-carrying 1x1 ``Conv`` over NCHW, or an
    ``nn.Linear``) split by output channel over the model axis: it holds
    rows ``[index * K / n, (index + 1) * K / n)`` of the head's weight and
    bias as ``weight`` / ``bias`` (so state-dict names stay the head's),
    computes those output channels and gathers the full output over the
    group.  Computes in ``promote(input, weight)`` as the port's ``Conv``."""

    def __init__(self, head: nn.Module, group, n: int, index: int):
        super().__init__()
        self.group, self.n, self.index = group, n, index
        self.conv = head.weight.ndim == 4
        if self.conv:
            self.stride, self.padding, self.groups = head.stride, head.padding, head.groups
        self.weight = nn.Parameter(head.weight.detach().chunk(n, 0)[index].clone())
        self.bias = (None if head.bias is None
                     else nn.Parameter(head.bias.detach().chunk(n, 0)[index].clone()))

    def forward(self, x):
        x = copy_to_group(x, self.group)
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        if self.conv:
            y = torch.nn.functional.conv2d(x.to(dt), self.weight.to(dt), b, self.stride,
                                           self.padding, 1, self.groups)
            return gather_columns(y, 1, self.group, self.n, self.index)
        y = torch.nn.functional.linear(x.to(dt), self.weight.to(dt), b)
        return gather_columns(y, -1, self.group, self.n, self.index)


# --------------------------------------------------------------------------
# random draws at the global shape
# --------------------------------------------------------------------------

class RowDraw(NamedTuple):
    """Draws as one device would make them on the global batch: ``total``
    rows from ``generator`` (a CPU ``torch.Generator``), of which this rank
    keeps ``rows`` (a slice or an index tensor)."""

    generator: torch.Generator
    total: int
    rows: Union[slice, torch.Tensor, Sequence[int]]


def global_draw(shape, gen) -> torch.Tensor:
    """``torch.rand(shape)`` on the CPU from ``gen``: a ``torch.Generator``
    (or None, the default one), or a :class:`RowDraw`, for which the draw is
    made at ``(gen.total, *shape[1:])`` and this rank's rows kept."""
    shape = tuple(shape)
    if not isinstance(gen, RowDraw):
        return torch.rand(shape, generator=gen)
    u = torch.rand((gen.total,) + shape[1:], generator=gen.generator)
    rows = gen.rows if isinstance(gen.rows, slice) else torch.as_tensor(gen.rows)
    u = u[rows]
    if u.shape[0] != shape[0]:
        raise ValueError(f"a draw of {shape[0]} rows kept {u.shape[0]} of {gen.total}")
    return u
