"""Data parallelism of the port (counterpart of
`lgteun_tpu/parallel/mesh.py` and of its use in the JAX Runner).

The JAX package shards each batch over a named `data` axis of a device
mesh and lets GSPMD insert the gradient all-reduce. Here each rank is a
process (launched by `torchrun`, or spawned by `parallel/ranks.py`) with
its own device, and the reductions are explicit `torch.distributed`
collectives:

    make_mesh(mesh_shape, device=)   the rank's `Mesh`: rank, world size,
                                     device, process group (none for one
                                     rank without a launcher)
    shard_batch(batch, mesh)         the rank's contiguous rows
                                     [r*B/W, (r+1)*B/W), the rows that
                                     JAX's NamedSharding(mesh, P("data"))
                                     puts on device r; the whole batch on
                                     every rank when B % W != 0 (the JAX
                                     Runner's `_put_batch` replicates it)
    replicated(modules, mesh)        every parameter and buffer broadcast
                                     from rank 0
    all_reduce_grads(modules, mesh)  one SUM all-reduce of each module's
                                     gradients as one flat buffer
    all_gather_rows(t, mesh)         every rank's rows, in rank order

The contract is that a run over W ranks computes what the one-rank run
computes, up to the order of the gradient sums. Each rank's loss is
therefore the global batch's loss, and its backward reaches only its
own rows: the Runner's step generator of a sharded step is a
`ShardGenerator`, which names the rank's rows, and the loss terms reduce
through it:

    draw(sampler, shape, generator, device)
                              a draw at the global batch's shape, the
                              rank's rows kept (dropout masks, MutInf's
                              noise, WGAN-GP's eps: the one-rank draw's
                              rows, not the same rows on every rank)
    batch_mean(mean, generator)
                              the global batch's mean from the rank's mean
                              of its rows
    batch_sum(total, generator)
                              the global batch's sum
    batch_rows(t, generator)  the global batch's rows of a per-row value

Their forward is a collective; their backward is the identity on the
rank's share, because every rank computes the same loss from the same
reduced values, so the rank's gradients summed over ranks are the
gradient of the one-rank loss. With a plain generator (one rank, or a
replicated batch) each is the identity, so that path is bit-equal to the
Runner without a mesh.

Backends: NCCL where every rank has its own card, gloo on the CPU and
where ranks share a card (NCCL refuses two ranks on one device; gloo's
collectives run on host copies of CUDA tensors).

The `space` axis (height-sharded eval forwards, `parallel/spatial.py`):
`mesh_shape` {"space": s} or {"data": d, "space": s} with d * s the world
size lays the ranks out as JAX's `make_mesh` reshapes its devices, a
d x s grid in row-major order, so rank r = i * s + j holds data index i
and space index j. Every rank of a space group holds the same batch
rows (JAX's P("data") sharding), so `rows`, `shard` and the data
collectives above (`all_reduce_grads`, `all_gather_rows`, `batch_mean`,
...) run over the rank's `data_group` (None where d is 1: no collective);
`replicated`, `barrier` and `reduce_max` over the whole world. A Runner on
such a mesh trains and scores as the JAX Runner does: the forward is
the whole image's on every rank of a space group (the space axis shards
only `parallel.spatial.run_spatially_sharded`'s eval forwards), and the
gradients are SUM-reduced over the data group alone.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

__all__ = ["Mesh", "Shard", "ShardGenerator", "launcher", "make_mesh",
           "require_device",
           "check_mesh_shape", "shard_batch", "replicated",
           "all_reduce_grads", "all_gather_rows", "draw", "batch_mean",
           "batch_sum", "batch_rows"]


def launcher() -> tuple[int, int, int]:
    """(rank, world size, local rank) from a launcher's environment
    (torchrun's RANK, WORLD_SIZE, LOCAL_RANK); (0, 1, 0) without one."""
    env = os.environ
    return (int(env.get("RANK", 0)), int(env.get("WORLD_SIZE", 1)),
            int(env.get("LOCAL_RANK", 0)))


def check_mesh_shape(mesh_shape: dict | None, world: int
                     ) -> tuple[int, int]:
    """(data, space) sizes of `mesh_shape` on a world of `world` ranks:
    {} is (world, 1), {"data": d} (d, 1), {"space": s} (1, s); raise
    unless data * space is the world size, or for another axis or the
    axes in another order (nothing of a config's mesh is ignored)."""
    mesh_shape = dict(mesh_shape or {})
    other = sorted(set(mesh_shape) - {"data", "space"})
    if other:
        raise ValueError(
            f"mesh_shape axes {other} are not ported: the port's mesh has "
            "a 'data' axis and a 'space' axis")
    if list(mesh_shape) == ["space", "data"]:
        raise ValueError(
            "mesh_shape lists 'space' before 'data': the port lays ranks "
            "out data-major (rank = data index * space + space index); "
            "write {'data': d, 'space': s}")
    space = int(mesh_shape.get("space", 1))
    data = int(mesh_shape.get("data", 1 if "space" in mesh_shape
                              else world))
    if data < 1 or space < 1 or data * space != world:
        raise ValueError(
            f"mesh_shape data={data} x space={space} needs {data * space} "
            f"ranks, but the launcher gave world size {world}: launch "
            f"{data * space} ranks (python -m torch.distributed.run "
            "--nproc_per_node N ...) or leave mesh_shape empty")
    return data, space


@dataclass
class Mesh:
    """One rank of a run over `world` ranks laid out as a data x space
    grid (module docstring). `group` is None for one rank without a
    launcher (no process group, no collective); `owned` says that
    `make_mesh` made the process group and `close` ends it.
    `data_group` is the rank's group along `data` (the whole `group`
    without a space axis; None where the data axis has one rank) and
    `space_group` its group along `space` (None where space is 1)."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    group: object = None
    backend: str | None = None
    owned: bool = False
    space_world: int = 1
    data_group: object = None
    space_group: object = None

    def __post_init__(self):
        if self.space_world == 1 and self.data_group is None:
            self.data_group = self.group

    @property
    def data_world(self) -> int:
        return self.world // self.space_world

    @property
    def data_rank(self) -> int:
        return self.rank // self.space_world

    @property
    def space_rank(self) -> int:
        return self.rank % self.space_world

    def space_peer(self, j: int) -> int:
        """The global rank of space index j in the rank's space group."""
        return self.data_rank * self.space_world + j

    def rows(self, n: int) -> slice | None:
        """The rank's rows of a batch of n (split over the data axis), or
        None when n % data_world (every rank keeps all n)."""
        if n % self.data_world:
            return None
        per = n // self.data_world
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    def shard(self, n: int) -> "Shard | None":
        """The rank's `Shard` of a batch of n; None without a data group
        or when the batch is replicated (n % data_world)."""
        rows = self.rows(n)
        if self.data_group is None or rows is None:
            return None
        return Shard(self, rows.start, rows.stop, n)

    def barrier(self) -> None:
        if self.group is None:
            return
        if self.backend == "nccl":
            dist.barrier(self.group, device_ids=[self.device.index])
        else:
            dist.barrier(self.group)

    def reduce_max(self, value: float) -> float:
        """The largest `value` over the ranks."""
        if self.group is None:
            return value
        # NCCL reduces on the rank's card, gloo on the host
        t = torch.tensor([value], dtype=torch.float64, device=(
            self.device if self.backend == "nccl" else "cpu"))
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return float(t.item())

    def close(self) -> None:
        """End the process group `make_mesh` made (a no-op otherwise)."""
        if self.owned and dist.is_initialized():
            dist.destroy_process_group()
        self.owned = False


@dataclass(frozen=True)
class Shard:
    """Rows [start, stop) of a global batch of `total` rows, held by one
    rank of `mesh`."""

    mesh: Mesh
    start: int
    stop: int
    total: int

    @property
    def fraction(self) -> float:
        return (self.stop - self.start) / self.total


class ShardGenerator(torch.Generator):
    """The step generator of one rank of a sharded step: a
    `torch.Generator` seeded as every other rank's, which also names the
    rank's rows (`shard`), so that `draw` keeps the rank's rows of the
    global draw and the loss terms reduce over the ranks."""

    def __new__(cls, device, shard: Shard):
        return super().__new__(cls, device=device)

    def __init__(self, device, shard: Shard):
        self.shard = shard


def _resolve_device(device, local_rank: int, local_world: int,
                    backend: str | None) -> tuple[torch.device, str]:
    """(the rank's device, the backend): "cuda" takes card local_rank when
    every local rank has its own card (NCCL by default), else the ranks
    share the cards round robin and need gloo."""
    device = torch.device(device)
    if device.type != "cuda":
        return device, backend or "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} asked for, but torch "
                           "sees no CUDA device")
    n = torch.cuda.device_count()
    shared = local_world > n
    if device.index is None:
        device = torch.device("cuda", local_rank % n)
    if backend is None:
        backend = "gloo" if shared else "nccl"
    if backend == "nccl" and shared:
        raise ValueError(f"{local_world} local ranks on {n} card(s): NCCL "
                         "refuses two ranks on one device; use gloo")
    return device, backend


def _subgroups(rank: int, data: int, space: int) -> tuple:
    """(data group, space group) of `rank` on a data x space grid of the
    default group: every rank makes every subgroup, in one order (a
    collective); a group of one rank is None, a group of every rank the
    default group."""
    world = dist.group.WORLD
    mine = {}
    for axis, groups in (
            ("data", [[i * space + j for i in range(data)]
                      for j in range(space)]),
            ("space", [[i * space + j for j in range(space)]
                       for i in range(data)])):
        for ranks in groups:
            if len(ranks) == 1:
                group = None
            elif len(ranks) == data * space:
                group = world
            else:
                group = dist.new_group(ranks)
            if rank in ranks:
                mine[axis] = group
    return mine["data"], mine["space"]


def require_device(device) -> None:
    """Raise where `device` is a card and torch sees none: an entry point
    runs on the CPU only when asked for it."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} asked for, but torch "
                           "sees no CUDA device; pass --device cpu "
                           "(device=\"cpu\") to run the plain versions on "
                           "the CPU")


def make_mesh(mesh_shape: dict | None = None, *, device="cuda",
              backend: str | None = None,
              init_method: str | None = None) -> Mesh:
    """The rank's mesh on `device` (the card unless the caller asks for
    the CPU; `require_device`). Without a launcher (no WORLD_SIZE in the
    environment, no `init_method`, no process group yet): one rank, no
    process group, the Runner's path without collectives. Otherwise the
    default process group (made here from RANK / WORLD_SIZE and
    MASTER_ADDR / MASTER_PORT, or `init_method`, e.g. a file:// one; a
    group already made is used as it is, so a second mesh of another
    shape can be laid over it). `mesh_shape` {} is the whole world on
    `data`; {"data": d}, {"space": s} or {"data": d, "space": s} must
    multiply to the world size (`check_mesh_shape`), and a space axis
    makes the rank's data and space subgroups (`dist.new_group`, on
    every rank in the same order). `backend` None: NCCL where each local
    rank has its own card, gloo otherwise (`_resolve_device`)."""
    require_device(device)
    rank, world, local_rank = launcher()
    launched = ("WORLD_SIZE" in os.environ or init_method is not None
                or dist.is_initialized())
    if not launched:
        check_mesh_shape(mesh_shape, 1)
        return Mesh(device=torch.device(device))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    owned = not dist.is_initialized()
    if owned:
        data, space = check_mesh_shape(mesh_shape, world)
        device, backend = _resolve_device(device, local_rank, local_world,
                                          backend)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world, rank=rank)
    else:
        rank, world = dist.get_rank(), dist.get_world_size()
        data, space = check_mesh_shape(mesh_shape, world)
        device, _ = _resolve_device(device, local_rank, local_world, backend)
        backend = dist.get_backend()
    if space == 1:
        return Mesh(rank=rank, world=world, device=device,
                    group=dist.group.WORLD, backend=backend, owned=owned)
    data_group, space_group = _subgroups(rank, data, space)
    return Mesh(rank=rank, world=world, device=device,
                group=dist.group.WORLD, backend=backend, owned=owned,
                space_world=space, data_group=data_group,
                space_group=space_group)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """The rank's rows of every entry of `batch` (arrays, tensors, the
    image ids); the batch itself when its size does not divide the data
    axis (replicated) or on one data rank."""
    n = len(next(v for k, v in batch.items() if k != "image_id"))
    rows = mesh.rows(n)
    if rows is None or mesh.data_world == 1:
        return batch
    return {k: v[rows] for k, v in batch.items()}


def _host_staged(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    return t.cpu() if mesh.backend != "nccl" and t.is_cuda else t


def _all_reduce_(t: torch.Tensor, mesh: Mesh, group=None) -> torch.Tensor:
    """SUM all-reduce of `t` in place over `group` (the data group by
    default), through a host copy under gloo."""
    src = _host_staged(mesh, t)
    dist.all_reduce(src, group=mesh.data_group if group is None else group)
    if src is not t:
        t.copy_(src)
    return t


@torch.no_grad()
def replicated(modules, mesh: Mesh) -> None:
    """Every parameter and buffer of `modules` (every module of a method:
    the discriminator, MutInf's `mi`, SFIIN's frozen LU buffers too)
    broadcast from rank 0."""
    if mesh.group is None:
        return
    for module in modules:
        for t in (*module.parameters(), *module.buffers()):
            src = _host_staged(mesh, t.data)
            dist.broadcast(src, 0, group=mesh.group)
            if src is not t.data:
                t.data.copy_(src)


@torch.no_grad()
def all_reduce_grads(modules, mesh: Mesh, average: bool = False) -> None:
    """One SUM all-reduce a module of its gradients, as one flat buffer
    (the parameters without a gradient, the same on every rank since
    every rank runs the same graph, are left out); `average` divides the
    sum by the data axis's size (a replicated batch: every rank computed
    the whole batch's gradient). Over the data group: the ranks of a
    space group hold the same rows."""
    if mesh.data_group is None:
        return
    for module in modules:
        grads = [p.grad for p in module.parameters() if p.grad is not None]
        if not grads:
            continue
        flat = _all_reduce_(torch.cat([g.reshape(-1) for g in grads]), mesh)
        if average:
            flat /= mesh.data_world
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def all_gather_rows(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Every data rank's `t` (the same shape on every rank), concatenated
    along dim 0 in data order, on t's device; `t` itself on one data
    rank."""
    if mesh is None or mesh.data_group is None:
        return t
    src = _host_staged(mesh, t).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.data_world)]
    dist.all_gather(parts, src, group=mesh.data_group)
    return torch.cat(parts).to(t.device)


class _SumOverRanks(torch.autograd.Function):
    """Forward: the SUM over the ranks; backward: the identity (every
    rank's loss is the same function of the sum, so the gradient of the
    rank's share is the loss's gradient of the sum)."""

    @staticmethod
    def forward(ctx, t, mesh):
        return _all_reduce_(t.clone(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherRows(torch.autograd.Function):
    """Forward: the global batch's rows; backward: the rank's rows of the
    gradient."""

    @staticmethod
    def forward(ctx, t, shard):
        ctx.rows = slice(shard.start, shard.stop)
        return all_gather_rows(t, shard.mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows], None


def _shard_of(generator) -> Shard | None:
    return getattr(generator, "shard", None)


def draw(sampler, shape, generator, device) -> torch.Tensor:
    """`sampler(shape, generator=, device=)` (torch.rand, torch.randn);
    under a `ShardGenerator` the rank's rows of the draw at the global
    batch's shape (shape[0] is the rank's row count)."""
    shard = _shard_of(generator)
    if shard is None:
        return sampler(shape, generator=generator, device=device)
    if shape[0] != shard.stop - shard.start:
        raise ValueError(f"a draw of {shape[0]} rows on a shard of "
                         f"{shard.stop - shard.start}")
    full = sampler((shard.total, *shape[1:]), generator=generator,
                   device=device)
    return full[shard.start:shard.stop]


def batch_mean(mean: torch.Tensor, generator) -> torch.Tensor:
    """The global batch's mean, on every rank, from the rank's `mean`
    over its rows (equal shares); `mean` itself without a shard."""
    shard = _shard_of(generator)
    if shard is None:
        return mean
    return _SumOverRanks.apply(mean * shard.fraction, shard.mesh)


def batch_sum(total: torch.Tensor, generator) -> torch.Tensor:
    """The global batch's sum, on every rank, from the rank's sum over
    its rows; `total` itself without a shard."""
    shard = _shard_of(generator)
    if shard is None:
        return total
    return _SumOverRanks.apply(total, shard.mesh)


def batch_rows(t: torch.Tensor, generator) -> torch.Tensor:
    """The global batch's rows of a per-row value `t` [b, ...] (a
    statistic that is not a sum over the rows, as QNR's batch means of
    per-image Q feeding |differences|, is then computed from them exactly
    as on one rank); `t` itself without a shard."""
    shard = _shard_of(generator)
    if shard is None:
        return t
    return _GatherRows.apply(t, shard)
