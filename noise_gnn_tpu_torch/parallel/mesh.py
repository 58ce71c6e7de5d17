"""The (data, model) grid over the ranks, and the port's collectives.

Port of ``noise_gnn_tpu/parallel/mesh.py``. JAX's mesh is a grid of devices
under one controller, and named shardings say where each array lives. Here
each rank is a process holding one device, and a :class:`Mesh` says which
rank this process is and which process group carries its ``data`` axis.
``replicated`` and ``batch_sharding`` become plain helpers: a broadcast from
rank 0, and this rank's rows of a leading dimension.

Axes:
  ``data``  -- seed-batch parallelism (DP) and node shards (halo, full graph);
  ``model`` -- tensor parallelism over the hidden dimension (TP): the
               columns of every weight that :func:`param_sharding` picks
               are split over the model ranks in contiguous blocks.

Rank r sits at data index ``r // M`` and model index ``r % M``, as JAX's
``reshape(n // M, M)`` lays the devices out. A :class:`Mesh`'s ``rank``,
``size`` and ``group`` are its data axis, so everything keyed on the data
axis (the batch rows, the draws, the halo partition, batch norm's sums,
the gradient all-reduce) reads the same at any M; ``model_rank``,
``model_size`` and ``model_group`` are the model axis. The ranks of one
data index hold the same generator state and draw what one data-parallel
rank draws.

The collectives are here, each a thin call of ``torch.distributed`` on one
axis's group: the all-reduce sum of one buffer (with :func:`sum_ranks`, its
autograd form, whose backward sums the gradient over the ranks), the
all-gather into one tensor (with :func:`gather_rows`, its autograd form,
whose backward keeps only this rank's slice, and :func:`gather_flat`, which
also puts a flat subgraph's rows in the one-process order),
``all_to_all_single`` and the point-to-point rounds; and on the model
axis, :func:`model_input` and :func:`gather_cols`, the two halves of
Megatron's column-parallel product (``models/layers.py::tp_matmul``).

A flat seed-first subgraph (``ops/sampler.py``) is laid out depth-major:
the seeds, then every depth-1 row, and so on. A rank's own flat subgraph is
its block of each depth, so its rows are not one block of the whole: the
draws over it (:meth:`Mesh.rand_flat`) and its gather (:func:`gather_flat`)
follow :func:`flat_rank_rows`.
Collectives that only move data move the bytes (a ``uint8`` view), so every
dtype takes the same path on every backend. Of gloo's collectives the
port gives CUDA tensors only to all-reduce and broadcast, whose CUDA forms
gloo has; a gloo group given CUDA tensors for any other collective stages
them through pinned host memory itself, as gloo's own CUDA forms do, and
says so once in the log. A collective that fails raises.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)
_STAGED_SAID: set = set()


@dataclass(frozen=True)
class Mesh:
    """This process's place in a (data, model) grid of ranks."""

    shape: dict  # {"data": D, "model": M}
    rank: int  # this process's index on the data axis
    group: object | None  # process group of the data axis; None where D == 1
    backend: str | None = None
    model_rank: int = 0  # this process's index on the model axis
    model_group: object | None = None  # process group of the model axis; None where M == 1

    @property
    def size(self) -> int:
        return int(self.shape["data"])

    @property
    def model_size(self) -> int:
        return int(self.shape["model"])

    def model_axis(self) -> "Mesh":
        """The model axis as a mesh of its own (its ranks as the data
        axis): what the model-axis collectives run on."""
        return Mesh({"data": self.model_size, "model": 1}, self.model_rank, self.model_group,
                    self.backend)

    def model_only(self) -> "Mesh":
        """This mesh with its data axis dropped: for a pass that every rank
        of a data group runs whole, with the one-process draws, whose
        column-sharded products still run over the model axis."""
        return Mesh({"data": 1, "model": self.model_size}, 0, None, self.backend,
                    self.model_rank, self.model_group)

    def rows(self, n: int) -> slice:
        """This rank's block of a leading dimension of ``n`` rows."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def rand(self, gen: torch.Generator, shape, device) -> torch.Tensor:
        """This rank's rows of ``torch.rand`` over the whole batch: every rank
        holds the same generator state and draws the [D * shape[0], ...]
        uniforms one process would draw, then keeps its own block, so the
        draws do not depend on how the rows are split over the ranks."""
        full = torch.rand((self.size * shape[0], *shape[1:]), generator=gen, device=device)
        return full[self.rows(full.shape[0])]

    def rand_flat(self, gen: torch.Generator, sizes, shape, device) -> torch.Tensor:
        """This rank's rows of ``torch.rand`` over a whole flat subgraph: the
        [D * sum(sizes), ...] uniforms one process would draw, of which the
        rank keeps its block of each depth (``sizes``: its rows a depth;
        ``shape``: its local tensor's)."""
        n = self.size * shape[0]
        full = torch.rand((n, *shape[1:]), generator=gen, device=device)
        return full[flat_rank_rows(sizes, self.size, self.rank, device)]


def flat_rank_rows(sizes, world: int, rank: int, device=None) -> torch.Tensor:
    """The rows of the whole flat subgraph (one process's depth-major
    layout) that ``rank`` of ``world`` holds, in its own order: its block of
    each depth, ``sizes[d]`` rows at depth d (a seed's subtree is one
    contiguous block of every depth, child-major)."""
    idx, base = [], 0
    for s in sizes:
        idx.append(base + rank * s + torch.arange(s, device=device))
        base += world * s
    return torch.cat(idx)


def flat_order(sizes, world: int, device=None) -> torch.Tensor:
    """The index that puts the rank-major all-gather of every rank's flat
    rows (each ``sum(sizes)`` rows, laid out as :func:`flat_rank_rows`) in
    the one-process order: depth by depth, each depth's blocks in rank
    order."""
    n, idx, base = sum(sizes), [], 0
    for s in sizes:
        idx += [r * n + base + torch.arange(s, device=device) for r in range(world)]
        base += s
    return torch.cat(idx)


_GROUPS: list = []  # [(default group, M, data groups, model groups)], reused by make_mesh


def _grid_groups(world: int, model: int):
    """(data groups, model groups) of the (world / M, M) grid, each list
    indexed by the other axis's index; a group of one rank is None. Every
    rank creates every group of more than one rank, in one fixed order
    (``new_group`` is collective), once per default group and M."""
    for pg, m, data_groups, model_groups in _GROUPS:
        if pg is dist.group.WORLD and m == model:
            return data_groups, model_groups
    d = world // model
    data_groups = [dist.new_group([i * model + j for i in range(d)]) if d > 1 else None
                   for j in range(model)]
    model_groups = [dist.new_group([i * model + j for j in range(model)])
                    for i in range(d)]
    _GROUPS[:] = [g for g in _GROUPS if g[0] is dist.group.WORLD]
    _GROUPS.append((dist.group.WORLD, model, data_groups, model_groups))
    return data_groups, model_groups


def make_mesh(n_devices: int | None = None, model_parallel: int = 1) -> Mesh:
    """The (data, model) grid over every rank of the default group (one
    rank, and no group, in a single process): D = world / M data indices
    of M model ranks each. Raises where M does not divide the ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} ranks not divisible by model_parallel={model_parallel}")
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"n_devices={n_devices} without a process group")
        return Mesh({"data": 1, "model": 1}, 0, None)
    if n_devices not in (None, world):
        raise ValueError(f"n_devices={n_devices}: the mesh spans all {world} ranks of the "
                         "group (a sub-mesh would need every rank to build its group)")
    rank, backend = dist.get_rank(), dist.get_backend()
    if model_parallel == 1:
        return Mesh({"data": world, "model": 1}, rank, dist.group.WORLD, backend)
    data_groups, model_groups = _grid_groups(world, model_parallel)
    d, m = divmod(rank, model_parallel)
    return Mesh({"data": world // model_parallel, "model": model_parallel}, d,
                data_groups[m], backend, m, model_groups[d])


def column_sharded(shape, model: int) -> bool:
    """The JAX package's TP rule for one leaf of whole ``shape``: a 2-D
    leaf whose columns divide by M shards them over ``model``; every
    other leaf is replicated."""
    return model > 1 and len(shape) == 2 and shape[1] % model == 0


def column_block(mesh: Mesh, width: int) -> slice:
    """This rank's contiguous block of ``width`` sharded columns."""
    c = width // mesh.model_size
    return slice(mesh.model_rank * c, (mesh.model_rank + 1) * c)


def param_sharding(mesh: Mesh, params):
    """The TP rule of the JAX package (``parallel/mesh.py::param_sharding``)
    over a nest of whole leaves: ``(None, "model")`` (columns split over
    the model axis) for each leaf :func:`column_sharded` picks, ``()``
    (replicated) for every other; all ``()`` at M = 1."""
    if isinstance(params, dict):
        return {k: param_sharding(mesh, v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(param_sharding(mesh, v) for v in params)
    return (None, "model") if column_sharded(tuple(params.shape), mesh.model_size) else ()


def replicated(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous) made equal on every rank: broadcast from rank 0,
    in place."""
    if not t.is_contiguous():
        raise ValueError("replicated broadcasts in place: t must be contiguous")
    if mesh.group is not None:
        dist.broadcast(_bytes(t), src=dist.get_global_rank(mesh.group, 0), group=mesh.group)
    return t


def batch_sharding(mesh: Mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` (a view)."""
    return t.narrow(dim, mesh.rows(t.shape[dim]).start, t.shape[dim] // mesh.size)


# ------------------------------------------------------------ collectives


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous ``uint8`` view of ``t`` (for collectives that only move
    data): the rows stay rows, each ``element_size()`` times wider."""
    t = t.contiguous()
    if t.dim() == 0:
        t = t.reshape(1)
    return t.view(torch.uint8)


def _staged(mesh: Mesh, what: str, *ts: torch.Tensor) -> bool:
    """True where a gloo group gets CUDA tensors for a collective other
    than all-reduce and broadcast; says so once per collective."""
    if mesh.backend != "gloo" or not any(t.is_cuda for t in ts):
        return False
    if what not in _STAGED_SAID:
        _STAGED_SAID.add(what)
        log.warning(f"gloo group given CUDA tensors: staging its {what} through pinned host "
                    "memory")
    return True


def _pinned(like: torch.Tensor) -> torch.Tensor:
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)


def _move(mesh: Mesh, what: str, collective, out: torch.Tensor,
          inp: torch.Tensor) -> torch.Tensor:
    """``collective(out_bytes, in_bytes)`` on the mesh's group, staged
    through pinned host memory where gloo gets CUDA tensors; returns out."""
    if not _staged(mesh, what, inp):
        collective(_bytes(out), _bytes(inp))
        return out
    h_out = _pinned(out)
    collective(_bytes(h_out), _bytes(_pinned(inp).copy_(inp)))
    return out.copy_(h_out)


def all_reduce_sum_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place (one call: pass one flat buffer)."""
    if mesh.group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """[D * n, ...]: every rank's ``t`` [n, ...], in rank order."""
    if mesh.group is None:
        return t
    t = t.contiguous()
    out = torch.empty((mesh.size * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    return _move(mesh, "all_gather", lambda o, i: dist.all_gather_into_tensor(
        o, i, group=mesh.group), out, t)


def all_to_all(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``all_to_all_single`` in equal blocks: block d of this rank's [D * b,
    ...] goes to rank d, and block s of the result came from rank s."""
    if mesh.group is None:
        return t
    t = t.contiguous()
    return _move(mesh, "all_to_all", lambda o, i: dist.all_to_all_single(
        o, i, group=mesh.group), torch.empty_like(t), t)


def send_recv(mesh: Mesh, send: torch.Tensor, to: int, recv_shape, frm: int) -> torch.Tensor:
    """One point-to-point round: ``send`` goes to rank ``to``, and a tensor
    of ``recv_shape`` (``send``'s dtype) comes from rank ``frm``."""
    send = send.contiguous()
    recv = torch.empty(tuple(recv_shape), dtype=send.dtype, device=send.device)
    staged = _staged(mesh, "send/recv", send)
    s_buf = _pinned(send).copy_(send) if staged else send
    r_buf = _pinned(recv) if staged else recv
    ops = []
    if s_buf.numel():
        ops.append(dist.P2POp(dist.isend, _bytes(s_buf), dist.get_global_rank(mesh.group, to),
                              group=mesh.group))
    if r_buf.numel():
        ops.append(dist.P2POp(dist.irecv, _bytes(r_buf),
                              dist.get_global_rank(mesh.group, frm), group=mesh.group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return recv.copy_(r_buf) if staged else recv


class _GatherRows(torch.autograd.Function):
    """All-gather along rows whose backward returns only this rank's slice
    of the incoming gradient, with no communication. Every rank computes the
    same loss from the gathered rows, so each rank's slice is the gradient
    of its own rows; the ranks' parameter gradients are then summed once
    (``train/steps.py::_step``). (``torch.distributed.nn``'s all-gather
    reduce-scatters in its backward, which would count the same loss D
    times.)"""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh, ctx.n = mesh, t.shape[0]
        return all_gather(mesh, t)

    @staticmethod
    def backward(ctx, grad):
        m = ctx.mesh
        return grad[m.rank * ctx.n:(m.rank + 1) * ctx.n], None


def gather_rows(mesh: Mesh | None, t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``t``, in rank order, differentiably (see
    :class:`_GatherRows`); ``t`` itself without a group."""
    if mesh is None or mesh.group is None:
        return t
    return _GatherRows.apply(t, mesh)


def gather_flat(mesh: Mesh | None, t: torch.Tensor, sizes) -> torch.Tensor:
    """The whole flat subgraph's rows of ``t`` in the one-process order,
    from every rank's own flat rows (``sizes``: its rows a depth),
    differentiably: the backward keeps this rank's rows (see
    :class:`_GatherRows`); ``t`` itself without a group."""
    if mesh is None or mesh.group is None:
        return t
    return gather_rows(mesh, t)[flat_order(sizes, mesh.size, t.device)]


class _SumRanks(torch.autograd.Function):
    """All-reduce sum whose backward all-reduces the gradient: every rank
    computes the same loss, and the ranks' rows each reach it through the
    sum, so the sum's gradient is the sum of the ranks' gradients (the
    batch statistics of ``models/layers.py::batch_norm``)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce_sum_(mesh, t.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum_(ctx.mesh, grad.contiguous().clone()), None


def sum_ranks(mesh: Mesh | None, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, differentiably (see :class:`_SumRanks`);
    ``t`` itself without a group."""
    if mesh is None or mesh.group is None:
        return t
    return _SumRanks.apply(t, mesh)


# ------------------------------------------------------------ model axis


def all_gather_cols(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """[n, M * c]: every model rank's column block [n, c] of ``t``, in
    model-rank order (the all-gather stacks the ranks along rows, [M * n,
    c], and the blocks are put side by side)."""
    if mesh.model_group is None:
        return t
    n, c = t.shape
    stacked = all_gather(mesh.model_axis(), t)
    return stacked.view(mesh.model_size, n, c).permute(1, 0, 2).reshape(n, mesh.model_size * c)


class _GatherCols(torch.autograd.Function):
    """The output half of a column-parallel product: the all-gather of the
    column blocks, whose backward keeps this rank's columns of the
    gradient (everything after it is replicated over the model axis, so
    every model rank holds the whole gradient)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh, ctx.c = mesh, t.shape[1]
        return all_gather_cols(mesh, t)

    @staticmethod
    def backward(ctx, grad):
        m, c = ctx.mesh.model_rank, ctx.c
        return grad[:, m * c:(m + 1) * c].contiguous(), None


def gather_cols(mesh: Mesh | None, t: torch.Tensor) -> torch.Tensor:
    """Every model rank's columns of ``t`` [n, c], side by side,
    differentiably (see :class:`_GatherCols`); ``t`` itself without a
    model group."""
    if mesh is None or mesh.model_group is None:
        return t
    return _GatherCols.apply(t, mesh)


class _ModelInput(torch.autograd.Function):
    """The input half of a column-parallel product: the identity forward,
    and in backward one all-reduce over the model axis of the gradients of
    every input (flattened into one f32 buffer). Each model rank's
    ``dy_local @ w_local^T`` is one block's share of the input's gradient;
    their sum is the whole of it."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        flat = all_reduce_sum_(ctx.mesh.model_axis(),
                               torch.cat([g.reshape(-1).float() for g in grads]))
        parts = torch.split(flat, [g.numel() for g in grads])
        return (None, *(p.view_as(g).to(g.dtype) for p, g in zip(parts, grads)))


def model_input(mesh: Mesh | None, *xs: torch.Tensor) -> tuple:
    """``xs`` unchanged, with their gradients summed over the model axis in
    backward (see :class:`_ModelInput`); ``xs`` themselves without a model
    group."""
    if mesh is None or mesh.model_group is None:
        return xs
    return _ModelInput.apply(mesh, *xs)
