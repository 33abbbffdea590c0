"""Collectives over a mesh axis, one controller (counterpart of
``ray_tpu/collective/ops.py``).

The reference's collectives are ``jax.lax`` operations inside
``shard_map``: one program per shard, each holding its own value. Here
the one process holds every shard's tensor: each function takes a list
of per-shard tensors and a ``Mesh`` with an axis name, or a tuple of
names whose shards are ordered row-major, as ``lax`` orders them, and
returns the list of per-shard results. The list holds either the shards
of one group along the axis (as many as the axis has) or every shard of
the mesh, in the order of ``mesh.devices.flat``; then the op runs on
each group of shards that share the other coordinates, as ``lax`` does
inside a ``shard_map`` over the whole mesh. Result ``j`` lives on shard
``j``'s device (the device of ``xs[j]``) in a buffer of its own, moved
there with ``.to(device, copy=True)``: on one device a copy, across GPUs
a peer copy. The reductions run on a group's first shard's device in
shard order.

A mesh that spans processes (``parallel.distributed``) takes the list of
this process's shards, in the mesh's flat order. A group whose members
all live here runs as above. ``allreduce``, ``allgather``,
``reducescatter``, ``broadcast`` and ``all_to_all`` also take groups that
cross processes: first the members held here are combined onto the
group's first local shard, as above; then ``torch.distributed`` carries
the combined value between the group's processes, over a process group
made for that set of processes, on this process's first device of the
mesh; then the result goes to each local member. Results keep ``lax``'s
row-major order, which is process-major. ``reducescatter`` is an
all-reduce followed by each member's block. ``all_to_all`` is built on
the all-gather: every member's tensor reaches every process, which picks
out its members' blocks (n times the bytes of a true all-to-all; the
all-gather's backward gives the inverse exchange). Gloo has only
``all_reduce`` and ``broadcast`` for CUDA tensors, so on gloo an
``allgather`` of CUDA tensors is an all-reduce of each process's block
placed in zeros.

``permute`` and ``send_recv`` across processes are point to point
(``route``): every (source, destination) pair of the call, for every
group, in one order that every process computes (groups in ``groups``
order, pairs in the order given); a pair inside this process is a copy,
a pair across processes a ``torch.distributed`` send and receive,
posted together (``batch_isend_irecv``), so NCCL, which matches a pair
of ranks' sends and receives by order and has no tags, pairs them as
posted. Over gloo a CUDA tensor is staged through host memory (gloo has
no point-to-point for CUDA tensors); over NCCL it goes from this
process's first device of the mesh. Its backward is the inverse route,
posted in the same order. The pipeline (``parallel/pipeline.py``) hops
its activations across processes through the same ``route``.

Every op is built of differentiable tensor operations (``.to``, sums,
``cat``, ``chunk``), so under autograd its backward is the transpose
that ``jax`` gives its ``lax`` counterpart: ``allreduce``'s is an
``allreduce`` of the cotangents delivered to every member, ``permute``'s
the inverse permutation and ``all_to_all``'s the inverse exchange
(``tests/test_torch_parallel.py`` holds each against ``jax.grad``). The
step across processes is a ``torch.autograd.Function`` whose backward is
the same transpose over ``torch.distributed``.

The backward's exchanges across processes run in one order in every
process, however many devices a process drives: each Function that
crosses processes is ordered in its scope's chain (``order.py``).

``permute`` and ``send_recv`` keep ``ppermute``'s rule: a shard that
receives nothing holds zeros.
"""

from __future__ import annotations

import math
from typing import (Callable, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.collective.order import in_order, link, ordered, unlink
from ray_tpu_torch.parallel import distributed
from ray_tpu_torch.parallel.mesh import Mesh

AxisName = Union[str, Sequence[str]]


def axis_size(mesh: Mesh, axis: AxisName) -> int:
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    for a in names:
        if a not in mesh.shape:
            raise ValueError(
                f"mesh has no axis {a!r}; axes: {mesh.axis_names}")
    return math.prod(mesh.shape[a] for a in names)


def axis_index(mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """Each shard's position along ``axis``, an int32 scalar on its
    device."""
    return [torch.tensor(i, dtype=torch.int32, device=d)
            for i, d in enumerate(mesh.axis_devices(axis))]


def _names(axis: AxisName) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_indices(mesh: Mesh, axis: AxisName) -> List[int]:
    """Every shard's position along ``axis`` (a tuple of names: row-major
    over them), in the order of ``mesh.devices.flat``: what
    ``lax.axis_index`` gives each shard of a ``shard_map`` over the whole
    mesh. Of a mesh that spans processes, this process's shards'."""
    axis_size(mesh, axis)
    coords = np.indices(mesh.devices.shape).reshape(mesh.devices.ndim, -1)
    index = np.zeros(mesh.size, dtype=np.int64)
    for a in _names(axis):
        k = mesh.axis_names.index(a)
        index = index * mesh.devices.shape[k] + coords[k]
    return index[mesh.local_indices].tolist()


def groups(mesh: Mesh, axis: AxisName) -> List[List[int]]:
    """The groups of shards along ``axis``: for each combination of the
    other axes' coordinates, the flat indices (into ``mesh.devices.flat``)
    of its shards, ordered as ``axis_indices`` orders them."""
    axis_size(mesh, axis)
    ks = [mesh.axis_names.index(a) for a in _names(axis)]
    others = [k for k in range(mesh.devices.ndim) if k not in ks]
    flat = np.arange(mesh.size).reshape(mesh.devices.shape)
    n = math.prod(mesh.devices.shape[k] for k in ks)
    return flat.transpose(others + ks).reshape(-1, n).tolist()


def _check_local(xs, mesh: Mesh, axis: AxisName) -> None:
    if len(xs) != mesh.local_size:
        raise ValueError(f"{len(xs)} shard tensors for axis {axis!r} of "
                         f"size {axis_size(mesh, axis)} (or a mesh of "
                         f"which this process holds {mesh.local_size})")


# op(parts, pos, n, cross): the members of one group of n held here
# (``parts``, at positions ``pos`` of the group), with ``cross`` None when
# the whole group lives in this process, else its ``_Cross``.
GroupOp = Callable[[List[torch.Tensor], List[int], int,
                    Optional["_Cross"]], List[torch.Tensor]]


def _per_group(xs: Sequence[torch.Tensor], mesh: Mesh, axis: AxisName,
               op: GroupOp) -> List[torch.Tensor]:
    """``op`` on the shards of one group (``xs`` as long as the axis), or
    on every group of the mesh (``xs`` as long as the mesh, or, of a mesh
    that spans processes, this process's shards)."""
    n = axis_size(mesh, axis)
    if len(xs) == n and not mesh.spans_processes:
        return op(list(xs), list(range(n)), n, None)
    _check_local(xs, mesh, axis)
    owner = mesh.processes.reshape(-1)
    where = {j: i for i, j in enumerate(mesh.local_indices)}
    gs = groups(mesh, axis)
    owners = [[int(owner[j]) for j in g] for g in gs]
    crossing = sorted({tuple(sorted(set(o))) for o in owners
                       if len(set(o)) > 1})
    # The mesh's maker made every crossing group's process group in every
    # process (distributed.ready_groups): here they come from the cache.
    pgs = {ranks: distributed.process_group(ranks) for ranks in crossing}
    home = mesh.local_devices[0]
    out = [None] * len(xs)
    for g, o in zip(gs, owners):
        pos = [k for k, j in enumerate(g) if j in where]
        if not pos:
            continue
        cross = (None if len(pos) == n
                 else _Cross(pgs[tuple(sorted(set(o)))], o, home))
        for k, r in zip(pos, op([xs[where[g[k]]] for k in pos], pos, n,
                                cross)):
            out[where[g[k]]] = r
    return out


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


def _contiguous(x: torch.Tensor) -> torch.Tensor:
    return x.clone(memory_format=torch.contiguous_format)


class _AllReduce(torch.autograd.Function):
    """``dist.all_reduce``; the backward all-reduces the cotangent. For
    max and min, ``ties`` counts the members behind each element of this
    process's ``x`` that hold it; the cotangent goes to the processes
    whose ``x`` holds the result, in proportion to their ties, so every
    member that holds it gets an even share. Ordered (``ordered``)."""

    @staticmethod
    def forward(ctx, x, pg, op, ties, after):
        y = _contiguous(x)
        dist.all_reduce(y, op=_REDUCE_OPS[op], group=pg)
        ctx.pg, ctx.op = pg, op
        if op != "sum":
            ctx.save_for_backward(x, y, ties)
        return y, link(ctx, after, x.device)

    @staticmethod
    def backward(ctx, g, _):
        g = _contiguous(g)
        dist.all_reduce(g, group=ctx.pg)
        if ctx.op != "sum":
            x, y, ties = ctx.saved_tensors
            share = (x == y).to(g.dtype) * ties
            total = _contiguous(share)
            dist.all_reduce(total, group=ctx.pg)
            g = g * share / total
        return g, None, None, None, unlink(ctx)


class _AllGather(torch.autograd.Function):
    """Each process's block [k, ...] -> every block in rank order
    [P * k, ...]; the backward all-reduces the cotangent and keeps this
    process's block. Ordered (``ordered``)."""

    @staticmethod
    def forward(ctx, block, pg, after):
        n, r, k = dist.get_world_size(pg), dist.get_rank(pg), block.shape[0]
        ctx.pg, ctx.rows = pg, slice(r * k, (r + 1) * k)
        token = link(ctx, after, block.device)
        if block.is_cuda and dist.get_backend(pg) == "gloo":
            full = block.new_zeros((n * k,) + tuple(block.shape[1:]))
            full[ctx.rows] = block
            dist.all_reduce(full, group=pg)
            return full, token
        outs = [torch.empty_like(block, memory_format=torch.contiguous_format)
                for _ in range(n)]
        dist.all_gather(outs, _contiguous(block), group=pg)
        return torch.cat(outs), token

    @staticmethod
    def backward(ctx, g, _):
        g = _contiguous(g)
        dist.all_reduce(g, group=ctx.pg)
        return g[ctx.rows], None, unlink(ctx)


class _Broadcast(torch.autograd.Function):
    """``dist.broadcast`` from global rank ``src``; the backward sums the
    cotangent onto the source (zeros elsewhere). Ordered
    (``ordered``)."""

    @staticmethod
    def forward(ctx, x, src, pg, after):
        y = _contiguous(x)
        dist.broadcast(y, src=src, group=pg)
        ctx.src, ctx.pg = src, pg
        return y, link(ctx, after, x.device)

    @staticmethod
    def backward(ctx, g, _):
        g = _contiguous(g)
        dist.all_reduce(g, group=ctx.pg)
        if dist.get_rank() != ctx.src:
            g = torch.zeros_like(g)
        return g, None, None, unlink(ctx)


class _Cross:
    """The step of one group across processes: ``owners[k]`` is the
    process of the group's k-th member, ``pg`` their process group and
    ``home`` the device this process exchanges on."""

    def __init__(self, pg, owners: List[int], home: torch.device):
        self.pg, self.owners, self.home = pg, owners, home

    def allreduce(self, x: torch.Tensor, op: str,
                  ties: Optional[torch.Tensor] = None) -> torch.Tensor:
        if ties is not None:
            ties = ties.to(self.home)
        y, = ordered(_AllReduce, x.to(self.home), self.pg, op, ties)
        return y.to(x.device)

    def allgather(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every member's tensor in group order, from this process's
        members' (in group order)."""
        ranks = sorted(set(self.owners))
        k = len(parts)
        if any(self.owners.count(q) != k for q in ranks):
            raise ValueError(f"an allgather across processes needs as many "
                             f"members in each; the group's owners are "
                             f"{self.owners}")
        full, = ordered(_AllGather,
                         torch.stack([p.to(self.home) for p in parts]),
                         self.pg)
        seen = dict.fromkeys(ranks, 0)
        rows = []
        for q in self.owners:
            rows.append(ranks.index(q) * k + seen[q])
            seen[q] += 1
        return [full[r].to(parts[0].device) for r in rows]

    def broadcast(self, x: torch.Tensor, root: int) -> torch.Tensor:
        """The root member's ``x`` (on its process; elsewhere ``x`` gives
        only the shape and type)."""
        y, = ordered(_Broadcast, x.to(self.home), self.owners[root],
                      self.pg)
        return y.to(x.device)


class Like(NamedTuple):
    """What a receiver needs of a tensor: its shape, type and device."""
    shape: torch.Size
    dtype: torch.dtype
    device: torch.device


def like(x: torch.Tensor) -> Like:
    return Like(x.shape, x.dtype, x.device)


def _p2p(sends: Sequence[Tuple[torch.Tensor, int]],
         recvs: Sequence[Tuple[torch.Tensor, int]], via: torch.device
         ) -> List[torch.Tensor]:
    """Send each ``(tensor, rank)`` of ``sends`` and receive a tensor like
    each ``(template, rank)`` of ``recvs`` (its shape and type; the result
    lands on the template's device), all posted at once. Both lists hold
    this process's side of one order that every process computes, so a
    pair of ranks matches its sends and receives in order. Tensors cross
    on ``via``: a CUDA tensor over gloo goes through host memory."""
    if not sends and not recvs:
        return []
    ops, keep = [], []
    for t, rank in sends:
        t = t.detach().to(via).contiguous()
        keep.append(t)
        ops.append(dist.P2POp(dist.isend, t, int(rank)))
    bufs = []
    for tmpl, rank in recvs:
        bufs.append(torch.empty(tmpl.shape, dtype=tmpl.dtype, device=via))
        ops.append(dist.P2POp(dist.irecv, bufs[-1], int(rank)))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [b.to(tmpl.device) for b, (tmpl, _) in zip(bufs, recvs)]


def _via(mesh: Mesh) -> torch.device:
    """The device this process's point-to-point tensors cross on: the
    host over gloo, else the mesh's first local device."""
    home = mesh.local_devices[0]
    if dist.get_backend() == "gloo":
        return torch.device("cpu")
    distributed.ready_p2p(home)
    return home


def route(mesh: Mesh, pairs: Sequence[Tuple[int, int]], values,
          templates) -> List[Tuple[int, List[torch.Tensor]]]:
    """Move tensors between shards of a mesh that may span processes, no
    autograd. ``pairs`` are (source, destination) flat indices of the
    mesh, in one order that every process computes; ``values[src]`` is
    the list of tensors a source of this process sends,
    ``templates[dst]`` what a destination of this process receives
    (shapes, types, devices: tensors or ``Like``). Returns, for each pair
    whose destination lives here, in ``pairs`` order, ``(dst,
    tensors)``: a copy onto the destination's device within the
    process, a send and a receive across processes (``_p2p``, every pair
    of the call posted together). Every process of the mesh calls it
    alike, whether or not it holds a pair."""
    owner = mesh.processes.reshape(-1)
    me = mesh.process
    via = _via(mesh) if mesh.spans_processes else None
    got: List[Optional[List[torch.Tensor]]] = [None] * len(pairs)
    sends, recvs, recv_at = [], [], []
    for k, (src, dst) in enumerate(pairs):
        if owner[dst] == me and owner[src] == me:
            got[k] = [v.to(t.device, copy=True)
                      for v, t in zip(values[src], templates[dst])]
        elif owner[src] == me:
            sends += [(v, owner[dst]) for v in values[src]]
        elif owner[dst] == me:
            recvs += [(t, owner[src]) for t in templates[dst]]
            recv_at.append((k, len(templates[dst])))
    if sends or recvs:
        flat = iter(_p2p(sends, recvs, via))
        for k, n in recv_at:
            got[k] = [next(flat) for _ in range(n)]
    return [(dst, v) for (_, dst), v in zip(pairs, got) if v is not None]


class _Route(torch.autograd.Function):
    """``permute`` across processes: each local shard's result is what
    its pair's source sent (zeros where nothing comes); the backward
    routes the cotangents back along the reversed pairs. Ordered
    (``ordered``)."""

    @staticmethod
    def forward(ctx, mesh, pairs, *xs_after):
        *xs, after = xs_after
        where = {j: i for i, j in enumerate(mesh.local_indices)}
        ctx.mesh, ctx.pairs, ctx.like = mesh, pairs, [like(x) for x in xs]
        out = [torch.zeros_like(x) for x in xs]
        got = route(mesh, pairs, {j: [xs[i]] for j, i in where.items()},
                    {j: [xs[i]] for j, i in where.items()})
        for dst, (v,) in got:
            out[where[dst]] = v
        return (*out, link(ctx, after, xs[0].device))

    @staticmethod
    def backward(ctx, *gs):
        gs = gs[:-1]
        mesh = ctx.mesh
        where = {j: i for i, j in enumerate(mesh.local_indices)}
        back = route(mesh, [(d, s) for s, d in ctx.pairs],
                     {j: [gs[i]] for j, i in where.items()},
                     {j: [ctx.like[i]] for j, i in where.items()})
        grads = [None] * len(gs)
        for src, (g,) in back:       # a permutation's sources are distinct
            grads[where[src]] = g
        return (None, None, *grads, unlink(ctx))


def _deliver(values: Sequence[torch.Tensor], xs: Sequence[torch.Tensor]
             ) -> List[torch.Tensor]:
    """values[j] copied onto shard j's device, into a buffer of its own."""
    return [v.to(x.device, copy=True) for v, x in zip(values, xs)]


def _on_first(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    dev = xs[0].device
    return [x.to(dev) for x in xs]


def _fold(parts: Sequence[torch.Tensor], op: str) -> torch.Tensor:
    """The members' reduction on the first one's device: a sum in order,
    or ``amax``/``amin``, whose gradient goes evenly to the members that
    hold the result (as ``jnp.max``'s does)."""
    parts = _on_first(parts)
    if op in ("max", "min"):
        stacked = torch.stack(parts)
        return stacked.amax(0) if op == "max" else stacked.amin(0)
    acc = parts[0]
    for x in parts[1:]:
        acc = acc + x
    return acc


@in_order
def allreduce(xs, mesh: Mesh, axis: AxisName, op: str = "sum"
              ) -> List[torch.Tensor]:
    if op not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unsupported reduce op {op!r}")

    def reduce(parts, pos, n, cross):
        acc = _fold(parts, op)
        if cross is not None and op in ("max", "min"):
            ties = (torch.stack(_on_first(parts)).detach()
                    == acc.detach()).sum(0).to(acc.dtype)
            acc = cross.allreduce(acc, op, ties)
        elif cross is not None:
            acc = cross.allreduce(acc, "sum")
        if op == "mean":
            acc = acc / n
        return _deliver([acc] * len(parts), parts)

    return _per_group(xs, mesh, axis, reduce)


@in_order
def allgather(xs, mesh: Mesh, axis: AxisName, *, tiled: bool = True,
              gather_axis: int = 0) -> List[torch.Tensor]:
    """Every shard gets every shard's tensor: concatenated along
    ``gather_axis`` (tiled) or stacked on a new axis there."""
    def gather(parts, pos, n, cross):
        every = _on_first(parts)
        if cross is not None:
            every = cross.allgather(every)
        joined = (torch.cat(every, dim=gather_axis) if tiled
                  else torch.stack(every, dim=gather_axis))
        return _deliver([joined] * len(parts), parts)

    return _per_group(xs, mesh, axis, gather)


@in_order
def reducescatter(xs, mesh: Mesh, axis: AxisName, *, scatter_axis: int = 0,
                  tiled: bool = True) -> List[torch.Tensor]:
    """The sum, split along ``scatter_axis``: shard j gets block j (tiled),
    or index j of an axis of size n, which it drops (not tiled)."""
    def scatter(parts, pos, n, cross):
        total = _fold(parts, "sum")
        if cross is not None:
            total = cross.allreduce(total, "sum")
        size = total.shape[scatter_axis]
        if tiled:
            if size % n:
                raise ValueError(f"scatter axis of size {size} does not "
                                 f"divide {n} shards")
            pieces = torch.chunk(total, n, dim=scatter_axis)
        else:
            if size != n:
                raise ValueError(f"untiled scatter axis of size {size} "
                                 f"needs {n} (the axis size)")
            pieces = total.unbind(scatter_axis)
        return _deliver([pieces[k] for k in pos], parts)

    return _per_group(xs, mesh, axis, scatter)


@in_order
def broadcast(xs, mesh: Mesh, axis: str, root: int = 0
              ) -> List[torch.Tensor]:
    """Every shard gets the root shard's value."""
    def bcast(parts, pos, n, cross):
        if cross is None:
            value = parts[root]
        else:
            # Elsewhere a stand-in of the root's shape, which needs grad
            # where the members do: every process then runs the backward's
            # all-reduce.
            mine = parts[pos.index(root)] if root in pos else \
                torch.zeros_like(parts[0],
                                 requires_grad=parts[0].requires_grad)
            value = cross.broadcast(mine, root)
        return _deliver([value] * len(parts), parts)

    return _per_group(xs, mesh, axis, bcast)


@in_order
def permute(xs, mesh: Mesh, axis: str, perm: Sequence[Tuple[int, int]]
            ) -> List[torch.Tensor]:
    """Shard dst gets shard src's value for each (src, dst) pair; a shard
    that receives nothing holds zeros (``ppermute``)."""
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"permutation {perm} repeats a source or a "
                         f"destination")
    sent = dict((d, s) for s, d in perm)
    owner = mesh.processes.reshape(-1)
    gs = groups(mesh, axis)
    if all(len(set(owner[g].tolist())) == 1 for g in gs):
        return _per_group(xs, mesh, axis, lambda g, pos, n, cross: [
            g[sent[j]].to(x.device, copy=True) if j in sent
            else torch.zeros_like(x) for j, x in enumerate(g)])
    _check_local(xs, mesh, axis)
    pairs = [(g[s], g[d]) for g in gs for s, d in perm]
    return list(ordered(_Route, mesh, pairs, *xs))


@in_order
def all_to_all(xs, mesh: Mesh, axis: str, split_axis: int, concat_axis: int,
               *, tiled: bool = True) -> List[torch.Tensor]:
    """Shard j gets block j of every shard's ``split_axis``, in shard
    order: concatenated along ``concat_axis`` (tiled), or, for a split
    axis of size n, which each piece drops, stacked on a new axis at
    ``concat_axis`` (not tiled)."""
    def exchange(g, pos, n, cross):
        parts = _on_first(g)
        if cross is not None:
            parts = cross.allgather(parts)
        if tiled:
            blocks = [torch.chunk(x, n, dim=split_axis) for x in parts]
            if any(len(b) != n or b[0].shape != b[-1].shape
                   for b in blocks):
                raise ValueError(f"split axis {split_axis} does not divide "
                                 f"{n} shards")
            out = [torch.cat([b[j] for b in blocks], dim=concat_axis)
                   for j in range(n)]
        else:
            if any(x.shape[split_axis] != n for x in parts):
                raise ValueError(f"untiled split axis needs size {n}")
            out = [torch.stack([x.select(split_axis, j) for x in parts],
                               dim=concat_axis) for j in range(n)]
        return _deliver([out[k] for k in pos], g)

    return _per_group(xs, mesh, axis, exchange)


def send_recv(xs, mesh: Mesh, axis: str, src: int, dst: int
              ) -> List[torch.Tensor]:
    """Point to point: dst receives src's value; everyone else holds
    zeros (``ppermute``'s rule)."""
    return permute(xs, mesh, axis, [(src, dst)])
