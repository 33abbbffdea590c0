"""Pipeline parallelism: GPipe microbatching over the ``pp`` mesh axis
(counterpart of ``ray_tpu/parallel/pipeline.py``).

Every shard along ``pp`` holds one stage's parameters; activations hop
stage -> stage + 1 over ``n_stages + n_microbatches - 1`` ticks (the
bubble is GPipe's cost). Autograd gives the backward: the transpose of a
hop is the reverse hop, so the backward runs the pipeline in reverse.

One controller drives every shard, so the schedule differs from the
reference's in what it computes, not in its values. The reference runs
every stage on every tick and masks the inactive ticks with ``where``:
their values reach no output and no gradient. Here stage s runs on tick
t only when it holds a microbatch (0 <= t - s < M), so each stage runs M
times, not n + M - 1, and a hop carries only an active stage's output
(the reference's ``ppermute`` of the ring also sends the last stage's
output back to stage 0, which never reads it).

Across processes (a mesh whose ``pp`` groups span processes, as the
reference's ``pp`` spans hosts): each process runs only the stages its
shards hold, on the same ticks. A hop inside a process is a copy; a hop
across processes is a send and a receive (``collective.ops.route``). The
processes hold different stages, so their autograd graphs differ, and
autograd would reach the hops' backward in an order of its own in each.
So the pipeline is one ``torch.autograd.Function`` that runs GPipe's
schedule itself, as ``torch.distributed.pipelining`` does: the forward
keeps each (tick, stage) call's inputs and outputs (the call's own
graph); the backward walks the ticks in reverse, calling
``torch.autograd.grad`` on each call, and hops each input cotangent back
to the previous stage at a fixed point. The order of the exchanges, in
both directions, is: the forward's hops of tick 0, 1, .., n + M - 2,
each tick's hops by stage and then by ``pp`` group in ``groups`` order;
then the last stage's outputs to every shard of its group (the
reference's masked ``psum``), by group; the backward runs the same
lists reversed: first every shard's output cotangent back to the last
stage, summed there in group order (the ``psum``'s transpose), then
tick n + M - 2 down to 0. Every process computes these lists, so a pair
of processes posts its sends and receives in one order; the backward is
one autograd node, so it runs once however many devices a process
drives.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.collective import ops as cops
from ray_tpu_torch.collective.order import backward_order
from ray_tpu_torch.parallel.mesh import Mesh


def _tree_map(fn, *trees):
    """``fn`` over the leaves of tensors or (nested) tuples and lists of
    them: the activation pytrees a stage passes on."""
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def stage_mesh(mesh: Mesh, axis_name: str, stage: int) -> Mesh:
    """The sub-mesh of the shards at ``stage`` along ``axis_name`` (that
    axis kept at size 1); its flat order is the mesh's order restricted
    to those shards."""
    k = mesh.axis_names.index(axis_name)
    index = [slice(None)] * mesh.devices.ndim
    index[k] = slice(stage, stage + 1)
    return mesh.sub(tuple(index))


def pipeline_spmd(
    stage_fn: Callable[[int, Mesh, List[Any], List[Any]], List[Any]],
    stage_params: Sequence[Any],
    microbatches: Sequence[Any],
    *,
    mesh: Mesh,
    axis_name: str = "pp",
) -> List[Any]:
    """Run ``stage_fn`` as a GPipe pipeline over every shard of ``mesh``.

    ``stage_fn(stage, sub_mesh, params, acts) -> acts'`` runs one stage on
    the shards of ``stage_mesh(mesh, axis_name, stage)`` (``params`` and
    ``acts`` their per-shard lists in its flat order; ``acts'`` keeps each
    activation's structure and shapes). It may hold collectives over that
    sub-mesh's other axes. ``stage_params`` and ``microbatches`` are
    per-shard lists over the mesh (``mesh.devices.flat`` order; of a
    mesh that spans processes, this process's shards, ``axis_name``
    staying inside each process); every
    leaf of a microbatch pytree has a leading axis M, and only stage 0's
    are read. Returns the per-shard list of the last stage's outputs
    stacked over M, delivered to every shard as the reference's masked
    ``psum`` does."""
    n = cops.axis_size(mesh, axis_name)
    first = microbatches[0]
    while isinstance(first, (tuple, list)):
        first = first[0]
    M = first.shape[0]
    if n == 1:
        outs = [stage_fn(0, mesh, list(stage_params),
                         [_tree_map(lambda a, i=i: a[i], mb)
                          for mb in microbatches]) for i in range(M)]
        return [_tree_map(lambda *xs: torch.stack(xs), *per)
                for per in zip(*outs)]
    owner = mesh.processes.reshape(-1)
    if any(len(set(owner[g].tolist())) > 1
           for g in cops.groups(mesh, axis_name)):
        return _pipeline_across(stage_fn, stage_params, microbatches, mesh,
                                axis_name, n, M)
    devices = mesh.local_devices
    stage_of = np.asarray(cops.axis_indices(mesh, axis_name))
    members = [np.flatnonzero(stage_of == s).tolist() for s in range(n)]
    meshes = [stage_mesh(mesh, axis_name, s) for s in range(n)]
    params = [[stage_params[j] for j in members[s]] for s in range(n)]
    results: List[List[Any]] = []        # the last stage's outputs per t
    act_in: List[Any] = [None] * n       # what each stage received
    for t in range(n + M - 1):
        act_out: List[Any] = [None] * n
        for s in range(max(0, t - M + 1), min(t, n - 1) + 1):
            if s == 0:
                # Stage 0 injects microbatch t.
                inp = [_tree_map(lambda a: a[t], microbatches[j])
                       for j in members[0]]
            else:
                inp = act_in[s]
            act_out[s] = stage_fn(s, meshes[s], params[s], inp)
        if act_out[n - 1] is not None:
            results.append(act_out[n - 1])
        # The hop to the next stage (ppermute j -> j + 1), active pairs.
        act_in = [None] + [
            None if act_out[s] is None else [
                _tree_map(lambda a, d=devices[j]: a.to(d, copy=True), a)
                for a, j in zip(act_out[s], members[s + 1])]
            for s in range(n - 1)]
    # The last stage's outputs [M, ...] on each of its shards, broadcast
    # along the axis to every shard (the reference's masked psum).
    last = [_tree_map(lambda *xs: torch.stack(xs), *per)
            for per in zip(*results)]
    where = {j: i for i, j in enumerate(mesh.local_indices)}
    out: List[Any] = [None] * mesh.local_size
    for g in cops.groups(mesh, axis_name):
        if g[0] not in where:
            continue                 # a group of another process
        g = [where[j] for j in g]
        src = last[members[n - 1].index(g[-1])]
        for j in g:
            out[j] = _tree_map(lambda a, d=devices[j]: a.to(d, copy=True),
                               src)
    return out


# ------------------------------------------------------ across processes
def _flatten(tree) -> Tuple[List[torch.Tensor], Callable[[List], Any]]:
    """The tensor leaves of a tree of dicts, lists and tuples, and the
    function that puts a list of as many leaves back in their places
    (other leaves, such as None, stay as they are)."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda ls: ls[0]
    if isinstance(tree, (dict, list, tuple)):
        keys = list(tree) if isinstance(tree, dict) else range(len(tree))
        parts = [_flatten(tree[k]) for k in keys]
        cuts = np.cumsum([0] + [len(p[0]) for p in parts]).tolist()

        def rebuild(ls):
            vals = [b(ls[lo:hi]) for (_, b), lo, hi in
                    zip(parts, cuts[:-1], cuts[1:])]
            if isinstance(tree, dict):
                return dict(zip(keys, vals))
            return type(tree)(vals)

        return [l for p in parts for l in p[0]], rebuild
    return [], lambda ls: tree


def _grad_alias(t: torch.Tensor) -> torch.Tensor:
    """A leaf of this call's graph that shares ``t``'s storage."""
    t = t.detach()
    return t.requires_grad_(True) if t.is_floating_point() else t


class _Schedule:
    """GPipe's schedule over a mesh whose ``pp`` groups cross processes
    (module docstring): ``forward`` runs it, keeping each call's graph
    when asked; ``backward`` walks it in reverse. Shards are named by
    their flat index in the mesh (``j``) or their position in this
    process's lists (``i``)."""

    def __init__(self, stage_fn, mesh, axis_name, n, M, params_tree,
                 mbs_tree):
        self.stage_fn, self.mesh, self.n, self.M = stage_fn, mesh, n, M
        self.params_tree, self.mbs_tree = params_tree, mbs_tree
        self.groups = cops.groups(mesh, axis_name)
        self.local = mesh.local_indices
        self.where = {j: i for i, j in enumerate(self.local)}
        stage_of = cops.axis_indices(mesh, axis_name)
        # members[s]: the positions i of stage s's shards held here.
        self.members = [[i for i, st in enumerate(stage_of) if st == s]
                        for s in range(n)]
        self.meshes = [stage_mesh(mesh, axis_name, s) for s in range(n)]
        self.calls: Dict[Tuple[int, int], Tuple[list, list]] = {}

    def active(self, t: int) -> range:
        return range(max(0, t - self.M + 1), min(t, self.n - 1) + 1)

    def hops(self, t: int) -> List[Tuple[int, int]]:
        """The forward's hops after tick t: stage s -> s + 1 of every
        group, by stage, then group."""
        return [(g[s], g[s + 1]) for s in self.active(t)
                if s < self.n - 1 for g in self.groups]

    def _templates(self, pairs, stacked: bool) -> Dict[int, list]:
        """What each local destination of ``pairs`` receives: one
        microbatch's activation leaves (or all M, ``stacked``), shaped
        as its own microbatches."""
        return {j: [cops.like(a if stacked else a[0])
                    for a in _flatten(self.mbs[self.where[j]])[0]]
                for _, j in pairs if j in self.where}

    def forward(self, p_leaves, mb_leaves, record: bool) -> List:
        n, M, members, local = self.n, self.M, self.members, self.local
        alias = _grad_alias if record else torch.Tensor.detach
        self.params = self.params_tree([alias(t) for t in p_leaves])
        self.mbs = self.mbs_tree([t.detach() for t in mb_leaves])
        act_in: Dict[Tuple[int, int], list] = {}   # (t, i) -> leaves
        results: Dict[int, List[list]] = {}        # i -> leaves per t
        for t in range(n + M - 1):
            outs = {}
            for s in self.active(t):
                if not members[s]:
                    continue
                if s == 0:
                    inp = [_tree_map(lambda a: a[t], self.mbs[i])
                           for i in members[0]]
                else:
                    inp = [_flatten(self.mbs[i])[1](act_in.pop((t, i)))
                           for i in members[s]]
                if record:
                    inp = [_tree_map(_grad_alias, a) for a in inp]
                # A recorded call is a graph of its own (``backward``
                # takes its gradients alone), so its exchanges across
                # processes get a chain of their own.
                with torch.enable_grad() if record else torch.no_grad(), \
                        backward_order():
                    out = self.stage_fn(s, self.meshes[s],
                                        [self.params[i] for i in members[s]],
                                        inp)
                for i, o in zip(members[s], out):
                    leaves = _flatten(o)[0]
                    want = [cops.like(a[0])[:2]
                            for a in _flatten(self.mbs[i])[0]]
                    if [cops.like(x)[:2] for x in leaves] != want:
                        raise ValueError(
                            f"stage {s} changed an activation's shape or "
                            f"type; across processes a stage keeps both "
                            f"(a receiver sizes its buffer from its own "
                            f"microbatch)")
                    outs[local[i]] = leaves
                    if s == n - 1:
                        results.setdefault(i, []).append(
                            [x.detach() for x in leaves])
                if record:
                    self.calls[t, s] = (inp, out)
            hops = self.hops(t)
            for j, v in cops.route(self.mesh, hops, outs,
                                   self._templates(hops, False)):
                act_in[t + 1, self.where[j]] = v
        # The last stage's outputs [M, ...] to every shard of its group.
        last = {local[i]: [torch.stack(xs) for xs in zip(*per)]
                for i, per in results.items()}
        pairs = [(g[n - 1], j) for g in self.groups for j in g]
        got = dict(cops.route(self.mesh, pairs, last,
                              self._templates(pairs, True)))
        return [x for j in local for x in got[j]]

    def backward(self, cots) -> List:
        """The gradients of the parameter and microbatch leaves, in
        ``forward``'s order, from the outputs' cotangents."""
        n, M, members, local = self.n, self.M, self.members, self.local
        cots = list(cots)
        by_shard = {}
        for i, j in enumerate(local):
            mbs = _flatten(self.mbs[i])[0]
            by_shard[j] = [torch.zeros_like(a) if c is None else c
                           for a, c in zip(mbs, cots[:len(mbs)])]
            cots = cots[len(mbs):]
        # The delivery's transpose: every shard's cotangent back to its
        # group's last stage, summed there in group order.
        pairs = [(j, g[n - 1]) for g in self.groups for j in g]
        g_last: Dict[int, list] = {}
        for j, v in cops.route(self.mesh, pairs, by_shard,
                               self._templates(pairs, True)):
            i = self.where[j]
            g_last[i] = v if i not in g_last else [
                a + b for a, b in zip(g_last[i], v)]
        self.p_grads: Dict[int, torch.Tensor] = {}
        mb_grads: Dict[int, Dict[int, list]] = {}   # i -> t -> leaves
        out_cot: Dict[Tuple[int, int], list] = {}
        for t in reversed(range(n + M - 1)):
            in_cots = {}
            for s in reversed(self.active(t)):
                if not members[s]:
                    continue
                inp, out = self.calls.pop((t, s))
                cots = [[c[t - s] for c in g_last[i]] if s == n - 1
                        else out_cot.pop((t, i)) for i in members[s]]
                for i, g_in in zip(members[s], self._grad_call(
                        members[s], inp, out, cots)):
                    if s == 0:
                        mb_grads.setdefault(i, {})[t] = g_in
                    else:
                        in_cots[local[i]] = g_in
            hops = [(b, a) for a, b in self.hops(t - 1)] if t else []
            for j, v in cops.route(self.mesh, hops, in_cots,
                                   self._templates(hops, False)):
                out_cot[t - 1, self.where[j]] = v
        p_alias = _flatten(self.params)[0]
        grads = [self.p_grads.get(id(a)) for a in p_alias]
        for i in range(len(local)):
            for k, a in enumerate(_flatten(self.mbs[i])[0]):
                per = mb_grads.get(i)
                grads.append(None if per is None or not a.is_floating_point()
                             else torch.stack([per[t][k] for t in range(M)]))
        return grads

    def _grad_call(self, members, inp, out, cots) -> List[list]:
        """One call's backward (its shards' graphs may be joined by the
        stage's collectives, so one ``autograd.grad`` for all of them):
        its parameters' gradients added to ``p_grads``; returns each
        shard's input cotangent (zeros where none)."""
        outs = [(o, c) for tree, cot in zip(out, cots)
                for o, c in zip(_flatten(tree)[0], cot) if o.requires_grad]
        ins = [_flatten(a)[0] for a in inp]
        mine = [a for i in members for a in _flatten(self.params[i])[0]
                if a.requires_grad]
        wrt = [a for leaves in ins for a in leaves if a.requires_grad] + mine
        got = [None] * len(wrt)
        if outs and wrt:
            got = list(torch.autograd.grad(
                [o for o, _ in outs], wrt, [c for _, c in outs],
                allow_unused=True))
        n_in = len(wrt) - len(mine)
        for a, g in zip(mine, got[n_in:]):
            if g is not None:
                have = self.p_grads.get(id(a))
                self.p_grads[id(a)] = g if have is None else have + g
        it = iter(got[:n_in])
        g_in = [[(next(it) if a.requires_grad else None) for a in leaves]
                for leaves in ins]
        return [[torch.zeros_like(a) if g is None else g
                 for a, g in zip(leaves, gs)]
                for leaves, gs in zip(ins, g_in)]


class _Pipeline(torch.autograd.Function):
    """The pipeline across processes as one autograd node: its inputs
    every parameter and microbatch leaf of this process's shards, its
    outputs every leaf of the per-shard results."""

    @staticmethod
    def forward(ctx, schedule, n_params, *leaves):
        ctx.schedule = schedule
        return tuple(schedule.forward(leaves[:n_params], leaves[n_params:],
                                      record=True))

    @staticmethod
    def backward(ctx, *cots):
        grads = ctx.schedule.backward(cots)
        ctx.schedule = None
        return (None, None, *grads)


def _pipeline_across(stage_fn, stage_params, microbatches, mesh: Mesh,
                     axis_name: str, n: int, M: int) -> List[Any]:
    p_leaves, p_tree = _flatten(list(stage_params))
    mb_leaves, mb_tree = _flatten(list(microbatches))
    schedule = _Schedule(stage_fn, mesh, axis_name, n, M, p_tree, mb_tree)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in p_leaves + mb_leaves):
        flat = _Pipeline.apply(schedule, len(p_leaves), *p_leaves,
                               *mb_leaves)
    else:
        flat = schedule.forward(p_leaves, mb_leaves, record=False)
    out = []
    for i in range(mesh.local_size):
        leaves, rebuild = _flatten(schedule.mbs[i])
        out.append(rebuild(list(flat[:len(leaves)])))
        flat = flat[len(leaves):]
    return out
