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
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import numpy as np
import torch

from ray_tpu_torch.collective import ops as cops
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
