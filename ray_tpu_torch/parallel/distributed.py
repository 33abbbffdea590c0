"""Multi-process bootstrap and DCN/ICI-aware meshes (counterpart of
``ray_tpu/parallel/distributed.py``).

The reference joins a ``jax.distributed`` coordination service, every
host adds its chips to one global device view, and the parallelism axes
are laid out so that bandwidth-hungry collectives (tp/sp/ep/fsdp) stay
inside a slice while only gradient sync (dp) and pipeline edges (pp)
cross the DCN between hosts. Here the processes join one
``torch.distributed`` process group (NCCL between cards; gloo only where
the caller names it) over a TCP store at the coordinator's address.
After ``initialize``, ``make_mesh`` and ``make_hybrid_mesh`` lay out
every process's devices process-major, so the outermost axes cross
processes; each process holds the shards of its own devices, and the
collectives of ``ray_tpu_torch.collective`` run the part of a group that
crosses processes over ``torch.distributed`` (``mesh.py``'s docstring).
Any axis may cross processes, as the reference's ``make_mesh`` lays any
axis across hosts: the gradient sync over dp, the pipeline's activation
hops over pp (``pipeline.py``), and the ICI-bound axes' exchanges
(fsdp's and tp's sums, sp's ring and all-to-all, ep's dispatch) over
``torch.distributed`` too. ``make_hybrid_mesh`` keeps the reference's
rule that an ICI-bound axis stays off the DCN tier.

One process (and the CPU tests' virtual shards) is the degenerate case:
``initialize()`` is a no-op with ``process_count() == 1`` and the hybrid
mesh is a flat reshape of this process's devices.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import Mesh, visible_devices

# Axes whose collectives must stay inside a slice (high bandwidth);
# dp/pp tolerate DCN (per-step gradient all-reduce / p2p activations).
ICI_AXES = ("fsdp", "tp", "sp", "ep")
DCN_AXES = ("dp", "pp")

_STORE_PREFIX = "ray_tpu_torch/distributed"
# The bound on every wait of the store and the process group.
TIMEOUT = datetime.timedelta(seconds=300)

_state: dict = {"initialized": False, "process_id": 0, "num_processes": 1,
                "store": None, "local_devices": None, "exchanges": 0,
                "groups": {}, "p2p_ready": False}


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               *, backend: str = "nccl") -> None:
    """Join the multi-process device plane (``jax.distributed`` shape).

    Arguments default from the environment (``RAY_TPU_COORDINATOR_ADDRESS``
    / ``RAY_TPU_NUM_PROCESSES`` / ``RAY_TPU_PROCESS_ID``), as in the
    reference. ``coordinator_address`` is ``host:port``: process 0 serves
    a TCP store there and every process joins
    ``torch.distributed.init_process_group(backend, store=...)``.
    ``local_device_ids`` are the CUDA cards this process drives (default:
    every card it sees); the first becomes the current device.
    ``backend`` is NCCL unless the caller names another (gloo for CPU
    shards, or for two processes on one card, which NCCL refuses);
    nothing falls back on its own. ``TIMEOUT`` bounds the store's and
    the process group's waits. With one process (or no coordinator
    configured) this is a local no-op: the single-process paths are
    unchanged."""
    from ray_tpu_torch._private.config import GlobalConfig

    coordinator_address = coordinator_address or \
        GlobalConfig.coordinator_address or None
    num_processes = num_processes if num_processes is not None else int(
        os.environ.get("RAY_TPU_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("RAY_TPU_PROCESS_ID", "0"))
    if num_processes <= 1 or not coordinator_address:
        _state.update(initialized=True, process_id=0, num_processes=1)
        return
    if _state["num_processes"] > 1:
        raise RuntimeError("distributed.initialize called twice; call "
                           "shutdown() first")
    local = None
    if local_device_ids is not None:
        local = [torch.device("cuda", int(i)) for i in local_device_ids]
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the NCCL backend needs a CUDA card; pass "
                               "backend='gloo' for CPU shards")
        torch.cuda.set_device((local or visible_devices())[0])
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0, timeout=TIMEOUT)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=TIMEOUT)
    _state.update(initialized=True, process_id=process_id,
                  num_processes=num_processes, store=store,
                  local_devices=local, exchanges=0, groups={},
                  p2p_ready=False)


def shutdown() -> None:
    if _state["num_processes"] > 1:
        dist.destroy_process_group()
    _state.update(initialized=False, process_id=0, num_processes=1,
                  store=None, local_devices=None, exchanges=0, groups={},
                  p2p_ready=False)


def is_initialized() -> bool:
    return _state["initialized"]


def process_count() -> int:
    return (dist.get_world_size() if _state["num_processes"] > 1
            else _state["num_processes"])


def process_index() -> int:
    return (dist.get_rank() if _state["num_processes"] > 1
            else _state["process_id"])


def local_devices() -> List[torch.device]:
    """The devices this process drives: ``initialize``'s
    ``local_device_ids``, else every visible card."""
    return list(_state["local_devices"] or visible_devices())


def global_devices(local: Sequence[torch.device]
                   ) -> Tuple[List[torch.device], List[int]]:
    """Every process's devices, process-major, and the owner of each:
    each process passes its own (``local``), and every process must call
    this alike (it meets the others through the store)."""
    names = _exchange("devices", ",".join(str(d) for d in local))
    devices, owners = [], []
    for p, joined in enumerate(names):
        for name in joined.split(","):
            devices.append(torch.device(name))
            owners.append(p)
    return devices, owners


def _exchange(tag: str, value: str) -> List[str]:
    """Every process's ``value``, by process index, through the store."""
    n = _state["exchanges"]
    _state["exchanges"] += 1
    store = _state["store"]
    store.set(f"{_STORE_PREFIX}/{tag}/{n}/{process_index()}", value)
    return [store.get(f"{_STORE_PREFIX}/{tag}/{n}/{p}").decode()
            for p in range(process_count())]


def process_group(ranks: Sequence[int]):
    """The ``torch.distributed`` group of these processes, made at first
    use and cached: every process must ask for the same groups in the
    same order (``new_group`` is collective over the whole world), as
    ``ready_groups`` does for every group of a mesh when the mesh is
    made."""
    ranks = tuple(sorted(int(r) for r in ranks))
    if ranks == tuple(range(process_count())):
        return dist.group.WORLD
    pg = _state["groups"].get(ranks)
    if pg is None:
        pg = _state["groups"][ranks] = dist.new_group(list(ranks))
    return pg


def ready_p2p(device: torch.device) -> None:
    """Make the world's NCCL communicator before the first point-to-point
    batch (an all-reduce of one element on ``device``, once): a batch of
    sends and receives runs on that communicator, and making it is
    collective over every process, while a batch may involve only some.
    Every process reaches it when it makes its first mesh that spans
    processes (``ready_groups``)."""
    if _state["p2p_ready"] or dist.get_backend() != "nccl":
        return
    dist.all_reduce(torch.zeros(1, device=device))
    _state["p2p_ready"] = True


def ready_groups(mesh: Mesh) -> None:
    """Make, in one order in every process, the process group of every
    set of processes that a group of ``mesh`` along some of its axes
    spans, and the world's NCCL communicator for point-to-point
    (``ready_p2p``). Making either is collective over every process,
    while a collective over a group may be reached by its members alone
    (a pipeline stage's tp sum runs in that stage's processes only), so
    ``make_mesh`` and ``make_hybrid_mesh``, which every process calls
    alike, make them all up front."""
    if not mesh.spans_processes:
        return
    procs = mesh.processes
    wide = [k for k, n in enumerate(procs.shape) if n > 1]
    sets = set()
    for r in range(1, len(wide) + 1):
        for ks in itertools.combinations(wide, r):
            rest = [k for k in range(procs.ndim) if k not in ks]
            rows = procs.transpose(rest + list(ks)).reshape(
                -1, math.prod(procs.shape[k] for k in ks))
            sets.update(tuple(sorted(set(row.tolist()))) for row in rows)
    for ranks in sorted(s for s in sets if len(s) > 1):
        process_group(ranks)
    ready_p2p(mesh.local_devices[0])


@dataclasses.dataclass(frozen=True)
class HybridMeshConfig:
    """Axis sizes split between the DCN tier (across hosts/slices) and the
    ICI tier (within a slice)."""

    dcn: Dict[str, int] = dataclasses.field(default_factory=dict)
    ici: Dict[str, int] = dataclasses.field(default_factory=dict)


def make_hybrid_mesh(config: HybridMeshConfig,
                     devices: Optional[Sequence] = None) -> Mesh:
    """Build a mesh whose axis ORDER encodes the network tier: DCN axes
    (dp, pp) are outermost, their neighbours in other processes, and ICI
    axes innermost. Only the axes larger than 1 are kept, as in the
    reference (ROADMAP C.16: ``make_spmd_train_step`` reads all six).
    With several processes the DCN axes are the process axes: their
    product must be the number of processes, and ``devices`` (default:
    ``local_devices()``) are this process's. With one process it is a
    flat reshape of ``devices`` (default: the visible cards)."""
    for name in config.dcn:
        if name not in DCN_AXES:
            raise ValueError(
                f"axis {name!r} must not cross DCN (ICI-bound axes: "
                f"{ICI_AXES}); put it in the ici tier")
    dcn_sizes = {a: config.dcn.get(a, 1) for a in DCN_AXES}
    ici_sizes = dict(config.ici)
    axis_names = tuple([a for a in DCN_AXES if dcn_sizes[a] > 1]
                       + list(ici_sizes))
    if not axis_names:
        raise ValueError("hybrid mesh needs at least one axis of size > 1")
    dcn_shape = tuple(dcn_sizes[a] for a in axis_names if a in DCN_AXES)
    ici_shape = tuple(ici_sizes[a] for a in axis_names
                      if a not in DCN_AXES)
    n_proc = process_count()
    owners = None
    if n_proc > 1:
        local = list(devices) if devices is not None else local_devices()
        devices, owners = global_devices([torch.device(d) for d in local])
        if math.prod(dcn_shape) != n_proc:
            raise ValueError(
                f"the DCN tier {dict(config.dcn)} spans "
                f"{math.prod(dcn_shape)} processes, have {n_proc}")
    elif devices is None:
        devices = visible_devices()
    total = math.prod(dcn_shape) * math.prod(ici_shape)
    if total != len(devices):
        raise ValueError(
            f"mesh asks for {total} devices, have {len(devices)}")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    shape = dcn_shape + ici_shape
    mesh = Mesh(arr.reshape(shape), axis_names,
                None if owners is None else np.reshape(owners, shape),
                process_index())
    ready_groups(mesh)
    return mesh


def host_local_batch_slice(global_batch: int, mesh: Optional[Mesh] = None
                           ) -> Tuple[int, int]:
    """(start, size) of this host's slice of a globally-sharded batch —
    the per-host data-loading contract (each host feeds only its chips).

    Without ``mesh`` (the reference's signature) the processes hold
    equal slices in process order, right where only ``dp`` or ``fsdp``
    crosses processes. ``mesh=`` is the port's one addition: only the
    batch axes (dp, fsdp) change a process's rows. Processes that differ
    only along ``tp``, ``sp``, ``ep`` or ``pp`` hold the same (dp, fsdp)
    blocks and need the same rows (``sp`` then cuts the sequence inside
    them), and the reference's rule would hand each such peer a part of
    a batch it needs whole. With it a process feeds the rows of the
    (dp, fsdp) blocks its shards hold (``sharding.data_rows``), the rows
    ``shard_host_local`` cuts."""
    if mesh is None:
        index, n = process_index(), process_count()
    else:
        from ray_tpu_torch.parallel.sharding import data_rows

        index, n = data_rows(mesh)
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{n} processes")
    per = global_batch // n
    return index * per, per
