"""Device mesh construction and axis conventions (counterpart of
``ray_tpu/parallel/mesh.py``, copied and trimmed).

Axis vocabulary (fixed across the framework):

- ``dp``   data parallel (batch sharding; gradients all-reduced over it)
- ``fsdp`` fully-sharded data parallel (params sharded, all-gathered per layer)
- ``pp``   pipeline parallel (layer stages; activations permuted)
- ``tp``   tensor parallel (hidden/head sharding inside matmuls)
- ``sp``   sequence/context parallel (ring attention / Ulysses over tokens)
- ``ep``   expert parallel (MoE token all-to-all)

The reference's mesh is a ``jax.sharding.Mesh`` that one process drives
through ``shard_map``. Here a ``Mesh`` is the same thing for PyTorch: a
numpy object array of ``torch.device`` with named axes, driven by one
process; ``ray_tpu_torch.collective`` exchanges per-shard tensors between
its devices.

Several processes (``parallel.distributed.initialize``): every process
builds the same mesh over every process's devices, laid out
process-major as ``jax.devices()`` orders them, so the outermost axis of
size > 1 is the one that crosses processes (and the next ones, once it
is used up). ``Mesh.processes`` records which process owns each entry;
each process holds the shards of its own entries, and every per-shard
list (``shard_params``, ``shard_tensor``, the collectives, the training
step's ``shards``) holds this process's shards only, in the mesh's flat
order. Every axis may cross processes, as the reference's ``make_mesh``
lays any axis across hosts; only its hybrid mesh keeps the ICI-bound
axes off the DCN tier (``distributed.make_hybrid_mesh``).

Default devices are the visible CUDA devices. Virtual shards are never
made implicitly: ``RAY_TPU_TORCH_VIRTUAL_DEVICES=n`` (read only here)
gives n shards of the first CUDA device (a CPU shard only where the
caller asks for ``"cpu"``), the counterpart of the reference
tests' ``--xla_force_host_platform_device_count``; an explicit
``devices=`` list may repeat a device to the same effect. Each virtual
shard owns its own tensors, so every sharded program runs for real on one
card, exchanges included.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

AXES = ("dp", "fsdp", "pp", "tp", "sp", "ep")

VIRTUAL_DEVICES_ENV = "RAY_TPU_TORCH_VIRTUAL_DEVICES"

_local = threading.local()


class Mesh:
    """Devices laid out on named axes: ``devices`` is a numpy object array
    of ``torch.device`` whose dimensions are ``axis_names``; ``shape``
    maps each axis name to its size, as ``jax.sharding.Mesh.shape`` does.

    ``processes`` (same shape, default all 0) is the process that owns
    each entry, and ``process`` this process's index: ``local_indices``
    are the flat indices of this process's entries, whose devices it
    drives (an entry of another process names the device as that process
    does). An axis along which the owner changes crosses processes."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 processes: Optional[np.ndarray] = None, process: int = 0):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} dimensions cannot "
                             f"take axis names {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.processes = (np.zeros(devices.shape, dtype=np.int64)
                          if processes is None
                          else np.asarray(processes, dtype=np.int64))
        if self.processes.shape != devices.shape:
            raise ValueError(f"processes of shape {self.processes.shape} "
                             f"for devices of shape {devices.shape}")
        self.process = int(process)
        self.local_indices = np.flatnonzero(
            self.processes.reshape(-1) == self.process).tolist()

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def spans_processes(self) -> bool:
        return bool(np.any(self.processes != self.process))

    @property
    def local_size(self) -> int:
        return len(self.local_indices)

    @property
    def local_devices(self) -> List[torch.device]:
        """This process's devices, in the mesh's flat order."""
        return [self.devices.flat[i] for i in self.local_indices]

    def sub(self, index) -> "Mesh":
        """The sub-mesh at numpy ``index`` (slices keep every axis)."""
        return Mesh(self.devices[index], self.axis_names,
                    self.processes[index], self.process)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at position 0 of every other axis:
        the shards of a program partitioned over ``axis`` alone (the
        reference replicates it over the other axes)."""
        if axis not in self.axis_names:
            raise ValueError(
                f"mesh has no axis {axis!r}; axes: {self.axis_names}")
        k = self.axis_names.index(axis)
        index = [0] * len(self.axis_names)
        index[k] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self) -> str:
        procs = (f", processes={self.processes.reshape(-1).tolist()}"
                 if self.spans_processes else "")
        return f"Mesh({self.shape}, devices={list(self.devices.flat)}{procs})"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes for each mesh axis; -1 on at most one axis means "absorb the
    rest". Unspecified axes default to 1, so every sharding annotation in
    the framework is valid on any mesh (a size-1 axis is a no-op shard)."""

    dp: int = -1
    fsdp: int = 1
    pp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1

    def sizes(self, n_devices: int) -> Tuple[int, ...]:
        vals = [self.dp, self.fsdp, self.pp, self.tp, self.sp, self.ep]
        if vals.count(-1) > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = math.prod(v for v in vals if v != -1)
        if n_devices % fixed:
            raise ValueError(
                f"mesh {vals} does not divide {n_devices} devices")
        if -1 in vals:
            vals[vals.index(-1)] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {vals} uses {fixed} devices, have {n_devices}")
        return tuple(vals)


def visible_devices(device_type: Optional[str] = None
                    ) -> List[torch.device]:
    """The devices a default mesh spans, of ``device_type`` (``"cuda"``
    when not given: an entry point never drops to the CPU on its own).
    With ``RAY_TPU_TORCH_VIRTUAL_DEVICES=n``: n virtual shards of the
    first device of that type (``cuda:0``, which must exist, or the CPU).
    Without it: every visible CUDA device (none on a machine without a
    card), or the one CPU when ``device_type`` is ``"cpu"``."""
    if device_type is None:
        device_type = "cuda"
    n_virtual = os.environ.get(VIRTUAL_DEVICES_ENV)
    if n_virtual:
        if device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device to hold virtual shards")
        first = (torch.device("cuda", 0) if device_type == "cuda"
                 else torch.device("cpu"))
        return [first] * int(n_virtual)
    if device_type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_mesh(
    config: Optional[MeshConfig] = None,
    *,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    **axis_sizes: int,
) -> Mesh:
    """Build a Mesh over the visible (or given) devices with the standard
    axes: ``make_mesh(dp=2, tp=4)`` or ``make_mesh(MeshConfig(tp=4))``.
    Devices are laid out as the reference lays them out, ``reshape(sizes)``
    over ``AXES`` with tp/sp/ep innermost, so the axes that exchange most
    land on adjacent devices.

    After ``parallel.distributed.initialize`` with several processes,
    every process calls this alike: ``devices`` (default: the process's
    own, ``distributed.local_devices()``) are this process's, the mesh
    spans every process's devices, process-major (module docstring), and
    every process group its collectives may use is made here
    (``distributed.ready_groups``)."""
    # distributed imports this module, so it is imported here.
    from ray_tpu_torch.parallel import distributed

    if config is None:
        config = MeshConfig(**axis_sizes) if axis_sizes else MeshConfig()
    elif axis_sizes:
        raise ValueError("pass either a MeshConfig or axis kwargs, not both")
    multi = distributed.process_count() > 1
    if devices is None:
        devices = distributed.local_devices() if multi else visible_devices()
        if not devices:
            raise RuntimeError(
                f"no CUDA device is visible; pass devices= or set "
                f"{VIRTUAL_DEVICES_ENV}")
    devs = [torch.device(d) for d in devices]
    processes = None
    if multi:
        devs, processes = distributed.global_devices(devs)
    sizes = config.sizes(len(devs))
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    if processes is not None:
        processes = np.asarray(processes).reshape(sizes)
    mesh = Mesh(arr.reshape(sizes), AXES, processes,
                distributed.process_index())
    distributed.ready_groups(mesh)
    return mesh


def mesh_shape(mesh: Mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def get_mesh() -> Optional[Mesh]:
    """The ambient mesh set by :func:`mesh_context` (or None)."""
    return getattr(_local, "mesh", None)


@contextlib.contextmanager
def mesh_context(mesh: Mesh):
    prev = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = prev
