"""The device-resident DAG executor: lower a static task DAG to one program
on the card (counterpart of ``ray_tpu/dag/jax_executor.py``, one device).

The reference compiles the whole DAG into one XLA program; this executor
keeps its tables and its schedule and runs them in PyTorch:

- **Object table**: every intermediate value lives in one device tensor
  ``obj[num_slots, *payload_shape]``: slots for the inputs, one per task
  output, and a last scratch slot that nothing reads.
- **Task table**: per compiled task its op, argument slots and output
  slot, as index tensors on the device.
- **Static wave schedule** (default): dependency levels are resolved at
  compile time. Each wave gathers its tasks' arguments
  (``obj[arg_slots]``), runs them and scatters the outputs. The reference
  runs a wave as ``vmap`` over ``lax.switch`` over the op table; PyTorch
  has no data-dependent switch under ``vmap``, so each wave's lanes are
  grouped by op on the host at compile time and each group runs as
  ``torch.func.vmap(op)`` over its gathered args ``[n, arity, *P]``.
  Padding lanes do not exist. Fused runs whose ops are the same functions
  in the same order share a group (the reference's op table still names
  each run, as ``op_names`` shows).
- **Dynamic frontier mode** (``dynamic=True``): an in-degree vector stays
  on the device; each iteration runs every compiled task, group by group,
  scatters the outputs of the ready ones (``indeg == 0 & ~done``) to their
  slots and the rest to the scratch slot, and decrements consumers'
  in-degrees by a segment-sum over the edge list. The reference's
  ``lax.while_loop`` tests ``done`` on the device; here the host reads it,
  once per chunk of iterations (below). An iteration after every task is
  done changes nothing: no task is ready, so every lane writes the
  scratch slot and no in-degree moves.
- **One program per execute on the card.** At the first execute the wave
  loop runs once eagerly (on a side stream, which also counts the dynamic
  mode's iterations) and is then captured as one CUDA graph: the static
  waves, or a chunk of as many dynamic iterations as the first run took.
  Every later execute copies the inputs into the table, replays the graph
  (the dynamic mode replays again while the host reads a task not done),
  and gathers the outputs. A replay overwrites the table, so each
  ``TorchDAGRef`` owns a gathered copy of its outputs. On the CPU the
  loop runs eagerly every time.

Multi-device (``mesh=``, a ``ray_tpu_torch.parallel.Mesh``): the task
schedule is partitioned over one mesh axis, as the reference partitions it
with ``shard_map``, and one process drives every shard
(``ShardedTorchDAG``). Each shard owns its object table on its own
device, PARTIALLY replicated as in the reference: a shard writes only its
own lanes' outputs and the slots it imports, so a slot that it neither
produces nor imports stays zero there. The compile work on the host is
the reference's: locality-aware lanes (a task lands on the shard that
produced most of its inputs, ``Wn`` lanes per shard per wave), per-wave
export sets packed to the largest export count ``X_max``, and one tiled
``allgather`` per wave of only the cross-shard-consumed outputs (none
when ``X_max == 0``). The dynamic frontier gives task ``ci`` to shard
``ci // Cn``; each iteration a shard fires at most ``F`` of its ready
tasks, lowest ids first, and the fired ids are gathered, the payloads too
unless every edge stays inside its owner's block (then the leaves
replicate once after the loop through a masked ``allreduce``). When every
shard sits on one CUDA device (virtual shards) the whole sharded execute,
every shard's waves and exchanges, is one CUDA graph, as on one device.
Shards on distinct devices run eagerly, since one graph cannot span
devices (tests/test_torch_multi_gpu.py runs that case on several cards;
per-device graphs are ROADMAP work).

Shapes are checked on the ``meta`` device (the reference's
``jax.eval_shape``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)
from ray_tpu_torch.collective.ops import allgather, allreduce
from ray_tpu_torch.device import resolve_device

# The reference's GlobalConfig defaults (``ray_tpu/_private/config.py``):
# padded arg slots per task, and the static level schedule by default.
WAVE_EXECUTOR_MAX_ARGS = 4
WAVE_EXECUTOR_DYNAMIC = False


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[1]


class TorchDAGRef:
    """Handle to a completed execution (``JaxDAGRef``'s counterpart). It
    owns its values: a later execute does not change them."""

    def __init__(self, values: torch.Tensor, multi: bool):
        self._values = values
        self._multi = multi

    def get(self):
        """The output(s) as numpy arrays (a list for a multi-output DAG)."""
        host = self._values.cpu()
        if self._multi:
            return [t.numpy() for t in host]
        return host.numpy()

    def device_value(self) -> torch.Tensor:
        """The output tensor, still on the device: ``[num_outputs, *P]``
        for a multi-output DAG, else ``P``-shaped."""
        return self._values


class _Group:
    """Lanes that run one op: ``fn`` vmapped over [n, arity, *P] args.
    ``lanes`` index the task mask of the dynamic modes."""

    def __init__(self, fn, arity, lanes, arg_slots, out_slots, device):
        self.fn = fn
        self.lanes = torch.tensor(lanes, dtype=torch.long, device=device)
        self.args = torch.tensor(arg_slots, dtype=torch.long,
                                 device=device).reshape(len(lanes), arity)
        self.out = torch.tensor(out_slots, dtype=torch.long, device=device)


def _vmapped(fn: Callable, arity: int) -> Callable:
    def branch(stacked):
        return fn(*[stacked[i] for i in range(arity)])

    return torch.func.vmap(branch)


class CompiledTorchDAG:
    """A compiled DAG (``CompiledJaxDAG``'s counterpart): ``execute(*inputs)``
    returns a ``TorchDAGRef``."""

    def __init__(self, *, num_inputs: int, multi_output: bool,
                 num_tasks: int, num_compiled_tasks: int, num_waves: int,
                 wave_width: int,
                 payload_shape, dtype, dynamic: bool, op_names: List[str],
                 device: torch.device, num_slots: int, leaf_slots,
                 waves: List[List[_Group]], groups: List[_Group],
                 scratch_slot: int, indeg0, edges, viz):
        self._init_meta(
            num_inputs=num_inputs, multi_output=multi_output,
            num_tasks=num_tasks, num_compiled_tasks=num_compiled_tasks,
            num_waves=num_waves, wave_width=wave_width,
            payload_shape=payload_shape, dtype=dtype, dynamic=dynamic,
            op_names=op_names, device=device, viz=viz)
        self._launches_per_reset = 2
        self._obj = torch.zeros((num_slots,) + self.payload_shape,
                                dtype=dtype, device=device)
        self._leaf_idx = torch.tensor(leaf_slots, dtype=torch.long,
                                      device=device)
        self._waves = waves
        self._groups = groups
        self._scratch = scratch_slot
        if dynamic:
            C = len(indeg0)
            self._indeg0 = torch.tensor(indeg0, dtype=torch.int32,
                                        device=device)
            self._indeg = self._indeg0.clone()
            self._done = torch.zeros(C, dtype=torch.bool, device=device)
            self._e_src = torch.tensor(edges[0], dtype=torch.long,
                                       device=device)
            self._e_dst = torch.tensor(edges[1], dtype=torch.long,
                                       device=device)

    def _init_meta(self, *, num_inputs, multi_output, num_tasks,
                   num_compiled_tasks, num_waves, wave_width, payload_shape,
                   dtype, dynamic, op_names, device, viz) -> None:
        self.num_inputs = num_inputs
        self.multi_output = multi_output
        self.num_tasks = num_tasks
        self.num_compiled_tasks = num_compiled_tasks
        self.num_waves = num_waves
        self.wave_width = wave_width
        self.payload_shape = tuple(payload_shape)
        self.dtype = dtype
        self.dynamic = dynamic
        self.op_names = op_names
        self.device = device
        self.num_shards = 1
        # Sharded-exchange metadata (None on one device, as in the
        # reference): lanes per shard per wave, and payloads shipped per
        # shard per wave (0: no collective).
        self.export_width: Optional[int] = None
        self.lanes_per_shard: Optional[int] = None
        # Host-side work per execute on the card, for the DAG phases of
        # chip_smoke.py: graph replays and other launches (input copies,
        # the dynamic state's reset, the output gather).
        self.graph_replays = 0
        self.host_launches = 0
        self._viz = viz
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._chunk = 0   # dynamic iterations per graph replay
        self._graphable = device.type == "cuda"

    # ------------------------------------------------------------- run
    def _run_group(self, g: _Group, out_slots: torch.Tensor) -> None:
        self._obj[out_slots] = g.fn(self._obj[g.args])   # [n, *P]

    def _run_static(self) -> None:
        for wave in self._waves:
            for g in wave:
                self._run_group(g, g.out)

    def _reset_frontier(self) -> None:
        self._indeg.copy_(self._indeg0)
        self._done.zero_()

    def _iteration(self) -> None:
        """One frontier step: every task runs; a ready task writes its
        slot, any other lane the scratch slot (which may repeat: written
        by assignment, never accumulated, never read)."""
        ready = (self._indeg == 0) & ~self._done
        for g in self._groups:
            self._run_group(g, torch.where(ready[g.lanes], g.out,
                                           self._scratch))
        self._done |= ready
        if self._e_src.numel():
            fired = ready[self._e_src].to(torch.int32)
            self._indeg -= torch.zeros_like(self._indeg).index_add_(
                0, self._e_dst, fired)

    def _all_done(self) -> bool:
        """Reads ``done`` on the host: one reduction and one sync."""
        if self.device.type == "cuda":
            self.host_launches += 1
        return bool(self._done.all())

    def _run_dynamic_eager(self) -> int:
        """The frontier loop with one host read of ``done`` per iteration;
        returns the number of iterations."""
        self._reset_frontier()
        n = 0
        while not self._all_done():
            self._iteration()
            n += 1
        return n

    def _capture(self) -> None:
        """First execute on the card: run the loop eagerly on a side stream
        (its results are this execute's), then capture it as one graph."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            if self.dynamic:
                self._chunk = max(1, self._run_dynamic_eager())
            else:
                self._run_static()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            if self.dynamic:
                for _ in range(self._chunk):
                    self._iteration()
            else:
                self._run_static()
        self._graph = graph

    def _replay(self) -> None:
        if self.dynamic:
            self._reset_frontier()
            self.host_launches += self._launches_per_reset
            self._graph.replay()
            self.graph_replays += 1
            while not self._all_done():    # one host read per chunk
                self._graph.replay()
                self.graph_replays += 1
        else:
            self._graph.replay()
            self.graph_replays += 1

    # --------------------------------------------------------- execute
    def _stage(self, i: int, x) -> None:
        """Input ``i`` into its table slot: a tensor is copied (and cast)
        as it is, so one on the device never passes through the host;
        Python scalars and numpy arrays become payload-dtype tensors."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x), dtype=self.dtype)
        self._obj[i].copy_(x.reshape(self.payload_shape))
        if self.device.type == "cuda":
            self.host_launches += 1

    def _gather_outputs(self) -> torch.Tensor:
        return self._obj[self._leaf_idx]   # a gathered copy the ref owns

    def execute(self, *inputs) -> TorchDAGRef:
        if len(inputs) != self.num_inputs:
            raise ValueError(
                f"compiled DAG takes {self.num_inputs} input(s), got "
                f"{len(inputs)}")
        for i, x in enumerate(inputs):
            self._stage(i, x)
        if self._graphable:
            if self._graph is None:
                self._capture()
            else:
                self._replay()
        elif self.dynamic:
            self._run_dynamic_eager()
        else:
            self._run_static()
        out = self._gather_outputs()
        if self.device.type == "cuda":
            self.host_launches += 1   # the gather (the copies: _stage)
        return TorchDAGRef(out if self.multi_output else out[0],
                           self.multi_output)

    def __call__(self, *inputs):
        return self.execute(*inputs).get()

    def teardown(self):
        """API parity with the reference's ``CompiledJaxDAG.teardown``;
        nothing to stop here."""

    def visualize_schedule(self, max_lanes: int = 8) -> str:
        """Render the compiled schedule: per-wave (and per-shard) lane
        tables with output slots, exported lanes marked ``*`` and each
        wave's cross-shard exchange spelled out (static), or the compiled
        tasks of the frontier (dynamic)."""
        shards = (f", sharded ×{self.num_shards}" if self.num_shards > 1
                  else "")
        header = (
            f"CompiledTorchDAG: {self.num_tasks} tasks, "
            f"{self.num_waves} waves × width {self.wave_width}{shards}, "
            f"{'dynamic frontier' if self.dynamic else 'static levels'}, "
            f"payload {self.payload_shape} {_dtype_name(self.dtype)}, "
            f"ops {self.op_names}"
        )
        viz = self._viz
        lines = [header]

        def lane_str(entries):
            cells = []
            for e in entries[:max_lanes]:
                star = "*" if (len(e) > 3 and e[3]) else ""
                cells.append(f"[{e[0]}]{e[1]}->s{e[2]}{star}")
            if len(entries) > max_lanes:
                cells.append(f"… +{len(entries) - max_lanes} lanes")
            return "  ".join(cells)

        if viz["mode"] == "static":
            for wi, wave in enumerate(viz["waves"]):
                lines.append(f"wave {wi}: {lane_str(wave)}")
        elif viz["mode"] == "sharded_static":
            for wi, by_shard in enumerate(viz["waves"]):
                lines.append(f"wave {wi}:")
                exports = []
                for sh in range(viz["n_sh"]):
                    entries = by_shard.get(sh, [])
                    if entries:
                        lines.append(f"  shard {sh}: {lane_str(entries)}")
                    for ci, name, slot, exp in entries:
                        if exp:
                            exports.append(f"shard{sh}:[{ci}]->s{slot}")
                if exports:
                    lines.append(
                        "  exchange (all_gather): " + ", ".join(exports))
                else:
                    lines.append("  exchange: none (no collective)")
        else:
            lines.append(
                f"dynamic frontier over {len(viz['tasks'])} compiled "
                f"tasks, {viz['n_edges']} edges"
                + (f", frontier width {viz['frontier_width']}/shard"
                   if viz.get("frontier_width") else ""))
            for ci, name, slot in viz["tasks"][:max_lanes]:
                lines.append(f"  [{ci}]{name}->s{slot}")
            if len(viz["tasks"]) > max_lanes:
                lines.append(f"  … +{len(viz['tasks']) - max_lanes} tasks")
        return "\n".join(lines)


class _Shard:
    """One shard of a ``ShardedTorchDAG``: its own object table on its own
    device and its part of the schedule (static: per-wave op groups and
    export tables; dynamic: its owned tasks and its copy of the frontier
    state)."""

    def __init__(self, device: torch.device, num_slots: int, payload_shape,
                 dtype, leaf_slots):
        self.device = device
        self.obj = torch.zeros((num_slots,) + tuple(payload_shape),
                               dtype=dtype, device=device)
        self.leaf_idx = self.long(leaf_slots)

    def long(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.long, device=self.device)


class ShardedTorchDAG(CompiledTorchDAG):
    """A compiled DAG partitioned over one mesh axis, every shard driven by
    this process (the reference's ``shard_map`` paths; see the module
    docstring). ``shards()`` exposes each shard's object table."""

    def __init__(self, *, mesh, mesh_axis: str, shards: List[_Shard],
                 scratch_slot: int, export_width: int, lanes_per_shard: int,
                 frontier: Optional[dict] = None, **meta):
        # The shards hold the tables: the one-device table of
        # CompiledTorchDAG.__init__ is not built.
        self._init_meta(**meta)
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.num_shards = len(shards)
        self.export_width = export_width
        self.lanes_per_shard = lanes_per_shard
        self._shards = shards
        self._scratch = scratch_slot
        # One CUDA graph holds every shard only when they share a device.
        self._graphable = (self.device.type == "cuda"
                           and len({sh.device for sh in shards}) == 1)
        self._launches_per_reset = 2 * len(shards)
        if frontier is not None:
            self._F = frontier["F"]
            self._C_pad = frontier["C_pad"]
            self._cross_payload = frontier["cross_payload"]

    def shards(self) -> List[torch.Tensor]:
        """Each shard's object table ``[num_slots, *P]``, on its device."""
        return [sh.obj for sh in self._shards]

    def _stage(self, i: int, x) -> None:
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x), dtype=self.dtype)
        x = x.reshape(self.payload_shape)
        for sh in self._shards:
            sh.obj[i].copy_(x)
        if self.device.type == "cuda":
            self.host_launches += len(self._shards)

    def _exchange(self, packed: List[torch.Tensor], wave: Optional[int] = None
                  ) -> List[torch.Tensor]:
        """Every shard's packed exports, gathered (tiled) onto every shard:
        the reference's one ``lax.all_gather`` per wave (static) or per
        iteration (dynamic, ``wave`` None)."""
        return allgather(packed, self.mesh, self.mesh_axis)

    def _run_static(self) -> None:
        for w in range(self.num_waves):
            for sh in self._shards:
                for g in sh.waves[w]:
                    sh.obj[g.out] = g.fn(sh.obj[g.args])
            if self.export_width:
                # Exports are read back from the table the shard just
                # wrote (padding reads the scratch slot and lands there).
                got = self._exchange(
                    [sh.obj[sh.exp_src[w]] for sh in self._shards], w)
                for sh, vals in zip(self._shards, got):
                    sh.obj[sh.exp_dst[w]] = vals

    def _reset_frontier(self) -> None:
        for sh in self._shards:
            sh.indeg.copy_(sh.indeg0)
            sh.done.copy_(sh.done0)

    def _iteration(self) -> None:
        """One frontier step. Each shard computes every task it owns and
        writes the outputs of the F lowest ready ids (the reference's
        ``top_k`` over ``-id``, here a rank by ``cumsum``: the same set);
        its other lanes write the scratch slot. The fired ids are
        gathered, with the payloads when an edge crosses shards, and every
        shard marks them done and decrements their consumers."""
        F, C_pad = self._F, self._C_pad
        chosen = []
        for sh in self._shards:
            ready = (sh.indeg == 0) & ~sh.done                 # [C_pad]
            mine = ready[sh.my_ids]                            # [Cn]
            rank = torch.cumsum(mine, 0) - 1
            fire = mine & (rank < F)
            for g in sh.groups:
                sh.obj[torch.where(fire[g.lanes], g.out, self._scratch)] = \
                    g.fn(sh.obj[g.args])
            ids = torch.full((F + 1,), C_pad, dtype=torch.long,
                             device=sh.device)
            ids.scatter_(0, torch.where(fire, rank, F), sh.my_ids)
            chosen.append(ids[:F])
        g_ids = allgather(chosen, self.mesh, self.mesh_axis)   # [n * F]
        if self._cross_payload:
            got = self._exchange([sh.obj[sh.out_ext[c]]
                                  for sh, c in zip(self._shards, chosen)])
            for sh, ids, vals in zip(self._shards, g_ids, got):
                sh.obj[sh.out_ext[ids]] = vals
        for sh, ids in zip(self._shards, g_ids):
            fired = torch.zeros(C_pad + 1, dtype=torch.bool,
                                device=sh.device).index_fill_(0, ids, True)
            fired = fired[:C_pad]
            sh.done |= fired
            if sh.e_src.numel():
                sh.indeg -= torch.zeros_like(sh.indeg).index_add_(
                    0, sh.e_dst, fired[sh.e_src].to(torch.int32))

    def _all_done(self) -> bool:
        if self.device.type == "cuda":
            self.host_launches += 1
        return bool(self._shards[0].done.all())

    def _gather_outputs(self) -> torch.Tensor:
        if self.dynamic and not self._cross_payload:
            # Leaves live only on their producer shard: replicate once
            # with a masked allreduce.
            parts = [torch.where(sh.leaf_mask, sh.obj[sh.leaf_idx],
                                 torch.zeros((), dtype=self.dtype,
                                             device=sh.device))
                     for sh in self._shards]
            if self.device.type == "cuda":
                # Per shard a gather and a select, then the allreduce's
                # adds and copies (the base counts one launch).
                self.host_launches += 4 * len(self._shards) - 2
            return allreduce(parts, self.mesh, self.mesh_axis)[0]
        sh = self._shards[0]
        return sh.obj[sh.leaf_idx]


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def _make_macro(head_fn: Callable, tail: List[Callable]) -> Callable:
    """Compose head + arity-1 tail fns into one payload->payload op. The
    reference unrolls a tail of up to 16 ops and runs a longer one as a
    ``lax.scan`` (over ``lax.switch`` when the ops differ); eager PyTorch
    has neither, so every tail is one Python loop, recorded kernel by
    kernel into the CUDA graph."""
    if not tail:
        return head_fn

    def macro(*args):
        x = head_fn(*args)
        for f in tail:
            x = f(x)
        return x

    return macro


def compile_torch_dag(
    leaf: DAGNode,
    payload_shape: Sequence[int] = (),
    dtype=torch.float32,
    dynamic: Optional[bool] = None,
    max_args: Optional[int] = None,
    fuse: bool = True,
    mesh=None,
    mesh_axis: Optional[str] = None,
    frontier_width: Optional[int] = None,
    device="cuda",
) -> CompiledTorchDAG:
    """Lower a static DAG of PyTorch FunctionNodes to the wave executor on
    ``device``.

    Every task op must map payload-shaped tensors to one payload-shaped
    tensor of the payload dtype (uniform buckets, as in the reference).

    With ``mesh=`` (a ``ray_tpu_torch.parallel.Mesh``), execution is
    partitioned over ``mesh_axis`` (default: the mesh's first axis of size
    > 1) and runs on that axis's devices, not on ``device``: a
    ``ShardedTorchDAG``. ``frontier_width`` caps the tasks a shard fires
    per dynamic iteration (default ``min(Cn, 32)``). A one-shard axis
    falls through to the one-device executor on the mesh's device.
    """
    shard_devs: List[torch.device] = []
    if mesh is not None:
        if mesh_axis is None:
            mesh_axis = next(
                (a for a in mesh.axis_names if mesh.shape[a] > 1),
                mesh.axis_names[0])
        if mesh_axis not in mesh.shape:
            raise ValueError(
                f"mesh has no axis {mesh_axis!r}; axes: {mesh.axis_names}")
        shard_devs = [resolve_device(d) for d in mesh.axis_devices(mesh_axis)]
        if len(shard_devs) == 1:
            device, mesh = shard_devs[0], None  # single-shard fall-through
    dev = shard_devs[0] if mesh is not None else resolve_device(device)
    dtype = _torch_dtype(dtype)
    if dynamic is None:
        dynamic = WAVE_EXECUTOR_DYNAMIC
    if max_args is None:
        max_args = WAVE_EXECUTOR_MAX_ARGS

    order = leaf.topological_order()

    # ---- classify nodes, assign object slots --------------------------------
    input_keys: List[Any] = []
    slot_of: Dict[int, int] = {}  # id(node) -> object slot
    tasks: List[FunctionNode] = []
    plain_input_used = False

    for node in order:
        if isinstance(node, InputNode):
            continue  # slot assigned via its consumers / attribute nodes
        elif isinstance(node, InputAttributeNode):
            if node._key not in input_keys:
                input_keys.append(node._key)
        elif isinstance(node, FunctionNode):
            tasks.append(node)
        elif isinstance(node, MultiOutputNode):
            if node is not leaf:
                raise ValueError("MultiOutputNode must be the DAG leaf")
        elif isinstance(node, ClassMethodNode):
            raise NotImplementedError(
                "backend='torch' compiles stateless task DAGs")
        else:
            raise TypeError(f"cannot compile node type {type(node).__name__}")

    consumes_plain_input = any(
        isinstance(a, InputNode)
        for t in tasks
        for a in list(t._bound_args) + list(t._bound_kwargs.values())
    )
    if consumes_plain_input and input_keys:
        raise ValueError(
            "mix of whole-input and projected-input (inp[i]) consumption is "
            "not supported in the torch backend")
    if consumes_plain_input:
        input_keys = [None]
        plain_input_used = True
    else:
        # Positional execute(*inputs) maps to inp[k] by key order, as in
        # the reference.
        if not all(isinstance(k, int) for k in input_keys):
            raise ValueError(
                "torch backend input projections must use integer keys "
                f"(inp[0], inp[1], ...); got {input_keys!r}")
        input_keys.sort()
        if input_keys != list(range(len(input_keys))):
            raise ValueError(
                f"torch backend requires dense input keys 0..N-1; got "
                f"{input_keys!r}")
    num_inputs = len(input_keys)

    # slots: [inputs..., task outputs..., scratch]
    for node in order:
        if isinstance(node, InputNode):
            if plain_input_used:
                slot_of[id(node)] = 0
        elif isinstance(node, InputAttributeNode):
            slot_of[id(node)] = input_keys.index(node._key)
    for i, t in enumerate(tasks):
        slot_of[id(t)] = num_inputs + i
    # The last row is a scratch slot: the dynamic mode's lanes that are not
    # ready scatter there, so they never collide with a producer's slot.
    scratch_slot = num_inputs + len(tasks)
    num_slots = scratch_slot + 1

    # ---- per-task IR --------------------------------------------------------
    T = len(tasks)
    if T == 0:
        raise ValueError("DAG contains no tasks")
    task_fns: List[Callable] = []
    task_dep_slots: List[List[int]] = []
    seen_fn_arities: Dict[Tuple[int, int], str] = {}

    for t in tasks:
        if t._bound_kwargs:
            raise ValueError(
                "torch backend requires positional bind() args "
                f"(task {t.function.__name__!r} bound kwargs)")
        deps = list(t._bound_args)
        for a in deps:
            if not isinstance(a, DAGNode):
                raise ValueError(
                    "torch backend requires all bind() args to be DAG "
                    "nodes; close over constants instead")
        if len(deps) > max_args:
            raise ValueError(
                f"task {t.function.__name__!r} has {len(deps)} args > "
                f"max_args={max_args}; raise max_args or use "
                f"dag.reduce_tree")
        task_fns.append(t.function)
        task_dep_slots.append([slot_of[id(a)] for a in deps])
        seen_fn_arities[(id(t.function), len(deps))] = getattr(
            t.function, "__name__", "op")

    # ---- validate op shapes on the meta device ------------------------------
    payload_shape = tuple(int(n) for n in payload_shape)
    checked = set()
    for fn, deps in zip(task_fns, task_dep_slots):
        key = (id(fn), len(deps))
        if key in checked:
            continue
        checked.add(key)
        args = [torch.empty(payload_shape, dtype=dtype, device="meta")
                for _ in deps]
        out = fn(*args)
        out_shape = tuple(getattr(out, "shape", ()))
        out_dtype = getattr(out, "dtype", None)
        if out_shape != payload_shape or out_dtype != dtype:
            got = (_dtype_name(out_dtype) if isinstance(out_dtype, torch.dtype)
                   else type(out).__name__)
            raise ValueError(
                f"op {seen_fn_arities[key]!r} maps "
                f"{payload_shape}/{_dtype_name(dtype)} -> "
                f"{out_shape}/{got}; all ops must preserve the payload "
                f"bucket")

    # ---- output slots -------------------------------------------------------
    if isinstance(leaf, MultiOutputNode):
        leaf_slots = [slot_of[id(a)] for a in leaf._bound_args]
        multi_output = True
    else:
        leaf_slots = [slot_of[id(leaf)]]
        multi_output = False

    # ---- linear-run fusion --------------------------------------------------
    # A maximal chain t1 -> t2 -> ... -> tk where every interior output has
    # exactly one consumer (the next task, arity 1) and is not a DAG output
    # collapses into one macro-op, removing the table gather/scatter on
    # sequential segments.
    producer_of_slot = {num_inputs + i: i for i in range(T)}
    consumers: List[List[int]] = [[] for _ in range(T)]
    external = [False] * T
    for ti, deps in enumerate(task_dep_slots):
        for s in deps:
            p = producer_of_slot.get(s)
            if p is not None:
                consumers[p].append(ti)
    for s in leaf_slots:
        p = producer_of_slot.get(int(s))
        if p is not None:
            external[p] = True

    # (macro, deps, out slot, run length, name, signature); the signature
    # names the functions the macro applies, in order, so that runs of the
    # same functions share a vmap group.
    fused: List[Tuple[Callable, List[int], int, int, str, tuple]] = []
    assigned = [False] * T
    for ti in range(T):  # tasks[] is already topological
        if assigned[ti]:
            continue
        run = [ti]
        assigned[ti] = True
        cur = ti
        while (fuse and not external[cur] and len(consumers[cur]) == 1):
            nxt = consumers[cur][0]
            if assigned[nxt] or len(task_dep_slots[nxt]) != 1:
                break
            run.append(nxt)
            assigned[nxt] = True
            cur = nxt
        head = run[0]
        tail_fns = [task_fns[i] for i in run[1:]]
        macro = _make_macro(task_fns[head], tail_fns)
        name = getattr(task_fns[head], "__name__", "op")
        if tail_fns:
            name = f"fused[{len(run)}]{name}"
        sig = (len(task_dep_slots[head]),) + tuple(
            id(task_fns[i]) for i in run)
        fused.append((macro, task_dep_slots[head], num_inputs + run[-1],
                      len(run), name, sig))

    # ---- compact op table ---------------------------------------------------
    C = len(fused)
    op_index: Dict[Any, int] = {}
    op_names: List[str] = []
    for ci, (macro, deps, out_slot, size, name, _) in enumerate(fused):
        # Fused macros are unique per run; plain ops dedupe by (fn, arity).
        key = (id(macro), len(deps)) if size == 1 else ("run", ci)
        if key not in op_index:
            op_index[key] = len(op_names)
            op_names.append(name)
    out_slots = [int(f[2]) for f in fused]
    compact_producer = {s: ci for ci, s in enumerate(out_slots)}
    vmapped: Dict[tuple, Callable] = {}

    def groups_of(cis: List[int], device: torch.device = dev,
                  lane_base: int = 0) -> List[_Group]:
        """The lanes ``cis`` grouped by signature, in first-seen order;
        each group's ``lanes`` are ``ci - lane_base``."""
        by_sig: Dict[tuple, List[int]] = {}
        for ci in cis:
            by_sig.setdefault(fused[ci][5], []).append(ci)
        out = []
        for sig, lanes in by_sig.items():
            macro, deps = fused[lanes[0]][0], fused[lanes[0]][1]
            if sig not in vmapped:
                vmapped[sig] = _vmapped(macro, len(deps))
            out.append(_Group(vmapped[sig], len(deps),
                              [ci - lane_base for ci in lanes],
                              [s for ci in lanes for s in fused[ci][1]],
                              [out_slots[ci] for ci in lanes], device))
        return out

    meta = dict(num_inputs=num_inputs, multi_output=multi_output,
                num_tasks=T, num_compiled_tasks=C, payload_shape=payload_shape,
                dtype=dtype, dynamic=dynamic, op_names=op_names, device=dev)
    indeg0: List[int] = []
    edges: Tuple[List[int], List[int]] = ([], [])
    waves_groups: List[List[_Group]] = []
    all_groups: List[_Group] = []
    if not dynamic:
        # ---- static level schedule ------------------------------------------
        levels = [0] * C
        for ci, f in enumerate(fused):
            lvl = 0
            for s in f[1]:
                p = compact_producer.get(int(s))
                if p is not None:
                    lvl = max(lvl, levels[p] + 1)
            levels[ci] = lvl
        num_waves = max(levels) + 1
        waves: List[List[int]] = [[] for _ in range(num_waves)]
        for ci in range(C):
            waves[levels[ci]].append(ci)
        wave_width = max(len(w) for w in waves)
        if mesh is not None:
            return _sharded_static(
                mesh, mesh_axis, shard_devs, fused, waves, out_slots, compact_producer, leaf_slots, scratch_slot,
                num_slots, groups_of, meta)
        waves_groups = [groups_of(w) for w in waves]
        viz = {"mode": "static",
               "waves": [[(ci, fused[ci][4], out_slots[ci]) for ci in w]
                         for w in waves]}
    else:
        # ---- dynamic frontier -----------------------------------------------
        indeg0 = [0] * C
        for ci, f in enumerate(fused):
            for s in f[1]:
                src = compact_producer.get(int(s))
                if src is not None:
                    edges[0].append(src)
                    edges[1].append(ci)
                    indeg0[ci] += 1
        num_waves = 0  # unknown statically
        wave_width = C
        viz = {"mode": "dynamic",
               "tasks": [(ci, f[4], out_slots[ci])
                         for ci, f in enumerate(fused)],
               "n_edges": len(edges[0])}
        if mesh is not None:
            return _sharded_dynamic(
                mesh, mesh_axis, shard_devs, frontier_width, indeg0, edges,
                out_slots, compact_producer, leaf_slots, scratch_slot,
                num_slots, groups_of, meta, viz)
        all_groups = groups_of(list(range(C)))

    return CompiledTorchDAG(
        num_waves=num_waves, wave_width=wave_width, num_slots=num_slots,
        leaf_slots=leaf_slots, waves=waves_groups, groups=all_groups,
        scratch_slot=scratch_slot, indeg0=indeg0, edges=edges, viz=viz,
        **meta)


def _sharded_static(mesh, mesh_axis, shard_devs, fused, waves, out_slots,
                    compact_producer, leaf_slots, scratch_slot, num_slots,
                    groups_of, meta) -> ShardedTorchDAG:
    """The mesh-sharded static waves (the reference's host-side compile
    work, rule for rule): locality-aware lanes, per-(wave, shard) lane
    tables, export sets packed to ``X_max``, and each shard's groups."""
    n_sh = len(shard_devs)
    C = len(fused)
    num_waves = len(waves)
    wave_width = max(len(w) for w in waves)
    Wn = -(-wave_width // n_sh)

    # Locality-aware lane assignment: balance Wn lanes per shard per wave,
    # preferring the shard owning most producers.
    owner = [0] * C
    for w in waves:
        counts = [0] * n_sh
        for ci in w:
            prefs: Dict[int, int] = {}
            for s in fused[ci][1]:
                p = compact_producer.get(int(s))
                if p is not None:
                    prefs[owner[p]] = prefs.get(owner[p], 0) + 1
            cand = sorted(range(n_sh),
                          key=lambda sh: (-prefs.get(sh, 0), counts[sh]))
            sh = next(s for s in cand if counts[s] < Wn)
            owner[ci] = sh
            counts[sh] += 1

    # Which shards consume each slot (leaf slots: all shards, so the
    # output is replicated).
    consumers_of_slot: Dict[int, set] = {}
    for ci, f in enumerate(fused):
        for s in f[1]:
            consumers_of_slot.setdefault(int(s), set()).add(owner[ci])
    for s in leaf_slots:
        consumers_of_slot.setdefault(int(s), set()).update(range(n_sh))

    # Per-(wave, shard) lane tables and export sets.
    sched_sh = np.full((n_sh, num_waves, Wn), -1, np.int64)
    for wi, w in enumerate(waves):
        fill = [0] * n_sh
        for ci in w:
            sh = owner[ci]
            sched_sh[sh, wi, fill[sh]] = ci
            fill[sh] += 1
    exports: List[List[List[int]]] = [
        [[] for _ in range(num_waves)] for _ in range(n_sh)]
    for wi, w in enumerate(waves):
        for ci in w:
            sh = owner[ci]
            if consumers_of_slot.get(out_slots[ci], set()) - {sh}:
                exports[sh][wi].append(ci)
    X_max = max((len(exports[sh][wi]) for sh in range(n_sh)
                 for wi in range(num_waves)), default=0)
    X = max(X_max, 1)
    # exp_slots[w]: the slot of every entry of the gathered exports, shard
    # by shard (padding: the scratch slot).
    exp_slots = np.full((num_waves, n_sh * X), scratch_slot, np.int64)
    exp_src = np.full((n_sh, num_waves, X), scratch_slot, np.int64)
    for sh in range(n_sh):
        for wi in range(num_waves):
            for k, ci in enumerate(exports[sh][wi]):
                exp_src[sh, wi, k] = out_slots[ci]
                exp_slots[wi, sh * X + k] = out_slots[ci]

    shards = []
    for sh, d in enumerate(shard_devs):
        shard = _Shard(d, num_slots, meta["payload_shape"], meta["dtype"],
                       leaf_slots)
        shard.waves = [groups_of([int(ci) for ci in sched_sh[sh, wi]
                                  if ci >= 0], d)
                       for wi in range(num_waves)]
        shard.exp_src = [shard.long(exp_src[sh, wi])
                         for wi in range(num_waves)]
        shard.exp_dst = [shard.long(exp_slots[wi])
                         for wi in range(num_waves)]
        shards.append(shard)

    exported = {ci for sh in range(n_sh) for wi in range(num_waves)
                for ci in exports[sh][wi]}
    viz = {"mode": "sharded_static", "n_sh": n_sh,
           "waves": [{sh: [(ci, fused[ci][4], out_slots[ci], ci in exported)
                           for ci in map(int, sched_sh[sh, wi]) if ci >= 0]
                      for sh in range(n_sh)}
                     for wi in range(num_waves)]}
    return ShardedTorchDAG(
        mesh=mesh, mesh_axis=mesh_axis, shards=shards,
        scratch_slot=scratch_slot, export_width=X_max, lanes_per_shard=Wn,
        num_waves=num_waves, wave_width=Wn * n_sh, viz=viz, **meta)


def _sharded_dynamic(mesh, mesh_axis, shard_devs, frontier_width, indeg0,
                     edges, out_slots, compact_producer, leaf_slots,
                     scratch_slot, num_slots, groups_of, meta, viz
                     ) -> ShardedTorchDAG:
    """The mesh-sharded dynamic frontier: task ``ci`` is owned by shard
    ``ci // Cn`` (contiguous blocks padded to ``C_pad = Cn * n_sh``; the
    padding tasks are born done); the in-degree vector and the done mask
    are replicated, one copy per shard."""
    n_sh = len(shard_devs)
    C = len(out_slots)
    Cn = -(-C // n_sh)
    C_pad = Cn * n_sh
    F = frontier_width or min(Cn, 32)
    F = max(1, min(int(F), Cn))
    out_ext = [scratch_slot] * (C_pad + 1)
    out_ext[:C] = out_slots           # index C_pad: a dummy -> scratch
    indeg0_pad = list(indeg0) + [0] * (C_pad - C)
    done0_pad = [False] * C + [True] * (C_pad - C)
    # Shard-partitioned graphs (every edge inside its owner's block) move
    # only ids per iteration and replicate the leaves once at the end.
    cross_payload = any((s // Cn) != (d // Cn) for s, d in zip(*edges))
    leaf_prod = [compact_producer.get(int(s)) for s in leaf_slots]
    leaf_owner = [(p // Cn if p is not None else 0) for p in leaf_prod]
    mask_shape = (len(leaf_slots),) + (1,) * len(meta["payload_shape"])

    shards = []
    for sh, d in enumerate(shard_devs):
        shard = _Shard(d, num_slots, meta["payload_shape"], meta["dtype"],
                       leaf_slots)
        shard.groups = groups_of(list(range(sh * Cn, min(C, (sh + 1) * Cn))),
                                 d, lane_base=sh * Cn)
        shard.my_ids = shard.long(range(sh * Cn, (sh + 1) * Cn))
        shard.out_ext = shard.long(out_ext)
        shard.indeg0 = torch.tensor(indeg0_pad, dtype=torch.int32, device=d)
        shard.indeg = shard.indeg0.clone()
        shard.done0 = torch.tensor(done0_pad, dtype=torch.bool, device=d)
        shard.done = shard.done0.clone()
        shard.e_src = shard.long(edges[0])
        shard.e_dst = shard.long(edges[1])
        shard.leaf_mask = torch.tensor(
            [o == sh for o in leaf_owner], device=d).reshape(mask_shape)
        shards.append(shard)

    viz = dict(viz, frontier_width=F)
    return ShardedTorchDAG(
        mesh=mesh, mesh_axis=mesh_axis, shards=shards,
        scratch_slot=scratch_slot, export_width=F if cross_payload else 0,
        lanes_per_shard=Cn, num_waves=0, wave_width=C, viz=viz,
        frontier=dict(F=F, C_pad=C_pad, cross_payload=cross_payload),
        **meta)
