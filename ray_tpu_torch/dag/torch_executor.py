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

Shapes are checked on the ``meta`` device (the reference's
``jax.eval_shape``). The ``mesh=`` paths (sharded waves and frontier)
wait for the multi-axis layer (ROADMAP A.4).
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
    """Lanes that run one op: ``fn`` vmapped over [n, arity, *P] args."""

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
        # Host-side work per execute on the card, for the DAG phase of
        # chip_smoke.py: graph replays and other launches (input copies,
        # the dynamic state's reset, the output gather).
        self.graph_replays = 0
        self.host_launches = 0
        self._viz = viz
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
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._chunk = 0   # dynamic iterations per graph replay

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
            self.host_launches += 2
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

    def execute(self, *inputs) -> TorchDAGRef:
        if len(inputs) != self.num_inputs:
            raise ValueError(
                f"compiled DAG takes {self.num_inputs} input(s), got "
                f"{len(inputs)}")
        for i, x in enumerate(inputs):
            self._stage(i, x)
        if self.device.type == "cuda":
            self.host_launches += len(inputs) + 1   # copies, the gather
            if self._graph is None:
                self._capture()
            else:
                self._replay()
        elif self.dynamic:
            self._run_dynamic_eager()
        else:
            self._run_static()
        out = self._obj[self._leaf_idx]   # a gathered copy the ref owns
        return TorchDAGRef(out if self.multi_output else out[0],
                           self.multi_output)

    def __call__(self, *inputs):
        return self.execute(*inputs).get()

    def visualize_schedule(self, max_lanes: int = 8) -> str:
        """Render the compiled schedule: per-wave lane tables with output
        slots (static), or the compiled tasks of the frontier (dynamic)."""
        header = (
            f"CompiledTorchDAG: {self.num_tasks} tasks, "
            f"{self.num_waves} waves × width {self.wave_width}, "
            f"{'dynamic frontier' if self.dynamic else 'static levels'}, "
            f"payload {self.payload_shape} {_dtype_name(self.dtype)}, "
            f"ops {self.op_names}"
        )
        viz = self._viz
        lines = [header]

        def lane_str(entries):
            cells = [f"[{ci}]{name}->s{slot}"
                     for ci, name, slot in entries[:max_lanes]]
            if len(entries) > max_lanes:
                cells.append(f"… +{len(entries) - max_lanes} lanes")
            return "  ".join(cells)

        if viz["mode"] == "static":
            for wi, wave in enumerate(viz["waves"]):
                lines.append(f"wave {wi}: {lane_str(wave)}")
        else:
            lines.append(
                f"dynamic frontier over {len(viz['tasks'])} compiled "
                f"tasks, {viz['n_edges']} edges")
            for ci, name, slot in viz["tasks"][:max_lanes]:
                lines.append(f"  [{ci}]{name}->s{slot}")
            if len(viz["tasks"]) > max_lanes:
                lines.append(f"  … +{len(viz['tasks']) - max_lanes} tasks")
        return "\n".join(lines)


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
    device="cuda",
) -> CompiledTorchDAG:
    """Lower a static DAG of PyTorch FunctionNodes to the wave executor on
    ``device``.

    Every task op must map payload-shaped tensors to one payload-shaped
    tensor of the payload dtype (uniform buckets, as in the reference).
    ``mesh`` belongs to the sharded paths, which wait for ROADMAP A.4.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the mesh-sharded wave executor waits for the multi-axis layer "
            "(ROADMAP A.4); compile without mesh=")
    dev = resolve_device(device)
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

    def groups_of(cis: List[int]) -> List[_Group]:
        """The lanes ``cis`` grouped by signature, in first-seen order."""
        by_sig: Dict[tuple, List[int]] = {}
        for ci in cis:
            by_sig.setdefault(fused[ci][5], []).append(ci)
        out = []
        for sig, lanes in by_sig.items():
            macro, deps = fused[lanes[0]][0], fused[lanes[0]][1]
            if sig not in vmapped:
                vmapped[sig] = _vmapped(macro, len(deps))
            out.append(_Group(vmapped[sig], len(deps), lanes,
                              [s for ci in lanes for s in fused[ci][1]],
                              [out_slots[ci] for ci in lanes], dev))
        return out

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
        all_groups = groups_of(list(range(C)))
        viz = {"mode": "dynamic",
               "tasks": [(ci, f[4], out_slots[ci])
                         for ci, f in enumerate(fused)],
               "n_edges": len(edges[0])}

    return CompiledTorchDAG(
        num_inputs=num_inputs, multi_output=multi_output, num_tasks=T,
        num_compiled_tasks=C, num_waves=num_waves, wave_width=wave_width,
        payload_shape=payload_shape, dtype=dtype, dynamic=dynamic,
        op_names=op_names, device=dev, num_slots=num_slots,
        leaf_slots=leaf_slots, waves=waves_groups, groups=all_groups,
        scratch_slot=scratch_slot, indeg0=indeg0, edges=edges, viz=viz)
