"""Actor-loop compiled DAG backend (counterpart of
``ray_tpu/dag/compiled_dag.py``, the reference's aDAG semantics).

Compiling a DAG allocates versioned channels on every edge and starts one
long-running execution loop per participating actor, which reads its
input channels, runs the bound method and writes its output channel,
with no per-execution scheduling. ``execute()`` writes the input channel
and returns a ref; ``get()`` reads the output channel. Stages without an
actor (remote functions, input projections) run on one driver loop
thread.

Every actor of the port is a thread of this process, so every edge is a
channel of this process (``channels/``) and values cross it BY
REFERENCE: a CUDA tensor reaches the next stage as the same tensor, on
its device, with no copy. The reference's shared-memory channel plane
(``with_tensor_transport("shm")``, stage loops inside worker processes)
needs process-backed actors, which the port does not have; such a hint
raises at compile.

Mixed DAGs: contiguous ``with_tensor_transport("device")`` function
stages fuse into ONE stage on the driver loop, across sole-argument,
single-consumer edges only. Where the reference jits a fused chain into
one XLA program, here the chain's functions run back to back as plain
PyTorch on the tensors they are given: the chain's inner edges are no
channels, and its output crosses to the next stage as a live tensor.
"""

from __future__ import annotations

import atexit
import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.channels import BufferedChannel
from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    ClassNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    ChannelError,
    ChannelTimeoutError,
    RayTaskError,
)

_UNREAD = object()

# Exec loops poll at this cadence so they can notice teardown; partial
# stage progress is kept across poll timeouts, so polling never desyncs.
_POLL_S = 0.5
# Bound on an actor's __init__ at compile time.
_ACTOR_READY_S = 30.0

# Live DAGs are torn down at interpreter exit, so exec loops hosted on
# actor threads cannot hang process shutdown.
_LIVE_DAGS: "weakref.WeakSet[CompiledDAG]" = weakref.WeakSet()


def _teardown_all():
    for dag in list(_LIVE_DAGS):
        try:
            dag.teardown()
        except Exception:  # noqa: BLE001 — best-effort at exit
            pass


atexit.register(_teardown_all)


class CompiledDAGRef:
    """Handle to one in-flight execution; results are read in order."""

    def __init__(self, dag: "CompiledDAG", index: int):
        self._dag = dag
        self._index = index

    def get(self, timeout: Optional[float] = None):
        return self._dag._read_result(self._index, timeout)


class _Stage:
    """One executable node: read args from channels, run, write output.

    Partial progress (args read, value computed but not yet written)
    survives a ChannelTimeoutError, so ``run_once`` is simply retried
    without consuming a channel version twice.
    """

    def __init__(self, node: DAGNode, fn, arg_sources: List[Tuple],
                 out_channel: BufferedChannel, method_name: str = ""):
        self.node = node
        self.fn = fn  # None for actor stages: resolved against `instance`
        self.method_name = method_name
        self.arg_sources = arg_sources  # (kind, channel or value, reader)
        self.out_channel = out_channel
        self._args_cache = [_UNREAD] * len(arg_sources)
        self._pending = _UNREAD

    def run_once(self, instance=None):
        if self._pending is _UNREAD:
            for i, (kind, a, b) in enumerate(self.arg_sources):
                if self._args_cache[i] is _UNREAD:
                    self._args_cache[i] = (
                        a if kind == "const" else a.read(b, _POLL_S))
            fn = self.fn if instance is None else getattr(
                instance, self.method_name)
            try:
                value = fn(*self._args_cache)
            except Exception as exc:  # noqa: BLE001 — stage error boundary
                value = RayTaskError.from_exception(
                    self.method_name or getattr(fn, "__name__", "stage"),
                    exc)
            self._pending = value
            self._args_cache = [_UNREAD] * len(self.arg_sources)
        self.out_channel.write(self._pending, _POLL_S)
        self._pending = _UNREAD


class CompiledDAG:
    def __init__(self, leaf: DAGNode, max_buffered_executions: int = 2,
                 **_options):
        self._leaf = leaf
        self._buffer = max(int(max_buffered_executions), 1)
        self._lock = threading.Lock()
        self._read_lock = threading.Lock()
        self._exec_count = 0
        self._read_count = 0
        self._results: Dict[int, Any] = {}
        self._torn_down = False
        self._threads: List[threading.Thread] = []
        self._channels: Dict[int, Any] = {}
        self._build()
        self._partial = [_UNREAD] * len(self._out_sources)
        _LIVE_DAGS.add(self)

    # ------------------------------------------------------------------ build
    def _build(self):
        order = self._leaf.topological_order()
        self._input_node: Optional[InputNode] = None
        consumers: Dict[int, int] = {}  # id(node) -> number of consumers

        exec_nodes: List[DAGNode] = []
        for node in order:
            if isinstance(node, InputNode):
                if (self._input_node is not None
                        and node is not self._input_node):
                    raise ValueError("compiled DAG supports one InputNode")
                self._input_node = node
            elif isinstance(node, (FunctionNode, ClassMethodNode,
                                   InputAttributeNode)):
                exec_nodes.append(node)
            elif isinstance(node, MultiOutputNode):
                if node is not self._leaf:
                    raise ValueError("MultiOutputNode must be the leaf")
            elif isinstance(node, ClassNode):
                pass  # actor construction resolved below
            else:
                raise TypeError(
                    f"cannot compile node type {type(node).__name__}")

        def _count_consumer(dep: DAGNode):
            consumers[id(dep)] = consumers.get(id(dep), 0) + 1

        for node in exec_nodes:
            for a in list(node._bound_args) + list(
                    node._bound_kwargs.values()):
                if isinstance(a, DAGNode) and not isinstance(a, ClassNode):
                    _count_consumer(a)
        if isinstance(self._leaf, MultiOutputNode):
            for a in self._leaf._bound_args:
                _count_consumer(a)
        else:
            _count_consumer(self._leaf)

        self._shm_mode = self._select_transport(order)

        # Mixed DAGs: contiguous device-hinted FunctionNode chains fuse
        # into ONE stage; their inner edges never exist as channels.
        chain_of, internal = self._fuse_device_chains(exec_nodes, consumers)

        reader_cursor: Dict[int, int] = {}
        for node in order:
            n = consumers.get(id(node), 0)
            if n > 0 and id(node) not in internal \
                    and not isinstance(node, (MultiOutputNode, ClassNode)):
                self._channels[id(node)] = self._make_channel(n)
                reader_cursor[id(node)] = 0

        def _source_for(a):
            if isinstance(a, ClassNode):
                raise ValueError("actor handles cannot be data deps")
            if isinstance(a, DAGNode):
                ch = self._channels[id(a)]
                rid = reader_cursor[id(a)]
                reader_cursor[id(a)] += 1
                return ("chan", ch, rid)
            return ("const", a, None)

        # Stages grouped by execution loop: one loop per actor, one driver
        # loop for stateless and projection stages.
        self._loops: Dict[Any, List[_Stage]] = {}
        for node in exec_nodes:
            if node._bound_kwargs:
                raise ValueError(
                    "compiled DAGs require positional bind() args")
            if id(node) in internal:
                continue  # fused into a device chain ending elsewhere
            out_ch = self._channels.get(id(node))
            if out_ch is None:
                out_ch = self._make_channel(1)
            if id(node) in chain_of:
                # A fused unit: ONE stage on the driver loop running the
                # chain's functions; args come from the HEAD's bound
                # edges, the output goes to the TAIL's channel.
                chain = chain_of[id(node)]
                arg_sources = [_source_for(a) for a in chain[0]._bound_args]
                self._loops.setdefault("__driver__", []).append(
                    _Stage(node, self._run_chain(chain), arg_sources,
                           out_ch, ""))
                continue
            arg_sources = [_source_for(a) for a in node._bound_args]
            method_name = ""
            if isinstance(node, FunctionNode):
                fn = node.function
                key = "__driver__"
            elif isinstance(node, InputAttributeNode):
                k = node._key

                def fn(v, _k=k):
                    if isinstance(_k, str) and not isinstance(v, dict):
                        return getattr(v, _k)
                    return v[_k]

                key = "__driver__"
            else:  # ClassMethodNode
                method = node._bound_method()
                runtime = method._runtime
                if not runtime._instance_ready.wait(timeout=_ACTOR_READY_S):
                    raise TimeoutError(
                        f"actor {runtime.class_name!r} did not finish "
                        f"__init__ within {_ACTOR_READY_S}s during DAG "
                        f"compile")
                if runtime.dead or runtime._init_error is not None:
                    raise ActorDiedError(
                        runtime.actor_id,
                        runtime.death_cause or "actor died before compile")
                fn = None  # resolved against the actor instance in-loop
                method_name = method._method_name
                key = runtime
            self._loops.setdefault(key, []).append(
                _Stage(node, fn, arg_sources, out_ch, method_name))

        # Output readers (driver side).
        if isinstance(self._leaf, MultiOutputNode):
            self._out_sources = [
                _source_for(a) for a in self._leaf._bound_args]
            self._multi_output = True
        else:
            self._out_sources = [_source_for(self._leaf)]
            self._multi_output = False

        # Start the loops: the driver's stages on a thread of their own,
        # each actor's as a closure occupying its mailbox (the
        # reference's do_exec_tasks), on the actor's loop thread.
        for key, stages in self._loops.items():
            if key == "__driver__":
                t = threading.Thread(
                    target=self._exec_loop, args=(stages, None), daemon=True,
                    name="compiled-dag-loop-driver")
                t.start()
                self._threads.append(t)
            else:
                key.submit_exec_loop(
                    lambda instance, stages=stages:
                    self._exec_loop(stages, instance))

    @staticmethod
    def _is_device_node(node) -> bool:
        return (isinstance(node, FunctionNode)
                and getattr(node, "_transport_hint", "auto") == "device")

    def _fuse_device_chains(self, exec_nodes, consumers):
        """Group contiguous device-hinted FunctionNodes into fused units.
        Returns (tail_chains, internal): ``tail_chains`` maps id(tail
        node) -> the ordered node list of its chain; ``internal`` is the
        id-set of fused non-tail members (no channel, no stage of their
        own). A chain extends only through single-consumer edges, so
        fusing never changes observable dataflow."""
        tail_chains: Dict[int, List[DAGNode]] = {}
        internal: set = set()
        for node in exec_nodes:
            if not self._is_device_node(node):
                continue
            # Fusable ONLY when the previous node is the SOLE bound arg:
            # the chain calls non-head functions as f(value), so a node
            # with extra literal args heads its own unit.
            prev = (node._bound_args[0]
                    if len(node._bound_args) == 1
                    and isinstance(node._bound_args[0], DAGNode)
                    and not isinstance(node._bound_args[0], ClassNode)
                    else None)
            if prev is not None and id(prev) in tail_chains \
                    and consumers.get(id(prev), 0) == 1:
                chain = tail_chains.pop(id(prev))
                internal.add(id(prev))
                chain.append(node)
                tail_chains[id(node)] = chain
            else:
                tail_chains[id(node)] = [node]
        return tail_chains, internal

    @staticmethod
    def _run_chain(chain: List[DAGNode]):
        """One stage for a fused device chain: its functions back to back
        on the tensors they are given, the output a live tensor."""
        fns = tuple(n.function for n in chain)

        def composed(*args):
            value = fns[0](*args)
            for f in fns[1:]:
                value = f(value)
            return value

        composed.__name__ = "+".join(
            getattr(f, "__name__", "stage") for f in fns)
        return composed

    def _select_transport(self, order) -> bool:
        """The reference's transport choice. Every port actor is a
        thread, so the shared-memory plane is never eligible: ``"shm"``
        raises as the reference does for an ineligible DAG, and every
        other hint keeps the channel plane of this process."""
        hints = {getattr(n, "_transport_hint", "auto") for n in order}
        if "shm" in hints and ("driver" in hints or "device" in hints):
            raise ValueError(
                "conflicting tensor transports: 'shm' cannot mix with "
                "'driver'/'device' hints in one DAG")
        if "shm" in hints:
            raise ValueError(
                "with_tensor_transport('shm') requires every actor stage "
                "to be a process-backed sync actor and the native shm "
                "store to be available; every actor of ray_tpu_torch is "
                "a thread of this process")
        return False

    def _make_channel(self, num_readers: int):
        return BufferedChannel(num_readers=num_readers,
                               buffer_count=self._buffer)

    def _exec_loop(self, stages: List[_Stage], instance):
        """Run the static schedule until teardown. A timeout only means a
        producer or consumer is slow: retry (stages keep partial
        progress); a closed channel means teardown: exit."""
        while True:
            try:
                for stage in stages:
                    stage.run_once(instance)
            except ChannelTimeoutError:
                if self._torn_down:
                    return
                continue
            except ChannelError:
                return

    # ---------------------------------------------------------------- execute
    def execute(self, *input_values) -> CompiledDAGRef:
        if self._torn_down:
            raise ChannelError("compiled DAG has been torn down")
        # Index assignment and the input write are atomic, so concurrent
        # execute() calls keep ref and result order aligned; the count
        # advances only after a successful write.
        with self._lock:
            if self._input_node is not None:
                ch = self._channels.get(id(self._input_node))
                if ch is not None:
                    value = (input_values[0] if len(input_values) == 1
                             else input_values)
                    ch.write(value)
            index = self._exec_count
            self._exec_count += 1
        return CompiledDAGRef(self, index)

    def _read_result(self, index: int, timeout: Optional[float]):
        with self._read_lock:
            while self._read_count <= index:
                # Partial reads survive a timeout: each output channel is
                # consumed at most once per execution row, so a retry
                # resumes at the missing channel.
                for i, (kind, ch, rid) in enumerate(self._out_sources):
                    if self._partial[i] is _UNREAD:
                        self._partial[i] = (
                            ch.read(rid, timeout) if kind == "chan" else ch)
                vals, self._partial = (
                    self._partial, [_UNREAD] * len(self._out_sources))
                result = vals if self._multi_output else vals[0]
                self._results[self._read_count] = result
                self._read_count += 1
            result = self._results.pop(index)
        errs = result if isinstance(result, list) else [result]
        for v in errs:
            if isinstance(v, RayTaskError):
                raise v.as_instanceof_cause()
        return result

    def teardown(self):
        """Close every channel (each loop exits at its next read or
        write) and join the driver loop's thread (bounded)."""
        self._torn_down = True
        for ch in self._channels.values():
            ch.close()
        for t in self._threads:
            t.join(timeout=2)
        _LIVE_DAGS.discard(self)
