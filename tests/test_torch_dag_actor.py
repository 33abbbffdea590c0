"""Twins of the reference's DAG tests (``tests/test_dag.py``) for the
interpreted path and the actor-loop backend (``experimental_compile(
backend="actor")``), on the CPU.

Each DAG is built twice from the same plain functions and classes: once
through ``ray_tpu.remote`` and ``ray_tpu.dag`` on
``ray_tpu.init(worker_mode="thread")``, once through the port's
``remote`` and ``ray_tpu_torch.dag`` on its one-process runtime, both
runtimes up in one process. Outcomes must be equal: values exactly
(integer and single IEEE operations), error types by name and message,
stage counts of the fused mixed DAGs. The tensor twins pass a jax array
to the reference and a torch tensor to the port, and compare values
within 0 (the same one-operation f32 arithmetic) and identity (``out is
x``: both channel planes pass values by reference).
"""

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.dag as jdag
import ray_tpu_torch
import ray_tpu_torch.dag as tdag

T = 30.0


def _add1(x):
    return x + 1


def _double(x):
    return x * 2


class _Acc:
    def __init__(self):
        self.total = 0

    def add(self, x):
        self.total += x
        return self.total


class _Plus:
    def __init__(self, n):
        self.n = n

    def apply(self, x):
        return x + self.n


class _Bad:
    def apply(self, x):
        raise ValueError("stage failed")


class _Worker:
    def inc(self, x):
        return x + 1

    def dec(self, x):
        return x - 1


class _Side:
    def __init__(self, name, rt, dag):
        self.name, self.rt, self.dag = name, rt, dag

    def remote(self, target, **opts):
        if self.name == "port":
            opts.pop("runtime", None)   # every port actor is a thread
        return self.rt.remote(**opts)(target) if opts else \
            self.rt.remote(target)


REF = _Side("ref", ray_tpu, jdag)
PORT = _Side("port", ray_tpu_torch, tdag)


@pytest.fixture
def sides():
    for rt in (ray_tpu, ray_tpu_torch):
        rt.shutdown()
    ray_tpu.init(num_cpus=4, worker_mode="thread", ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=4)
    try:
        yield REF, PORT
    finally:
        for rt in (ray_tpu, ray_tpu_torch):
            rt.shutdown()


def _both(sides, fn):
    return [fn(s) for s in sides]


def _error(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — compared by type and text
        return type(exc).__name__, str(exc).splitlines()[0]
    return None


# ---------------------------------------------------------- interpreted path
def test_interpreted_execute(sides):
    def run(s):
        add1, double = s.remote(_add1), s.remote(_double)
        with s.dag.InputNode() as inp:
            dag = add1.bind(double.bind(inp))
        return s.rt.get(dag.execute(10), timeout=T)

    assert _both(sides, run) == [21, 21]


def test_interpreted_multi_output(sides):
    def run(s):
        add1, double = s.remote(_add1), s.remote(_double)
        with s.dag.InputNode() as inp:
            dag = s.dag.MultiOutputNode([add1.bind(inp), double.bind(inp)])
        return s.rt.get(dag.execute(5), timeout=T)

    assert _both(sides, run) == [[6, 10], [6, 10]]


def test_interpreted_actor_dag(sides):
    def run(s):
        a = s.remote(_Acc).remote()
        with s.dag.InputNode() as inp:
            dag = a.add.bind(inp)
        return [s.rt.get(dag.execute(3), timeout=T),
                s.rt.get(dag.execute(4), timeout=T)]

    assert _both(sides, run) == [[3, 7], [3, 7]]


def test_interpreted_class_node_binds_one_actor(sides):
    def run(s):
        acc = s.remote(_Acc).bind()
        with s.dag.InputNode() as inp:
            dag = s.dag.MultiOutputNode([acc.add.bind(inp),
                                         acc.add.bind(inp)])
        # One actor for both method nodes: the second call sees the first.
        return sorted(s.rt.get(dag.execute(2), timeout=T))

    assert _both(sides, run) == [[2, 4], [2, 4]]


# -------------------------------------------------------- actor-loop backend
def test_compiled_actor_pipeline(sides):
    def run(s):
        actors = [s.remote(_Plus).remote(i) for i in range(1, 5)]
        with s.dag.InputNode() as inp:
            node = inp
            for a in actors:
                node = a.apply.bind(node)
        compiled = node.experimental_compile(backend="actor")
        try:
            # Repeat executions reuse the loops (no new tasks).
            return [compiled.execute(i).get(timeout=T) for i in range(11)]
        finally:
            compiled.teardown()

    want = [i + 10 for i in range(11)]
    assert _both(sides, run) == [want, want]


def test_compiled_stage_error_propagates(sides):
    def run(s):
        a = s.remote(_Bad).remote()
        with s.dag.InputNode() as inp:
            dag = a.apply.bind(inp)
        compiled = dag.experimental_compile(backend="actor")
        try:
            with pytest.raises(ValueError, match="stage failed"):
                compiled.execute(1).get(timeout=T)
            return _error(lambda: compiled.execute(2).get(timeout=T))
        finally:
            compiled.teardown()

    ref, port = _both(sides, run)
    # A subclass of both RayTaskError and the stage's error type.
    assert port == ref and port[0] == "RayTaskError(ValueError)"


def test_compiled_multi_output(sides):
    def run(s):
        cls = s.remote(_Worker)
        a, b = cls.remote(), cls.remote()
        with s.dag.InputNode() as inp:
            dag = s.dag.MultiOutputNode([a.inc.bind(inp), b.dec.bind(inp)])
        compiled = dag.experimental_compile(backend="actor")
        try:
            return compiled.execute(10).get(timeout=T)
        finally:
            compiled.teardown()

    assert _both(sides, run) == [[11, 9], [11, 9]]


def test_compiled_dag_teardown_and_shutdown(sides):
    """A torn-down DAG refuses execute as the reference's does; the
    runtime's shutdown ends a DAG left up (its actor loops and driver
    thread)."""
    def run(s):
        a = s.remote(_Plus).remote(1)
        with s.dag.InputNode() as inp:
            dag = s.remote(_add1).bind(a.apply.bind(inp))
        compiled = dag.experimental_compile(backend="actor")
        got = compiled.execute(1).get(timeout=T)
        compiled.teardown()
        return got, _error(lambda: compiled.execute(1))

    ref, port = _both(sides, run)
    assert port == ref == (3, ("ChannelError",
                               "compiled DAG has been torn down"))
    a = PORT.remote(_Plus).remote(1)
    with tdag.InputNode() as inp:
        left_up = a.apply.bind(inp).experimental_compile(backend="actor")
    assert left_up.execute(1).get(timeout=T) == 2
    ray_tpu_torch.shutdown()
    assert left_up._torn_down
    assert not any(t.is_alive() for t in left_up._threads)
    assert not any(t.is_alive() for t in a._runtime._threads)


# ---------------------------------------------------- tensors by reference
class _Stage:
    def __init__(self, kind):
        self.kind = kind

    def apply(self, x):
        # Identity-preserving: return the SAME tensor object.
        assert type(x).__name__ in self.kind
        return x


def test_actor_dag_channels_preserve_device_residency(sides):
    import jax.numpy as jnp

    def run(s):
        cls = s.remote(_Stage, max_concurrency=2, runtime="driver")
        kind = ("ArrayImpl", "Array") if s is REF else ("Tensor",)
        a, b = cls.remote(kind), cls.remote(kind)
        with s.dag.InputNode() as inp:
            dag = b.apply.bind(a.apply.bind(inp))
        compiled = dag.experimental_compile(backend="actor")
        x = (jnp.arange(1024.0) if s is REF
             else torch.arange(1024.0))
        try:
            out = compiled.execute(x).get(timeout=T)
            return out is x, np.asarray(out).tolist()
        finally:
            compiled.teardown()

    ref, port = _both(sides, run)
    assert port == ref and port[0]


def test_actor_dag_transport_hints(sides):
    """'driver' keeps the channel plane of the process; 'shm' on a DAG
    whose actors are not process-backed raises ValueError (every port
    actor is a thread; the reference's thread-mode actors are too)."""
    class P:
        def apply(self, x):
            return x + 1

    def run(s):
        p = s.remote(P).remote()
        with s.dag.InputNode() as inp:
            dag = p.apply.bind(inp).with_tensor_transport("driver")
        compiled = dag.experimental_compile(backend="actor")
        try:
            out = (compiled._shm_mode, compiled.execute(1).get(timeout=T))
        finally:
            compiled.teardown()
        d = s.remote(P, runtime="driver").remote()
        with s.dag.InputNode() as inp:
            dag2 = d.apply.bind(inp).with_tensor_transport("shm")
        err = _error(lambda: dag2.experimental_compile(backend="actor"))
        with pytest.raises(ValueError, match="process-backed"):
            dag2.experimental_compile(backend="actor")
        with pytest.raises(ValueError, match="unknown transport"):
            dag2.with_tensor_transport("nccl")
        return out, err[0]

    ref, port = _both(sides, run)
    assert port == ref == ((False, 2), "ValueError")


class _Gate:
    def __init__(self):
        self.seen = []

    def apply(self, x):
        # Host-side control logic; the payload stays a device value.
        self.seen.append(type(x).__name__)
        return x


def _scale(x):
    return x * 2.0


def _shift(x):
    return x + 1.0


def _finish(x):
    return x - 3.0


def test_mixed_actor_dag(sides):
    """Device-hinted function stages fuse into units whose outputs cross
    to a host actor stage as live values (a jax Array, a torch tensor),
    and a downstream device stage consumes the actor's output."""
    import jax.numpy as jnp

    def run(s):
        scale, shift, finish = (s.remote(f) for f in (_scale, _shift,
                                                      _finish))
        g = s.remote(_Gate, runtime="driver").remote()
        with s.dag.InputNode() as inp:
            a = scale.bind(inp).with_tensor_transport("device")
            b = shift.bind(a).with_tensor_transport("device")  # fuses
            c = g.apply.bind(b)
            d = finish.bind(c).with_tensor_transport("device")
        compiled = d.experimental_compile(backend="actor")
        try:
            x = (jnp.arange(8, dtype=jnp.float32) if s is REF
                 else torch.arange(8, dtype=torch.float32))
            out = compiled.execute(x).get(timeout=T)
            return {"shm": compiled._shm_mode,
                    "driver_stages": len(compiled._loops["__driver__"]),
                    "values": np.asarray(out).tolist(),
                    "seen": list(g._runtime.instance.seen),
                    "out_type": type(out).__name__}
        finally:
            compiled.teardown()

    ref, port = _both(sides, run)
    assert port["values"] == ref["values"] == (
        np.arange(8) * 2.0 + 1.0 - 3.0).tolist()
    assert port["shm"] is ref["shm"] is False
    assert port["driver_stages"] == ref["driver_stages"] == 2
    assert ref["seen"] and all(t in ("ArrayImpl", "Array")
                               for t in ref["seen"])
    assert port["seen"] == ["Tensor"] * len(ref["seen"])
    assert port["out_type"] == "Tensor"


def _axpy(x, k):
    return x + k


def test_mixed_dag_literal_args_break_fusion(sides):
    import jax.numpy as jnp

    def run(s):
        double, axpy = s.remote(_double), s.remote(_axpy)
        with s.dag.InputNode() as inp:
            a = double.bind(inp).with_tensor_transport("device")
            b = axpy.bind(a, 5.0).with_tensor_transport("device")
        compiled = b.experimental_compile(backend="actor")
        try:
            x = jnp.ones(4) if s is REF else torch.ones(4)
            out = compiled.execute(x).get(timeout=T)
            return (len(compiled._loops["__driver__"]),
                    np.asarray(out).tolist())
        finally:
            compiled.teardown()

    ref, port = _both(sides, run)
    assert port == ref == (2, [7.0] * 4)


def test_mixed_dag_shm_conflict_raises(sides):
    def run(s):
        f = s.remote(_add1)
        with s.dag.InputNode() as inp:
            a = f.bind(inp).with_tensor_transport("device")
            b = f.bind(a).with_tensor_transport("shm")
        with pytest.raises(ValueError, match="cannot mix"):
            b.experimental_compile(backend="actor")
        return _error(lambda: b.experimental_compile(backend="actor"))

    ref, port = _both(sides, run)
    assert port == ref and port[0] == "ValueError"
