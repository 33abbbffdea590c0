"""Parity of the port's compiled-DAG wave executor
(``experimental_compile(backend="torch")``) with the reference's JAX wave
executor (``backend="jax"``), on the CPU.

Each DAG is built twice, side by side, from the same plain functions:
once through ``ray_tpu.remote`` and ``ray_tpu.dag`` (the reference
compiles without a runtime), once through the port's ``remote`` and
``ray_tpu_torch.dag``. Ops are single IEEE operations (x + 1, x * 2,
a + b, ...), which both frameworks round alike, so outputs must be equal
exactly, as must the schedule metadata (``num_tasks``,
``num_compiled_tasks``, ``num_waves``, ``wave_width``, ``op_names``) and
the ``visualize_schedule`` text. The tensor-payload DAGs of ``bench.py``
(x * 1.001 + 0.5, x @ x * 0.01 + x), whose products XLA may contract,
compare at the reference's own limits (rtol 1e-5 and 1e-3).
"""

import dataclasses
import pathlib
import subprocess
import sys
from typing import Any, Callable

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.dag as jdag
import ray_tpu_torch.dag as tdag
from ray_tpu_torch.remote_function import remote as tremote

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _inc(x):
    return x + 1.0


def _double(x):
    return x * 2.0


def _add(a, b):
    return a + b


def _sub(a, b):
    return a - b


def _add3(a, b, c):
    return a + b + c


def _noop(x):
    return x


def _combine(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def _scale(x):
    return x * 1.001 + 0.5


def _matsq(x):
    return x @ x * 0.01 + x


@dataclasses.dataclass
class Side:
    """One framework's DAG vocabulary: its remote functions, InputNode,
    MultiOutputNode, reduce_tree and compile options."""
    name: str
    remote: Callable[[Callable], Any]
    InputNode: Any
    MultiOutputNode: Any
    reduce_tree: Any
    backend: str
    options: dict

    def __post_init__(self):
        self.ops = {f.__name__.lstrip("_"): self.remote(f) for f in (
            _inc, _double, _add, _sub, _add3, _noop, _combine, _scale,
            _matsq)}

    def compile(self, node, **kw):
        return node.experimental_compile(backend=self.backend,
                                         **self.options, **kw)


JAX = Side("jax", ray_tpu.remote, jdag.InputNode, jdag.MultiOutputNode,
           jdag.reduce_tree, "jax", {})
TORCH = Side("torch", tremote, tdag.InputNode, tdag.MultiOutputNode,
             tdag.reduce_tree, "torch", {"device": "cpu"})


def _same_schedule(jc, tc):
    for attr in ("num_tasks", "num_compiled_tasks", "num_waves",
                 "wave_width", "op_names"):
        assert getattr(tc, attr) == getattr(jc, attr), attr
    for lanes in (8, 3):
        assert tc.visualize_schedule(lanes).replace(
            "CompiledTorchDAG", "CompiledJaxDAG") == \
            jc.visualize_schedule(lanes)


def _twins(build, *inputs, **kw):
    """Compile build(side) on both sides with options ``kw``; both must
    give the same outputs (exactly) and the same schedule. Returns the
    port's compiled DAG."""
    jc = JAX.compile(build(JAX), **kw)
    tc = TORCH.compile(build(TORCH), **kw)
    _same_schedule(jc, tc)
    want, got = jc.execute(*inputs).get(), tc.execute(*inputs).get()
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)
    return tc


def _chain(op_names, n):
    def build(s):
        with s.InputNode() as inp:
            node = inp
            for i in range(n):
                node = s.ops[op_names[i % len(op_names)]].bind(node)
        return node
    return build


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("fuse", [True, False])
def test_chain_twin(dynamic, fuse):
    """Twin of test_jax_chain / test_jax_chain_unfused: 64 incs fuse into
    one macro-op (one wave), or run one wave per task."""
    tc = _twins(_chain(["inc"], 64), 0.0, dynamic=dynamic, fuse=fuse)
    assert float(tc.execute(0.0).get()) == 64.0
    assert tc.num_compiled_tasks == (1 if fuse else 64)


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("ops,n", [(["inc"], 40), (["inc", "double"], 40),
                                   (["double", "inc", "inc"], 17),
                                   (["noop"], 1000)],
                         ids=["same-op-40", "mixed-40", "mixed-17",
                              "chain-1k-noop"])
def test_chain_over_unroll_limit_twin(ops, n, dynamic):
    """Fused tails longer than the reference's unroll limit of 16: the
    reference scans one op (same-op) or switches over several (mixed);
    the port runs one loop. bench.py's chain_1k_noop is the last case."""
    _twins(_chain(ops, n), 1.5, dynamic=dynamic)


@pytest.mark.parametrize("dynamic", [False, True])
def test_fanout_fanin_twin(dynamic):
    """Twin of test_jax_fanout_fanin: 256 leaves through a binary tree."""
    def build(s):
        with s.InputNode() as inp:
            leaves = [s.ops["inc"].bind(inp) for _ in range(256)]
            return s.reduce_tree(s.ops["add"], leaves, arity=2)

    tc = _twins(build, 1.0, dynamic=dynamic)
    assert float(tc.execute(1.0).get()) == 512.0


@pytest.mark.parametrize("dynamic", [False, True])
def test_bench_fanout_twin(dynamic):
    """bench.py's fan-out shape at width 256: noop leaves reduced by a
    4-ary combine tree (341 tasks)."""
    def build(s):
        with s.InputNode() as inp:
            leaves = [s.ops["noop"].bind(inp) for _ in range(256)]
            return s.reduce_tree(s.ops["combine"], leaves, arity=4)

    tc = _twins(build, 2.0, dynamic=dynamic)
    assert tc.num_tasks == 256 + 64 + 16 + 4 + 1


def _diamond(s):
    with s.InputNode() as inp:
        a = s.ops["inc"].bind(inp)
        b = s.ops["inc"].bind(a)
        c = s.ops["add"].bind(a, b)
        return s.ops["add"].bind(c, inp)


def test_dynamic_frontier_matches_static_twin():
    """Twin of test_jax_dynamic_frontier_matches_static."""
    static = _twins(_diamond, 3.0, dynamic=False)
    dynamic = _twins(_diamond, 3.0, dynamic=True)
    assert float(static.execute(3.0).get()) == float(
        dynamic.execute(3.0).get()) == (4 + 5) + 3


@pytest.mark.parametrize("dynamic", [False, True])
def test_multi_output_twin(dynamic):
    def build(s):
        with s.InputNode() as inp:
            x = s.ops["inc"].bind(inp)
            return s.MultiOutputNode([x, s.ops["inc"].bind(x)])

    a, b = _twins(build, 0.0, dynamic=dynamic).execute(0.0).get()
    assert float(a) == 1.0 and float(b) == 2.0


@pytest.mark.parametrize("dynamic", [False, True])
def test_vector_payload_twin(dynamic):
    def build(s):
        with s.InputNode() as inp:
            return s.ops["add"].bind(s.ops["inc"].bind(inp),
                                     s.ops["double"].bind(inp))

    x = np.arange(8, dtype=np.float32)
    out = _twins(build, x, dynamic=dynamic, payload_shape=(8,),
                 dtype=np.float32).execute(x).get()
    np.testing.assert_array_equal(out, 3 * x + 1)


@pytest.mark.parametrize("dynamic", [False, True])
def test_multiple_inputs_twin(dynamic):
    def build(s):
        with s.InputNode() as inp:
            return s.ops["sub"].bind(s.ops["noop"].bind(inp[1]),
                                     s.ops["noop"].bind(inp[0]))

    tc = _twins(build, 2.0, 5.0, dynamic=dynamic)
    assert float(tc.execute(2.0, 5.0).get()) == 3.0
    with pytest.raises(ValueError, match="takes 2 input"):
        tc.execute(1.0)


def _reference_error(s, node, **kw):
    with pytest.raises(ValueError) as info:
        s.compile(node, **kw)
    return str(info.value)


def test_shape_mismatch_rejected_twin():
    """Twin of test_jax_shape_mismatch_rejected: an op that changes the
    payload shape fails at compile time with the same message."""
    import jax.numpy as jnp

    def bad_jax(x):
        return jnp.stack([x, x])

    def bad_torch(x):
        return torch.stack([x, x])

    msgs = []
    for s, bad in ((JAX, bad_jax), (TORCH, bad_torch)):
        bad.__name__ = "bad"
        with s.InputNode() as inp:
            node = s.remote(bad).bind(inp)
        msgs.append(_reference_error(s, node))
    assert "payload bucket" in msgs[1]
    assert msgs[1] == msgs[0]


def test_kwargs_and_max_args_rejected_twin():
    msgs = {}
    for s in (JAX, TORCH):
        with s.InputNode() as inp:
            kw = s.ops["add"].bind(inp, b=inp)
            wide = s.ops["combine"].bind(*[inp] * 5)
            three = s.ops["add3"].bind(inp, inp, inp)
        msgs[s.name] = (_reference_error(s, kw),
                        _reference_error(s, wide),
                        _reference_error(s, three, max_args=2))
        # The default max_args (4) takes the 3-arg task.
        assert float(s.compile(three).execute(1.0).get()) == 3.0
    j, t = msgs["jax"], msgs["torch"]
    assert "positional bind() args" in t[0] and "5 args > max_args=4" in t[1]
    assert "3 args > max_args=2" in t[2]
    assert [m.replace("torch backend", "jax backend").replace(
        "raise max_args", "raise wave_executor_max_args") for m in t] == \
        list(j)


def _random_dag(s, seed, n):
    """A seeded random DAG over the exact ops: each task draws its op and
    its arguments from the input and earlier tasks (recent ones more
    often, so chains, fan-in and fan-out all occur); the leaf outputs
    every task that nothing consumes."""
    rng = np.random.default_rng(seed)
    arity = {"inc": 1, "double": 1, "add": 2, "sub": 2, "add3": 3}
    names = list(arity)
    consumed = set()
    with s.InputNode() as inp:
        nodes = [inp]
        for _ in range(n):
            op = names[rng.integers(len(names))]
            picks = [int(len(nodes) - 1 - min(rng.geometric(0.3) - 1,
                                             len(nodes) - 1))
                     for _ in range(arity[op])]
            consumed.update(picks)
            nodes.append(s.ops[op].bind(*[nodes[i] for i in picks]))
        outs = [nodes[i] for i in range(1, len(nodes)) if i not in consumed]
        return s.MultiOutputNode(outs) if len(outs) > 1 else outs[0]


@pytest.mark.parametrize("seed", range(6))
def test_random_dags_static_dynamic_and_reference(seed):
    n = 30 + 20 * seed
    x = 0.25 * seed - 0.5
    want = JAX.compile(_random_dag(JAX, seed, n)).execute(x).get()
    for dynamic in (False, True):
        for fuse in (True, False):
            jc = JAX.compile(_random_dag(JAX, seed, n), dynamic=dynamic,
                             fuse=fuse)
            tc = TORCH.compile(_random_dag(TORCH, seed, n), dynamic=dynamic,
                               fuse=fuse)
            _same_schedule(jc, tc)
            got = tc.execute(x).get()
            if not isinstance(want, list):
                want, got = [want], [got]
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g, w)


def _bench_tensor_dag(s, op, width, depth):
    """bench.py's sharded-suite DAG: ``width`` chains of ``depth`` ops from
    the input, merged pairwise."""
    with s.InputNode() as inp:
        chains = []
        for _ in range(width):
            node = inp
            for _ in range(depth):
                node = s.ops[op].bind(node)
            chains.append(node)
        while len(chains) > 1:
            chains = [s.ops["add"].bind(chains[i], chains[i + 1])
                      for i in range(0, len(chains), 2)]
        return chains[0]


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("op,payload,x,rtol", [
    ("scale", (1024,), np.linspace(0.0, 1.0, 1024, dtype=np.float32), 1e-5),
    ("matsq", (64, 64), np.linspace(0.0, 0.1, 4096, dtype=np.float32)
     .reshape(64, 64), 1e-3)], ids=["elementwise", "matmul"])
def test_bench_tensor_dags_twin(op, payload, x, rtol, dynamic):
    """bench.py's elementwise_1k and matmul_heavy DAGs at width 8 (the
    chip runs width 64): the reference's limits, the same schedule."""
    jc = JAX.compile(_bench_tensor_dag(JAX, op, 8, 15), dynamic=dynamic,
                     payload_shape=payload)
    tc = TORCH.compile(_bench_tensor_dag(TORCH, op, 8, 15), dynamic=dynamic,
                       payload_shape=payload)
    _same_schedule(jc, tc)
    np.testing.assert_allclose(tc.execute(x).get(), jc.execute(x).get(),
                               rtol=rtol)


@pytest.mark.parametrize("dynamic", [False, True])
def test_ref_keeps_its_value_after_the_next_execute(dynamic):
    """The executor reuses its object table; each ref owns its outputs,
    and a chain of executes feeds each output into the next (bench.py)."""
    tc = TORCH.compile(_diamond(TORCH), dynamic=dynamic)
    first = tc.execute(1.0)
    refs = [first]
    for _ in range(3):
        refs.append(tc.execute(refs[-1].device_value()))
    want = 1.0
    for ref in refs:
        want = 3 * want + 3
        assert float(ref.get()) == want
    assert float(first.get()) == 6.0
    assert isinstance(first.device_value(), torch.Tensor)


def test_extra_dynamic_iterations_change_nothing():
    tc = TORCH.compile(_random_dag(TORCH, 7, 40), dynamic=True)
    out = tc.execute(0.75).get()
    table = tc._obj.clone()
    indeg = tc._indeg.clone()
    assert bool(tc._done.all())
    for _ in range(3):
        tc._iteration()
    assert torch.equal(tc._indeg, indeg) and bool(tc._done.all())
    # Only the scratch slot (the last row) may change.
    assert torch.equal(tc._obj[:-1], table[:-1])
    for a, b in zip(out, tc.execute(0.75).get()):
        np.testing.assert_array_equal(a, b)


def test_what_waits_for_the_runtime_or_the_mesh_raises():
    with TORCH.InputNode() as inp:
        node = TORCH.ops["inc"].bind(inp)
    # The mesh paths are ported: only an axis the mesh lacks raises.
    from ray_tpu_torch.parallel import Mesh

    mesh = Mesh(np.array([torch.device("cpu")] * 2, dtype=object), ("dag",))
    with pytest.raises(ValueError, match="no axis 'tp'"):
        TORCH.compile(node, mesh=mesh, mesh_axis="tp")
    # The runtime's paths are ported (tests/test_torch_dag_actor.py):
    # .remote(), the interpreted execute and the actor backend run.
    import ray_tpu_torch

    try:
        assert ray_tpu_torch.get(TORCH.ops["inc"].remote(1.0),
                                 timeout=30) == _inc(1.0)
        assert ray_tpu_torch.get(node.execute(1.0), timeout=30) == _inc(1.0)
        compiled = node.experimental_compile(backend="actor")
        try:
            assert compiled.execute(1.0).get(timeout=30) == _inc(1.0)
        finally:
            compiled.teardown()
    finally:
        ray_tpu_torch.shutdown()
    with pytest.raises(ValueError, match="unknown compile backend"):
        node.experimental_compile(backend="jax")


def test_compile_defaults_to_cuda_and_refuses_to_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with TORCH.InputNode() as inp:
        node = TORCH.ops["inc"].bind(inp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        node.experimental_compile(backend="torch")


def test_port_import_loads_no_jax_and_no_ray_tpu():
    code = (
        "import sys\n"
        "import ray_tpu_torch, ray_tpu_torch.dag, ray_tpu_torch.models\n"
        "import ray_tpu_torch.remote_function, ray_tpu_torch.llm\n"
        "import ray_tpu_torch.parallel, ray_tpu_torch.collective\n"
        "import ray_tpu_torch.rl.impala, ray_tpu_torch.train\n"
        "import ray_tpu_torch.util.profiling, ray_tpu_torch.llm.disagg\n"
        "import ray_tpu_torch.dag.compiled_dag, ray_tpu_torch.channels\n"
        "import ray_tpu_torch.collective.collective\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ray_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
