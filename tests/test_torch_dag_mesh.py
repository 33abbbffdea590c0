"""Parity of the port's mesh-sharded compiled-DAG executor
(``experimental_compile(backend="torch", mesh=...)``) with the
reference's (``backend="jax", mesh=...``), on the CPU.

The reference shards over its 8-device CPU mesh (tests/conftest.py);
the port over 8 virtual CPU shards of a one-controller mesh. Each DAG is
built twice, side by side, as tests/test_torch_dag.py builds them: the
outputs must be equal (exactly for the single-op DAGs, at rtol 1e-5 for
the (1024,) tensor DAG), and so must the sharded metadata (num_shards,
export_width, lanes_per_shard, wave_width, num_compiled_tasks) and the
visualize_schedule text. The partial replication of the object tables
is read shard by shard, and a zeroed exchange must change the output.
"""

import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from ray_tpu_torch.parallel import mesh as tmesh
from test_torch_dag import JAX, TORCH, _random_dag

torch.set_num_threads(1)

CPU = torch.device("cpu")
META = ("num_shards", "export_width", "lanes_per_shard", "wave_width",
        "num_compiled_tasks", "num_tasks", "num_waves", "op_names")


def _mesh(side, n=8):
    if side is JAX:
        return JMesh(np.array(jax.devices("cpu")[:n]), ("dag",))
    return tmesh.Mesh(np.array([CPU] * n, dtype=object), ("dag",))


def _compile(side, build, sharded=True, **kw):
    if sharded:
        kw = dict(kw, mesh=_mesh(side), mesh_axis="dag")
    return side.compile(build(side), **kw)


def _same(jc, tc):
    for attr in META:
        assert getattr(tc, attr) == getattr(jc, attr), attr
    for lanes in (8, 3):
        assert tc.visualize_schedule(lanes).replace(
            "CompiledTorchDAG", "CompiledJaxDAG") == \
            jc.visualize_schedule(lanes)


def _outputs(ref):
    out = ref.get()
    return out if isinstance(out, list) else [out]


def _twins(build, *inputs, rtol=None, **kw):
    """Compile ``build`` sharded on both sides and on one device on the
    port; sharded outputs equal the reference's, and the port's sharded
    outputs equal its one-device ones. Returns the port's sharded DAG."""
    jc = _compile(JAX, build, **kw)
    tc = _compile(TORCH, build, **kw)
    single = _compile(TORCH, build, sharded=False, **kw)
    assert single.num_shards == 1 and tc.num_shards == jc.num_shards
    _same(jc, tc)
    want = _outputs(jc.execute(*inputs))
    got = _outputs(tc.execute(*inputs))
    one = _outputs(single.execute(*inputs))
    assert len(got) == len(want) == len(one)
    for w, g, o in zip(want, got, one):
        if rtol is None:
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, o)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol)
            np.testing.assert_allclose(g, o, rtol=rtol)
    return tc


def _fanout(width):
    def build(s):
        with s.InputNode() as inp:
            layer = [s.ops["inc"].bind(inp) for _ in range(width)]
            while len(layer) > 1:
                layer = [s.ops["add"].bind(layer[i], layer[i + 1])
                         for i in range(0, len(layer), 2)]
            return layer[0]
    return build


@pytest.mark.parametrize("dynamic", [False, True])
def test_sharded_parity_fanout_twin(dynamic):
    """Twin of test_jax_sharded_parity_fanout: fan-out + reduce tree over
    8 shards."""
    x = np.arange(4, dtype=np.float32)
    tc = _twins(_fanout(32), x, payload_shape=(4,), dynamic=dynamic)
    assert tc.num_shards == 8
    np.testing.assert_array_equal(tc.execute(x).get(), (x + 1) * 32)


def test_sharded_chain_and_multi_output_twin():
    def build(s):
        with s.InputNode() as inp:
            a = inp
            for _ in range(10):
                a = s.ops["inc"].bind(a)
            b = s.ops["inc"].bind(inp)
            return s.MultiOutputNode([a, s.ops["add"].bind(a, b)])

    out_a, out_ab = _twins(build, 1.0).execute(1.0).get()
    assert float(out_a) == 11.0 and float(out_ab) == 13.0


@pytest.mark.parametrize("dynamic", [False, True])
def test_sharded_width_not_divisible_twin(dynamic):
    def build(s):
        with s.InputNode() as inp:
            mids = [s.ops["inc"].bind(inp) for _ in range(13)]
            acc = mids[0]
            for m in mids[1:]:
                acc = s.ops["add"].bind(acc, m)
            return acc

    assert float(_twins(build, 0.0, dynamic=dynamic).execute(0.0).get()) \
        == 13.0


def _tensor_dag(s):
    with s.InputNode() as inp:
        chains = []
        for _ in range(64):  # 64 independent chains of 15 -> 960 tasks
            node = inp
            for _ in range(15):
                node = s.ops["scale"].bind(node)
            chains.append(node)
        while len(chains) > 1:  # + 63 merge tasks crossing shards
            chains = [s.ops["add"].bind(chains[i], chains[i + 1])
                      for i in range(0, len(chains), 2)]
        return chains[0]


@pytest.mark.parametrize("dynamic", [False, True])
def test_sharded_tensor_payload_parity_twin(dynamic):
    """Twin of test_jax_sharded_tensor_payload_parity: ~1k tasks with
    (1024,) payloads, at the reference's rtol."""
    x = np.linspace(0.0, 1.0, 1024, dtype=np.float32)
    _twins(_tensor_dag, x, rtol=1e-5, payload_shape=(1024,), fuse=True,
           dynamic=dynamic)


def _diamonds(s):
    with s.InputNode() as inp:
        outs = []
        for _ in range(32):
            h = s.ops["inc"].bind(inp)
            l, r = s.ops["inc"].bind(h), s.ops["inc"].bind(h)
            outs.append(s.ops["add"].bind(l, r))
        acc = outs[0]
        for o in outs[1:]:
            acc = s.ops["add"].bind(acc, o)
        return acc


def test_sharded_exchange_is_compacted_twin():
    tc = _twins(_diamonds, 0.0, fuse=False)
    assert tc.export_width is not None and tc.export_width <= 4
    assert tc.lanes_per_shard >= 8
    assert float(tc.execute(0.0).get()) == 128.0


@pytest.mark.parametrize("dynamic", [False, True])
def test_sharded_chain_skips_collective_twin(dynamic):
    def build(s):
        with s.InputNode() as inp:
            node = inp
            for _ in range(24):
                node = s.ops["inc"].bind(node)
            return node

    tc = _twins(build, 0.0, fuse=False, dynamic=dynamic)
    if not dynamic:
        assert tc.export_width is not None and tc.export_width <= 1
        assert "exchange: none (no collective)" in tc.visualize_schedule()
    assert float(tc.execute(0.0).get()) == 24.0


@pytest.mark.parametrize("frontier_width", [1, 2, 5, None])
def test_sharded_dynamic_compacted_frontier_twin(frontier_width):
    tc = _twins(_fanout(32), 1.0, dynamic=True,
                frontier_width=frontier_width)
    if frontier_width == 2:
        assert tc.export_width == 2
    assert f"frontier width {tc._F}/shard" in tc.visualize_schedule()
    assert float(tc.execute(1.0).get()) == 64.0


def test_visualize_schedule_names_exports_twin():
    x = np.ones(4, np.float32)
    tc = _twins(_fanout(16), x, payload_shape=(4,), fuse=False)
    text = tc.visualize_schedule()
    assert "wave 0" in text and "wave 2" in text and "shard 0" in text
    assert "exchange (all_gather)" in text
    assert re.findall(r"shard\d+:\[\d+\]->s(\d+)", text)
    assert "*" in text


@pytest.mark.parametrize("fuse", [True, False])
def test_sharded_dynamic_partitioned_skips_payload_exchange_twin(fuse):
    def build(s):
        with s.InputNode() as inp:
            chains = []
            for _ in range(8):
                node = inp
                for _ in range(5):
                    node = s.ops["inc"].bind(node)
                chains.append(node)
            return s.MultiOutputNode(chains)

    x = np.arange(4, dtype=np.float32)
    tc = _twins(build, x, payload_shape=(4,), dynamic=True, fuse=fuse)
    assert tc.export_width == 0
    for g in tc.execute(x).get():
        np.testing.assert_array_equal(g, x + 5)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dynamic", [False, True])
def test_random_dags_sharded_twin(seed, dynamic):
    """test_torch_dag.py's seeded random DAGs, sharded over 8 and over 3
    shards (lanes that do not divide the waves)."""
    n = 30 + 25 * seed
    x = 0.25 * seed - 0.5
    for n_sh in (8, 3):
        jm = JMesh(np.array(jax.devices("cpu")[:n_sh]), ("dag",))
        tm = tmesh.Mesh(np.array([CPU] * n_sh, dtype=object), ("dag",))
        for fuse in (True, False):
            jc = JAX.compile(_random_dag(JAX, seed, n), dynamic=dynamic,
                             fuse=fuse, mesh=jm)
            tc = TORCH.compile(_random_dag(TORCH, seed, n), dynamic=dynamic,
                               fuse=fuse, mesh=tm)
            _same(jc, tc)
            for w, g in zip(_outputs(jc.execute(x)), _outputs(tc.execute(x))):
                np.testing.assert_array_equal(g, w)


def test_shard_tables_are_partially_replicated():
    """After a sharded static execute each shard's table holds the inputs,
    its own lanes' outputs and the exported slots; a slot that another
    shard produced and did not export stays zero there."""
    tc = _compile(TORCH, _diamonds, fuse=False)
    assert float(tc.execute(0.0).get()) == 128.0
    tables = tc.shards()
    assert len(tables) == 8
    owner, exported = {}, set()
    for by_shard in tc._viz["waves"]:
        for sh, entries in by_shard.items():
            for ci, name, slot, exp in entries:
                owner[slot] = sh
                if exp:
                    exported.add(slot)
    local = [s for s in owner if s not in exported]
    assert local and exported
    for sh, table in enumerate(tables):
        for slot, producer in owner.items():
            value = float(table[slot])
            if slot in exported or producer == sh:
                assert value > 0, (sh, slot)   # every task output is > 0
            else:
                assert value == 0.0, (sh, slot)
    # Every shard imported something and kept something to itself.
    for sh in range(8):
        assert any(owner[s] == sh for s in local)


@pytest.mark.parametrize("wave", [0, 1, 4])
def test_zeroed_exchange_changes_the_fanout_output(wave):
    x = np.arange(4, dtype=np.float32)
    tc = _compile(TORCH, _fanout(32), payload_shape=(4,))
    want = tc.execute(x).get()
    real = tc._exchange

    def zeroed(packed, w=None):
        got = real(packed, w)
        return [torch.zeros_like(g) for g in got] if w == wave else got

    tc._exchange = zeroed
    got = tc.execute(x).get()
    assert not np.array_equal(got, want)
    tc._exchange = real
    np.testing.assert_array_equal(tc.execute(x).get(), want)


def test_mesh_axis_rule_and_fall_through():
    """The default axis is the first of size > 1; an unknown axis raises
    the reference's ValueError; a one-shard axis compiles the one-device
    executor."""
    jm = jax.sharding.Mesh(
        np.array(jax.devices("cpu")[:8]).reshape(1, 4, 2), ("a", "b", "c"))
    tm = tmesh.Mesh(np.array([CPU] * 8, dtype=object).reshape(1, 4, 2),
                    ("a", "b", "c"))
    jc = JAX.compile(_fanout(8)(JAX), mesh=jm)
    tc = TORCH.compile(_fanout(8)(TORCH), mesh=tm)
    _same(jc, tc)
    assert tc.num_shards == 4 and tc.mesh_axis == "b"
    assert float(tc.execute(1.0).get()) == float(jc.execute(1.0).get())
    msgs = []
    for side, mesh in ((JAX, jm), (TORCH, tm)):
        with pytest.raises(ValueError) as info:
            side.compile(_fanout(8)(side), mesh=mesh, mesh_axis="dag")
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
    for side, mesh in ((JAX, jm), (TORCH, tm)):
        one = side.compile(_fanout(8)(side), mesh=mesh, mesh_axis="a")
        assert one.num_shards == 1 and one.export_width is None
    tone = TORCH.compile(_fanout(8)(TORCH), mesh=tm, mesh_axis="a")
    assert type(tone).__name__ == "CompiledTorchDAG"
