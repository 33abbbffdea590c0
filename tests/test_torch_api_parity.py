"""Two corners of the reference's API that the port now takes, on the CPU.

``CompiledJaxDAG.teardown`` (``ray_tpu/dag/jax_executor.py``) exists for
parity with the actor-loop backend and stops nothing; the port's compiled
DAGs, one-device and sharded, have the same no-op. The reference's
``forward`` and ``loss_fn`` take ``mesh=`` and ``rules=``, which only add
sharding constraints to the GSPMD program: the values do not change. The
port takes both and returns the same values, here against the reference's
on the same parameters (``params_from_jax``), with no mesh and on an
8-device CPU mesh (dp 2 x tp 4, the reference's over its 8 virtual CPU
devices, the port's over 8 virtual shards of the CPU).

The reference's exception types that it defines and never raises
(``ActorUnavailableError``, ``ObjectReconstructionFailedError``,
``PendingCallsLimitExceededError``) exist in the port with the same bases
and messages. ``SerializationContext.register_serializer`` /
``deregister_serializer``: a registered class round-trips through
``put``/``get`` and a task on the thread plane, through the wire form and
through a worker process of the process plane, its values equal on both
sides. In the port the pair is used until it is deregistered; in the
reference it never is (ROADMAP C.18: its dispatch table is set on the
``CloudPickler`` after construction, which the C pickler never reads).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.models as jm
from ray_tpu.models import transformer as jt
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel.sharding import ShardingRules as JRules
from ray_tpu_torch import models as tm
from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel.sharding import ShardingRules as TRules
from test_torch_dag import TORCH
from test_torch_dag_mesh import _mesh

torch.set_num_threads(1)

CPU = torch.device("cpu")
# f32 logits of the same parameters through the same ops in another
# framework: the summation orders differ (as tests/test_torch_attention_
# routing.py allows for its configs).
LOGIT_ATOL = 1e-4
LOSS_RTOL = 1e-6
CFG = jm.TransformerConfig(vocab_size=64, d_model=64, n_layers=2,
                           n_heads=4, n_kv_heads=2, d_ff=128,
                           dtype=jnp.float32)


@pytest.mark.parametrize("sharded", [False, True], ids=["one", "sharded"])
def test_compiled_torch_dag_teardown_is_a_noop(sharded):
    with TORCH.InputNode() as inp:
        node = TORCH.ops["add"].bind(TORCH.ops["inc"].bind(inp),
                                     TORCH.ops["double"].bind(inp))
    kw = dict(mesh=_mesh(TORCH), mesh_axis="dag") if sharded else {}
    compiled = TORCH.compile(node, **kw)
    assert type(compiled).__name__ == ("ShardedTorchDAG" if sharded
                                       else "CompiledTorchDAG")
    want = compiled.execute(3).get()
    assert compiled.teardown() is None
    # Nothing was stopped: the DAG still executes, and equals itself.
    np.testing.assert_array_equal(compiled.execute(3).get(), want)


def _port_cfg(cfg):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = torch.float32
    return tt.TransformerConfig(**fields)


def _meshes(with_mesh):
    if not with_mesh:
        return (None, None), (None, None)
    jm8 = jmesh.make_mesh(dp=2, tp=4, devices=jax.devices("cpu")[:8])
    tm8 = tmesh.make_mesh(dp=2, tp=4, devices=[CPU] * 8)
    return (jm8, JRules()), (tm8, TRules())


@pytest.mark.parametrize("with_mesh", [False, True],
                         ids=["mesh_none", "mesh_dp2_tp4"])
def test_forward_and_loss_take_mesh_and_rules(with_mesh):
    jp = jm.init_params(CFG, jax.random.PRNGKey(0))
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                            _port_cfg(CFG), device="cpu")
    tcfg = _port_cfg(CFG)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 64, (2, 16)).astype(np.int32)
    targets = rng.integers(0, 64, (2, 16)).astype(np.int32)
    (jmesh8, jrules), (tmesh8, trules) = _meshes(with_mesh)
    ref_logits = jm.forward(CFG, jp, jnp.asarray(tokens), jmesh8, jrules)
    ref_loss = jt.loss_fn(CFG, jp, jnp.asarray(tokens),
                          jnp.asarray(targets), jmesh8, jrules)
    tt_tokens, tt_targets = torch.from_numpy(tokens), torch.from_numpy(
        targets)
    logits = tm.forward(tcfg, tp, tt_tokens, mesh=tmesh8, rules=trules)
    loss = tm.loss_fn(tcfg, tp, tt_tokens, tt_targets, mesh=tmesh8,
                      rules=trules)
    # The same values as the plain call, exactly, and as the reference's.
    assert torch.equal(logits, tm.forward(tcfg, tp, tt_tokens))
    assert torch.equal(loss, tm.loss_fn(tcfg, tp, tt_tokens, tt_targets))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)


# ------------------------------------------------------ A.11's leftovers
@pytest.mark.parametrize("name,base,args,message", [
    ("ActorUnavailableError", "RayActorError", ("a1",), "actor a1 is dead"),
    ("ObjectReconstructionFailedError", "ObjectLostError", ("o1",),
     "object o1 was lost"),
    ("PendingCallsLimitExceededError", "RayTpuError", ("full",), "full"),
])
def test_exception_types_match_reference(name, base, args, message):
    import ray_tpu.exceptions as jexc
    import ray_tpu_torch.exceptions as texc

    for mod in (jexc, texc):
        cls = getattr(mod, name)
        assert cls.__bases__ == (getattr(mod, base),)
        err = cls(*args)
        assert isinstance(err, getattr(mod, base))
        assert isinstance(err, mod.RayTpuError)
        assert str(err) == message
    assert [c.__name__ for c in getattr(texc, name).__mro__] == [
        c.__name__ for c in getattr(jexc, name).__mro__]


def _point_class():
    """A class defined here, so it crosses to a worker process by value."""
    class Point:
        def __init__(self, x, via="pickle"):
            self.x, self.via = x, via

    return Point


def _registered_round_trips(rt, worker_mod):
    """(x, via) of a Point through put/get, through a task that takes it
    by reference and returns it, and, for the wire form, through
    ``to_bytes``: with a serializer registered, then after
    ``deregister_serializer``."""
    Point = _point_class()
    ctx = worker_mod.global_worker().serialization_context
    ser_mod = importlib.import_module(
        worker_mod.__name__.replace(".worker", ".serialization"))

    @rt.remote
    def echo(p):
        return p.x, p.via, p

    def trips(base):
        got = rt.get(rt.put(Point(base)))
        x, via_in_task, back = rt.get(echo.remote(rt.put(Point(base + 1))))
        wire = ser_mod.SerializationContext().deserialize(
            ser_mod.SerializedObject.from_bytes(
                ctx.serialize(Point(base + 2)).to_bytes()))
        return [(got.x, got.via), (x, via_in_task), (back.x, back.via),
                (wire.x, wire.via)]

    ctx.register_serializer(Point, serializer=lambda p: p.x,
                            deserializer=lambda x: Point(x, "custom"))
    try:
        registered = trips(10)
    finally:
        ctx.deregister_serializer(Point)
    return registered, trips(20)


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_registered_serializer_round_trips(mode):
    import ray_tpu
    import ray_tpu._private.worker as jworker
    import ray_tpu_torch
    import ray_tpu_torch._private.worker as tworker

    out = {}
    for name, rt, mod in (("reference", ray_tpu, jworker),
                          ("port", ray_tpu_torch, tworker)):
        rt.shutdown()
        rt.init(num_cpus=2, worker_mode=mode, ignore_reinit_error=True)
        try:
            out[name] = _registered_round_trips(rt, mod)
        finally:
            rt.shutdown()
    values = {name: [[x for x, _ in trips] for trips in both]
              for name, both in out.items()}
    assert values["port"] == values["reference"] == [
        [10, 11, 11, 12], [20, 21, 21, 22]]
    registered, deregistered = out["port"]
    assert [via for _, via in registered] == ["custom"] * 4
    assert [via for _, via in deregistered] == ["pickle"] * 4
    # C.18: the reference's registration never reaches its pickler.
    assert [via for trips in out["reference"] for _, via in trips] == [
        "pickle"] * 8
