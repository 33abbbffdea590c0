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
"""

import dataclasses

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
