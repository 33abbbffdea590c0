"""Parity of the port's one-controller mesh and collectives
(``ray_tpu_torch.parallel.mesh``, ``ray_tpu_torch.collective``) with the
reference's (``ray_tpu.parallel.mesh``, ``ray_tpu.collective.ops`` inside
``jax.shard_map``), on the CPU.

The reference runs each op in ``shard_map`` over its 8-device CPU mesh
(tests/conftest.py); the port runs the same op over 8 virtual CPU shards,
on the same numpy inputs cut into the same blocks. Inputs are integers
held as floats, so sums, means over 8 and every gather are exact: results
must be equal.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh, PartitionSpec as P

import ray_tpu.collective.ops as jops
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig
from ray_tpu.parallel.mesh import make_mesh as jmake_mesh
import ray_tpu_torch.collective as tops
from ray_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _meshes(kind):
    """(reference mesh, port mesh, the axis the op runs over, the spec
    that cuts dim 0 over every device)."""
    devs = jax.devices("cpu")[:8]
    if kind == "1d":
        return (JMesh(np.array(devs), ("x",)),
                tmesh.Mesh(np.array([CPU] * 8, dtype=object), ("x",)),
                "x", P("x"))
    # 2 x 4: the op runs over the inner axis, once per row.
    return (jmake_mesh(JMeshConfig(tp=4), devices=devs),
            tmesh.make_mesh(tmesh.MeshConfig(tp=4), devices=[CPU] * 8),
            "tp", P(tuple(tmesh.AXES)))


def _reference(kind, fn, x):
    """fn(shard) on every shard of the reference's mesh; [8, *out]."""
    jm, _, axis, spec = _meshes(kind)
    run = jax.shard_map(lambda a: fn(a, axis)[None], mesh=jm,
                        in_specs=spec, out_specs=spec, check_vma=False)
    return np.asarray(run(x))


def _port(kind, fn, x):
    """fn(shard list, mesh, axis) over each group of the port's mesh along
    the axis, on the same blocks; [8, *out]."""
    _, tm, axis, _ = _meshes(kind)
    blocks = [torch.from_numpy(b) for b in np.split(x, 8)]
    n = tm.shape[axis]
    out = []
    for g in range(0, 8, n):
        res = fn(blocks[g:g + n], tm, axis)
        assert len(res) == n
        # Each shard owns its result: no two share a buffer.
        assert len({r.data_ptr() for r in res}) == n
        out += res
    return torch.stack(out).numpy()


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 9, size=(8 * shape[0],) + shape[1:]).astype(
        np.float32)


def _twin(kind, jfn, tfn, shape=(4, 6)):
    x = _inputs(shape)
    want = _reference(kind, jfn, x)
    got = _port(kind, tfn, x)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


KINDS = ["1d", "2d"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_allreduce(kind, op):
    _twin(kind, lambda a, ax: jops.allreduce(a, ax, op),
          lambda xs, m, ax: tops.allreduce(xs, m, ax, op))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("tiled", [True, False])
@pytest.mark.parametrize("gather_axis", [0, 1])
def test_allgather(kind, tiled, gather_axis):
    _twin(kind,
          lambda a, ax: jops.allgather(a, ax, tiled=tiled,
                                       gather_axis=gather_axis),
          lambda xs, m, ax: tops.allgather(xs, m, ax, tiled=tiled,
                                           gather_axis=gather_axis))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("scatter_axis,tiled,shape", [
    (0, True, (8, 6)), (1, True, (4, 8)), (0, False, None)])
def test_reducescatter(kind, scatter_axis, tiled, shape):
    n = 8 if kind == "1d" else 4
    shape = shape or (n, 6)
    _twin(kind,
          lambda a, ax: jops.reducescatter(a, ax, scatter_axis=scatter_axis,
                                           tiled=tiled),
          lambda xs, m, ax: tops.reducescatter(
              xs, m, ax, scatter_axis=scatter_axis, tiled=tiled),
          shape)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("root", [0, 3])
def test_broadcast(kind, root):
    _twin(kind, lambda a, ax: jops.broadcast(a, ax, root),
          lambda xs, m, ax: tops.broadcast(xs, m, ax, root))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("perm", ["shift", "partial"])
def test_permute(kind, perm):
    n = 8 if kind == "1d" else 4
    pairs = ([(i, (i + 1) % n) for i in range(n)] if perm == "shift"
             else [(0, 2), (3, 1)])
    _twin(kind, lambda a, ax: jops.permute(a, ax, pairs),
          lambda xs, m, ax: tops.permute(xs, m, ax, pairs))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("split_axis,concat_axis,tiled", [
    (0, 1, True), (1, 0, True), (0, 0, True), (0, 1, False),
    (1, 0, False)])
def test_all_to_all(kind, split_axis, concat_axis, tiled):
    n = 8 if kind == "1d" else 4
    shape = [8, 16] if tiled else [3, 5]
    shape[split_axis] = 8 if tiled else n
    _twin(kind,
          lambda a, ax: jops.all_to_all(a, ax, split_axis, concat_axis,
                                        tiled=tiled),
          lambda xs, m, ax: tops.all_to_all(xs, m, ax, split_axis,
                                            concat_axis, tiled=tiled),
          tuple(shape))


@pytest.mark.parametrize("kind", KINDS)
def test_send_recv(kind):
    _twin(kind, lambda a, ax: jops.send_recv(a, ax, 2, 1),
          lambda xs, m, ax: tops.send_recv(xs, m, ax, 2, 1))


@pytest.mark.parametrize("kind", KINDS)
def test_axis_index_and_size(kind):
    _twin(kind,
          lambda a, ax: (jops.axis_index(ax) * 100 + jops.axis_size(ax)
                         + 0 * a[0, 0]).astype(np.float32),
          lambda xs, m, ax: [
              (i * 100 + tops.axis_size(m, ax) + 0 * x[0, 0]).float()
              for i, x in zip(tops.axis_index(m, ax), xs)])


def test_make_mesh_lays_out_devices_as_the_reference():
    """The same device order on the same axes: device i of the port's
    list sits where the reference puts jax device i."""
    jdevs = jax.devices("cpu")[:8]
    tdevs = [torch.device("cuda", i) for i in range(8)]
    for cfg in (JMeshConfig(tp=4), JMeshConfig(dp=2, pp=2, tp=2),
                JMeshConfig(dp=1, fsdp=2, tp=2, ep=2)):
        jm = jmake_mesh(cfg, devices=jdevs)
        tm = tmesh.make_mesh(tmesh.MeshConfig(**{
            a: getattr(cfg, a) for a in tmesh.AXES}), devices=tdevs)
        assert tm.axis_names == tuple(jm.axis_names)
        assert tm.shape == dict(jm.shape)
        assert tmesh.mesh_shape(tm) == dict(jm.shape)
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        tids = np.vectorize(lambda d: d.index)(tm.devices)
        np.testing.assert_array_equal(tids, ids)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_mesh(tp=3, devices=tdevs)
    with pytest.raises(ValueError, match="at most one"):
        tmesh.make_mesh(dp=-1, tp=-1, devices=tdevs)


def test_virtual_devices_come_only_from_the_variable_or_a_list(monkeypatch):
    monkeypatch.delenv(tmesh.VIRTUAL_DEVICES_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert tmesh.visible_devices() == []
    assert tmesh.visible_devices("cpu") == [CPU]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "8")
    # With no card the variable gives no shards on its own: CPU shards come
    # only from asking for them.
    with pytest.raises(RuntimeError, match="no CUDA device to hold virtual"):
        tmesh.make_mesh(tp=4)
    mesh = tmesh.make_mesh(tp=4, devices=tmesh.visible_devices("cpu"))
    assert mesh.shape == {"dp": 2, "fsdp": 1, "pp": 1, "tp": 4, "sp": 1,
                          "ep": 1}
    assert list(mesh.devices.flat) == [CPU] * 8
    assert mesh.axis_devices("tp") == [CPU] * 4
    with pytest.raises(RuntimeError, match="virtual shards"):
        tmesh.visible_devices("cuda")
    with tmesh.mesh_context(mesh):
        assert tmesh.get_mesh() is mesh
    assert tmesh.get_mesh() is None


def test_collectives_refuse_what_the_reference_refuses():
    _, tm, axis, _ = _meshes("1d")
    xs = [torch.zeros(2) for _ in range(8)]
    with pytest.raises(ValueError, match="7 shard tensors"):
        tops.allreduce(xs[:7], tm, axis)
    with pytest.raises(ValueError, match="no axis"):
        tops.allgather(xs, tm, "tp")
    with pytest.raises(ValueError, match="unsupported reduce op"):
        tops.allreduce(xs, tm, axis, "prod")
    with pytest.raises(ValueError, match="repeats"):
        tops.permute(xs, tm, axis, [(0, 1), (0, 2)])
    with pytest.raises(ValueError, match="does not divide"):
        tops.reducescatter([torch.zeros(6)] * 8, tm, axis)
