"""Twins of the reference's actor-plane collective test
(``tests/test_ops.py::test_collective_group_allreduce_between_actors``)
and of its top-level resource verbs, on the CPU.

Both runtimes run in one process (the reference on
``ray_tpu.init(worker_mode="thread")``); the same actor class joins a
group of 3 on each and the results are compared: the reference's numpy
arrays against the port's tensors, exactly (sums, means and maxima of
small integers in f32). Every wait is bounded.
"""

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import collective as jcol
from ray_tpu_torch.collective import collective as tcol

T = 30.0


@pytest.fixture
def runtimes():
    for rt in (ray_tpu, ray_tpu_torch):
        rt.shutdown()
    ray_tpu.init(num_cpus=4, worker_mode="thread", ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=4)
    try:
        yield
    finally:
        for rt in (ray_tpu, ray_tpu_torch):
            rt.shutdown()


def _worker_class(rt, col, as_array):
    @rt.remote
    class Worker:
        def __init__(self, rank):
            self.rank = rank

        def collective_join(self, world_size, rank, backend, group):
            col.init_collective_group(world_size, rank, backend, group)
            return rank

        def reduce(self, group, op="sum"):
            return col.allreduce(as_array(np.full((4,), float(
                self.rank + 1), np.float32)), group_name=group, op=op)

        def gather(self, group):
            return col.allgather(as_array(np.asarray([self.rank])),
                                 group_name=group)

        def scatter(self, group):
            return col.reducescatter(as_array(np.arange(
                6, dtype=np.float32) * (self.rank + 1)), group_name=group)

        def bcast(self, group):
            return col.broadcast(as_array(np.full((2,), float(
                self.rank), np.float32)), src_rank=2, group_name=group)

        def ring(self, group):
            col.barrier(group_name=group)
            dst, src = (self.rank + 1) % 3, (self.rank - 1) % 3
            col.send(as_array(np.asarray([10 * self.rank])), dst,
                     group_name=group)
            return col.recv(src, group_name=group), col.get_rank(group)

    return Worker


def _drive(rt, col, as_array):
    workers = [_worker_class(rt, col, as_array).remote(i) for i in range(3)]
    col.create_collective_group(workers, world_size=3, ranks=[0, 1, 2],
                                group_name="g1")
    out = {}
    for name, call in (("sum", lambda w: w.reduce.remote("g1")),
                       ("mean", lambda w: w.reduce.remote("g1", "mean")),
                       ("max", lambda w: w.reduce.remote("g1", "max")),
                       ("gather", lambda w: w.gather.remote("g1")),
                       ("scatter", lambda w: w.scatter.remote("g1")),
                       ("bcast", lambda w: w.bcast.remote("g1")),
                       ("ring", lambda w: w.ring.remote("g1"))):
        vals = rt.get([call(w) for w in workers], timeout=T)
        out[name] = _plain(vals)
    col.destroy_collective_group("g1")
    # A re-created group starts again at round 0.
    col.create_collective_group(workers, world_size=3, ranks=[0, 1, 2],
                                group_name="g1")
    out["again"] = _plain(rt.get([w.reduce.remote("g1") for w in workers],
                                 timeout=T))
    col.destroy_collective_group("g1")
    return out


def _plain(v):
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, torch.Tensor):
        return v.tolist()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def test_collective_group_between_actors_matches_reference(runtimes):
    want = _drive(ray_tpu, jcol, lambda a: a)
    got = _drive(ray_tpu_torch, tcol, torch.from_numpy)
    assert got == want
    assert got["sum"] == [[6.0] * 4] * 3
    assert got["gather"] == [[[0], [1], [2]]] * 3
    assert got["ring"] == [[[20], 0], [[0], 1], [[10], 2]]


def test_collective_stays_on_the_tensor_device(runtimes):
    """A contribution keeps its device and dtype through the store; a
    rank that never joined, a group that does not exist and a world size
    that disagrees raise as the reference's do."""
    w = _worker_class(ray_tpu_torch, tcol, torch.from_numpy)
    workers = [w.remote(i) for i in range(2)]
    tcol.create_collective_group(workers, world_size=2, ranks=[0, 1],
                                 group_name="g2")
    outs = ray_tpu_torch.get([x.reduce.remote("g2") for x in workers],
                             timeout=T)
    assert all(o.dtype == torch.float32 and o.device.type == "cpu"
               for o in outs)
    with pytest.raises(RuntimeError, match="has not joined"):
        tcol.allreduce(torch.ones(2), group_name="g2")
    with pytest.raises(ValueError, match="world_size"):
        tcol.init_collective_group(3, 0, group_name="g2")
    tcol.destroy_collective_group("g2")
    with pytest.raises(RuntimeError, match="no collective group"):
        tcol.get_collective_group_size("g2")
    tcol.init_collective_group(2, 0, group_name="g3")
    try:
        with pytest.raises(TimeoutError, match="1/2 ranks"):
            tcol.allreduce(torch.ones(2), group_name="g3", timeout=0.05)
    finally:
        tcol.destroy_collective_group("g3")


def test_resource_verbs_match_reference(runtimes):
    assert (ray_tpu_torch.cluster_resources()
            == ray_tpu.cluster_resources() == {"CPU": 4.0})
    assert (ray_tpu_torch.available_resources()
            == ray_tpu.available_resources())

    @ray_tpu_torch.remote(num_cpus=3)
    def held(ready, release):
        ready.set()
        release.wait(T)
        return ray_tpu_torch.available_resources()

    import threading

    ready, release = threading.Event(), threading.Event()
    ref = held.remote(ready, release)
    assert ready.wait(T)
    during = ray_tpu_torch.available_resources()
    release.set()
    assert ray_tpu_torch.get(ref, timeout=T) == during == {"CPU": 1.0}
    assert ray_tpu_torch.cluster_resources() == {"CPU": 4.0}
