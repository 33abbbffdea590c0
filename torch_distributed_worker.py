"""One process of a multi-process run of ``ray_tpu_torch``, for
``chip_smoke.py``'s phase 23 (the flagship, gloo on one card or NCCL a
card each), ``tests/test_torch_distributed.py`` (gloo, CPU shards) and
``tests/test_torch_multi_gpu.py`` (NCCL, a card or two per process).

Run as ``python torch_distributed_worker.py SPEC.json`` (``start`` does).
It imports no JAX: the caller computes any reference and passes arrays
through ``spec["in"]`` (an ``.npz``); this process joins the process
group through ``parallel.distributed.initialize`` (its address, size and
rank from the ``RAY_TPU_*`` environment variables), runs ``spec["jobs"]``
in order and writes what each job read into ``spec["out"]`` (an
``.npz``), with ``jax_imported`` and ``ray_tpu_imported`` last.
``start`` (or ``launch``) starts such processes and reads their outputs.

Jobs (``kind``):

- ``step``: ``make_spmd_train_step`` (``cfg``, f32 unless ``cfg`` names
  a ``dtype``) on ``make_mesh(**mesh)`` over the tree ``<params>/<path>``
  of the input (``params`` names the prefix, default ``params``; or
  ``init_params(cfg, init_seed)``), ``steps`` steps of SGD, AdamW or the
  step's default optimizer (``"default"``) on this process's rows
  (``host_local_batch_slice(..., mesh=mesh)``: the rows of the
  (dp, fsdp) blocks its shards hold) of ``tokens[i]`` and
  ``targets[i]``; writes the losses, the seconds of each step (host
  clock, the devices synchronised), the seconds the step took to build,
  this process's flat indices and every local shard's every leaf. With
  ``counts``, also ``chip_smoke``'s kernel launch counts of the steps
  alone (zeroed just before them), as JSON.
- ``allreduce``: ``iters`` timed all-reduces (after two untimed) of
  ``elements`` of ``dtype`` (f32 unless named) over the whole group on
  the first device; writes the seconds of each and whether the result
  is exact.
- ``collectives``: each op of ``OPS`` over this process's blocks of the
  input ``x`` (cut into one block per shard), then the gradient of
  sum(w * out) with ``w`` the input's ``w/<name>/<op>``; writes each
  local shard's output and gradient.
- ``attention``: ring attention or Ulysses (``op``) over ``sp`` of
  ``make_mesh(**mesh)`` on this process's sequence blocks of the input's
  ``attn_<name>/q``, ``/k`` and ``/v`` ([B, H, S, D], cut along S by each
  shard's sp index), then the gradient of sum(w * out) with ``w`` the
  input's ``attn_<name>/w``; writes each local shard's output and the
  gradients of its q, k and v.
- ``hybrid``: ``make_hybrid_mesh(dcn <dcn> 2, ici tp n)`` (``dcn`` dp or
  pp) with a sum over each tier of ``x``'s blocks; given ``cfg``, what
  building the training step on that mesh raised (ROADMAP C.16).
- ``mesh``: ``make_mesh(**mesh)``; writes its owners (``processes``),
  this process's flat indices and whether it spans processes.
- ``pipeline``: ``pipeline_spmd`` of ``pipeline_stage`` on
  ``make_mesh(**mesh)``, and its gradients (``_pipeline``); the process
  ``die_in`` names exits at its first stage call.
- ``hop``: timed hops of one activation across processes (``_hop``).
- ``refusals``: each hybrid mesh that may not be built; writes the type
  and message of what each raised ("" if nothing).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from ray_tpu_torch import collective as tops
from ray_tpu_torch.models import (
    TransformerConfig,
    init_params,
    make_spmd_train_step,
)
from ray_tpu_torch.parallel import (
    HybridMeshConfig,
    MeshConfig,
    distributed,
    make_hybrid_mesh,
    make_mesh,
    pipeline_spmd,
    ring_attention,
    ulysses_attention,
)

OPS = {
    "allreduce_dp": lambda xs, m: tops.allreduce(xs, m, "dp"),
    "allreduce_dp_tp_mean": lambda xs, m: tops.allreduce(
        xs, m, ("dp", "tp"), op="mean"),
    "allreduce_dp_max": lambda xs, m: tops.allreduce(xs, m, "dp", op="max"),
    "allgather_dp": lambda xs, m: tops.allgather(xs, m, "dp"),
    "allgather_dp_tp_stacked": lambda xs, m: tops.allgather(
        xs, m, ("dp", "tp"), tiled=False),
    "reducescatter_dp": lambda xs, m: tops.reducescatter(xs, m, "dp"),
    # Root 1, or 0 on a mesh whose dp has one shard.
    "broadcast_dp_root1": lambda xs, m: tops.broadcast(
        xs, m, "dp", root=min(1, m.shape["dp"] - 1)),
    "allreduce_tp": lambda xs, m: tops.allreduce(xs, m, "tp"),
    "permute_tp": lambda xs, m: tops.permute(
        xs, m, "tp", [(j, (j + 1) % m.shape["tp"])
                      for j in range(m.shape["tp"])]),
}
# The exchanges, over dp, pp and sp, each of which may cross processes:
# the ring, a send from the axis's first shard to its last, and the
# all-to-all (tiled; over pp also untiled, each block cut into as many
# rows as the axis has shards).
for _a in ("dp", "pp", "sp"):
    OPS.update({
        f"permute_{_a}": lambda xs, m, a=_a: tops.permute(
            xs, m, a, [(j, (j + 1) % m.shape[a])
                       for j in range(m.shape[a])]),
        f"send_recv_{_a}": lambda xs, m, a=_a: tops.send_recv(
            xs, m, a, 0, m.shape[a] - 1),
        f"all_to_all_{_a}": lambda xs, m, a=_a: tops.all_to_all(
            xs, m, a, 0, 1),
    })
OPS["all_to_all_pp_untiled"] = lambda xs, m: tops.all_to_all(
    [x.reshape(m.shape["pp"], -1) for x in xs], m, "pp", 0, 0, tiled=False)


def pipeline_stage(stage, sub_mesh, ws, acts):
    """The pipeline job's stage: one matmul and a tanh on each shard."""
    return [torch.tanh(a @ w) for w, a in zip(ws, acts)]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flat(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def _tree(arrays, prefix):
    """The nested dict of the input's ``prefix/<a.b.c>`` leaves."""
    out: dict = {}
    for key in arrays.files:
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(arrays[key]))
    return out


def _sync(devices):
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _step(job, arrays, devices, out):
    name = job["name"]
    fields = dict(job["cfg"])
    fields["dtype"] = getattr(torch, fields.get("dtype", "float32"))
    cfg = TransformerConfig(**fields)
    mesh = make_mesh(MeshConfig(**job["mesh"]), devices=devices)
    t0 = time.perf_counter()
    params = (_tree(arrays, job.get("params", "params"))
              if "init_seed" not in job
              else init_params(cfg, job["init_seed"], device="cpu"))
    if job["optimizer"] == "sgd":
        make_opt = lambda ls: torch.optim.SGD(ls, lr=job["lr"])  # noqa: E731
    elif job["optimizer"] == "adamw":
        make_opt = lambda ls: torch.optim.AdamW(  # noqa: E731
            ls, lr=job["lr"], betas=(0.9, 0.999), eps=1e-8,
            weight_decay=1e-4)
    else:
        make_opt = None
    step, _, shards = make_spmd_train_step(
        cfg, mesh, params, optimizer=make_opt,
        n_microbatches=job.get("microbatches", 1))
    build_s = time.perf_counter() - t0
    tokens = torch.from_numpy(np.array(arrays["tokens"]))
    targets = torch.from_numpy(np.array(arrays["targets"]))
    start, size = distributed.host_local_batch_slice(tokens.shape[1],
                                                     mesh=mesh)
    if job.get("counts"):
        import chip_smoke

        chip_smoke._zero_counts()
    losses, seconds = [], []
    for i in range(job["steps"]):
        t0 = time.perf_counter()
        loss = step(tokens[i, start:start + size],
                    targets[i, start:start + size]).item()
        _sync(mesh.local_devices)
        seconds.append(time.perf_counter() - t0)
        losses.append(loss)
    if job.get("counts"):
        out[f"{name}/counts"] = np.array(json.dumps(chip_smoke._counts()))
    out[f"{name}/losses"] = np.array(losses)
    out[f"{name}/seconds"] = np.array(seconds)
    out[f"{name}/build_s"] = np.array(build_s)
    out[f"{name}/local_indices"] = np.array(mesh.local_indices)
    for j, tree in zip(mesh.local_indices, shards):
        for path, leaf in _flat(tree):
            out[f"{name}/{j}/{path}"] = leaf.detach().cpu().numpy()


def _allreduce(job, arrays, devices, out):
    x = torch.ones(job["elements"],
                   dtype=getattr(torch, job.get("dtype", "float32")),
                   device=devices[0])
    seconds = []
    for i in range(job["iters"] + 2):
        _sync(devices[:1])
        t0 = time.perf_counter()
        torch.distributed.all_reduce(x)
        _sync(devices[:1])
        if i >= 2:
            seconds.append(time.perf_counter() - t0)
    want = float(distributed.process_count()) ** (job["iters"] + 2)
    out["allreduce/seconds"] = np.array(seconds)
    out["allreduce/exact"] = np.array(bool((x.float() == want).all()))


def _collectives(job, arrays, devices, out):
    name = job["name"]
    mesh = make_mesh(MeshConfig(**job["mesh"]), devices=devices)
    blocks = np.split(np.array(arrays["x"]), mesh.size)
    for op in job["ops"]:
        xs = [torch.tensor(blocks[j], device=d, requires_grad=True)
              for j, d in zip(mesh.local_indices, mesh.local_devices)]
        outs = OPS[op](xs, mesh)
        ws = np.array(arrays[f"w/{name}/{op}"])
        sum(torch.sum(o * torch.from_numpy(ws[j]).to(o.device)).to(
            devices[0]) for j, o in zip(mesh.local_indices, outs)).backward()
        for j, o, x in zip(mesh.local_indices, outs, xs):
            out[f"{name}/{op}/out/{j}"] = o.detach().cpu().numpy()
            out[f"{name}/{op}/grad/{j}"] = (
                np.zeros(x.shape, np.float32) if x.grad is None
                else x.grad.cpu().numpy())


def _attention(job, arrays, devices, out):
    name, op = job["name"], job["op"]
    mesh = make_mesh(MeshConfig(**job["mesh"]), devices=devices)
    n = mesh.shape["sp"]
    q, k, v, w = (np.split(np.array(arrays[f"attn_{name}/{t}"]), n, axis=2)
                  for t in "qkvw")
    local = list(zip(tops.axis_indices(mesh, "sp"), mesh.local_devices))
    qs, ks, vs = ([torch.tensor(a[i], device=d, requires_grad=True)
                   for i, d in local] for a in (q, k, v))
    fn = ring_attention if op == "ring" else ulysses_attention
    outs = fn(qs, ks, vs, mesh=mesh, axis_name="sp", causal=True)
    sum(torch.sum(o * torch.from_numpy(w[i]).to(o.device)).to(devices[0])
        for (i, _), o in zip(local, outs)).backward()
    for j, o, *ts in zip(mesh.local_indices, outs, qs, ks, vs):
        out[f"{name}/out/{j}"] = o.detach().cpu().numpy()
        for t, g in zip("qkv", ts):
            out[f"{name}/grad_{t}/{j}"] = g.grad.cpu().numpy()


def _hybrid(job, arrays, devices, out):
    axis = job.get("dcn", "dp")
    name = job.get("name", "hybrid")
    mesh = make_hybrid_mesh(HybridMeshConfig(dcn={axis: 2},
                                             ici={"tp": len(devices)}),
                            devices=devices)
    blocks = np.split(np.array(arrays["x"]), mesh.size)
    xs = [torch.tensor(blocks[j], device=d)
          for j, d in zip(mesh.local_indices, mesh.local_devices)]
    got = tops.allreduce(tops.allreduce(xs, mesh, "tp"), mesh, axis)
    out[f"{name}/axis_names"] = np.array(mesh.axis_names)
    out[f"{name}/processes"] = mesh.processes
    for j, g in zip(mesh.local_indices, got):
        out[f"{name}/{j}"] = g.cpu().numpy()
    if "cfg" in job:
        cfg = TransformerConfig(**job["cfg"], dtype=torch.float32)
        out[f"{name}/step_raised"] = np.array(_raised(
            lambda: make_spmd_train_step(
                cfg, mesh, init_params(cfg, 0, device="cpu"))))


def _pipeline(job, arrays, devices, out):
    """``pipeline_spmd`` alone: each local shard's weight ``pipe/w[j]``
    and microbatches ``pipe/x[j]`` ([M, ...]); the gradient of
    sum(pipe/c * out) with respect to both."""
    name = job["name"]
    mesh = make_mesh(MeshConfig(**job["mesh"]), devices=devices)
    local = list(zip(mesh.local_indices, mesh.local_devices))
    w, x, c = (np.array(arrays[f"pipe/{k}"]) for k in "wxc")
    ws = [torch.tensor(w[j], device=d, requires_grad=True) for j, d in local]
    xs = [torch.tensor(x[j], device=d, requires_grad=True) for j, d in local]
    stage_fn = pipeline_stage
    if job.get("die_in") == distributed.process_index():
        def stage_fn(stage, sub_mesh, ws, acts):
            os._exit(3)          # this process dies mid-pipeline
    outs = pipeline_spmd(stage_fn, ws, xs, mesh=mesh)
    sum(torch.sum(o * torch.from_numpy(c[j]).to(o.device))
        for (j, _), o in zip(local, outs)).backward()
    for (j, _), o, wj, xj in zip(local, outs, ws, xs):
        out[f"{name}/out/{j}"] = o.detach().cpu().numpy()
        for key, t in (("grad_w", wj), ("grad_x", xj)):
            out[f"{name}/{key}/{j}"] = (
                np.zeros(t.shape, np.float32) if t.grad is None
                else t.grad.cpu().numpy())


def _hop(job, arrays, devices, out):
    """``iters`` timed hops (after two untimed) of one ``shape`` tensor of
    ``dtype`` from the first shard of process 0 to the first of process
    1, through the pipeline's exchange (``collective.ops.route``) on
    ``make_mesh(pp=processes)``; each process writes the seconds of each
    hop (host clock, its device synchronised) and the receiver whether
    the value arrived."""
    from ray_tpu_torch.collective import ops as cops

    mesh = make_mesh(MeshConfig(pp=distributed.process_count()),
                     devices=devices[:1])
    dev = mesh.local_devices[0]
    x = torch.full(job["shape"], 1.5, dtype=getattr(torch, job["dtype"]),
                   device=dev)
    pairs = [(0, 1)]
    seconds, arrived = [], True
    for i in range(job["iters"] + 2):
        _sync([dev])
        t0 = time.perf_counter()
        got = cops.route(mesh, pairs, {mesh.local_indices[0]: [x]},
                         {mesh.local_indices[0]: [cops.like(x)]})
        _sync([dev])
        if i >= 2:
            seconds.append(time.perf_counter() - t0)
        for _, (v,) in got:
            arrived = arrived and bool((v == x).all())
    out["hop/seconds"] = np.array(seconds)
    out["hop/arrived"] = np.array(arrived)
    out["hop/bytes"] = np.array(x.numel() * x.element_size())


def _raised(fn) -> str:
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — the test reads what
        return f"{type(exc).__name__}: {exc}"
    return ""


def _mesh(job, arrays, devices, out):
    mesh = make_mesh(MeshConfig(**job["mesh"]), devices=devices)
    out[f"{job['name']}/processes"] = mesh.processes
    out[f"{job['name']}/local_indices"] = np.array(mesh.local_indices)
    out[f"{job['name']}/spans_processes"] = np.array(mesh.spans_processes)


def _refusals(job, arrays, devices, out):
    n = len(devices) * distributed.process_count()
    cases = {
        "hybrid_dcn_size": lambda: make_hybrid_mesh(HybridMeshConfig(
            dcn={"dp": n}, ici={"tp": 1}), devices=devices),
        "hybrid_tp_dcn": lambda: make_hybrid_mesh(HybridMeshConfig(
            dcn={"tp": 2}, ici={"dp": n // 2}), devices=devices),
    }
    for name, fn in cases.items():
        out[f"refusals/{name}"] = np.array(_raised(fn))


JOBS = {"step": _step, "allreduce": _allreduce,
        "collectives": _collectives, "attention": _attention,
        "hybrid": _hybrid, "mesh": _mesh, "pipeline": _pipeline,
        "hop": _hop, "refusals": _refusals}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Workers:
    """Worker processes started by ``start``: ``join`` waits for them
    (bounded) and returns each one's outputs by process index; ``kill``
    ends any still running. ``join`` kills them too on the way out."""

    def __init__(self, procs, logs, tmp_dir, timeout_s):
        self.procs, self.logs = procs, logs
        self.tmp_dir, self.timeout_s = tmp_dir, timeout_s
        self.deadline = time.monotonic() + timeout_s

    def kill(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)

    def join(self):
        texts = []
        try:
            for proc in self.procs:
                proc.wait(timeout=max(self.deadline - time.monotonic(), 1.0))
        finally:
            self.kill()
            for log in self.logs:
                log.seek(0)
                texts.append(log.read())
                log.close()
        if any(proc.returncode for proc in self.procs):
            raise AssertionError(
                f"worker exit codes {[p.returncode for p in self.procs]}:\n"
                + "\n".join(t[-4000:] for t in texts))
        return [dict(np.load(os.path.join(self.tmp_dir, f"out{p}.npz")))
                for p in range(len(self.procs))]


def start(jobs, tmp_dir, *, processes=2, backend="gloo", devices=None,
          local_device_ids=None, arrays=None, timeout_s=120.0) -> Workers:
    """Start ``processes`` worker processes running ``jobs`` (``devices``:
    each one's device names; ``local_device_ids``: each one's list of
    cards), meeting over a TCP store on a free port; ``timeout_s``
    bounds every wait."""
    root = os.path.dirname(os.path.abspath(__file__))
    tmp_dir = str(tmp_dir)
    in_path = os.path.join(tmp_dir, "in.npz") if arrays is not None else None
    if in_path:
        np.savez(in_path, **arrays)
    port = _free_port()
    procs, logs = [], []
    workers = Workers(procs, logs, tmp_dir, timeout_s)
    try:
        for p in range(processes):
            spec = {"backend": backend, "devices": devices,
                    "local_device_ids": (None if local_device_ids is None
                                         else local_device_ids[p]),
                    "jobs": jobs, "in": in_path,
                    "out": os.path.join(tmp_dir, f"out{p}.npz")}
            spec_path = os.path.join(tmp_dir, f"spec{p}.json")
            with open(spec_path, "w") as fh:
                json.dump(spec, fh)
            env = dict(os.environ,
                       RAY_TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       RAY_TPU_NUM_PROCESSES=str(processes),
                       RAY_TPU_PROCESS_ID=str(p), OMP_NUM_THREADS="1",
                       PYTHONPATH=os.pathsep.join(
                           [root] + [e for e in [os.environ.get(
                               "PYTHONPATH")] if e]))
            if devices is not None and all(d == "cpu" for d in devices):
                env["CUDA_VISIBLE_DEVICES"] = ""
            logs.append(open(os.path.join(tmp_dir, f"log{p}.txt"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), spec_path],
                stdout=logs[-1], stderr=subprocess.STDOUT, env=env))
    except BaseException:
        workers.kill()
        raise
    return workers


def launch(jobs, tmp_dir, **kw):
    """``start`` the workers and ``join`` them."""
    return start(jobs, tmp_dir, **kw).join()


def main(spec_path: str) -> int:
    with open(spec_path) as fh:
        spec = json.load(fh)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(local_device_ids=spec.get("local_device_ids"),
                           backend=spec["backend"])
    out = {"process_index": np.array(distributed.process_index()),
           "process_count": np.array(distributed.process_count())}
    try:
        devices = ([torch.device(d) for d in spec["devices"]]
                   if spec.get("devices") else distributed.local_devices())
        out["devices"] = np.array([str(d) for d in devices])
        arrays = np.load(spec["in"]) if spec.get("in") else None
        for job in spec["jobs"]:
            JOBS[job["kind"]](job, arrays, devices, out)
    finally:
        distributed.shutdown()
    out["jax_imported"] = np.array("jax" in sys.modules)
    out["ray_tpu_imported"] = np.array("ray_tpu" in sys.modules)
    np.savez(spec["out"], **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
