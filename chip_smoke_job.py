"""The job driver of ``chip_smoke.py``'s phase 22, and the trainer and
feed entry points it ships: a module that imports no torch, so a
submitted job attaches and makes its demand within a second of its start
(``import torch`` alone takes ~10 s on the H100 machine's host). The
trainer and the feed task run on the nodes the autoscaler launches,
where ``chip_smoke`` (and torch) are imported.

Run it as a job's entrypoint: ``python -c "import sys, chip_smoke_job;
sys.exit(chip_smoke_job.main(sys.argv[1]))" SPEC`` (``chip_smoke.
_elastic_submit``). ``SPEC`` is JSON: the head's ``address``, the
trainer's ``actor`` name, the model ``cfg`` fields, its ``dev``, ``card``
(a custom resource in place of ``num_gpus=1``) and ``params`` (a
``torch.save``d tree in place of seed 0's), the feed tasks' ``tag``,
``steps``, ``batch``, ``length``, the bound ``poll_s`` on every wait, and
the optional KV keys ``go`` and ``hold``.
"""

import json
import os
import time
import traceback


class ElasticTrainer:
    """The trainer actor: ``chip_smoke._ElasticTrainer``, built on the
    node that hosts it."""

    def __init__(self, cfg_fields, dev, params_path=None):
        import chip_smoke

        self._impl = chip_smoke._elastic_trainer(cfg_fields, dev,
                                                 params_path)

    def reset(self):
        return self._impl.reset()

    def step(self, fed):
        return self._impl.step(fed)

    def report(self):
        return self._impl.report()


def feed(i, vocab, batch, length):
    """The feed task: ``chip_smoke._elastic_feed`` on a feed node."""
    import chip_smoke

    return chip_smoke._elastic_feed(i, vocab, batch, length)


def main(spec_json: str) -> int:
    """Attach to spec["address"] with no CPU and no GPU (with spec["go"],
    make no demand until that KV key exists), submit spec["steps"] feed
    tasks (resources {"feed": 1}, env var FEED_TAG under a runtime_env;
    their shapes park), then create the named trainer, retrying while no
    node can place it, and pass each feed task's ref straight into
    ``trainer.step.remote``, in order.
    Print ``ELASTIC_JOB <json>`` (losses, the trainer's report, wall
    times), wait for the KV key spec["hold"] when one is given, kill the
    trainer and return 0, or 1 when anything failed."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.exceptions import PlacementInfeasibleError

    spec = json.loads(spec_json)
    out = {"pid": os.getpid(), "cwd": os.getcwd(),
           "job_tag": os.environ.get("ELASTIC_JOB_TAG"),
           "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES")}
    w = rt.init(num_cpus=0, num_gpus=0, address=spec["address"])
    out["attached_wall"] = time.time()
    trainer = None
    poll = spec["poll_s"]
    try:
        if spec.get("go"):
            deadline = time.monotonic() + poll
            while w.kv_get(spec["go"].encode()) is None:
                if time.monotonic() > deadline:
                    raise TimeoutError("no go key")
                time.sleep(0.05)
        out["go_wall"] = time.time()
        fed = rt.remote(feed)

        def feed_ref(i):
            return fed.options(
                resources={"feed": 1},
                runtime_env={"env_vars": {
                    "FEED_TAG": f"{spec['tag']}-{i}"}}).remote(
                i, spec["cfg"]["vocab_size"], spec["batch"],
                spec["length"])

        # Every batch's task at once: with no feed node yet they park,
        # and their shapes reach the autoscaler with the trainer's.
        refs = [feed_ref(i) for i in range(spec["steps"])]
        opts = {"name": spec["actor"]}
        if spec.get("card"):
            opts["resources"] = {spec["card"]: 1}
        else:
            opts["num_gpus"] = 1
        cls = rt.remote(ElasticTrainer).options(**opts)
        deadline = time.monotonic() + poll
        while True:
            try:
                trainer = cls.remote(spec["cfg"], spec["dev"],
                                     spec.get("params"))
                break
            except PlacementInfeasibleError:
                # No node can host it yet: the ask is advertised to the
                # autoscaler, which launches one.
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)
        out["placed_wall"] = time.time()
        calls = [trainer.step.remote(ref) for ref in refs]
        losses = [rt.get(calls[0], timeout=poll)]
        out["first_step_wall"] = time.time()
        out["losses"] = losses + rt.get(calls[1:], timeout=poll)
        out["report"] = rt.get(trainer.report.remote(), timeout=poll)
    except BaseException:  # noqa: BLE001 — reported in the job's log
        out["error"] = traceback.format_exc()
    print("ELASTIC_JOB " + json.dumps(out), flush=True)
    try:
        if spec.get("hold") and "error" not in out:
            deadline = time.monotonic() + poll
            while (w.kv_get(spec["hold"].encode()) is None
                   and time.monotonic() < deadline):
                time.sleep(0.05)
        if trainer is not None:
            rt.kill(trainer)
    finally:
        rt.shutdown()
    return 0 if "error" not in out else 1
