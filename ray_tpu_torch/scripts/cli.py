"""The operator's command line (counterpart of ``ray_tpu/scripts/cli.py``;
argparse, no click).

Usage: ``python -m ray_tpu_torch.scripts.cli <command> [...]``

- ``status``, ``list {tasks,actors,objects,placement-groups}``,
  ``timeline``: this process's runtime (a fresh local one when none runs).
- ``job submit <entrypoint...>``: run a shell command as a job driver
  (``job_submission.JobSubmissionClient``), stream its log, exit with its
  outcome.
- ``start --head [--port P] [--state PATH] [--standby-of H:P]
  [--metrics-port M]``: serve the control plane; it prints the head
  service's own first line, ``ray_tpu_torch head listening on
  HOST:PORT``. ``start --address H:P [--num-cpus N] [--resources JSON]
  [--worker-mode thread|process]``: join this machine as a node daemon;
  it prints the daemon's own ``ray_tpu_torch node <id> joined H:P as
  <client>``. Either line is read the same way as the
  modules' own ``main``'s (the autoscaler's provider, the tests).
- ``autoscale --address H:P --config FILE``: run a ``ClusterAutoscaler``
  against a head. The config is JSON: ``{"node_types": [{"name",
  "resources", "min_workers", "max_workers"}], "idle_timeout_s": 5.0,
  "update_interval_s": 1.0, "worker_mode": "thread"}``.
- ``logs [FILE] [--session DIR]``: list or print worker log files.
- ``debug [--address H:P] [--output DIR]``: one archive of every live
  process's flight bundle (this process's, the head's, each node
  daemon's), with its manifest.
- ``version``.

Left out: the reference's ``microbenchmark``, which runs the reference's
``bench.py``; it waits for the port's own benchmark.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def cmd_status(args):
    import ray_tpu_torch as rt
    from ray_tpu_torch.util.state import (
        summarize_actors,
        summarize_objects,
        summarize_tasks,
    )

    rt.init(ignore_reinit_error=True)
    print(json.dumps({
        "cluster_resources": rt.cluster_resources(),
        "available_resources": rt.available_resources(),
        "tasks": summarize_tasks(),
        "actors": summarize_actors(),
        "objects": summarize_objects(),
    }, indent=2))


def cmd_list(args):
    import ray_tpu_torch as rt
    from ray_tpu_torch.util import state

    rt.init(ignore_reinit_error=True)
    fn = {
        "tasks": state.list_tasks,
        "actors": state.list_actors,
        "objects": state.list_objects,
        "placement-groups": state.list_placement_groups,
    }[args.resource]
    for r in fn(limit=args.limit):
        print(json.dumps(r.__dict__ if hasattr(r, "__dict__") else r,
                         default=str))


def cmd_timeline(args):
    import ray_tpu_torch as rt
    from ray_tpu_torch.util.state import get_timeline

    rt.init(ignore_reinit_error=True)
    trace = get_timeline()
    with open(args.output, "w") as f:
        json.dump(trace, f)
    print(f"wrote {len(trace)} events to {args.output}")


def cmd_job(args):
    from ray_tpu_torch.job_submission import JobSubmissionClient

    client = JobSubmissionClient()
    if args.job_cmd == "submit":
        job_id = client.submit_job(entrypoint=" ".join(args.entrypoint))
        print(job_id, flush=True)
        for chunk in client.tail_job_logs(job_id):
            sys.stdout.write(chunk)
            sys.stdout.flush()
        info = client.get_job_info(job_id)
        print(f"job {job_id}: {info.status}")
        raise SystemExit(0 if info.return_code == 0 else 1)
    raise SystemExit(f"unknown job command {args.job_cmd!r}")


def cmd_start(args):
    """Run a cluster role: ``--head`` serves the control plane (its state
    log defaults to ``<token dir>/head_state_<port>.log``);
    ``--address`` joins this machine as a node daemon. Each runs the
    module's own ``main``, so each prints that main's lines."""
    if args.head:
        from ray_tpu_torch._private import head_service
        from ray_tpu_torch._private.transport import token_dir

        if args.standby_of and not args.state:
            # The per-port default would give the standby its own empty
            # log: promotion would serve empty state, not fail over.
            raise SystemExit(
                "--standby-of needs an explicit --state (the SAME log "
                "file the primary serves) and the cluster token in "
                "RAY_TPU_CLUSTER_TOKEN")
        state = args.state or os.path.join(
            token_dir(), f"head_state_{args.port}.log")
        argv = ["--host", args.host, "--port", str(args.port),
                "--state", state,
                "--metrics-port", str(args.metrics_port)]
        if args.standby_of:
            argv += ["--standby-of", args.standby_of]
        try:
            raise SystemExit(head_service.main(argv))
        except KeyboardInterrupt:
            return
    if args.address:
        from ray_tpu_torch._private import node_daemon

        argv = ["--address", args.address, "--num-cpus",
                str(args.num_cpus), "--resources", args.resources]
        if args.worker_mode:
            argv += ["--worker-mode", args.worker_mode]
        raise SystemExit(node_daemon.main(argv))
    raise SystemExit("pass --head to serve the control plane or "
                     "--address=host:port to join as a node")


def cmd_autoscale(args):
    """Run the cluster autoscaler against a head until interrupted (the
    config file: module docstring)."""
    import threading

    from ray_tpu_torch.autoscaler import (
        ClusterAutoscaler,
        LocalSubprocessProvider,
        NodeTypeConfig,
    )

    with open(args.config) as f:
        cfg = json.load(f)
    types = [NodeTypeConfig(
        name=t["name"], resources=dict(t["resources"]),
        min_workers=int(t.get("min_workers", 0)),
        max_workers=int(t.get("max_workers", 10)))
        for t in cfg["node_types"]]
    scaler = ClusterAutoscaler(
        args.address, types,
        provider=LocalSubprocessProvider(
            args.address, worker_mode=cfg.get("worker_mode")),
        idle_timeout_s=float(cfg.get("idle_timeout_s", 5.0)),
        update_interval_s=float(cfg.get("update_interval_s", 1.0)))
    print(f"ray_tpu_torch autoscaler managing {len(types)} node type(s) "
          f"against {args.address}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        scaler.shutdown()


def cmd_logs(args):
    """List or print the worker log files of a session."""
    from ray_tpu_torch._private.log_monitor import (
        latest_session_dir,
        list_log_files,
    )

    session = args.session or latest_session_dir()
    log_dir = os.path.join(session, "logs")
    if args.filename:
        with open(os.path.join(log_dir, args.filename), "r",
                  errors="replace") as f:
            print(f.read(), end="")
        return
    print(f"session: {session}")
    for fname in list_log_files(log_dir):
        size = os.path.getsize(os.path.join(log_dir, fname))
        print(f"  {fname}  ({size} bytes)")


def cmd_debug(args):
    """Pull every live process's flight bundle into one archive. The
    processes dumped need the flight recorder armed (RAY_TPU_FLIGHT=1);
    this process arms itself, so its own bundle is always there."""
    os.environ.setdefault("RAY_TPU_FLIGHT", "1")
    import ray_tpu_torch as rt

    kwargs = {"ignore_reinit_error": True}
    if args.address:
        kwargs.update(num_cpus=0, num_gpus=0, address=args.address)
    ours = not rt.is_initialized()
    rt.init(**kwargs)
    try:
        incident = rt.debug_dump(args.output)
    finally:
        if ours:   # a runtime this command started
            rt.shutdown()
    manifest = {}
    try:
        with open(os.path.join(incident, "manifest.json")) as f:
            manifest = json.load(f)
    except OSError:
        pass
    print(json.dumps({
        "incident_dir": incident,
        "num_processes": manifest.get("num_processes", 0),
        "sources": sorted(manifest.get("sources", {})),
    }, indent=2))


def cmd_version(args):
    import ray_tpu_torch

    print(ray_tpu_torch.__version__)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ray-tpu-torch")
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("status").set_defaults(fn=cmd_status)
    p = sub.add_parser("list")
    p.add_argument("resource", choices=[
        "tasks", "actors", "objects", "placement-groups"])
    p.add_argument("--limit", type=int, default=100)
    p.set_defaults(fn=cmd_list)
    p = sub.add_parser("timeline")
    p.add_argument("--output", default="timeline.json")
    p.set_defaults(fn=cmd_timeline)
    p = sub.add_parser("job")
    p.add_argument("job_cmd", choices=["submit"])
    p.add_argument("entrypoint", nargs=argparse.REMAINDER)
    p.set_defaults(fn=cmd_job)
    p = sub.add_parser("start")
    p.add_argument("--head", action="store_true")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=6380)
    p.add_argument("--state", default=None,
                   help="head state log path (--head only)")
    p.add_argument("--standby-of", default=None, metavar="HOST:PORT",
                   help="run --head as a warm standby: serve only "
                        "after this primary (sharing --state and the "
                        "cluster token) stops answering")
    p.add_argument("--metrics-port", type=int, default=-1,
                   help="with --head: the cluster /metrics scrape "
                        "(0 = any free port, -1 = off)")
    p.add_argument("--address", default=None, help="join head as a node")
    p.add_argument("--num-cpus", type=int, default=2)
    p.add_argument("--resources", default="{}")
    p.add_argument("--worker-mode", default=None,
                   choices=("process", "thread"))
    p.set_defaults(fn=cmd_start)
    p = sub.add_parser("autoscale")
    p.add_argument("--address", required=True, help="head host:port")
    p.add_argument("--config", required=True,
                   help="JSON autoscaling config (node_types)")
    p.set_defaults(fn=cmd_autoscale)
    p = sub.add_parser("logs")
    p.add_argument("filename", nargs="?", default=None)
    p.add_argument("--session", default=None)
    p.set_defaults(fn=cmd_logs)
    p = sub.add_parser("debug")
    p.add_argument("--address", default=None,
                   help="head host:port (omit for a local runtime)")
    p.add_argument("--output", default=None,
                   help="archive root (default <tmp>/ray_tpu_torch/"
                        "debug_dumps)")
    p.set_defaults(fn=cmd_debug)
    sub.add_parser("version").set_defaults(fn=cmd_version)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
