"""Twins of the operator's command line and its neighbours:
``tests/test_platform.py``'s job lifecycle and ``status``/``list`` cases,
``tests/test_logs.py``'s ``logs`` case and ``tests/test_dashboard.py``,
the reference's (``ray_tpu.scripts.cli``, ``ray_tpu.job_submission``,
``ray_tpu.dashboard``) beside the port's (``ray_tpu_torch.scripts.cli``,
``ray_tpu_torch.job_submission``, ``ray_tpu_torch.dashboard``).

Each twin is a function of a side and runs once per side; the values and
the error type names must be equal. Each side runs in a runtime of its
own, shut down in a ``finally``; every wait is bounded. The port's own
cases: ``start --head`` and ``start --address`` print the same lines as
the head's and the daemon's own ``main``, a task makes a round trip
through that cluster, and ``debug --address`` archives a bundle of the
head and of the node daemon.
"""

import contextlib
import importlib
import io
import json
import os
import subprocess
import sys
import time
import types
import urllib.request

SIDES = ("ray_tpu", "ray_tpu_torch")
T = 60.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the outcome
        return ("err", type(exc).__name__)


def _side(pkg):
    return types.SimpleNamespace(
        pkg=pkg, rt=importlib.import_module(pkg),
        cli=importlib.import_module(f"{pkg}.scripts.cli"),
        jobs=importlib.import_module(f"{pkg}.job_submission"))


def twin(case, init=None):
    out = {}
    for pkg in SIDES:
        side = _side(pkg)
        side.rt.shutdown()
        try:
            if init is not None:
                side.w = side.rt.init(**init)
            out[pkg] = _outcome(lambda: case(side))
        finally:
            side.rt.shutdown()
    assert out["ray_tpu_torch"] == out["ray_tpu"], out
    return out["ray_tpu"]


def _run_cli(side, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        side.cli.main(argv)
    return buf.getvalue()


def _wait_job(client, job_id, jobs):
    deadline = time.monotonic() + T
    while time.monotonic() < deadline:
        if client.get_job_status(job_id) not in (jobs.JobStatus.PENDING,
                                                 jobs.JobStatus.RUNNING):
            break
        time.sleep(0.1)
    return client.get_job_status(job_id)


# ------------------------------------------------ tests/test_platform.py
def test_job_submission_lifecycle():
    def case(side):
        client = side.jobs.JobSubmissionClient()
        good = client.submit_job(
            entrypoint=f"{sys.executable} -c \"print('job ran ok')\"")
        bad = client.submit_job(
            entrypoint=f"{sys.executable} -c \"raise SystemExit(3)\"")
        env = client.submit_job(
            entrypoint=f"{sys.executable} -c \"import os; "
                       f"print(os.environ['GRAFT_JOB_VAR'], os.getcwd())\"",
            runtime_env={"env_vars": {"GRAFT_JOB_VAR": "set"},
                         "working_dir": REPO})
        states = [_wait_job(client, j, side.jobs).value
                  for j in (good, bad, env)]
        return (states, "job ran ok" in client.get_job_logs(good),
                client.get_job_info(bad).return_code,
                client.get_job_logs(env).split(),
                sorted(i.job_id for i in client.list_jobs())
                == sorted([good, bad, env]))

    assert twin(case) == ("ok", (
        ["SUCCEEDED", "FAILED", "SUCCEEDED"], True, 3, ["set", REPO],
        True))


def test_job_stop_and_tail():
    """``stop_job`` ends a running job as STOPPED (reaped), and
    ``tail_job_logs`` yields its log until it ends."""

    def case(side):
        client = side.jobs.JobSubmissionClient()
        job = client.submit_job(
            entrypoint=f"{sys.executable} -u -c \"import time; "
                       f"print('tail-me', flush=True); time.sleep(60)\"")
        deadline = time.monotonic() + T
        while "tail-me" not in client.get_job_logs(job) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        stopped = client.stop_job(job)
        tailed = "".join(client.tail_job_logs(job))
        return (stopped, client.get_job_status(job).value,
                "tail-me" in tailed, client.stop_job(job))

    assert twin(case) == ("ok", (True, "STOPPED", True, False))


def test_cli_status_and_list():
    def case(side):
        @side.rt.remote
        def f():
            return 1

        side.rt.get(f.remote(), timeout=T)
        data = json.loads(_run_cli(side, ["status"]))
        deadline = time.monotonic() + 5
        out = ""
        while time.monotonic() < deadline:
            out = _run_cli(side, ["list", "tasks", "--limit", "5"])
            if "FINISHED" in out:
                break
            time.sleep(0.05)
        return ("cluster_resources" in data and "tasks" in data,
                "FINISHED" in out)

    assert twin(case, {"num_cpus": 4, "worker_mode": "thread"}) == (
        "ok", (True, True))


# ---------------------------------------------------- tests/test_logs.py
def test_logs_cli_lists_and_prints():
    def case(side):
        @side.rt.remote
        def loud():
            print("CLI-VISIBLE-LINE")
            return 1

        side.rt.get(loud.remote(), timeout=T)
        log_dir = os.path.join(side.w.session_dir, "logs")
        target = None
        deadline = time.monotonic() + 10
        while target is None and time.monotonic() < deadline:
            for fname in os.listdir(log_dir):
                with open(os.path.join(log_dir, fname),
                          errors="replace") as f:
                    if "CLI-VISIBLE-LINE" in f.read():
                        target = fname
            time.sleep(0.1)
        listing = _run_cli(side, ["logs", "--session", side.w.session_dir])
        printed = _run_cli(side, ["logs", target, "--session",
                                  side.w.session_dir]) if target else ""
        return "worker-" in listing, target is not None, \
            "CLI-VISIBLE-LINE" in printed

    assert twin(case, {"num_cpus": 2, "worker_mode": "process"}) == (
        "ok", (True, True, True))


# ----------------------------------------------- tests/test_dashboard.py
def test_dashboard_snapshot_and_page(tmp_path):
    def case(side):
        rt = side.rt
        workflow = importlib.import_module(f"{side.pkg}.workflow")
        dashboard = importlib.import_module(f"{side.pkg}.dashboard")

        @rt.remote
        def f(x):
            return x + 1

        @rt.remote
        class A:
            def ping(self):
                return "pong"

        got = rt.get(f.remote(1), timeout=T)
        a = A.options(name="dash_actor").remote()
        pong = rt.get(a.ping.remote(), timeout=T)
        workflow.init(str(tmp_path / side.pkg / "wf"))

        @workflow.step
        def one():
            return 1

        ran = workflow.run(one.bind(), workflow_id="dash_wf")
        dash = dashboard.start_dashboard(port=0)
        try:
            def read(path):
                with urllib.request.urlopen(dash.url + path,
                                            timeout=10) as r:
                    return r.read().decode()

            snap = json.loads(read("/api/snapshot"))
            page = read("/")
            actors_raw = read("/api/actors")
            rows = json.loads(read("/api/workflows"))
            return (got, pong, ran, snap["resources"]["total"]["CPU"],
                    snap["tasks"].get("FINISHED", 0) >= 1,
                    "dash_actor" in snap["actors"]["named"],
                    snap["workers"]["mode"] in ("process", "thread"),
                    f"{side.pkg} dashboard" in page,
                    "dash_actor" in actors_raw or "A" in actors_raw,
                    snap["workflows"]["summary"].get("SUCCESS", 0) >= 1,
                    snap["workflows"]["recent"].get("dash_wf"),
                    any(w["workflow_id"] == "dash_wf"
                        and w["status"] == "SUCCESS" for w in rows))
        finally:
            dashboard.stop_dashboard()

    assert twin(case, {"num_cpus": 4, "worker_mode": "thread"}) == (
        "ok", (2, "pong", 1, 4.0, True, True, True, True, True, True,
               "SUCCESS", True))


def test_dashboard_endpoints_answer():
    """Every endpoint of the module docstring answers 200 with JSON (or
    the page and the Prometheus text) on both sides."""
    paths = ["/api/tasks", "/api/llm", "/api/chaos", "/api/elastic",
             "/api/head", "/api/traces", "/api/debug", "/metrics"]

    def case(side):
        dashboard = importlib.import_module(f"{side.pkg}.dashboard")
        dash = dashboard.start_dashboard(port=0)
        try:
            codes = []
            for path in paths:
                with urllib.request.urlopen(dash.url + path,
                                            timeout=30) as r:
                    body = r.read().decode()
                    if path.startswith("/api/"):
                        json.loads(body)
                    codes.append(r.status)
            elastic = json.loads(urllib.request.urlopen(
                dash.url + "/api/elastic", timeout=10).read())
            return codes, sorted(k for k in elastic if k.startswith(
                ("launch_", "drained_")))
        finally:
            dashboard.stop_dashboard()

    assert twin(case, {"num_cpus": 2, "worker_mode": "thread"}) == (
        "ok", ([200] * len(paths), ["drained_nodes", "launch_attempts",
                                    "launch_errors", "launch_failures"]))


# -------------------------------------------------------- the port's own
def _read_line(proc, bound=T):
    import selectors

    with selectors.DefaultSelector() as sel:
        sel.register(proc.stdout, selectors.EVENT_READ)
        if not sel.select(timeout=bound):
            raise TimeoutError(f"no line from pid {proc.pid} within {bound} s")
    return proc.stdout.readline()


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["RAY_TPU_HEAD_CLIENT_TIMEOUT_S"] = "2.0"
    env.update(extra)
    return env


def test_cli_start_lines_round_trip_and_debug(tmp_path):
    """``start --head`` and ``start --address`` print the head's and the
    daemon's own lines; a task runs on the CLI's node; ``debug
    --address`` archives the head's and the node's bundles."""
    import ray_tpu_torch as rt

    env = _env(RAY_TPU_FLIGHT="1", CUDA_VISIBLE_DEVICES="")
    cli = [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "start"]
    procs = []
    try:
        head = subprocess.Popen(
            cli + ["--head", "--port", "0", "--state",
                   str(tmp_path / "state.log"), "--metrics-port", "0"],
            stdout=subprocess.PIPE, text=True, env=env)
        procs.append(head)
        line = _read_line(head)
        metrics_line = _read_line(head)
        address = line.strip().rsplit(" ", 1)[-1]
        node = subprocess.Popen(
            cli + ["--address", address, "--num-cpus", "1", "--resources",
                   '{"cli_node": 1}', "--worker-mode", "thread"],
            stdout=subprocess.PIPE, text=True, env=env)
        procs.append(node)
        joined = _read_line(node)
        rt.shutdown()
        w = rt.init(num_cpus=0, num_gpus=0, address=address)

        @rt.remote(resources={"cli_node": 1})
        def where():
            import os as _os

            return _os.getpid()

        pid = rt.get(where.remote(), timeout=T)
        client = joined.strip().rsplit(" ", 1)[-1]
        with urllib.request.urlopen(
                "http://" + metrics_line.strip().rsplit(" ", 1)[-1]
                + "/metrics", timeout=30) as r:
            scraped = r.read().decode()
        alive = [n["client_id"] for n in w.head_client.node_list()
                 if n.get("alive")]
        rt.shutdown()
        dbg = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "debug",
             "--address", address, "--output", str(tmp_path / "dbg")],
            capture_output=True, text=True, env=env, timeout=T)
        report = json.loads(dbg.stdout)
    finally:
        rt.shutdown()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    assert line.startswith("ray_tpu_torch head listening on ")
    assert len(line.split()) == 5
    assert metrics_line.startswith("ray_tpu_torch head metrics on ")
    assert joined.startswith("ray_tpu_torch node ")
    assert f" joined {address} as " in joined
    assert pid == node.pid
    assert alive == [client]
    assert f'node="{client}"' in scraped
    assert dbg.returncode == 0
    assert {"head", f"node-{client}"} <= set(report["sources"])
    assert os.path.exists(os.path.join(report["incident_dir"],
                                       "manifest.json"))


def test_cli_autoscale_and_version(tmp_path):
    """``autoscale --config`` launches its type's min_workers against a
    head; ``version`` prints the package's version."""
    import ray_tpu_torch as rt

    config = tmp_path / "autoscale.json"
    config.write_text(json.dumps({
        "node_types": [{"name": "base", "resources": {"CPU": 1},
                        "min_workers": 1, "max_workers": 1}],
        "idle_timeout_s": 60.0, "update_interval_s": 0.25,
        "worker_mode": "thread"}))
    env = _env(CUDA_VISIBLE_DEVICES="")
    procs = []
    try:
        head = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.head_service",
             "--port", "0"], stdout=subprocess.PIPE, text=True, env=env)
        procs.append(head)
        address = _read_line(head).strip().rsplit(" ", 1)[-1]
        scaler = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.scripts.cli",
             "autoscale", "--address", address, "--config", str(config)],
            stdout=subprocess.PIPE, text=True, env=env,
            start_new_session=True)
        procs.append(scaler)
        managing = _read_line(scaler)
        rt.shutdown()
        w = rt.init(num_cpus=0, num_gpus=0, address=address)
        deadline = time.monotonic() + T
        alive = []
        while not alive and time.monotonic() < deadline:
            alive = [n for n in w.head_client.node_list() if n.get("alive")]
            time.sleep(0.1)
        rt.shutdown()
        scaler.send_signal(2)   # SIGINT: the autoscaler reaps its node
        scaler.wait(timeout=T)
        version = _run_cli(_side("ray_tpu_torch"), ["version"]).strip()
    finally:
        rt.shutdown()
        for p in procs:
            if p.poll() is None:
                # The autoscaler's session holds the daemons it launched.
                if p is not head:
                    os.killpg(p.pid, 9)
                else:
                    p.kill()
                p.wait(timeout=10)
    assert managing.startswith("ray_tpu_torch autoscaler managing 1 node")
    assert len(alive) == 1 and alive[0]["resources"]["CPU"] == 1.0
    assert scaler.returncode == 0
    assert version == rt.__version__
