"""Twins of the reference's durable workflows (``tests/test_workflow.py``)
on the CPU: the runtime-only cases (``:35-160``, ``:378-469``) run on
both sides and their outcomes (values, statuses, attempt counts, side
effects, error type names) must be equal; the kill -9 and ``resume_all``
scenarios run each side's driver in a child process; the file names under
the storage root, and the state API's workflow listings, are compared.
The slow twin of ``:309`` kills the driver and its head service, restarts
the head from its state log and resumes from a new attached driver.

Both runtimes run in one process (the reference on
``ray_tpu.init(worker_mode="thread")``). Both sides pickle with
``cloudpickle`` where it imports (it does here) and with the standard
library's pickle otherwise; the crash scenarios take their steps from
this module, which both processes import (``port_link``).
``test_local_steps_resume_elsewhere_with_cloudpickle`` resumes a step
defined inside a function from another process on both sides;
``test_local_steps_resume_only_in_their_process`` pins the stdlib rule
with ``cloudpickle`` made unimportable. Every wait is bounded.
"""

import os
import re
import signal
import subprocess
import sys
import time
import types

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import dag as jdag
from ray_tpu import workflow as jworkflow
from ray_tpu.util import state as jstate
from ray_tpu_torch import dag as tdag
from ray_tpu_torch import workflow as tworkflow
from ray_tpu_torch.util import state as tstate

T = 60.0
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)

REF = types.SimpleNamespace(name="ref", rt=ray_tpu, wf=jworkflow, dag=jdag,
                            state=jstate)
PORT = types.SimpleNamespace(name="port", rt=ray_tpu_torch, wf=tworkflow,
                             dag=tdag, state=tstate)
SIDES = {"ref": REF, "port": PORT}


@pytest.fixture
def runtimes():
    for rt in (ray_tpu, ray_tpu_torch):
        rt.shutdown()
    ray_tpu.init(num_cpus=2, worker_mode="thread", ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=2)
    try:
        yield
    finally:
        for rt in (ray_tpu, ray_tpu_torch):
            rt.shutdown()


def _both(case, tmp_path):
    """The case's outcome on each side, each with a storage root and a
    scratch directory of its own; the outcomes must be equal."""
    out = {}
    for name, side in SIDES.items():
        scratch = tmp_path / name
        scratch.mkdir()
        try:
            out[name] = ("ok", case(side, str(scratch / "wf_storage"),
                                    str(scratch)))
        except Exception as exc:  # noqa: BLE001 — the error is the outcome
            out[name] = ("err", type(exc).__name__)
    assert out["port"] == out["ref"]
    return out["ref"]


# ------------------------------------------------------------------ basics
@pytest.mark.parametrize("where", ["local", "memory"])
def test_run_diamond_and_introspect(runtimes, tmp_path, where):
    def case(s, root, _):
        if where == "memory":
            root = f"memory://wf_{s.name}"

        @s.wf.step
        def src():
            return 10

        @s.wf.step
        def double(x):
            return 2 * x

        @s.wf.step
        def add(a, b):
            return a + b

        n = src.bind()
        out = s.wf.run(add.bind(double.bind(n), double.bind(n)),
                       workflow_id="diamond", storage=root)
        meta = s.wf.get_metadata("diamond", storage=root)
        return (out, s.wf.get_status("diamond", storage=root),
                s.wf.get_output("diamond", storage=root),
                s.wf.list_all(storage=root),
                sorted((sid, rec["attempts"], rec["name"])
                       for sid, rec in meta["steps"].items()))

    out = _both(case, tmp_path)
    assert out[1][:3] == (40, "SUCCESS", 40)
    assert len(out[1][4]) == 4


def test_completed_steps_skip_on_rerun(runtimes, tmp_path):
    def case(s, root, scratch):
        counts = os.path.join(scratch, "side_effects")

        @s.wf.step
        def effect(tag, prev=None):
            with open(counts, "a") as f:
                f.write(tag + "\n")
            return tag

        dag = effect.bind("b", effect.bind("a"))
        outs = [s.wf.run(dag, workflow_id="rerun", storage=root),
                s.wf.run(dag, workflow_id="rerun", storage=root),
                s.wf.resume("rerun", storage=root)]
        with open(counts) as f:
            return outs, sorted(f.read().split())

    assert _both(case, tmp_path) == ("ok", (["b", "b", "b"], ["a", "b"]))


def test_step_retries_with_backoff(runtimes, tmp_path):
    def case(s, root, scratch):
        attempts = os.path.join(scratch, "attempts")

        @s.wf.step(max_retries=3, retry_exceptions=(ValueError,),
                   backoff_s=0.01)
        def flaky():
            with open(attempts, "a") as f:
                f.write("x")
            if os.path.getsize(attempts) < 3:
                raise ValueError("transient")
            return "ok"

        out = s.wf.run(flaky.bind(), workflow_id="retry", storage=root)
        (rec,) = s.wf.get_metadata("retry",
                                   storage=root)["steps"].values()
        return out, os.path.getsize(attempts), rec["attempts"]

    assert _both(case, tmp_path) == ("ok", ("ok", 3, 3))


def test_retry_exceptions_filter(runtimes, tmp_path):
    def case(s, root, scratch):
        attempts = os.path.join(scratch, "attempts")

        @s.wf.step(max_retries=5, retry_exceptions=(ValueError,))
        def wrong_kind():
            with open(attempts, "a") as f:
                f.write("x")
            raise KeyError("not retryable")

        with pytest.raises(KeyError):
            s.wf.run(wrong_kind.bind(), workflow_id="filt", storage=root)
        rec = s.wf.get_metadata("filt", storage=root)
        return (os.path.getsize(attempts), rec["status"],
                "KeyError" in rec["error"])

    assert _both(case, tmp_path) == ("ok", (1, "FAILED", True))


def test_retries_exhausted_fail_the_workflow(runtimes, tmp_path):
    def case(s, root, scratch):
        attempts = os.path.join(scratch, "attempts")

        @s.wf.step(max_retries=2, backoff_s=0.0)
        def always():
            with open(attempts, "a") as f:
                f.write("x")
            raise ValueError("always")

        with pytest.raises(ValueError):
            s.wf.run(always.bind(), workflow_id="ex", storage=root)
        return os.path.getsize(attempts), s.wf.get_status("ex",
                                                          storage=root)

    assert _both(case, tmp_path) == ("ok", (3, "FAILED"))


def test_catch_exceptions_continuation(runtimes, tmp_path):
    def case(s, root, _):
        @s.wf.step(catch_exceptions=True)
        def boom():
            raise RuntimeError("kaboom")

        @s.wf.step(catch_exceptions=True)
        def fine():
            return 5

        @s.wf.step
        def recover(pair, ok):
            result, err = pair
            return ("fallback" if err is not None else result,
                    type(err).__name__, str(err), ok)

        out = s.wf.run(recover.bind(boom.bind(), fine.bind()),
                       workflow_id="catch", storage=root)
        return out, s.wf.get_status("catch", storage=root)

    assert _both(case, tmp_path) == (
        "ok", (("fallback", "RuntimeError", "kaboom", (5, None)), "SUCCESS"))


def test_run_async_and_delete(runtimes, tmp_path):
    def case(s, root, _):
        @s.wf.step
        def one():
            return 1

        fut = s.wf.run_async(one.bind(), workflow_id="bg", storage=root)
        out = fut.result(timeout=T)
        listed = s.wf.list_all(storage=root)
        s.wf.delete("bg", storage=root)
        return (out, listed, s.wf.list_all(storage=root),
                s.wf.get_status("bg", storage=root))

    assert _both(case, tmp_path) == (
        "ok", (1, [("bg", "SUCCESS")], [], None))


def test_virtual_actor_durable(runtimes, tmp_path):
    def case(s, root, _):
        @s.wf.virtual_actor
        class Counter:
            def __init__(self, start=0):
                self.n = start

            def incr(self, by=1):
                self.n += by
                return self.n

        c = Counter.get_or_create("acct", 100, storage=root)
        outs = [c.incr.run(), c.incr.run(9)]
        # A fresh handle loads the last committed snapshot, not the
        # constructor's arguments.
        c2 = Counter.get_or_create("acct", 0, storage=root)
        outs.append(c2.incr.run())
        outs.append(c2.incr.run_async(4).result(timeout=T))
        return outs, c2.get_state(), repr(c2).split("(", 1)[1]

    assert _both(case, tmp_path) == (
        "ok", ([101, 110, 111, 115], {"n": 115},
               "Counter, id='acct', seq=4)"))


# -------------------------------------------------------- commit protocol
def test_commit_step_single_winner(tmp_path):
    def case(s, root, _):
        store = s.wf.WorkflowStorage(root)
        won_a, rec_a = store.commit_step("race", "0000_s", "value_a")
        won_b, rec_b = store.commit_step("race", "0000_s", "value_b")
        return (won_a, won_b, rec_b["token"] == rec_a["token"],
                store.load_step_output("race", "0000_s"))

    assert _both(case, tmp_path) == ("ok", (True, False, True, "value_a"))


def test_virtual_actor_concurrent_writer_detected(runtimes, tmp_path):
    def case(s, root, _):
        @s.wf.virtual_actor
        class Counter:
            def __init__(self):
                self.n = 0

            def incr(self):
                self.n += 1
                return self.n

        a = Counter.get_or_create("dup", storage=root)
        b = Counter.get_or_create("dup", storage=root)
        first = a.incr.run()
        with pytest.raises(RuntimeError, match="concurrent"):
            b.incr.run()  # b's seq-1 commit lost to a's
        c = Counter.get_or_create("dup", storage=root)
        return first, c.incr.run()

    assert _both(case, tmp_path) == ("ok", (1, 2))


def test_virtual_actor_snapshots_bounded(runtimes, tmp_path):
    def case(s, root, _):
        @s.wf.virtual_actor
        class Counter:
            def __init__(self):
                self.n = 0

            def incr(self):
                self.n += 1
                return self.n

        c = Counter.get_or_create("hot", storage=root)
        for _ in range(20):
            c.incr.run()
        actor_dir = os.path.join(root, "virtual_actors", "hot")
        markers = sorted(f for f in os.listdir(actor_dir)
                         if f.startswith("commit."))
        states = [f for f in os.listdir(actor_dir)
                  if f.startswith("state.")]
        keep = s.wf.WorkflowStorage.ACTOR_KEEP_SNAPSHOTS
        assert len(markers) <= keep + 1, markers
        assert len(states) <= keep + 2, states
        c2 = Counter.get_or_create("hot", storage=root)
        return (markers, len(states), c2.incr.run(),
                s.wf.WorkflowStorage(root).list_actors())

    out = _both(case, tmp_path)
    assert out[1][2] == 21 and out[1][3] == ["hot"]


# ------------------------------------------------------------- validation
def test_rejects_non_step_dags(runtimes, tmp_path):
    def case(s, root, _):
        @s.rt.remote
        def plain(x):
            return x

        errors = []
        try:
            s.wf.run(plain.bind(1), workflow_id="bad", storage=root)
        except Exception as exc:  # noqa: BLE001 — the type is the outcome
            errors.append(type(exc).__name__)

        @s.wf.step
        def st(x):
            return x

        with s.dag.InputNode() as inp:
            dag = st.bind(inp)
        try:
            s.wf.run(dag, workflow_id="bad2", storage=root)
        except Exception as exc:  # noqa: BLE001
            errors.append(type(exc).__name__)
        try:
            s.wf.run(42, workflow_id="bad3", storage=root)
        except Exception as exc:  # noqa: BLE001
            errors.append(type(exc).__name__)
        return errors

    assert _both(case, tmp_path) == ("ok", ["TypeError"] * 3)


def test_step_options_validation(tmp_path):
    def case(s, root, _):
        errors = []
        for bad in ({"bogus_option": 1}, {"max_retries": 2, "nope": 0}):
            try:
                s.wf.step(lambda: None, **bad)
            except ValueError as exc:
                errors.append(str(exc))
        wrapped = s.wf.step(lambda: 1)
        try:
            wrapped()
        except TypeError:
            errors.append("TypeError")
        try:
            wrapped.options(bogus=1)
        except ValueError:
            errors.append("ValueError")
        try:
            s.wf.step(3)
        except TypeError:
            errors.append("TypeError")
        named = s.wf.step(name="n", max_retries=1)(lambda: 1).options(
            backoff_s=0.5)
        node = named.step()
        return errors, node.step_name, sorted(node._step_options)

    assert _both(case, tmp_path)[1][0][-3:] == [
        "TypeError", "ValueError", "TypeError"]


# ----------------------------------------------- module-level steps (files)
@jworkflow.step(name="src")
def ref_src():
    return 3


@jworkflow.step(name="scale")
def ref_scale(x, k=2):
    return x * k


@tworkflow.step(name="src")
def port_src():
    return 3


@tworkflow.step(name="scale")
def port_scale(x, k=2):
    return x * k


def _files(root):
    out = []
    for d, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), root)
            out.append(re.sub(r"\.[0-9a-f]{32}\.pkl$", ".<token>.pkl", rel))
    return sorted(out)


def test_same_files_under_the_root(runtimes, tmp_path):
    out = {}
    for name, s, src, scale in (("ref", REF, ref_src, ref_scale),
                                ("port", PORT, port_src, port_scale)):
        root = str(tmp_path / name)
        value = s.wf.run(scale.bind(scale.bind(src.bind()), k=5),
                         workflow_id="files", storage=root)

        @s.wf.virtual_actor
        class Box:
            def __init__(self):
                self.v = 0

            def put(self, v):
                self.v = v
                return v

        b = Box.get_or_create("box", storage=root)
        for v in range(6):
            b.put.run(v)
        out[name] = (value, _files(root))
    assert out["port"] == out["ref"]
    assert "files/dag.pkl" in out["port"][1]
    assert "files/steps/0000_src/output.<token>.pkl" in out["port"][1]


def test_module_level_steps_pickle_by_name(runtimes, tmp_path):
    """A module-level ``@workflow.step`` pickles by name (its module
    attribute is the wrapper) and loads back as the same function."""
    import pickle

    root = str(tmp_path / "p")
    tworkflow.run(port_scale.bind(port_src.bind()), workflow_id="p",
                  storage=root)
    with open(os.path.join(root, "p", "dag.pkl"), "rb") as f:
        dag = pickle.load(f)
    assert dag._fn is port_scale._fn
    assert dag._bound_args[0]._fn is port_src._fn
    assert not tworkflow.WorkflowStorage(root).get_status("p").get(
        "dag_held_in_process")


def _held_workflow(s, root, gate):
    """A workflow whose steps are defined inside a function, run once
    with its gate closed: it fails at ``gated`` after ``first``
    committed."""

    @s.wf.step
    def first():
        return 4

    @s.wf.step
    def gated(x):
        if not gate.exists():
            raise RuntimeError("gate closed")
        return x + 1

    with pytest.raises(RuntimeError, match="gate closed"):
        s.wf.run(gated.bind(first.bind()), workflow_id="held",
                 storage=root)


def _resume_elsewhere(side, root, hide_cloudpickle=False):
    """Resume workflow ``held`` under ``root`` in a child process of
    ``side``'s runtime; its stdout names the result or the error."""
    hide = ('import sys; sys.modules["cloudpickle"] = None\n'
            if hide_cloudpickle else "")
    child = subprocess.run(
        [sys.executable, "-c", hide + _RESUME_ELSEWHERE[side], root],
        capture_output=True, text=True, timeout=T, cwd=REPO,
        env=_child_env())
    assert child.returncode == 0, child.stderr
    return child.stdout.strip()


def test_local_steps_resume_elsewhere_with_cloudpickle(runtimes, tmp_path):
    """With ``cloudpickle`` (as on this box) both sides store a step
    defined inside a function by value: another process resumes the
    workflow, and the two sides' results and statuses are equal."""
    pytest.importorskip("cloudpickle")
    out = {}
    for name, s in SIDES.items():
        root = str(tmp_path / name / "wf")
        gate = tmp_path / name / "gate"
        _held_workflow(s, root, gate)
        assert os.path.exists(os.path.join(root, "held", "dag.pkl"))
        gate.write_text("open")
        out[name] = (_resume_elsewhere(name, root),
                     s.wf.get_status("held", storage=root),
                     s.wf.get_output("held", storage=root))
    assert out["port"] == out["ref"] == ("resumed 5", "SUCCESS", 5)
    rec = tworkflow.WorkflowStorage(
        str(tmp_path / "port" / "wf")).get_status("held")
    assert "dag_held_in_process" not in rec


def test_local_steps_resume_only_in_their_process(runtimes, tmp_path,
                                                  monkeypatch):
    """The rule without ``cloudpickle`` (made unimportable here, in this
    process and in the child): a workflow
    whose step is defined inside a function keeps its DAG in this
    process; a resume from another process raises ValueError naming
    that step, a resume here completes it."""
    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    root = str(tmp_path / "held")
    gate = tmp_path / "gate"
    _held_workflow(PORT, root, gate)
    rec = tworkflow.WorkflowStorage(root).get_status("held")
    assert rec["status"] == "FAILED"
    assert rec["dag_held_in_process"] == "first"
    assert not os.path.exists(os.path.join(root, "held", "dag.pkl"))
    said = _resume_elsewhere("port", root, hide_cloudpickle=True)
    assert "ValueError" in said and "'first'" in said
    assert "module level" in said
    gate.write_text("open")
    assert tworkflow.resume("held", storage=root) == 5
    assert tworkflow.get_status("held", storage=root) == "SUCCESS"


_RESUME_ELSEWHERE = {side: r"""
import sys
import {rt}
from {rt} import workflow
{rt}.init(num_cpus=1{mode})
try:
    print("resumed", workflow.resume("held", storage=sys.argv[1]))
except Exception as exc:
    print(type(exc).__name__, exc)
finally:
    {rt}.shutdown()
""".format(rt=rt, mode=mode) for side, rt, mode in (
    ("ref", "ray_tpu", ', worker_mode="thread"'),
    ("port", "ray_tpu_torch", ""))}


# ---------------------------------------------------------- crash-resume
@tworkflow.step
def port_link(i, prev=None):
    """The reference driver's ``link`` at module level, for the port's
    child driver: step ``WF_KILL_AT`` parks at its start while the
    ``WF_HOLD`` file exists; every step appends its tag to
    ``WF_EFFECTS``."""
    if i == int(os.environ.get("WF_KILL_AT", "-1")):
        deadline = time.monotonic() + T
        while os.path.exists(os.environ["WF_HOLD"]):
            if time.monotonic() > deadline:
                raise TimeoutError("held past the test's bound")
            time.sleep(0.02)
    with open(os.environ["WF_EFFECTS"], "a") as f:
        f.write(f"step{i}\n")
        f.flush()
        os.fsync(f.fileno())
    return (prev or 0) + i


_PORT_DRIVER = r"""
import os, sys
sys.path.insert(0, sys.argv[5])
import ray_tpu_torch
from ray_tpu_torch import workflow
import test_torch_workflow as steps

root, effects, hold, kill_at = (
    sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]))
address = sys.argv[6] if len(sys.argv) > 6 else None
ray_tpu_torch.init(num_cpus=2, address=address)
os.environ["WF_KILL_AT"] = str(kill_at)
os.environ["WF_HOLD"] = hold
os.environ["WF_EFFECTS"] = effects
node = None
for i in range(10):
    node = (steps.port_link.bind(i, node) if node is not None
            else steps.port_link.bind(i))
out = workflow.run(node, workflow_id="crashy", storage=root)
print("RESULT:" + str(out), flush=True)
ray_tpu_torch.shutdown()
"""


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def _spawn(side, root, effects, hold, kill_at, address=None, env=None):
    if side == "ref":
        from test_workflow import _DRIVER

        args = [sys.executable, "-c", _DRIVER, root, effects, hold,
                str(kill_at)] + ([address] if address else [])
    else:
        args = [sys.executable, "-c", _PORT_DRIVER, root, effects, hold,
                str(kill_at), TESTS_DIR] + ([address] if address else [])
    return subprocess.Popen(args, stdout=subprocess.PIPE, text=True,
                            cwd=REPO, env=env or _child_env())


def _committed(s, root):
    meta = s.wf.get_metadata("crashy", storage=root)
    return sum(1 for r in meta["steps"].values() if r)


def _kill_at_hold(s, root, effects, hold, kill_at):
    """Run the side's child driver until step ``kill_at`` parks, then
    SIGKILL it. Returns (status, committed steps) as the parent reads
    them after the kill."""
    open(hold, "w").close()
    proc = _spawn(s.name, root, effects, hold, kill_at)
    try:
        deadline = time.monotonic() + T
        while time.monotonic() < deadline:
            if os.path.exists(effects):
                with open(effects) as f:
                    ran = len(f.read().split())
                if (ran >= kill_at and s.wf.get_status(
                        "crashy", storage=root) == "RUNNING"
                        and _committed(s, root) >= kill_at):
                    break
            assert proc.poll() is None, "the child driver ended early"
            time.sleep(0.05)
        else:
            raise AssertionError("the child driver never reached the hold")
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=T)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=T)
    os.unlink(hold)
    return s.wf.get_status("crashy", storage=root), _committed(s, root)


@pytest.mark.parametrize("sweep", ["resume", "resume_all"])
def test_driver_kill9_resume_exactly_once(runtimes, tmp_path, monkeypatch,
                                          sweep):
    """A 10-step chain survives kill -9 of its driver parked at step 4;
    resume (or resume_all) completes it with every step run exactly once
    across both processes, on each side."""
    kill_at = 4
    out = {}
    for name, s in SIDES.items():
        scratch = tmp_path / name
        scratch.mkdir()
        root = str(scratch / "wf_storage")
        effects = str(scratch / "effects.log")
        before = _kill_at_hold(s, root, effects, str(scratch / "hold"),
                               kill_at)
        monkeypatch.setenv("WF_EFFECTS", effects)
        monkeypatch.setenv("WF_KILL_AT", "-1")
        if sweep == "resume":
            result = s.wf.resume("crashy", storage=root)
        else:
            result = s.wf.resume_all(storage=root)
        with open(effects) as f:
            runs = sorted(f.read().split())
        out[name] = (before, result, runs,
                     s.wf.get_status("crashy", storage=root),
                     s.wf.list_all(status_filter="RUNNING", storage=root),
                     _committed(s, root))
    assert out["port"] == out["ref"]
    before, result, runs, status, running, committed = out["ref"]
    assert before == ("RUNNING", kill_at)
    assert result == (45 if sweep == "resume" else {"crashy": 45})
    assert runs == sorted(f"step{i}" for i in range(10))
    assert (status, running, committed) == ("SUCCESS", [], 10)


# ---------------------------------------------------- head-restart resume
_HEAD_MODULE = {"ref": "ray_tpu._private.head_service",
                "port": "ray_tpu_torch._private.head_service"}


def _spawn_head(side, port, state, env):
    proc = subprocess.Popen(
        [sys.executable, "-m", _HEAD_MODULE[side], "--port", str(port),
         "--state", state], stdout=subprocess.PIPE, text=True, cwd=REPO,
        env=env)
    return proc, proc.stdout.readline().strip().rsplit(" ", 1)[-1]


def _head_restart_resume(s, scratch, monkeypatch):
    """The twin of ``tests/test_workflow.py:309`` on one side: a chain on
    ``memory://`` storage (the head's KV and its append log) parked at
    step 4; kill -9 the driver and the head, restart the head from its
    log on the same port, and resume from a new driver attached to it.
    Returns (status seen after the restart, result, every step's runs)."""
    state = str(scratch / "head_state.log")
    effects = str(scratch / "effects.log")
    hold = str(scratch / "hold")
    open(hold, "w").close()
    env = _child_env()
    env["RAY_TPU_HEAD_CLIENT_TIMEOUT_S"] = "3.0"
    root = f"memory://wf_head_restart_{s.name}"
    head1, address = _spawn_head(s.name, 0, state, env)
    driver = _spawn(s.name, root, effects, hold, 4, address=address,
                    env=env)
    head2 = None
    try:
        deadline = time.monotonic() + T
        while time.monotonic() < deadline:
            if os.path.exists(effects):
                with open(effects) as f:
                    if len(f.read().split()) >= 4:
                        break
            assert driver.poll() is None, "the child driver ended early"
            time.sleep(0.05)
        else:
            raise AssertionError("the child driver never reached step 4")
        time.sleep(0.5)   # step 3's commit reaches the head's KV and log
        for p in (driver, head1):
            p.send_signal(signal.SIGKILL)
            p.wait(timeout=T)
        os.unlink(hold)
        head2, _ = _spawn_head(s.name, int(address.rsplit(":", 1)[1]),
                               state, env)
        kw = {"worker_mode": "thread"} if s.name == "ref" else {}
        s.rt.init(num_cpus=2, address=address, ignore_reinit_error=True,
                  **kw)
        monkeypatch.setenv("WF_EFFECTS", effects)
        monkeypatch.setenv("WF_KILL_AT", "-1")
        status, deadline = None, time.monotonic() + 30
        while status is None and time.monotonic() < deadline:
            try:
                status = s.wf.get_status("crashy", storage=root)
            except Exception:  # noqa: BLE001 — the head still re-dialing
                time.sleep(0.25)
        out = s.wf.resume("crashy", storage=root)
        with open(effects) as f:
            runs = sorted(f.read().split())
        return status, out, runs
    finally:
        s.rt.shutdown()
        for p in (driver, head1, head2):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=T)


@pytest.mark.slow
def test_workflow_resumes_after_head_restart(tmp_path, monkeypatch):
    for rt in (ray_tpu, ray_tpu_torch):
        rt.shutdown()
    out = {}
    for name, s in SIDES.items():
        scratch = tmp_path / name
        scratch.mkdir()
        out[name] = _head_restart_resume(s, scratch, monkeypatch)
    assert out["port"] == out["ref"]
    assert out["ref"] == ("RUNNING", 45,
                          sorted(f"step{i}" for i in range(10)))


# -------------------------------------------------------------- state API
def test_list_and_summarize_workflows(runtimes, tmp_path):
    def case(s, root, _):
        @s.wf.step
        def ok():
            return 1

        @s.wf.step
        def bad():
            raise ValueError("no")

        s.wf.init(root)
        s.wf.run(ok.bind(), workflow_id="a")
        s.wf.run(ok.bind(), workflow_id="b")
        with pytest.raises(ValueError):
            s.wf.run(bad.bind(), workflow_id="c")
        rows = s.state.list_workflows()
        failed = s.state.list_workflows(filters=[("status", "=", "FAILED")])
        return ([(r.workflow_id, r.status, r.root == root,
                  isinstance(r.updated_at, float)) for r in rows],
                [r.workflow_id for r in failed],
                s.state.summarize_workflows(),
                s.state.summarize_workflows(rows),
                len(s.state.list_workflows(limit=2)))

    from ray_tpu.workflow import api as japi
    from ray_tpu_torch.workflow import api as tapi

    before = japi._global_storage, tapi._global_storage
    try:
        out = _both(case, tmp_path)
    finally:
        japi._global_storage, tapi._global_storage = before
    assert out[1][2] == {"SUCCESS": 2, "FAILED": 1}
    assert out[1][1] == ["c"] and out[1][4] == 2


def test_public_names_match_the_reference():
    assert sorted(tworkflow.__all__) == sorted(jworkflow.__all__)
    assert all(hasattr(tworkflow, n) for n in jworkflow.__all__)
    from ray_tpu.workflow import api as japi
    from ray_tpu_torch.workflow import api as tapi

    assert tapi._STEP_OPTION_KEYS == japi._STEP_OPTION_KEYS
    assert sorted(tapi.__all__) == sorted(japi.__all__)
