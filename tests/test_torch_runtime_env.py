"""Twins of the runtime-env cases: ``tests/test_platform.py``'s
``RuntimeEnv`` case and ``tests/test_runtime_env_pip.py``'s, the
reference's ``ray_tpu.runtime_env`` beside the port's
``ray_tpu_torch.runtime_env``, plus ``env_vars``, ``working_dir`` and the
``pip`` refusal on the thread plane (``ray_tpu/_private/scheduler.py``'s
``RuntimeEnvSetupError``), which no reference test exercises.

Each case is a function of a side and runs once per side; the values and
the error type names must be equal. Each side runs in its own runtime,
shut down in a ``finally``; every ``get`` is bounded. The venv builds
(a hand-built local wheel, no network: pip without an index or its
version check, uv offline, through the environment both sides'
build tools inherit) are marked slow, as the reference's file is; the uv
case skips where ``uv`` is not on ``PATH``, as the reference's does.
"""

import base64
import hashlib
import importlib
import os
import sys
import types
import zipfile

import pytest

SIDES = ("ray_tpu", "ray_tpu_torch")
T = 60.0


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the outcome
        return ("err", type(exc).__name__)


def _side(pkg):
    return types.SimpleNamespace(
        pkg=pkg, rt=importlib.import_module(pkg),
        renv=importlib.import_module(f"{pkg}.runtime_env"),
        exc=importlib.import_module(f"{pkg}.exceptions"))


def twin(case, init=None):
    """``case(side)`` on each side, in a runtime started with ``init``
    (none when None); the outcomes must be equal."""
    out = {}
    for pkg in SIDES:
        side = _side(pkg)
        side.rt.shutdown()
        try:
            if init is not None:
                side.rt.init(**init)
            out[pkg] = _outcome(lambda: case(side))
        finally:
            side.rt.shutdown()
    assert out["ray_tpu_torch"] == out["ray_tpu"], out
    return out["ray_tpu"]


def _make_wheel(tmp_path, name="graft_testpkg", version="1.0", value=41):
    """A minimal pure-python wheel, built by hand (no network, no
    setuptools): a wheel is a zip with the package and its .dist-info."""
    tag = "py3-none-any"
    whl = tmp_path / f"{name}-{version}-{tag}.whl"
    dist = f"{name}-{version}.dist-info"
    files = {
        f"{name}/__init__.py": f"VALUE = {value}\n",
        f"{dist}/METADATA": (
            f"Metadata-Version: 2.1\nName: {name}\nVersion: {version}\n"),
        f"{dist}/WHEEL": (
            "Wheel-Version: 1.0\nGenerator: graft\nRoot-Is-Purelib: true\n"
            f"Tag: {tag}\n"),
    }
    record_name = f"{dist}/RECORD"
    record_lines = []
    with zipfile.ZipFile(whl, "w") as z:
        for arcname, text in files.items():
            data = text.encode()
            z.writestr(arcname, data)
            digest = base64.urlsafe_b64encode(
                hashlib.sha256(data).digest()).rstrip(b"=").decode()
            record_lines.append(f"{arcname},sha256={digest},{len(data)}")
        record_lines.append(f"{record_name},,")
        z.writestr(record_name, "\n".join(record_lines) + "\n")
    return str(whl)


# ------------------------------------------------------------------ tier-1
def test_runtime_env_env_vars_and_unsupported():
    """tests/test_platform.py::test_runtime_env_env_vars_and_unsupported"""

    def case(side):
        env = side.renv.RuntimeEnv(env_vars={"RAY_TPU_TEST_VAR": "on"})
        before = os.environ.get("RAY_TPU_TEST_VAR")
        with env.applied():
            inside = os.environ["RAY_TPU_TEST_VAR"]
        after = os.environ.get("RAY_TPU_TEST_VAR")
        conda = _outcome(lambda: side.renv.RuntimeEnv(
            conda={"dependencies": ["requests"]}))
        return before, inside, after, conda

    assert twin(case) == ("ok", (None, "on", None, ("err", "ValueError")))


def test_pip_and_uv_conflict_rejected():
    """tests/test_runtime_env_pip.py::test_pip_and_uv_conflict_rejected"""

    def case(side):
        try:
            side.renv.RuntimeEnv(pip=["x"], uv=["y"])
        except ValueError as exc:
            return "not both" in str(exc)
        return "accepted"

    assert twin(case) == ("ok", True)


def test_conda_still_rejected():
    """tests/test_runtime_env_pip.py::test_conda_still_rejected"""

    def case(side):
        try:
            side.renv.RuntimeEnv(conda={"dependencies": ["x"]})
        except ValueError as exc:
            return "not supported" in str(exc)
        return "accepted"

    assert twin(case) == ("ok", True)


def test_coerce_and_keys():
    """``coerce_runtime_env``'s three inputs, and ``env_key``: None
    without a venv field, the same content address for the same
    specs."""

    def case(side):
        none = side.renv.coerce_runtime_env(None)
        env = side.renv.coerce_runtime_env({"env_vars": {"A": "1"}})
        same = side.renv.coerce_runtime_env(env) is env
        keyed = side.renv.RuntimeEnv(pip=["/nonexistent/a.whl"])
        return (none, type(env).__name__, dict(env), same, env.env_key(),
                keyed.env_key() == side.renv.pip_env_key(
                    ["/nonexistent/a.whl"]))

    assert twin(case)[0] == "ok"


def test_env_vars_apply_in_worker():
    """tests/test_runtime_env_pip.py::test_env_vars_apply_in_worker (a
    process worker: the reference's default plane, the port's
    ``worker_mode="process"``)."""

    def case(side):
        rt = side.rt

        @rt.remote(runtime_env={"env_vars": {"GRAFT_RE_VAR": "yes"}})
        def read_var():
            import os as _os

            return _os.environ.get("GRAFT_RE_VAR")

        @rt.remote
        def read_plain():
            import os as _os

            return _os.environ.get("GRAFT_RE_VAR")

        return (rt.get(read_var.remote(), timeout=T),
                rt.get(read_plain.remote(), timeout=T))

    assert twin(case, {"num_cpus": 2, "worker_mode": "process"}) == (
        "ok", ("yes", None))


def test_thread_plane_env_vars_working_dir_and_streaming(tmp_path):
    """The thread plane applies env_vars and a staged working_dir around
    the call (the streaming generator's body too) and restores them
    after; a later task without an env sees neither."""
    wd = tmp_path / "wd"
    wd.mkdir()
    (wd / "graft_wd_module.py").write_text("VALUE = 'from-working-dir'\n")

    def case(side):
        rt = side.rt
        env = {"env_vars": {"GRAFT_THREAD_VAR": "t"},
               "working_dir": str(wd)}

        @rt.remote(runtime_env=env)
        def inside():
            import os as _os

            import graft_wd_module

            return (_os.environ.get("GRAFT_THREAD_VAR"),
                    graft_wd_module.VALUE,
                    _os.path.exists(_os.path.join(
                        _os.path.dirname(graft_wd_module.__file__),
                        "graft_wd_module.py")))

        @rt.remote(num_returns="streaming", runtime_env=env)
        def stream(n):
            import os as _os

            for _ in range(n):
                yield _os.environ.get("GRAFT_THREAD_VAR")

        @rt.remote
        def outside():
            import os as _os
            import sys as _sys

            return (_os.environ.get("GRAFT_THREAD_VAR"),
                    any(p.endswith("working_dir") and "runtime_env" in p
                        for p in _sys.path))

        got = rt.get(inside.remote(), timeout=T)
        streamed = [rt.get(r, timeout=T) for r in stream.remote(3)]
        sys.modules.pop("graft_wd_module", None)
        return got, streamed, rt.get(outside.remote(), timeout=T)

    assert twin(case, {"num_cpus": 2, "worker_mode": "thread"}) == (
        "ok", (("t", "from-working-dir", True), ["t", "t", "t"],
               (None, False)))


def test_thread_plane_refuses_pip():
    """A pip env cannot apply on the thread plane: the task fails with
    ``RuntimeEnvSetupError`` (the reference's scheduler raises it before
    the call), and the runtime keeps serving."""

    def case(side):
        rt = side.rt

        @rt.remote(runtime_env={"pip": ["/nonexistent/graft.whl"]})
        def needs_venv():
            return "ran"

        @rt.remote
        def plain():
            return "plain"

        try:
            rt.get(needs_venv.remote(), timeout=T)
            refused = None
        except Exception as exc:  # noqa: BLE001 — the outcome
            # A task error: the cause's type rides its message.
            refused = ("RuntimeEnvSetupError" in str(exc),
                       "process workers" in str(exc))
        return refused, rt.get(plain.remote(), timeout=T)

    assert twin(case, {"num_cpus": 2, "worker_mode": "thread"}) == (
        "ok", ((True, True), "plain"))


def test_unknown_option_and_runtime_env_option():
    """``runtime_env`` is a task option on both sides (an unknown one
    is refused)."""

    def case(side):
        rt = side.rt

        def f():
            return 1

        opts = rt.remote(f).options(
            runtime_env={"env_vars": {"X": "1"}})._options
        return (dict(opts["runtime_env"]["env_vars"]),
                _outcome(lambda: rt.remote(f).options(no_such=1)))

    out = twin(case)
    assert out[1][0] == {"X": "1"}


# -------------------------------------------------------------------- slow
@pytest.fixture
def offline_env_cache(tmp_path, monkeypatch):
    """A fresh env cache, and build tools that never reach a network."""
    cache = tmp_path / "env_cache"
    monkeypatch.setenv("RAY_TPU_RUNTIME_ENV_CACHE", str(cache))
    monkeypatch.setenv("PIP_NO_INDEX", "1")
    monkeypatch.setenv("PIP_DISABLE_PIP_VERSION_CHECK", "1")
    monkeypatch.setenv("UV_OFFLINE", "1")
    return cache


@pytest.mark.slow
def test_pip_env_builds_and_caches(tmp_path, offline_env_cache):
    """tests/test_runtime_env_pip.py::test_pip_env_builds_and_caches"""
    import subprocess

    whl = _make_wheel(tmp_path)

    def case(side):
        cache = offline_env_cache / side.pkg
        os.environ["RAY_TPU_RUNTIME_ENV_CACHE"] = str(cache)
        env = side.renv.RuntimeEnv(pip=[whl])
        py = env.python_executable()
        value = subprocess.run(
            [py, "-c", "import graft_testpkg; print(graft_testpkg.VALUE)"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        inherited = subprocess.run(
            [py, "-c", "import numpy; print('np')"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        marker = os.path.join(str(cache), side.renv.pip_env_key([whl]),
                              ".ready")
        mtime = os.path.getmtime(marker)
        again = env.python_executable() == py
        return (os.path.exists(py), value, inherited, again,
                os.path.getmtime(marker) == mtime)

    assert twin(case) == ("ok", (True, "41", "np", True, True))


@pytest.mark.slow
def test_pip_env_build_failure_is_typed(offline_env_cache):
    """tests/test_runtime_env_pip.py::test_pip_env_build_failure_is_typed
    """

    def case(side):
        env = side.renv.RuntimeEnv(
            pip=["/nonexistent/definitely_missing.whl"])
        try:
            env.python_executable()
        except side.exc.RuntimeEnvSetupError:
            return "typed"
        return "built"

    assert twin(case) == ("ok", "typed")


@pytest.mark.slow
def test_task_runs_inside_pip_env(tmp_path, offline_env_cache):
    """tests/test_runtime_env_pip.py::test_task_runs_inside_pip_env: a
    task imports a package the driver does not have (its worker runs
    under the env's venv, in its own sub-pool), and a default-env task
    on the same pool does not see it."""
    whl = _make_wheel(tmp_path, value=42)
    with pytest.raises(ImportError):
        import graft_testpkg  # noqa: F401 — must not exist here

    def case(side):
        rt = side.rt

        @rt.remote(runtime_env={"pip": [whl]})
        def uses_pkg():
            import sys as _sys

            import graft_testpkg

            return graft_testpkg.VALUE, _sys.executable

        @rt.remote
        def plain():
            try:
                import graft_testpkg  # noqa: F401
            except ImportError:
                return "isolated"
            return "leaked"

        value, exe = rt.get(uses_pkg.remote(), timeout=180)
        return value, str(offline_env_cache) in exe, rt.get(
            plain.remote(), timeout=T)

    assert twin(case, {"num_cpus": 2, "worker_mode": "process"}) == (
        "ok", (42, True, "isolated"))


@pytest.mark.slow
def test_uv_env_builds_and_runs_task(tmp_path, offline_env_cache):
    """tests/test_runtime_env_pip.py::test_uv_env_builds_and_runs_task"""
    import shutil

    if shutil.which("uv") is None:
        pytest.skip("uv not on PATH")
    whl = _make_wheel(tmp_path, name="graft_uvpkg", value=77)

    def case(side):
        rt = side.rt

        @rt.remote(runtime_env={"uv": [whl]})
        def uses_pkg():
            import sys as _sys

            import graft_uvpkg

            return graft_uvpkg.VALUE, _sys.executable

        value, exe = rt.get(uses_pkg.remote(), timeout=180)
        return value, str(offline_env_cache) in exe

    assert twin(case, {"num_cpus": 2, "worker_mode": "process"}) == (
        "ok", (77, True))
