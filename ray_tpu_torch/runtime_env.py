"""Runtime environments (counterpart of ``ray_tpu/runtime_env.py``).

Supported fields:

- ``env_vars`` — applied around task/actor execution in the worker
  (saved + restored).
- ``working_dir`` — copied to a session-scoped dir and prepended to
  ``sys.path``.
- ``py_modules`` — extra importable paths.
- ``pip`` — a list of requirement specs (names, local wheel/sdist paths).
  Builds a content-addressed virtualenv per unique requirement set and
  runs the task's worker process under that venv's interpreter. The venv
  inherits the driver environment's site-packages through a ``.pth``
  file appended AFTER the venv's own site dir, so pip-installed packages
  override inherited ones while torch/numpy stay importable without a
  reinstall. Builds are lazy (first lease that needs the env) and cached
  across sessions under ``~/.cache/ray_tpu_torch/runtime_envs`` (override:
  ``RAY_TPU_RUNTIME_ENV_CACHE``).
- ``uv`` — same semantics as ``pip`` but the venv is created and
  populated by the ``uv`` tool (much faster resolution/installs);
  requires ``uv`` on PATH.

Nothing is downloaded: pip runs with ``--no-index`` and without its
version check, uv with ``--offline``, so a spec must be a local wheel,
sdist or path (a bare name resolves only against what the build tool
already holds); a build that needs an index fails with
``RuntimeEnvSetupError``.

Where each field applies: the thread plane applies ``env_vars``,
``working_dir`` and ``py_modules`` around the call (a streaming
generator's body too) and refuses ``pip``/``uv`` with
``RuntimeEnvSetupError``; the process plane leases a worker by the env's
``env_key`` (a venv's own sub-pool) and the worker applies the rest
(``worker_main._cached_runtime_env``); a task pushed to a node daemon
carries its env in the push payload and the daemon's scheduler applies
it as above.

``conda``/``container`` envs are declared but rejected loudly rather
than silently ignored.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch.exceptions import RuntimeEnvSetupError

_UNSUPPORTED = ("conda", "container")
_apply_lock = threading.Lock()


def _cache_root() -> str:
    from ray_tpu_torch._private.config import GlobalConfig

    return GlobalConfig.runtime_env_cache or \
        os.path.expanduser("~/.cache/ray_tpu_torch/runtime_envs")


def pip_env_key(pip: List[str], builder: str = "pip") -> str:
    """Content address of a requirement set (+ interpreter version +
    builder tool)."""
    h = hashlib.sha256()
    h.update(builder.encode())
    h.update(sys.version.split()[0].encode())
    for spec in sorted(pip):
        # Local paths hash by content so a rebuilt wheel busts the cache.
        if os.path.exists(spec):
            with open(spec, "rb") as f:
                h.update(f.read())
        else:
            h.update(spec.encode())
    return h.hexdigest()[:16]


def ensure_pip_env(pip: List[str], builder: str = "pip") -> str:
    """Build (or reuse) the venv for this requirement set; returns its
    python executable. Concurrent builders coordinate via flock. The
    ``uv`` builder creates/populates the venv with the uv tool."""
    import fcntl

    key = pip_env_key(pip, builder)
    root = os.path.join(_cache_root(), key)
    python = os.path.join(root, "bin", "python")
    ready = os.path.join(root, ".ready")
    if os.path.exists(ready):
        return python
    os.makedirs(_cache_root(), exist_ok=True)
    lock_path = os.path.join(_cache_root(), f"{key}.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(ready):  # lost the build race — fine
                return python
            if os.path.exists(root):
                shutil.rmtree(root, ignore_errors=True)
            if builder == "uv":
                uv = shutil.which("uv")
                if uv is None:
                    raise RuntimeEnvSetupError(
                        "runtime_env 'uv' requested but the uv tool is "
                        "not on PATH")
                subprocess.run(
                    [uv, "venv", "--offline", "--python", sys.executable,
                     root], check=True, capture_output=True, timeout=300)
            else:
                subprocess.run(
                    [sys.executable, "-m", "venv", root],
                    check=True, capture_output=True, timeout=300)
            # Inherit the driver env's packages, venv's own dir first.
            site_dir = subprocess.run(
                [python, "-c",
                 "import sysconfig; print(sysconfig.get_paths()['purelib'])"],
                check=True, capture_output=True, text=True,
                timeout=60).stdout.strip()
            parent_site = sysconfig.get_paths()["purelib"]
            with open(os.path.join(site_dir, "_parent_site.pth"), "w") as f:
                f.write(parent_site + "\n")
            if builder == "uv":
                subprocess.run(
                    [shutil.which("uv"), "pip", "install", "--quiet",
                     "--offline", "--python", python, *pip],
                    check=True, capture_output=True, timeout=600)
            else:
                subprocess.run(
                    [python, "-m", "pip", "install", "--quiet",
                     "--no-index", "--disable-pip-version-check", *pip],
                    check=True, capture_output=True, timeout=600)
            with open(ready, "w") as f:
                f.write("\n".join(sorted(pip)))
            return python
        except subprocess.CalledProcessError as e:
            shutil.rmtree(root, ignore_errors=True)
            tail = e.stderr or ""
            if isinstance(tail, bytes):
                tail = tail.decode(errors="replace")
            raise RuntimeEnvSetupError(
                f"pip runtime env build failed for {pip}: "
                f"{tail[-2000:]}") from e
        except Exception as e:
            shutil.rmtree(root, ignore_errors=True)
            raise RuntimeEnvSetupError(
                f"pip runtime env build failed for {pip}: {e!r}") from e
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


class RuntimeEnv(dict):
    def __init__(self, *, env_vars: Optional[Dict[str, str]] = None,
                 working_dir: Optional[str] = None,
                 py_modules: Optional[List[str]] = None,
                 pip: Optional[List[str]] = None,
                 uv: Optional[List[str]] = None, **kwargs):
        bad = [k for k in kwargs if k in _UNSUPPORTED]
        if bad:
            raise ValueError(
                f"runtime_env features {bad} are not supported by this "
                f"runtime (supported: env_vars, working_dir, py_modules, "
                f"pip, uv)")
        if pip and uv:
            raise ValueError(
                "runtime_env accepts 'pip' OR 'uv', not both — they "
                "describe the same venv with different builders")
        super().__init__(
            env_vars=env_vars or {}, working_dir=working_dir,
            py_modules=py_modules or [], pip=list(pip or []),
            uv=list(uv or []), **kwargs)
        self._staged_dir: Optional[str] = None
        self._env_key: Optional[str] = None

    def _specs(self):
        """(requirement specs, builder) for the venv-backed fields."""
        if self.get("uv"):
            return self["uv"], "uv"
        if self.get("pip"):
            return self["pip"], "pip"
        return None, None

    def env_key(self) -> Optional[str]:
        """Worker-binding key: tasks sharing it may share a worker
        process. Only pip/uv envs change the interpreter; the other
        fields apply per-execution inside any worker."""
        specs, builder = self._specs()
        if specs is None:
            return None
        if self._env_key is None:  # hashing local wheels reads them; cache
            self._env_key = pip_env_key(specs, builder)
        return self._env_key

    def python_executable(self) -> Optional[str]:
        """Build (lazily) and return this env's interpreter, or None when
        the default interpreter serves."""
        specs, builder = self._specs()
        if specs is None:
            return None
        return ensure_pip_env(specs, builder)

    def stage(self) -> "RuntimeEnv":
        """Copy working_dir into a session dir (content-addressed caching is
        the reference's URI scheme; local copy suffices in-process)."""
        wd = self.get("working_dir")
        if wd and self._staged_dir is None:
            dst = tempfile.mkdtemp(prefix="ray_tpu_torch_runtime_env_")
            shutil.copytree(wd, os.path.join(dst, "working_dir"))
            self._staged_dir = os.path.join(dst, "working_dir")
        return self

    @contextlib.contextmanager
    def applied(self):
        """Apply env_vars + import paths around an execution."""
        with _apply_lock:
            saved = {}
            for k, v in self.get("env_vars", {}).items():
                saved[k] = os.environ.get(k)
                os.environ[k] = str(v)
            added_paths = []
            if self._staged_dir:
                sys.path.insert(0, self._staged_dir)
                added_paths.append(self._staged_dir)
            for p in self.get("py_modules", []):
                sys.path.insert(0, p)
                added_paths.append(p)
        try:
            yield
        finally:
            with _apply_lock:
                for k, old in saved.items():
                    if old is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = old
                for p in added_paths:
                    try:
                        sys.path.remove(p)
                    except ValueError:
                        pass


def coerce_runtime_env(env: Any) -> Optional[RuntimeEnv]:
    """Accept RuntimeEnv | plain dict | None from task options."""
    if env is None:
        return None
    if isinstance(env, RuntimeEnv):
        return env
    return RuntimeEnv(**env)
