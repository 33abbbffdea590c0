"""Job submission (counterpart of ``ray_tpu/job_submission.py``): a local
job manager that runs each entrypoint as a subprocess driver (a shell
command), with its status, its combined stdout/stderr log, stop and a
log tail.

``submit_job(runtime_env=...)`` applies the env's ``env_vars`` to the
driver's environment and runs it in ``working_dir`` (default: this
process's working directory); the driver attaches to a cluster itself
(``ray_tpu_torch.init(address=...)``). Logs go to
``~/.cache/ray_tpu_torch/jobs/<job_id>.log``. Every driver process is
reaped by its own reaper thread, which sets the final status
(``SUCCEEDED`` on exit code 0, else ``FAILED``; ``STOPPED`` after
``stop_job``).
"""

from __future__ import annotations

import os
import signal
import subprocess
import threading
import time
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional


def _signal_group(proc: subprocess.Popen, sig) -> None:
    try:
        os.killpg(proc.pid, sig)
    except (ProcessLookupError, PermissionError):
        pass


class JobStatus(str, Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"


@dataclass
class JobInfo:
    job_id: str
    entrypoint: str
    status: JobStatus
    start_time: float
    end_time: Optional[float] = None
    return_code: Optional[int] = None
    metadata: Dict[str, str] = field(default_factory=dict)


class JobSubmissionClient:
    """Local job manager: runs entrypoints as subprocess drivers with
    captured logs under the session dir."""

    def __init__(self, address: Optional[str] = None):
        self._jobs: Dict[str, JobInfo] = {}
        self._procs: Dict[str, subprocess.Popen] = {}
        self._logs_dir = os.path.join(
            os.path.expanduser("~"), ".cache", "ray_tpu_torch", "jobs")
        os.makedirs(self._logs_dir, exist_ok=True)
        self._lock = threading.Lock()

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[dict] = None,
                   metadata: Optional[Dict[str, str]] = None,
                   submission_id: Optional[str] = None) -> str:
        job_id = submission_id or f"raytpu_job_{uuid.uuid4().hex[:10]}"
        env = dict(os.environ)
        if runtime_env and runtime_env.get("env_vars"):
            env.update({k: str(v)
                        for k, v in runtime_env["env_vars"].items()})
        cwd = (runtime_env or {}).get("working_dir") or os.getcwd()
        log_path = os.path.join(self._logs_dir, f"{job_id}.log")
        log_f = open(log_path, "wb")
        # A session of its own: stop_job signals the whole group, the
        # shell and the driver it runs.
        proc = subprocess.Popen(
            entrypoint, shell=True, cwd=cwd, env=env,
            stdout=log_f, stderr=subprocess.STDOUT,
            start_new_session=True)
        info = JobInfo(job_id=job_id, entrypoint=entrypoint,
                       status=JobStatus.RUNNING, start_time=time.time(),
                       metadata=metadata or {})
        with self._lock:
            self._jobs[job_id] = info
            self._procs[job_id] = proc

        def reap():
            rc = proc.wait()
            log_f.close()
            with self._lock:
                info.end_time = time.time()
                info.return_code = rc
                if info.status != JobStatus.STOPPED:
                    info.status = (JobStatus.SUCCEEDED if rc == 0
                                   else JobStatus.FAILED)

        threading.Thread(target=reap, daemon=True,
                         name=f"ray_tpu_torch_job_reaper_{job_id}").start()
        return job_id

    def get_job_status(self, job_id: str) -> JobStatus:
        with self._lock:
            return self._jobs[job_id].status

    def get_job_info(self, job_id: str) -> JobInfo:
        with self._lock:
            return self._jobs[job_id]

    def get_job_logs(self, job_id: str) -> str:
        path = os.path.join(self._logs_dir, f"{job_id}.log")
        if not os.path.exists(path):
            return ""
        with open(path, "rb") as f:
            return f.read().decode(errors="replace")

    def list_jobs(self) -> List[JobInfo]:
        with self._lock:
            return list(self._jobs.values())

    def stop_job(self, job_id: str) -> bool:
        with self._lock:
            proc = self._procs.get(job_id)
            info = self._jobs.get(job_id)
        if proc is None or proc.poll() is not None:
            return False
        with self._lock:
            info.status = JobStatus.STOPPED
        _signal_group(proc, signal.SIGTERM)
        try:
            proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            _signal_group(proc, signal.SIGKILL)
            proc.wait(timeout=5)
        return True

    def tail_job_logs(self, job_id: str):
        """Generator yielding log chunks until the job finishes."""
        path = os.path.join(self._logs_dir, f"{job_id}.log")
        pos = 0
        while True:
            if os.path.exists(path):
                with open(path, "rb") as f:
                    f.seek(pos)
                    chunk = f.read()
                    pos = f.tell()
                if chunk:
                    yield chunk.decode(errors="replace")
            status = self.get_job_status(job_id)
            if status in (JobStatus.SUCCEEDED, JobStatus.FAILED,
                          JobStatus.STOPPED):
                break
            time.sleep(0.2)
