"""Runtime context: introspection of the current worker/task (copy of
``ray_tpu/runtime_context.py``)."""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private import worker as _worker_mod


class RuntimeContext:
    @property
    def job_id(self):
        return _worker_mod.global_worker().job_id

    @property
    def node_id(self):
        return _worker_mod.global_worker().node_id

    @property
    def worker_id(self):
        return _worker_mod.global_worker().worker_id

    def get_task_id(self) -> Optional[str]:
        tid = getattr(_worker_mod._task_context, "current_task_id", None)
        return tid.hex() if tid is not None else None

    def get_task_name(self) -> Optional[str]:
        return getattr(_worker_mod._task_context, "task_name", None)

    def get_node_id(self) -> str:
        return self.node_id.hex()

    def get_job_id(self) -> str:
        return self.job_id.hex()

    @property
    def was_current_actor_reconstructed(self) -> bool:
        return False

    def get_assigned_resources(self):
        return _worker_mod.global_worker().resource_pool.available()


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext()
