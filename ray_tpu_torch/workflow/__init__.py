"""ray_tpu_torch.workflow: durable workflows that survive their driver's
death (counterpart of ``ray_tpu/workflow``).

A workflow is a DAG of ``@workflow.step`` functions run as tasks on the
one-process runtime, each step's output committed to a
``WorkflowStorage`` (a local directory, or ``memory://`` in the
runtime's KV) before its dependents run. Kill -9 the driver mid-run,
and ``workflow.resume(workflow_id)`` from another process replays the
journal, skips the committed steps (exactly once, by the marker's
exclusive create) and runs only the rest; ``resume_all()`` sweeps every
interrupted workflow. Durable virtual actors snapshot named stateful
objects through the same storage.

Steps and their values are pickled with ``cloudpickle`` where it
imports, else with the standard library's ``pickle``, as in the
reference. Without ``cloudpickle`` a step resumed from another process
must be defined at module level (a step defined inside a function works
for a rerun or resume in the process that ran it;
``workflow/storage.py``).

    from ray_tpu_torch import workflow

    @workflow.step
    def fetch(): ...
    @workflow.step(max_retries=3, backoff_s=0.5)
    def train(data): ...

    dag = train.bind(fetch.bind())
    workflow.run(dag, workflow_id="nightly", storage="/data/workflows")
    # after a crash, from any process:
    workflow.resume("nightly", storage="/data/workflows")
"""

from ray_tpu_torch.workflow.api import (
    FAILED,
    RUNNING,
    SUCCESS,
    StepNode,
    WorkflowStepFunction,
    delete,
    get_metadata,
    get_output,
    get_status,
    init,
    list_all,
    resume,
    resume_all,
    run,
    run_async,
    step,
)
from ray_tpu_torch.workflow.storage import WorkflowStorage
from ray_tpu_torch.workflow.virtual_actor import (
    VirtualActorClass,
    VirtualActorHandle,
    virtual_actor,
)

__all__ = [
    "FAILED", "RUNNING", "SUCCESS", "StepNode", "VirtualActorClass",
    "VirtualActorHandle", "WorkflowStepFunction", "WorkflowStorage",
    "delete", "get_metadata", "get_output", "get_status", "init",
    "list_all", "resume", "resume_all", "run", "run_async", "step",
    "virtual_actor",
]
