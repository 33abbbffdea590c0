"""Public chaos-engineering surface (counterpart of
``ray_tpu/util/chaos.py``).

Quickstart::

    from ray_tpu_torch.util import chaos

    # Seeded fault decisions for the whole process (or RAY_TPU_CHAOS):
    inj = chaos.install(chaos.ChaosConfig(seed=7, delay=0.2, delay_ms=5))
    ... drive the workload ...
    print(inj.counters)          # {site: {fault: count}}
    chaos.uninstall()

    # Seeded process killer during a live workload:
    with chaos.NodeKiller([chaos.popen_kill_target("daemon", proc)],
                          seed=7, interval_s=(0.2, 0.5),
                          max_kills=1) as killer:
        ... workload ...
    print(killer.kills)

``chaos.snapshot()`` (and ``util.state.chaos_summary()``) reports the
active config, per-site fault counters and every recorded kill;
all-zero when chaos never ran. ``worker_kill_target()`` SIGKILLs a
worker process of the process plane's pool, ``head_kill_target(proc)``
the head.
"""

from ray_tpu_torch._private.chaos import (  # noqa: F401
    ChaosConfig,
    ChaosController,
    ChaosInjector,
    KillTarget,
    NodeKiller,
    active,
    current,
    head_kill_target,
    install,
    install_from_env,
    pid_kill_target,
    popen_kill_target,
    snapshot,
    uninstall,
    wire_counters,
    worker_kill_target,
)

__all__ = [
    "ChaosConfig",
    "ChaosController",
    "ChaosInjector",
    "KillTarget",
    "NodeKiller",
    "active",
    "current",
    "head_kill_target",
    "install",
    "install_from_env",
    "pid_kill_target",
    "popen_kill_target",
    "snapshot",
    "uninstall",
    "wire_counters",
    "worker_kill_target",
]
