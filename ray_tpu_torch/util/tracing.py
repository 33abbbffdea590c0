"""Public surface of the tracing plane (counterpart of
``ray_tpu/util/tracing.py``; the implementation is
``ray_tpu_torch._private.tracing``).

Quickstart::

    RAY_TPU_TRACE=1 python my_driver.py     # armed at init()

    import ray_tpu_torch
    from ray_tpu_torch.util import tracing
    with tracing.start_span("my.request") as span:
        ref = f.remote(x)                   # the context rides the task
        ray_tpu_torch.get(ref)
    summary = ray_tpu_torch.util.state.trace_summary(span.ctx.trace_id)
    ray_tpu_torch.timeline(trace_id=span.ctx.trace_id,
                           filename="trace.json")

Off by default: with ``RAY_TPU_TRACE`` unset every instrumentation point
is one module-global ``is None`` branch: zero spans, no payload keys.
"""

from ray_tpu_torch._private.tracing import (  # noqa: F401
    TraceContext,
    Tracer,
    active,
    begin,
    chrome_trace,
    current_context,
    event,
    extract,
    finish,
    inject,
    install,
    install_from_env,
    local_spans,
    new_trace,
    start_span,
    tracer,
    uninstall,
    use_context,
)

__all__ = [
    "TraceContext", "Tracer", "active", "begin", "chrome_trace",
    "current_context", "event", "extract", "finish", "inject",
    "install", "install_from_env", "local_spans", "new_trace",
    "start_span", "tracer", "uninstall", "use_context",
]
