"""Device profiling (counterpart of ``ray_tpu/util/profiling.py``, which
captures XLA traces with ``jax.profiler``): ``torch.profiler`` traces.

``profile_trace`` records everything inside its block, the host's
operators and, on the card, every kernel the device ran (CUPTI), and
writes a Chrome trace (``*.pt.trace.json``, loadable in Perfetto or
``chrome://tracing``) into ``logdir``. ``annotate`` nests a named span
into that trace, so a framework phase (a train step, a DAG wave) can be
found in the device view. ``trace_files`` lists what captures wrote.

One profiler runs in a process at a time: ``profile_trace`` refuses to
start inside another, and stops and writes its own in a ``finally``
block, so a failure inside the block never leaves the profiler running.
Registering the trace with the flight recorder's debug bundles waits for
the flight recorder, which is not ported (ROADMAP A.5).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ray_tpu_torch.device import resolve_device

TRACE_SUFFIX = ".pt.trace.json"


@contextlib.contextmanager
def profile_trace(logdir: str, host_tracer_level: Optional[int] = None,
                  device="cuda") -> Iterator[str]:
    """Capture a trace of the block into ``logdir`` (yielded): the host's
    activity, and the card's when ``device`` is a CUDA device.
    ``host_tracer_level`` is the reference's XLA host-tracer verbosity;
    ``torch.profiler`` has no counterpart, so it is accepted and unused.
    Raises RuntimeError if a profiler is already active."""
    del host_tracer_level
    dev = resolve_device(device)
    if torch._C._autograd._profiler_enabled():
        raise RuntimeError("a profiler is already active in this process; "
                           "profile_trace does not nest")
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}{TRACE_SUFFIX}"))


def annotate(name: str):
    """A named span inside an active trace (``record_function``)."""
    return record_function(name)


def trace_files(logdir: str) -> List[str]:
    """The Chrome trace files that captures wrote under ``logdir``."""
    out = []
    for root, _dirs, files in os.walk(logdir):
        for f in files:
            if f.endswith(TRACE_SUFFIX):
                out.append(os.path.join(root, f))
    return sorted(out)
