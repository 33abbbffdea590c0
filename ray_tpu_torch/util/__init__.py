"""ray_tpu_torch.util (counterpart of ``ray_tpu.util``): device
profiling; ``tracing``, ``metrics`` and ``state`` (the observability
plane) are its submodules. The runtime's other utilities (placement
groups, pub/sub, the sanitizer, chaos) are not ported yet (ROADMAP A)."""

from ray_tpu_torch.util.profiling import annotate, profile_trace, trace_files

__all__ = ["annotate", "profile_trace", "trace_files"]
