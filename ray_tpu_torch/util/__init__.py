"""ray_tpu_torch.util (counterpart of ``ray_tpu.util``): device
profiling. The runtime's utilities (placement groups, pub/sub) wait for
the runtime (ROADMAP A.5)."""

from ray_tpu_torch.util.profiling import annotate, profile_trace, trace_files

__all__ = ["annotate", "profile_trace", "trace_files"]
