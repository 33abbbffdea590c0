"""LLM serving of the PyTorch/CUDA port (counterpart of ``ray_tpu/llm``):
continuous batching over the flagship transformer with a paged KV cache,
copy-on-write prefix caching and chunked prefill.

- ``PagedKVCache`` (kv_cache.py): block pool, block tables, refcounted
  shared prefix blocks.
- ``Scheduler`` (scheduler.py): bounded waitqueue with load shedding,
  chunked prefill, recompute eviction.
- ``InferenceEngine`` (engine.py): the prefill-chunk/decode step loop
  with streaming per-request token queues.
"""

from ray_tpu_torch.exceptions import KVCacheOOM
from ray_tpu_torch.llm.engine import EngineConfig, InferenceEngine
from ray_tpu_torch.llm.kv_cache import PagedKVCache, chain_digests
from ray_tpu_torch.llm.scheduler import EngineQueueFull, Request, Scheduler

__all__ = [
    "EngineConfig",
    "EngineQueueFull",
    "InferenceEngine",
    "KVCacheOOM",
    "PagedKVCache",
    "Request",
    "Scheduler",
    "chain_digests",
]
