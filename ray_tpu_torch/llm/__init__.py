"""LLM serving of the PyTorch/CUDA port (counterpart of ``ray_tpu/llm``):
continuous batching over the flagship transformer with a paged KV cache,
copy-on-write prefix caching, chunked prefill, speculative decoding and
the engine side of disaggregated prefill/decode.

- ``PagedKVCache`` (kv_cache.py): block pool, block tables, refcounted
  shared prefix blocks, aux pools riding the same tables (the draft
  model's cache), and block export/graft for shipping KV between
  engines.
- ``Scheduler`` (scheduler.py): bounded waitqueue with load shedding,
  chunked prefill, recompute eviction, adoption of sequences prefilled
  elsewhere.
- ``InferenceEngine`` (engine.py): the prefill-chunk/decode step loop
  with streaming per-request token queues; ``tp_size`` serves
  tensor-parallel over a one-controller mesh (the pool held per shard);
  ``spec_k``/``draft_model`` arm speculative decoding; ``hold_after_prefill`` and
  ``begin_adopted``/``adopt_kv``/``commit_adopted`` are the two halves
  of a disaggregated hop (the servers of ``llm/disagg.py`` are not
  ported).
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
