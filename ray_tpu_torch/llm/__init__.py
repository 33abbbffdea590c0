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
  of a disaggregated hop.
- ``build_llm_app`` / ``LLMServer`` (api.py): the engine as a Serve
  deployment; token streams ride ``handle.options(stream=True)`` and the
  HTTP proxy's chunked path, a closed stream frees its sequence, and
  replicas report prefix digests the Serve router scores.
- ``build_disagg_llm_app`` / ``PrefillLLMServer`` / ``DecodeLLMServer`` /
  ``DisaggHandle`` (disagg.py): disaggregated serving, a prefill pool that
  publishes each prompt's KV blocks and a decode pool that grafts them and
  streams, with the publish/ack/TTL ledger, tail-only shipping and a
  counted local re-prefill fallback.
"""

from ray_tpu_torch.exceptions import KVCacheOOM
from ray_tpu_torch.llm.api import LLMServer, build_llm_app
from ray_tpu_torch.llm.disagg import (
    DecodeLLMServer,
    DisaggHandle,
    PrefillLLMServer,
    build_disagg_llm_app,
)
from ray_tpu_torch.llm.engine import EngineConfig, InferenceEngine, live_engines
from ray_tpu_torch.llm.kv_cache import PagedKVCache, chain_digests
from ray_tpu_torch.llm.scheduler import EngineQueueFull, Request, Scheduler

__all__ = [
    "DecodeLLMServer",
    "DisaggHandle",
    "EngineConfig",
    "EngineQueueFull",
    "InferenceEngine",
    "KVCacheOOM",
    "LLMServer",
    "PagedKVCache",
    "PrefillLLMServer",
    "Request",
    "Scheduler",
    "build_disagg_llm_app",
    "build_llm_app",
    "chain_digests",
    "live_engines",
]
