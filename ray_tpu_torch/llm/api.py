"""Serve-facing LLM API (counterpart of ``ray_tpu/llm/api.py``):
``build_llm_app`` wraps the inference engine in a streaming Serve
deployment.

``build_llm_app(EngineConfig(...))`` returns a Serve Application whose
replicas each own one ``InferenceEngine``. Requests stream: the replica
handler is a generator, so ``handle.options(stream=True)`` (and the HTTP
proxy's ``?stream=1`` chunked path) deliver each token as the engine's
iteration commits it. Closing the stream cancels the replica generator
between yields, which unwinds into the engine's generator and frees the
sequence's KV blocks at once.

An open token stream counts as one ongoing request on its replica until
exhausted or closed, so a deployment built with ``autoscaling_config=``
scales up under streaming load. Every replica exposes
``prefix_digest()``, the chain digests of its cached KV blocks; the
Serve controller polls it off the request path and the router scores
replicas by cached-prefix overlap with each prompt. The reference's
replica-init span and the request dict's ``_trace`` key wait for the
tracing plane, which is not ported.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterator, Optional, Union

from ray_tpu_torch.llm.engine import EngineConfig, InferenceEngine

__all__ = ["build_llm_app", "LLMServer"]


class LLMServer:
    """Replica class: one engine, streaming ``__call__``.

    A request is either a token list (``[1, 2, 3]``) or a dict
    ``{"prompt": [...], "max_new_tokens": n, "temperature": t,
    "eos_token_id": e, "seed": s, "priority": p}``. Yields one int token
    id per generated token. ``priority`` (0 = most important, default)
    feeds the engine's load-shedding admission.
    """

    def __init__(self, engine_config: Optional[EngineConfig] = None,
                 params: Optional[dict] = None,
                 warm_prefix: Optional[list] = None):
        self.init_started_monotonic = time.monotonic()
        self.first_token_monotonic: Optional[float] = None
        self.warmed_prefix_tokens = 0
        self.engine = InferenceEngine(engine_config, params=params)
        if warm_prefix:
            # Prefill the shared prompt ONCE at replica start, so it
            # registers as shared blocks before the first request and the
            # controller's next prefix_digest poll advertises it.
            tokens = [int(t) for t in warm_prefix]
            for _ in self.engine.generate(tokens, max_new_tokens=1):
                pass
            self.warmed_prefix_tokens = len(tokens)
        self.ready_monotonic = time.monotonic()

    def __call__(self, request: Union[Dict[str, Any], list]
                 ) -> Iterator[int]:
        if isinstance(request, dict):
            prompt = request["prompt"]
            kwargs = {k: request[k] for k in
                      ("max_new_tokens", "eos_token_id", "temperature",
                       "seed", "priority") if k in request}
        else:
            prompt, kwargs = request, {}
        # A cancelled stream raises GeneratorExit through here; the
        # engine generator's finally-cancel frees the KV blocks.
        for tok in self.engine.generate([int(t) for t in prompt],
                                        **kwargs):
            if self.first_token_monotonic is None:
                self.first_token_monotonic = time.monotonic()
            yield tok

    # ------------------------------------------------- replica telemetry
    def queue_depth(self) -> int:
        return self.engine.queue_depth()

    def autoscale_metric(self, name: str) -> float:
        """Custom autoscaling signal by name: ``queue_depth`` (prompts
        parked behind compute) or ``kv_blocks_in_use``. Unknown names
        read 0.0."""
        if name == "queue_depth":
            return float(self.engine.queue_depth())
        if name == "kv_blocks_in_use":
            return float(self.engine.cache.stats()["blocks_in_use"])
        return 0.0

    def stats(self) -> Dict[str, Any]:
        out = dict(self.engine.stats())
        out.update({
            "init_started_monotonic": self.init_started_monotonic,
            "ready_monotonic": self.ready_monotonic,
            "first_token_monotonic": self.first_token_monotonic,
            "warmed_prefix_tokens": self.warmed_prefix_tokens,
        })
        return out

    def prefix_digest(self) -> Dict[str, Any]:
        """Compact cached-prefix report: the chain digests of every
        registered KV block on this replica, and the block size they
        chain over."""
        digests = self.engine.cache.prefix_digest()
        cap = 8192  # bound the report; truncation is REPORTED
        return {
            "block_size": self.engine.cache.block_size,
            "digests": digests[:cap],
            "truncated": max(0, len(digests) - cap),
        }

    def shutdown(self) -> None:
        """Stop the engine (cancel what runs, join its step loop); the
        Serve controller calls it before it kills the replica."""
        self.engine.shutdown()


def build_llm_app(engine_config: Optional[EngineConfig] = None, *,
                  name: str = "llm", num_replicas: int = 1,
                  autoscaling_config: Optional[dict] = None,
                  max_ongoing_requests: Optional[int] = None,
                  params: Optional[dict] = None,
                  warm_prefix: Optional[list] = None,
                  ray_actor_options: Optional[dict] = None):
    """Build a Serve Application serving ``engine_config``.

    Every replica constructs its own engine; with ``params=None`` the
    weights init from ``engine_config.param_seed`` in the replica, so
    all replicas serve identical weights; ``params`` (a tree on any
    device) is moved to the engine's device once per replica. Deploy
    with ``serve.run(app)`` and stream through
    ``handle.options(stream=True).remote({...})`` or
    ``POST /<name>?stream=1``.

    ``max_ongoing_requests`` bounds total in-flight requests across the
    deployment (lower priority classes shed first with a typed
    ``RequestSheddedError`` / HTTP 503 + Retry-After). ``warm_prefix``
    (a token list, typically the shared system prompt) is prefilled by
    every new replica at construction.
    """
    from ray_tpu_torch import serve

    dep = serve.deployment(
        LLMServer, name=name, num_replicas=num_replicas,
        autoscaling_config=autoscaling_config,
        max_ongoing_requests=max_ongoing_requests,
        ray_actor_options=ray_actor_options)
    return dep.bind(engine_config, params, warm_prefix)
