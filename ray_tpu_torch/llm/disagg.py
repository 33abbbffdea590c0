"""Disaggregated prefill/decode serving (counterpart of
``ray_tpu/llm/disagg.py``): two Serve pools, one request.

- **prefill pool** (``PrefillLLMServer``): runs chunked prefill only. A
  finished prompt's KV blocks are HELD in the engine (never freed on
  finish), packed per layer with ``PagedKVCache.export_blocks`` (host
  tensors, as the reference's payload is host arrays) and published as
  ONE object with ``ray_tpu_torch.put``. The ticket returned to the
  pairing layer carries the object ref, the first generated token
  (sampled here from the final chunk's logits, as the colocated path
  samples it) and the publication id. Blocks free on the decode side's
  ACK, or on a bounded TTL (``RAY_TPU_LLM_KV_PUBLISH_TTL_S``) when the
  ack never comes, so a dead decode replica cannot leak prefill-pool KV.
- **decode pool** (``DecodeLLMServer``): allocates the prompt's block
  table (sharing its own cached prefix blocks), pulls the payload,
  grafts it under the table (``adopt_kv``) and joins the sequence to its
  continuous batch at the decode phase, with no prompt recompute. Any
  failure on that path (a dead ticket, a pull past its timeout, a stale
  plan) falls back to a LOCAL re-prefill of the same request, counted in
  ``disagg_fallbacks``: the request always completes.

**Tail-only shipping**: the pairing layer reads the decode pool's
prefix-digest reports (what prefix-aware routing reads) and asks the
prefill replica to export only the blocks past the pool's cached
overlap. The decode replica re-validates against its OWN cache at graft
time; a stale plan is refused and falls back, and shared blocks are
never overwritten.

**Per-pool autoscaling**: the prefill pool scales on engine waitqueue
depth (``queue_depth``), the decode pool on KV blocks in use
(``kv_blocks_in_use``), each through ``AutoscalingConfig(metric=...)``.

Both pools run on the one-process runtime: a replica is an actor thread
of the calling process, the KV hop is one ``put`` and one ``get`` of
host tensors through the object store. The reference's ``_trace`` key is
parsed and not forwarded (the tracing plane is not ported).

Wiring::

    pre_app, dec_app = build_disagg_llm_app(
        EngineConfig(model=cfg), prefill_replicas=1, decode_replicas=1)
    serve.run(pre_app, name="prefill"); serve.run(dec_app, name="decode")
    h = DisaggHandle.from_deployments()
    for tok in h.stream({"prompt": [...], "max_new_tokens": 64}): ...
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, Iterator, Optional, Union

import ray_tpu_torch
from ray_tpu_torch._private.config import GlobalConfig
from ray_tpu_torch._private.log import get_logger
from ray_tpu_torch.llm.api import LLMServer
from ray_tpu_torch.llm.engine import _DONE, _ERROR, EngineConfig

log = get_logger(__name__)

__all__ = ["PrefillLLMServer", "DecodeLLMServer", "DisaggHandle",
           "build_disagg_llm_app"]


def _parse(request: Union[Dict[str, Any], list]):
    """(prompt, engine_kwargs, trace) from an LLM request dict or token
    list, the shapes ``LLMServer.__call__`` accepts."""
    if isinstance(request, dict):
        prompt = [int(t) for t in request["prompt"]]
        kwargs = {k: request[k] for k in
                  ("max_new_tokens", "eos_token_id", "temperature",
                   "seed", "priority") if k in request}
        trace = request.get("_trace")
    else:
        prompt, kwargs, trace = [int(t) for t in request], {}, None
    return prompt, kwargs, trace


class PrefillLLMServer(LLMServer):
    """Prefill-pool replica: chunked prefill, publish, ack/TTL free.

    ``prefill(request)`` is an RPC (not a stream): it runs the prompt
    through the engine with a ONE-token budget and ``hold_after_prefill``
    (the KV blocks survive the finish), publishes the exported blocks and
    returns the pairing ticket. ``ack(pub_id)`` frees the publication;
    the TTL sweep frees whatever was never pulled."""

    def __init__(self, engine_config: Optional[EngineConfig] = None,
                 params: Optional[dict] = None,
                 warm_prefix: Optional[list] = None):
        super().__init__(engine_config, params, warm_prefix)
        self._pub_lock = threading.Lock()
        # pub_id (== engine seq_id) -> (deadline_monotonic, blocks)
        self._published: Dict[int, tuple] = {}
        # Publish/ack ledger: published == acked + expired + outstanding.
        self.kv_publishes = 0
        self.kv_acks = 0
        self.kv_expiries = 0
        self.kv_blocks_published = 0
        self.kv_blocks_acked = 0
        self.kv_blocks_expired = 0
        self.kv_bytes_published = 0

    def prefill(self, request: Union[Dict[str, Any], list]
                ) -> Dict[str, Any]:
        """Run ONE prompt's chunked prefill and publish its KV. The
        request dict may carry ``_skip_blocks`` (the pairing layer's
        tail-skip plan): leading blocks the decode pool already caches
        are not shipped. Returns the ticket ``{"ref", "first_token",
        "pub_id", "start_block", "blocks", "block_size", "bytes"}``."""
        self._expire_published()
        prompt, kwargs, _trace = _parse(request)
        skip = 0
        if isinstance(request, dict):
            skip = max(0, int(request.get("_skip_blocks", 0)))
        # The whole completion budget stays on the decode side; here
        # only the first token (from the final chunk's logits) matters.
        kwargs["max_new_tokens"] = 1
        req = self.engine.submit(prompt, hold_after_prefill=True, **kwargs)
        first: Optional[int] = None
        while True:
            item = req.output_queue.get(
                timeout=float(GlobalConfig.llm_disagg_prefill_timeout_s))
            if isinstance(item, tuple):
                kind, payload = item
                if kind == _ERROR:
                    raise payload
                break
            first = item
        # A prompt whose first token is not held (shed, cancelled) never
        # publishes; the typed error above already surfaced it.
        table_len = len(self.engine.cache.table(req.seq_id))
        start_block = min(skip, max(0, table_len - 1))
        payload = self.engine.cache.export_blocks(
            req.seq_id, start_block=start_block)
        ref = ray_tpu_torch.put(payload)
        nbytes = sum(
            int(getattr(part.get(name), "nbytes", 0))
            for part in (payload, *payload.get("aux", {}).values())
            for name in ("k", "v"))
        deadline = time.monotonic() + float(
            GlobalConfig.llm_kv_publish_ttl_s)
        with self._pub_lock:
            self._published[req.seq_id] = (deadline, payload["blocks"])
            self.kv_publishes += 1
            self.kv_blocks_published += payload["blocks"]
            self.kv_bytes_published += nbytes
        return {
            "ref": ref,
            "first_token": first,
            "pub_id": req.seq_id,
            "start_block": payload["start_block"],
            "blocks": payload["blocks"],
            "block_size": payload["block_size"],
            "bytes": nbytes,
        }

    def ack(self, pub_id: int) -> int:
        """Decode-side acknowledgment: the payload was pulled and
        grafted, free the held blocks NOW (not at the TTL). Idempotent;
        returns blocks freed."""
        with self._pub_lock:
            ent = self._published.pop(int(pub_id), None)
            if ent is not None:
                self.kv_acks += 1
                self.kv_blocks_acked += ent[1]
        freed = self.engine.release_held(int(pub_id))
        self._expire_published()
        return freed

    def _expire_published(self) -> int:
        """TTL sweep (lazy: runs on prefill, ack and stats, and through
        the public ``expire_published``): free publications never acked
        by their deadline."""
        now = time.monotonic()
        expired = []
        with self._pub_lock:
            for pub_id, (deadline, blocks) in list(
                    self._published.items()):
                if now >= deadline:
                    self._published.pop(pub_id)
                    expired.append(pub_id)
                    self.kv_expiries += 1
                    self.kv_blocks_expired += blocks
        return sum(self.engine.release_held(p) for p in expired)

    def expire_published(self) -> int:
        return self._expire_published()

    # ------------------------------------------------- replica telemetry
    def stats(self) -> Dict[str, Any]:
        self._expire_published()
        out = super().stats()
        with self._pub_lock:
            out.update({
                "kv_publishes": self.kv_publishes,
                "kv_acks": self.kv_acks,
                "kv_expiries": self.kv_expiries,
                "kv_blocks_published": self.kv_blocks_published,
                "kv_blocks_acked": self.kv_blocks_acked,
                "kv_blocks_expired": self.kv_blocks_expired,
                "kv_bytes_published": self.kv_bytes_published,
                "kv_publications_outstanding": len(self._published),
            })
        return out


class DecodeLLMServer(LLMServer):
    """Decode-pool replica: adopt remote prefills, stream tokens.

    A request dict carrying ``_disagg`` (the prefill ticket) takes the
    adoption path (pull, graft, join the batch at decode); anything that
    fails on it falls back to a LOCAL re-prefill of the same request. A
    plain request decodes colocated, so the pool is also the fallback
    target of the pairing layer."""

    def __init__(self, engine_config: Optional[EngineConfig] = None,
                 params: Optional[dict] = None,
                 warm_prefix: Optional[list] = None):
        super().__init__(engine_config, params, warm_prefix)
        self.disagg_adopted = 0
        self.disagg_fallbacks = 0

    def __call__(self, request: Union[Dict[str, Any], list]
                 ) -> Iterator[int]:
        if isinstance(request, dict) and request.get("_disagg"):
            yield from self._adopted_stream(request)
            return
        yield from super().__call__(request)

    def _adopted_stream(self, request: Dict[str, Any]) -> Iterator[int]:
        ticket = request["_disagg"]
        prompt, kwargs, _trace = _parse(request)
        req = self.engine.begin_adopted(prompt, **kwargs)
        if req is not None:
            # The remote prefill is done when the ticket lands here: from
            # this stamp to the graft is the TRANSFER phase of the TTFT
            # decomposition.
            req.t_prefill_done = time.monotonic()
            payload = None
            try:
                payload = ray_tpu_torch.get(
                    ticket["ref"],
                    timeout=float(GlobalConfig.llm_disagg_pull_timeout_s))
            except Exception as exc:  # noqa: BLE001 — typed fallback
                log.debug("disagg pull failed (publisher %r): %r; "
                          "re-prefilling locally", ticket.get("pub_id"),
                          exc)
            if (payload is None or ticket.get("first_token") is None
                    or not self.engine.adopt_kv(req, payload)):
                self.engine.abort_adopted(req)
                req = None
        if req is None:
            # Transparent re-prefill: the SAME request runs the colocated
            # path on this replica (prefill and decode here).
            self.disagg_fallbacks += 1
            plain = {k: v for k, v in request.items() if k != "_disagg"}
            yield from super().__call__(plain)
            return
        self.disagg_adopted += 1
        self.engine.commit_adopted(req, ticket["first_token"])
        try:
            while True:
                item = req.output_queue.get(timeout=120.0)
                if isinstance(item, tuple):
                    kind, payload = item
                    if kind == _DONE:
                        return
                    raise payload  # _ERROR
                if self.first_token_monotonic is None:
                    self.first_token_monotonic = time.monotonic()
                yield item
        finally:
            # A stream closed mid-generation frees the adopted sequence's
            # blocks like any cancelled request.
            if not req.finished():
                self.engine.cancel(req)

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        out.update({
            "disagg_adopted": self.disagg_adopted,
            "disagg_fallbacks": self.disagg_fallbacks,
        })
        return out


class DisaggHandle:
    """Driver-side pairing layer: one ``stream()`` call is one prefill
    RPC, one decode stream and one ack to the exact publisher.

    The two hops route through the live routers, so each pool's
    autoscaling and replica replacement apply per hop; the ack is NOT
    routed: it goes to the replica that published (the response's
    replica binding), because no other replica knows the publication
    (the TTL covers a lost ack).

    Failure ladder, each rung transparent to the caller: the prefill RPC
    fails or times out -> a colocated call on the decode pool; the
    ticket's payload cannot be pulled or the plan is stale -> the decode
    replica re-prefills locally."""

    def __init__(self, prefill_handle, decode_handle,
                 decode_deployment: str = "llm-decode"):
        self._prefill = prefill_handle.options(method_name="prefill",
                                               stream=False)
        self._decode = decode_handle.options(stream=True)
        self._decode_name = decode_deployment
        self.paired = 0
        self.prefill_fallbacks = 0

    @classmethod
    def from_deployments(cls, prefill: str = "llm-prefill",
                         decode: str = "llm-decode") -> "DisaggHandle":
        from ray_tpu_torch import serve

        return cls(serve.get_deployment_handle(prefill),
                   serve.get_deployment_handle(decode),
                   decode_deployment=decode)

    def _plan_skip_blocks(self, prompt, block_size: int) -> int:
        """Tail-skip plan: leading blocks the decode pool's advertised
        prefix caches already hold, capped one short of the full prompt
        (the last prompt position is always recomputed for its logits).
        Advisory: the decode replica re-validates at graft time."""
        try:
            from ray_tpu_torch.serve.controller import (
                get_or_create_controller,
            )

            rs = get_or_create_controller()._replica_set(self._decode_name)
            overlap = rs.plan_prefix(prompt)
        except Exception:  # noqa: BLE001 — the plan is best-effort
            return 0
        return min(overlap, len(prompt) - 1) // max(1, block_size)

    def stream(self, request: Union[Dict[str, Any], list]
               ) -> Iterator[int]:
        """Stream one request through the pair. Yields token ids; the
        first was computed by the prefill pool, every later one by the
        decode pool."""
        if not isinstance(request, dict):
            request = {"prompt": [int(t) for t in request]}
        ticket = None
        publisher = None
        try:
            resp = self._prefill.remote(dict(request))
            # Take the serving replica BEFORE result() releases the
            # router slot (and with it the response's replica binding):
            # the ack must reach the exact publisher.
            publisher = resp._replica
            ticket = resp.result(timeout=float(
                GlobalConfig.llm_disagg_prefill_timeout_s))
        except Exception as exc:  # noqa: BLE001 — typed fallback
            log.debug("disagg prefill hop failed: %r; colocated fallback "
                      "on the decode pool", exc)
            ticket, publisher = None, None
        if ticket is None:
            self.prefill_fallbacks += 1
            yield from self._decode.remote(dict(request))
            return
        self.paired += 1
        gen = self._decode.remote({**request, "_disagg": ticket})
        # The first token rides the ticket: hand it to the client NOW,
        # before the decode hop. The decode stream re-emits it as its
        # first item (adopted: commit_adopted streams it; fallback: the
        # local re-prefill regenerates it), so that item is swallowed as
        # the adoption's confirmation instead of yielded twice.
        yield int(ticket["first_token"])
        acked = False
        try:
            for tok in gen:
                if not acked:
                    # The first streamed token proves the decode side is
                    # past the graft (or committed to its fallback): the
                    # publication can free now.
                    acked = True
                    self._ack(publisher, ticket["pub_id"])
                    continue
                yield tok
        finally:
            if not acked:
                # No first token (dead decode replica, caller closed
                # early): still free eagerly; the TTL is the backstop.
                self._ack(publisher, ticket["pub_id"])

    def stream_planned(self, request: Dict[str, Any],
                       block_size: int) -> Iterator[int]:
        """``stream()`` with the tail-skip plan computed BEFORE the
        prefill hop (it needs the pool's block size): the prefill replica
        then ships only the blocks past the decode pool's cached
        overlap."""
        prompt = [int(t) for t in request["prompt"]]
        skip = self._plan_skip_blocks(prompt, block_size)
        yield from self.stream({**request, "_skip_blocks": skip})

    @staticmethod
    def _ack(publisher, pub_id) -> None:
        if publisher is None:
            return
        try:
            publisher.handle_request.remote("ack", (pub_id,), {})
        except Exception:  # noqa: BLE001 — the TTL is the backstop
            pass


def build_disagg_llm_app(engine_config: Optional[EngineConfig] = None,
                         *,
                         prefill_name: str = "llm-prefill",
                         decode_name: str = "llm-decode",
                         prefill_replicas: int = 1,
                         decode_replicas: int = 1,
                         prefill_autoscaling: Optional[dict] = None,
                         decode_autoscaling: Optional[dict] = None,
                         max_ongoing_requests: Optional[int] = None,
                         params: Optional[dict] = None,
                         warm_prefix: Optional[list] = None,
                         decode_engine_config: Optional[
                             EngineConfig] = None,
                         ray_actor_options: Optional[dict] = None):
    """Build the (prefill_app, decode_app) pair. Run both with
    ``serve.run`` and pair them with ``DisaggHandle.from_deployments``.

    The prefill pool's engine never speculates (its requests are one
    token long): a spec-configured ``engine_config`` is stripped to
    vanilla for the prefill deployment and kept (or replaced by
    ``decode_engine_config``) for the decode pool.

    Per-pool autoscaling: a ``*_autoscaling`` dict (forwarded to
    ``AutoscalingConfig``) defaults its metric to WAITQUEUE DEPTH for the
    prefill pool and KV BLOCKS IN USE for the decode pool."""
    from ray_tpu_torch import serve

    engine_config = engine_config or EngineConfig()
    pre_cfg = engine_config
    if pre_cfg.spec_k or pre_cfg.draft_model is not None:
        pre_cfg = dataclasses.replace(pre_cfg, spec_k=0, draft_model=None)
    dec_cfg = decode_engine_config or engine_config
    if prefill_autoscaling is not None:
        prefill_autoscaling = dict(prefill_autoscaling)
        prefill_autoscaling.setdefault("metric", "queue_depth")
    if decode_autoscaling is not None:
        decode_autoscaling = dict(decode_autoscaling)
        decode_autoscaling.setdefault("metric", "kv_blocks_in_use")
    pre_dep = serve.deployment(
        PrefillLLMServer, name=prefill_name,
        num_replicas=prefill_replicas,
        autoscaling_config=prefill_autoscaling,
        max_ongoing_requests=max_ongoing_requests,
        ray_actor_options=ray_actor_options)
    dec_dep = serve.deployment(
        DecodeLLMServer, name=decode_name,
        num_replicas=decode_replicas,
        autoscaling_config=decode_autoscaling,
        max_ongoing_requests=max_ongoing_requests,
        ray_actor_options=ray_actor_options)
    return (pre_dep.bind(pre_cfg, params, warm_prefix),
            dec_dep.bind(dec_cfg, params, warm_prefix))
