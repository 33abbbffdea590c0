"""Continuous-batching inference engine over the flagship transformer
(counterpart of ``ray_tpu/llm/engine.py``; vLLM's LLMEngine role).

One ``InferenceEngine`` owns a paged KV cache pool (copy-on-write shared
prefix blocks), a continuous-batching scheduler (chunked prefill) and two
programs over ``models.transformer``:

- ``prefill_chunk``: prompt slices, padded to a (batch, chunk) bucket,
  write their K/V into their blocks; a slice that completes its prompt
  yields the request's first token. Prefix-cache hits start the first
  chunk at the cached length.
- ``decode_step``: every fully-prefilled sequence advances one token per
  iteration (Orca's iteration-level batching).

Speculative decoding (``spec_k > 0`` with a ``draft_model``): a small
draft model proposes ``spec_k`` greedy tokens per sequence, its KV riding
the same block tables as the cache's aux pool ``"draft"``, and the
flagship scores them in one ``verify_step``; the longest agreeing prefix
plus one bonus token commits, token for token what greedy decode gives.
A round with a sampled row, or whose lookahead slots fail to allocate,
runs vanilla decode instead and is counted in ``spec_fallback_rounds``.

Disaggregated serving, the engine side: ``hold_after_prefill`` keeps a
finished request's blocks for ``PagedKVCache.export_blocks`` until
``release_held``; a decode engine adopts the payload with
``begin_adopted`` / ``adopt_kv`` / ``commit_adopted``.

Padding buckets are powers of two. Padded rows aim at the NULL block and
their logits are ignored; attention masks every slot past a sequence's
context, so a sequence's tokens are the same whatever batch it shares an
iteration with (the concurrent-equals-sequential invariant).

The reference jits both programs with the pool donated; here they run
eagerly and update the pool tensors in place. Logits come to the host
once per step (``.cpu()``), the step's one sync, and sampling stays on
the host in numpy so seeded sampling matches the reference. A spec round
keeps its argmaxes on the device (``torch.argmax`` returns the first
maximal index, as ``np.argmax`` does) and syncs once, for the proposals
and the verify argmaxes together.

Tensor parallelism (``tp_size > 1``): the engine builds a tp-only mesh
over the first ``tp_size`` visible devices (``parallel.visible_devices``
of ``config.device``'s type: the CUDA devices, or virtual shards of one
device under ``RAY_TPU_TORCH_VIRTUAL_DEVICES``), cuts the parameters by
``param_specs`` and the KV pool along ``n_kv_heads``, and runs both
programs tensor-parallel (``models/transformer.py``), the host-side
scheduler and block manager unchanged. Speculative decoding under
``tp_size > 1`` raises, as in the reference.

Observability: ``submit``, ``generate`` and ``begin_adopted`` take the
request's ``trace`` context, and a traced request's finish emits
``llm.queue``, ``llm.prefill``, ``llm.kv_ship`` (adopted sequences) and
``llm.decode`` spans with a ``first_token`` event, anchored to the
submit's wall clock (host times: a span around device work times its
enqueue and the step's host sync, not the kernels). With the flight
recorder armed each engine renders an ``llm.engine-<id>`` section (its
``stats()``, host counters only) into every debug bundle.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private import flight, tracing
from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.exceptions import KVCacheOOM, RequestSheddedError
from ray_tpu_torch.llm.kv_cache import PagedKVCache
from ray_tpu_torch.llm.scheduler import (
    CANCELLED,
    FAILED,
    FINISHED,
    SHED,
    Request,
    Scheduler,
)
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    decode_step,
    init_params,
    param_specs,
    prefill_chunk,
    serving_params,
    verify_step,
)
from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh, visible_devices
from ray_tpu_torch.parallel.sharding import ShardingRules, shard_params

__all__ = ["EngineConfig", "InferenceEngine", "live_engines"]

_DONE = "__done__"
_ERROR = "__error__"

# Live engines in this process (weak: observability must never keep a
# dead engine's KV pool alive).
_ENGINES: "weakref.WeakValueDictionary[int, InferenceEngine]" = \
    weakref.WeakValueDictionary()
_engine_ids = itertools.count(1)


def live_engines() -> List["InferenceEngine"]:
    """Engines constructed in this process and not yet collected (a shut
    down engine stays listed until collected: its final counters are
    still readable)."""
    return [e for _, e in sorted(_ENGINES.items())]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine knobs. ``model`` is the flagship TransformerConfig; the KV
    pool holds ``num_blocks`` blocks of ``block_size`` tokens (block 0
    reserved). ``device`` is where the model and pool live."""

    model: Any = None                  # models.TransformerConfig
    num_blocks: int = 128
    block_size: int = 16
    max_num_seqs: int = 8              # iteration batch cap
    prefill_token_budget: int = 2048   # prompt tokens computed per step
    max_queued_requests: int = 64      # bounded waitqueue (admission)
    eos_token_id: Optional[int] = None
    max_new_tokens_default: int = 64
    param_seed: int = 0
    cache_dtype: Any = None            # default: model dtype
    enable_prefix_caching: bool = True  # COW shared prefix blocks
    tp_size: int = 1                   # tensor-parallel mesh width
    # Speculative decoding: the draft proposes spec_k tokens per round and
    # the flagship verifies them in one verify_step. spec_k=0 or
    # draft_model=None disarms it (vanilla decode). Greedy only: a round
    # holding a temperature>0 sequence decodes vanilla.
    spec_k: int = 0
    draft_model: Any = None            # draft TransformerConfig
    device: str = "cuda"

    def resolved_model(self):
        return self.model if self.model is not None else TransformerConfig()


def _pow2_at_least(n: int, floor: int = 1) -> int:
    m = max(int(n), floor)
    p = 1
    while p < m:
        p *= 2
    return p


class InferenceEngine:
    """See module docstring. Construct with parameter trees (on any
    device; they are moved to ``config.device`` and cast once to their
    model's dtype) or let the engine init them: the flagship from
    ``param_seed``, the draft from ``param_seed + 1``."""

    def __init__(self, config: Optional[EngineConfig] = None,
                 params: Optional[dict] = None,
                 draft_params: Optional[dict] = None):
        self.config = config or EngineConfig()
        self.device = resolve_device(self.config.device)
        self.model_cfg = self.config.resolved_model()
        if params is None:
            params = init_params(self.model_cfg, self.config.param_seed,
                                 device=self.device)
        self.mesh = None
        self._rules = None
        if self.config.tp_size > 1:
            self.mesh, self._rules = self._build_tp_mesh(
                self.config.tp_size, self.config.device)
            self.device = self.mesh.devices.flat[0]
            self.params = self._shard_params(params, self._rules)
        else:
            # One cast to the serving dtype instead of one per call (exact).
            self.params = serving_params(params, self.model_cfg, self.device)
        self.cache = PagedKVCache(
            self.model_cfg, self.config.num_blocks, self.config.block_size,
            dtype=self.config.cache_dtype,
            enable_prefix_caching=self.config.enable_prefix_caching,
            device=self.device, mesh=self.mesh, rules=self._rules)
        self.scheduler = Scheduler(
            self.cache,
            max_num_seqs=self.config.max_num_seqs,
            prefill_token_budget=self.config.prefill_token_budget,
            max_queued_requests=self.config.max_queued_requests)
        # Speculative decoding: the draft's KV attaches to the same block
        # manager as an aux pool (one table, two pools).
        self._spec_armed = (self.config.spec_k > 0
                            and self.config.draft_model is not None)
        if self._spec_armed:
            if self.config.tp_size > 1:
                raise ValueError(
                    "speculative decoding is not supported with tp_size "
                    "> 1 (the draft aux pool is unsharded)")
            self.draft_cfg = self.config.draft_model
            if draft_params is None:
                draft_params = init_params(self.draft_cfg,
                                           self.config.param_seed + 1,
                                           device=self.device)
            self.draft_params = serving_params(draft_params, self.draft_cfg,
                                               self.device)
            self.cache.attach_aux("draft", self.draft_cfg,
                                  dtype=self.config.cache_dtype)
        self._lock = threading.RLock()          # scheduler + cache + step
        self._work = threading.Event()          # submit -> loop wakeup
        self._stop = threading.Event()
        self._loop_thread: Optional[threading.Thread] = None
        self._requests: Dict[int, Request] = {}
        # Held-after-prefill sequences (disaggregated prefill): finished
        # requests whose blocks stay allocated for export until
        # release_held().
        self._held: Dict[int, Request] = {}
        # -- counters --
        self.num_steps = 0
        self.num_prefill_tokens = 0      # prompt tokens actually computed
        self.num_generated_tokens = 0
        # -- speculative-decoding counters --
        self.spec_rounds = 0             # verify steps run
        self.spec_proposed = 0           # draft tokens proposed
        self.spec_accepted = 0           # proposals the flagship accepted
        self.spec_emitted = 0            # tokens emitted by spec rounds
        self.spec_fallback_rounds = 0    # rounds vanilla-decoded instead
        # Per-request TTFT decomposition records, bounded.
        self._timings: "deque" = deque(maxlen=2048)
        self.engine_id = next(_engine_ids)
        _ENGINES[self.engine_id] = self
        # Flight-recorder section: this engine's waitqueue depth, KV
        # occupancy and TTFT decomposition in every debug bundle
        # (weakly held: a collected engine reports itself gone).
        if flight.active():
            eid = self.engine_id

            def _section(_id=eid):
                e = _ENGINES.get(_id)
                return e.stats() if e is not None else {"gone": True}

            flight.add_section(f"llm.engine-{eid}", _section)

    # ------------------------------------------------------ tensor parallel
    @staticmethod
    def _build_tp_mesh(tp: int, device="cuda"):
        """A tp-only mesh over the first ``tp`` visible devices of
        ``device``'s type (every other axis size 1, so the default
        ShardingRules apply unchanged)."""
        devices = visible_devices(torch.device(device).type)
        if len(devices) < tp:
            raise ValueError(
                f"tp_size {tp} exceeds {len(devices)} visible devices")
        mesh = make_mesh(MeshConfig(dp=1, fsdp=1, pp=1, tp=tp, sp=1, ep=1),
                         devices=devices[:tp])
        return mesh, ShardingRules()

    def _shard_params(self, params, rules):
        """The per-shard serving trees: cut by ``param_specs``, each cast
        once to the serving dtype."""
        cfg = self.model_cfg
        if cfg.n_heads % self.config.tp_size or \
                cfg.n_kv_heads % self.config.tp_size:
            raise ValueError(
                f"n_heads {cfg.n_heads} / n_kv_heads {cfg.n_kv_heads} "
                f"must divide tp_size {self.config.tp_size}")
        shards = shard_params(params, self.mesh, param_specs(cfg, rules))
        return [serving_params(p, cfg, d)
                for p, d in zip(shards, self.mesh.devices.flat)]

    # ------------------------------------------------------------ lifecycle
    def _ensure_loop(self):
        if self._loop_thread is None or not self._loop_thread.is_alive():
            self._loop_thread = threading.Thread(
                target=self._loop, daemon=True, name="llm-engine-step")
            self._loop_thread.start()

    def shutdown(self):
        self._stop.set()
        with self._lock:
            for req in list(self._requests.values()):
                if not req.finished():
                    # Remove from the waitqueue before finishing, so a
                    # loop thread blocked on this lock cannot re-admit it.
                    self.scheduler.remove_waiting(req)
                    self._finish(req, CANCELLED)
            for seq_id in list(self._held):
                self.release_held(seq_id)
        self._work.set()
        loop = self._loop_thread
        if loop is not None and loop is not threading.current_thread():
            loop.join(timeout=5.0)

    def _loop(self):
        while not self._stop.is_set():
            self._work.wait()
            if self._stop.is_set():
                return
            try:
                busy = self.step()
            except Exception as exc:  # noqa: BLE001 — engine must not die
                # Fail every in-flight request typed (freeing its blocks)
                # and keep serving.
                with self._lock:
                    for req in list(self._requests.values()):
                        if not req.finished():
                            self.scheduler.remove_waiting(req)
                            self._finish(req, FAILED, exc)
                continue
            if not busy:
                idle = False
                with self._lock:
                    if (not self.scheduler.running
                            and self.scheduler.queue_depth() == 0):
                        self._work.clear()
                        idle = True
                if not idle:
                    time.sleep(0.001)  # a non-admittable queue must not spin

    # -------------------------------------------------------------- request
    def submit(self, prompt: List[int],
               max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               temperature: float = 0.0,
               seed: Optional[int] = None,
               priority: int = 0,
               trace=None,
               hold_after_prefill: bool = False) -> Request:
        """Enqueue a request. Past the bounded waitqueue the lowest
        priority class is shed with a typed ``RequestSheddedError``.
        Tokens arrive on ``req.output_queue`` as iterations commit them.
        ``trace`` (a wire context) parents the request's ``llm.*`` spans.
        With ``hold_after_prefill`` the finished request keeps its blocks
        for export until ``release_held``."""
        req = Request(
            prompt,
            max_new_tokens if max_new_tokens is not None
            else self.config.max_new_tokens_default,
            eos_token_id=(eos_token_id if eos_token_id is not None
                          else self.config.eos_token_id),
            temperature=temperature, seed=seed, priority=priority)
        req.trace = trace
        req.hold_after_prefill = bool(hold_after_prefill)
        total = len(req.prompt) + req.max_new_tokens
        max_len = self.model_cfg.max_seq_len
        if total > max_len:
            raise ValueError(
                f"prompt + max_new_tokens = {total} exceeds the model's "
                f"max_seq_len {max_len}")
        if self.cache.blocks_for_tokens(total) > self.cache.usable_blocks:
            raise KVCacheOOM(
                f"request needs {self.cache.blocks_for_tokens(total)} "
                f"blocks for {total} tokens; pool holds "
                f"{self.cache.usable_blocks}")
        with self._lock:
            victim = self.scheduler.submit(req)
            if victim is not None:
                self._finish(victim, SHED, RequestSheddedError(
                    f"request (priority class {victim.priority}) evicted "
                    f"from the waitqueue by a class-{req.priority} "
                    f"arrival under overload",
                    priority=victim.priority))
            self._requests[req.seq_id] = req
            self._work.set()
        self._ensure_loop()
        return req

    def generate(self, prompt: List[int],
                 max_new_tokens: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0,
                 seed: Optional[int] = None,
                 priority: int = 0,
                 timeout_s: float = 120.0,
                 trace=None) -> Iterator[int]:
        """Streaming generator of token ids. Closing it mid-generation
        frees the sequence's private KV blocks immediately."""
        req = self.submit(prompt, max_new_tokens=max_new_tokens,
                          eos_token_id=eos_token_id,
                          temperature=temperature, seed=seed,
                          priority=priority, trace=trace)
        try:
            while True:
                try:
                    item = req.output_queue.get(timeout=timeout_s)
                except queue.Empty:
                    raise TimeoutError(
                        f"no token for {timeout_s}s (sequence "
                        f"{req.seq_id}, status {req.status})") from None
                if isinstance(item, tuple):
                    kind, payload = item
                    if kind == _DONE:
                        return
                    raise payload  # _ERROR
                yield item
        finally:
            if not req.finished():
                self.cancel(req)

    def cancel(self, req) -> bool:
        """Cancel by Request or seq_id: drops its block refs now."""
        with self._lock:
            if isinstance(req, int):
                req = self._requests.get(req)
            if req is None or req.finished():
                return False
            self.scheduler.remove_waiting(req)
            self._finish(req, CANCELLED)
        self._work.set()  # a parked admission may now fit
        return True

    def _finish(self, req: Request, status: str,
                error: Optional[BaseException] = None):
        self.scheduler.release(req, status, error)
        self._requests.pop(req.seq_id, None)
        req.t_finish = time.monotonic()
        self._record_timing(req, status)
        if status in (FAILED, SHED) and error is not None:
            req.output_queue.put((_ERROR, error))
        else:
            req.output_queue.put((_DONE, status))

    def _hold(self, req: Request):
        """Disaggregated prefill: retire a ``hold_after_prefill`` request
        without freeing its blocks; they stay allocated (and
        prefix-registered) for export until ``release_held``. The
        consumer's stream ends as with ``_finish``."""
        self.scheduler.release(req, FINISHED, free_blocks=False)
        self._requests.pop(req.seq_id, None)
        self._held[req.seq_id] = req
        req.t_finish = time.monotonic()
        self._record_timing(req, FINISHED)
        req.output_queue.put((_DONE, FINISHED))

    def _retire(self, req: Request):
        if req.hold_after_prefill:
            self._hold(req)
        else:
            self._finish(req, FINISHED)

    def release_held(self, seq_id: int) -> int:
        """Free a held sequence's blocks (the decode side's ack, or
        shutdown). Idempotent: a second call sees 0. Returns blocks
        actually freed."""
        with self._lock:
            if self._held.pop(seq_id, None) is None:
                return 0
            freed = self.cache.free(seq_id)
        self._work.set()  # a parked admission may now fit
        return freed

    def held_count(self) -> int:
        with self._lock:
            return len(self._held)

    # ------------------------------------------------------ disagg adoption
    def begin_adopted(self, prompt: List[int],
                      max_new_tokens: Optional[int] = None,
                      eos_token_id: Optional[int] = None,
                      temperature: float = 0.0,
                      seed: Optional[int] = None,
                      priority: int = 0,
                      trace=None) -> Optional[Request]:
        """Disaggregated decode, step 1 of 3: allocate the prompt's block
        table as admission would (sharing every prefix-cached leading
        block) so a prefill replica's exported KV can be grafted into it.
        Returns None when the batch or pool has no room now; the caller
        falls back to the colocated path. The request runs only after
        ``commit_adopted``."""
        req = Request(
            prompt,
            max_new_tokens if max_new_tokens is not None
            else self.config.max_new_tokens_default,
            eos_token_id=(eos_token_id if eos_token_id is not None
                          else self.config.eos_token_id),
            temperature=temperature, seed=seed, priority=priority)
        req.trace = trace
        if len(req.prompt) + req.max_new_tokens > self.model_cfg.max_seq_len:
            return None
        with self._lock:
            if len(self.scheduler.running) >= self.config.max_num_seqs:
                return None
            cached = self.cache.allocate_prefix(
                req.seq_id, req.prompt, extra_tokens=1)
            if cached is None:
                return None
            req.cached_prompt_tokens = cached
            req.t_sched = time.monotonic()
            self._requests[req.seq_id] = req
        return req

    def abort_adopted(self, req: Request) -> None:
        """Undo ``begin_adopted`` (the remote prefill or the transfer
        failed): drop the allocation and forget the request. The caller
        retries on the colocated path with a fresh submit."""
        with self._lock:
            self._requests.pop(req.seq_id, None)
            self.cache.free(req.seq_id)
        self._work.set()

    def adopt_kv(self, req: Request, payload: dict) -> bool:
        """Disaggregated step 2: graft the prefill replica's exported
        blocks into this pool under the adopted sequence's table. Blocks
        before the locally prefix-cached boundary are never written; the
        payload must cover everything from that boundary on, or the graft
        is refused (False: the shipping plan went stale, the caller falls
        back). On success the full prompt registers in the prefix cache
        and the transfer phase's stamp closes."""
        graft_from = req.cached_prompt_tokens // self.cache.block_size
        if (int(payload.get("block_size", -1)) != self.cache.block_size
                or int(payload.get("start_block", 0)) > graft_from):
            return False
        with self._lock:
            try:
                self.cache.graft_blocks(req.seq_id, payload,
                                        start_block=graft_from)
            except (KeyError, ValueError):
                return False
            self.cache.register_prefix(req.seq_id, len(req.prompt))
        nbytes = 0
        for part in (payload, *payload.get("aux", {}).values()):
            for name in ("k", "v"):
                t = part.get(name)
                if t is not None:
                    nbytes += t.numel() * t.element_size()
        req.kv_ship = (int(payload.get("blocks", 0)), nbytes)
        now = time.monotonic()
        if req.t_prefill_done is None:
            # The caller normally stamps this when the remote prefill
            # returns; backfilling keeps transfer_s >= 0 regardless.
            req.t_prefill_done = now
        req.t_transfer_done = now
        return True

    def commit_adopted(self, req: Request, first_token: int) -> None:
        """Disaggregated step 3: the grafted sequence becomes a live
        decode row. Streams the prefill replica's first token (sampled
        there from the final chunk's logits, as the colocated path would)
        and joins the running set at the decode phase; EOS or a 1-token
        budget finishes at once."""
        tok = int(first_token)
        with self._lock:
            now = time.monotonic()
            if req.t_prefill_done is None:
                req.t_prefill_done = now
            if req.t_transfer_done is None:
                req.t_transfer_done = now
            req.prefill_pos = len(req.prompt)
            req.t_first_token = now
            req.out_tokens.append(tok)
            self.num_generated_tokens += 1
            req.output_queue.put(tok)
            if ((req.eos_token_id is not None
                    and tok == req.eos_token_id)
                    or len(req.out_tokens) >= req.max_new_tokens):
                self._finish(req, FINISHED)
                return
            self.scheduler.adopt_running(req)
            self._work.set()
        self._ensure_loop()

    def _record_timing(self, req: Request, status: str):
        """TTFT decomposition record (queue / prefill / transfer / decode
        seconds) and, for a request that carried a trace context, the
        ``llm.queue`` / ``llm.prefill`` / ``llm.kv_ship`` / ``llm.decode``
        spans with a ``first_token`` event (``llm.<status>`` for one
        never scheduled). Adopted sequences add a transfer phase (pull +
        graft) between prefill and decode; colocated ones have none and
        their decode starts at ``t_prefill_done``."""
        t_end = req.t_finish
        queue_s = ((req.t_sched - req.t_submit)
                   if req.t_sched is not None else t_end - req.t_submit)
        prefill_s = ((req.t_prefill_done - req.t_sched)
                     if req.t_sched is not None
                     and req.t_prefill_done is not None else 0.0)
        transfer_s = ((req.t_transfer_done - req.t_prefill_done)
                      if req.t_transfer_done is not None
                      and req.t_prefill_done is not None else 0.0)
        t_decode0 = (req.t_transfer_done
                     if req.t_transfer_done is not None
                     else req.t_prefill_done)
        decode_s = (t_end - t_decode0) if t_decode0 is not None else 0.0
        self._timings.append({
            "status": status,
            "queue_s": queue_s,
            "prefill_s": prefill_s,
            "transfer_s": transfer_s,
            "decode_s": decode_s,
            "ttft_s": ((req.t_first_token - req.t_submit)
                       if req.t_first_token is not None else None),
            "total_s": t_end - req.t_submit,
        })
        t = tracing.tracer()
        if t is None or req.trace is None:
            return
        ctx = tracing.extract(req.trace)
        if ctx is None:
            return

        # Monotonic stamps anchor to the submit's wall clock for spans.
        def wall(mono):
            return req.wall_submit + (mono - req.t_submit)

        ok = "ok" if status == FINISHED else "error"
        if req.t_sched is not None:
            t.emit(ctx.trace_id, tracing._new_id(), ctx.span_id,
                   "llm.queue", wall(req.t_submit), queue_s,
                   component="llm", tags={"seq": req.seq_id})
            if req.t_prefill_done is not None:
                t.emit(ctx.trace_id, tracing._new_id(), ctx.span_id,
                       "llm.prefill", wall(req.t_sched), prefill_s,
                       component="llm",
                       tags={"seq": req.seq_id,
                             "cached_tokens": req.cached_prompt_tokens})
                if req.t_transfer_done is not None:
                    blocks, nbytes = req.kv_ship or (0, 0)
                    t.emit(ctx.trace_id, tracing._new_id(), ctx.span_id,
                           "llm.kv_ship", wall(req.t_prefill_done),
                           transfer_s, component="llm",
                           tags={"seq": req.seq_id, "blocks": blocks,
                                 "bytes": nbytes})
                events = []
                if req.t_first_token is not None:
                    events.append([wall(req.t_first_token),
                                   "first_token"])
                t.emit(ctx.trace_id, tracing._new_id(), ctx.span_id,
                       "llm.decode", wall(t_decode0), decode_s,
                       status=ok, component="llm",
                       tags={"seq": req.seq_id,
                             "tokens": len(req.out_tokens)},
                       events=events)
        else:
            # Never scheduled (shed or cancelled in the waitqueue).
            t.emit(ctx.trace_id, tracing._new_id(), ctx.span_id,
                   "llm." + status.lower(), wall(req.t_submit), queue_s,
                   status=ok, component="llm",
                   tags={"seq": req.seq_id})

    # ----------------------------------------------------------------- step
    def step(self) -> bool:
        """Run ONE continuous-batching iteration: admit + one prefill chunk
        per prefilling sequence (under the token budget) + one decode for
        every fully-prefilled sequence. Returns True if any work ran."""
        with self._lock:
            try:
                chunks, decodes = self.scheduler.schedule()
            except MemoryError as e:
                # A single sequence outgrew the pool: fail it, keep going.
                for r in list(self.scheduler.running):
                    self._finish(r, FAILED, KVCacheOOM(str(e)))
                return True
            if not chunks and not decodes:
                # A parked head with nothing running can never unpark.
                if (self.scheduler.queue_depth() > 0
                        and not self.scheduler.running
                        and not self.cache.can_allocate(1)):
                    head = self.scheduler.waiting[0]
                    self.scheduler.remove_waiting(head)
                    self._finish(head, FAILED, KVCacheOOM(
                        "KV pool exhausted with no running sequences to "
                        "free blocks"))
                return False
            if chunks:
                self._run_prefill_chunks(chunks)
            # Newly completed prefills join decode next iteration.
            if decodes:
                decodes = [r for r in decodes if not r.finished()]
            if decodes:
                if self._spec_armed:
                    self._run_spec_decode(decodes)
                else:
                    self._run_decode(decodes)
            self.num_steps += 1
            return True

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device, dtype=torch.long)

    def _run_prefill_chunks(self, chunks: List[Tuple[Request, int, int]]):
        bs = self.cache.block_size
        b_pad = _pow2_at_least(len(chunks))
        max_chunk = max(n for _, _, n in chunks)
        c_pad = _pow2_at_least(max_chunk)
        tokens = np.zeros((b_pad, c_pad), np.int32)
        starts = np.zeros((b_pad,), np.int32)
        lens = np.ones((b_pad,), np.int32)
        for i, (r, start, n) in enumerate(chunks):
            tokens[i, :n] = r.prompt[start:start + n]
            starts[i] = start
            lens[i] = n
        tables = self.cache.padded_tables([r.seq_id for r, _, _ in chunks])
        # Cover every position this program may touch, padded chunk tails
        # included (their writes resolve to real entries or NULL padding).
        need_m = max((int(s) + c_pad - 1) // bs + 1
                     for s in starts[:len(chunks)])
        m_pad = _pow2_at_least(max(tables.shape[1], need_m))
        bt = np.zeros((b_pad, m_pad), np.int32)
        bt[:len(chunks), :tables.shape[1]] = tables
        tokens_t, starts_t, lens_t, bt_t = (
            self._upload(a) for a in (tokens, starts, lens, bt))
        logits, self.cache.data = prefill_chunk(
            self.model_cfg, self.params, self.cache.data,
            tokens_t, starts_t, lens_t, bt_t, mesh=self.mesh,
            rules=self._rules)
        if self._spec_armed:
            # The draft's KV rides the same chunk plan into its aux pool,
            # so the first spec round can draft at once.
            _, draft_data = prefill_chunk(
                self.draft_cfg, self.draft_params,
                self.cache.aux_data("draft"), tokens_t, starts_t, lens_t,
                bt_t)
            self.cache.set_aux_data("draft", draft_data)
        logits = None if not any(
            start + n >= len(r.prompt) for r, start, n in chunks) \
            else logits.cpu().numpy()
        completed: List[Request] = []
        rows: List[int] = []
        for i, (r, start, n) in enumerate(chunks):
            self.num_prefill_tokens += n
            r.prefill_pos = start + n
            # Blocks computed so far become shareable immediately.
            self.cache.register_prefix(r.seq_id, r.prefill_pos)
            if r.prefill_pos >= len(r.prompt):
                r.t_prefill_done = time.monotonic()
                completed.append(r)
                rows.append(i)
        if completed:
            self._emit(completed, logits[rows])

    def _run_decode(self, reqs: List[Request]):
        bs = self.cache.block_size
        b_pad = _pow2_at_least(len(reqs))
        tokens = np.zeros((b_pad,), np.int32)
        positions = np.zeros((b_pad,), np.int32)
        for i, r in enumerate(reqs):
            tokens[i] = r.last_token
            positions[i] = r.num_tokens - 1  # slot this step writes
        tables = self.cache.padded_tables([r.seq_id for r in reqs])
        m_pad = max(_pow2_at_least(tables.shape[1]),
                    (int(positions.max()) // bs) + 1)
        bt = np.zeros((b_pad, m_pad), np.int32)
        bt[:len(reqs), :tables.shape[1]] = tables
        logits, self.cache.data = decode_step(
            self.model_cfg, self.params, self.cache.data,
            self._upload(tokens), self._upload(positions), self._upload(bt),
            mesh=self.mesh, rules=self._rules)
        self._emit(reqs, logits.cpu().numpy()[:len(reqs)])

    def _run_spec_decode(self, reqs: List[Request]):
        """One speculative round: the draft proposes ``spec_k`` greedy
        tokens per sequence (its KV in the aux pool), the flagship scores
        ``[last_token, d_1..d_k]`` in one ``verify_step``, and the longest
        agreeing prefix plus one bonus token from the verify logits
        commits: 1 to k+1 tokens per sequence, token for token what
        vanilla greedy decode gives (the flagship's argmax decides; the
        draft only sets how many positions one step scores).

        A round with a temperature > 0 row, or whose k lookahead slots do
        not all allocate, decodes vanilla instead (counted). Stale
        lookahead KV past an accepted prefix is masked by the context
        length until a later round's writes cover it."""
        k = self.config.spec_k
        if any(r.temperature > 0.0 for r in reqs):
            self.spec_fallback_rounds += 1
            return self._run_decode(reqs)
        # schedule() guaranteed position num_tokens-1 (+1 headroom);
        # verify also writes num_tokens .. num_tokens+k-1.
        for r in reqs:
            for pos in range(r.num_tokens, r.num_tokens + k):
                if not self.cache.ensure_slot(r.seq_id, pos):
                    self.spec_fallback_rounds += 1
                    return self._run_decode(reqs)
        bs = self.cache.block_size
        b = len(reqs)
        b_pad = _pow2_at_least(b)
        c_pad = _pow2_at_least(k + 1)
        tables = self.cache.padded_tables([r.seq_id for r in reqs])
        # Cover every position verify's padded columns may touch: block
        # lookups clamp to the last table column, so positions past a
        # row's real table must resolve to the NULL pad, never onto its
        # last live block.
        need_m = max((r.num_tokens - 1 + c_pad - 1) // bs + 1
                     for r in reqs)
        m_pad = _pow2_at_least(max(tables.shape[1], need_m))
        bt = np.zeros((b_pad, m_pad), np.int32)
        bt[:b, :tables.shape[1]] = tables
        bt_t = self._upload(bt)
        last = np.zeros((b_pad,), np.int32)
        start = np.zeros((b_pad,), np.int32)
        for i, r in enumerate(reqs):
            last[i] = r.last_token
            start[i] = r.num_tokens - 1
        start_t = self._upload(start)

        # Draft pass: k one-token steps over the aux pool, argmax on the
        # device. Column j+1 of vtok is proposal j+1.
        draft_data = self.cache.aux_data("draft")
        vtok = torch.zeros((b_pad, c_pad), dtype=torch.long,
                           device=self.device)
        vtok[:, 0] = self._upload(last)
        for j in range(k):
            logits, draft_data = decode_step(
                self.draft_cfg, self.draft_params, draft_data,
                vtok[:, j], start_t + j, bt_t)
            vtok[:, j + 1] = torch.argmax(logits, dim=-1)
        self.cache.set_aux_data("draft", draft_data)

        # Verify pass: one flagship step scores all k proposals; one host
        # sync brings the proposals and the verify argmaxes together.
        logits, self.cache.data = verify_step(
            self.model_cfg, self.params, self.cache.data, vtok, start_t,
            bt_t)
        best = torch.argmax(logits[:b, :k + 1], dim=-1)
        host = torch.cat([vtok[:b, 1:k + 1], best], dim=1).cpu().numpy()
        proposals, best = host[:, :k], host[:, k:]

        self.spec_rounds += 1
        self.spec_proposed += b * k
        for i, req in enumerate(reqs):
            accepted = 0
            while (accepted < k
                   and best[i, accepted] == proposals[i, accepted]):
                accepted += 1
            self.spec_accepted += accepted
            # Accepted proposals + one bonus token (the flagship's own
            # next token after the accepted prefix).
            toks = [int(t) for t in proposals[i, :accepted]]
            toks.append(int(best[i, accepted]))
            if req.t_first_token is None:
                req.t_first_token = time.monotonic()
            for tok in toks:
                req.out_tokens.append(tok)
                self.num_generated_tokens += 1
                self.spec_emitted += 1
                req.output_queue.put(tok)
                if ((req.eos_token_id is not None
                        and tok == req.eos_token_id)
                        or len(req.out_tokens) >= req.max_new_tokens):
                    self._retire(req)
                    break

    def _emit(self, reqs: List[Request], logits: np.ndarray):
        """Sample one token per request, stream it, and retire sequences
        that hit EOS or their token budget."""
        for i, req in enumerate(reqs):
            tok = self._sample(req, logits[i])
            if req.t_first_token is None:
                req.t_first_token = time.monotonic()
            req.out_tokens.append(tok)
            self.num_generated_tokens += 1
            req.output_queue.put(tok)
            if ((req.eos_token_id is not None and tok == req.eos_token_id)
                    or len(req.out_tokens) >= req.max_new_tokens):
                self._retire(req)

    @staticmethod
    def _sample(req: Request, row: np.ndarray) -> int:
        if req.temperature <= 0.0:
            return int(np.argmax(row))
        # Per-request deterministic sampling stream (seeded, host-side).
        rng = np.random.default_rng(
            (req.seed if req.seed is not None else req.seq_id,
             len(req.out_tokens)))
        z = row.astype(np.float64) / req.temperature
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(rng.choice(len(row), p=p))

    # -------------------------------------------------------------- queries
    def queue_depth(self) -> int:
        return self.scheduler.queue_depth()

    def stats(self) -> Dict[str, Any]:
        out = {
            "engine_id": self.engine_id,
            "device": str(self.device),
            "tp_size": self.config.tp_size,
            "steps": self.num_steps,
            "prefill_tokens": self.num_prefill_tokens,
            "generated_tokens": self.num_generated_tokens,
            "ttft_decomposition": self.ttft_decomposition(),
            "held_sequences": len(self._held),
        }
        if self._spec_armed:
            out["spec"] = {
                "k": self.config.spec_k,
                "rounds": self.spec_rounds,
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "emitted": self.spec_emitted,
                "fallback_rounds": self.spec_fallback_rounds,
                "acceptance_rate": (self.spec_accepted
                                    / max(1, self.spec_proposed)),
            }
        out.update(self.scheduler.stats())
        out.update(self.cache.stats())
        return out

    def ttft_decomposition(self) -> Dict[str, Any]:
        """Percentile rollup of the per-request timing records."""
        rows = [r for r in list(self._timings) if r["status"] == FINISHED]
        if not rows:
            return {"completed": 0}

        def pct(key, q):
            vals = sorted(r[key] for r in rows if r.get(key) is not None)
            if not vals:
                return None
            return vals[min(len(vals) - 1, int(len(vals) * q))]

        out = {"completed": len(rows)}
        for key in ("queue", "prefill", "transfer", "decode", "ttft"):
            out[f"{key}_p50_s"] = pct(f"{key}_s", 0.5)
            out[f"{key}_p99_s"] = pct(f"{key}_s", 0.99)
        return out

    def wait_idle(self, timeout_s: float = 60.0) -> bool:
        """Block until no work remains (tests/bench convenience)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if (not self.scheduler.running
                        and self.scheduler.queue_depth() == 0):
                    return True
            time.sleep(0.002)
        return False

