"""Copy of ``ray_tpu/llm/scheduler.py`` for the PyTorch/CUDA port (the
port imports nothing of ``ray_tpu``). Only the imports differ, and
``adopt_running`` waits for the disaggregated-serving slice.

Iteration-level (continuous) batching scheduler with chunked prefill
and prefix-cache-aware admission (reference role: Orca's iteration-level
scheduling + vLLM's scheduler/policy — admission from a bounded
waitqueue each step, prefill and decode composed per iteration,
eviction-by-recompute on KV OOM, chunked prefill so one long prompt
cannot stall the running batch).

Per engine iteration ``schedule()`` returns the work for ONE step:

- ``chunks``: ``(request, start, length)`` prefill slices, composed
  under the prefill token budget. A prompt longer than the budget runs
  as several chunks across ITERATIONS — between any two of its chunks
  every running sequence decodes one token, so the batch's inter-token
  stall is bounded by one chunk's compute, never one prompt's
  (``max_prefill_tokens_per_step`` pins that bound). Admission
  allocates the prompt's blocks via ``PagedKVCache.allocate_prefix``:
  leading blocks already cached are SHARED and their tokens never
  appear in any chunk (the prefix-cache fast path). A request that
  doesn't fit PARKS at the head of the queue and is retried every
  iteration (KV-full never crashes, it waits for blocks to free).
- ``decodes``: every fully-prefilled running sequence, each guaranteed
  a writable physical slot for its next token. When the pool is empty
  mid-decode the YOUNGEST running sequence is preempted (block refs
  dropped, request requeued for recompute — vLLM's recompute eviction
  policy; on re-admission its still-cached prefix blocks match again),
  so the oldest work always completes.

Finished/cancelled sequences release their block references immediately
via ``release()`` — a short request parked behind a long one resumes on
the very next iteration, and only refcount-0 blocks actually free.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time as _time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.exceptions import RequestSheddedError
from ray_tpu_torch.llm.kv_cache import PagedKVCache

__all__ = ["EngineQueueFull", "Request", "Scheduler",
           "WAITING", "RUNNING", "FINISHED", "CANCELLED", "FAILED", "SHED"]

WAITING = "WAITING"
RUNNING = "RUNNING"
FINISHED = "FINISHED"
CANCELLED = "CANCELLED"
FAILED = "FAILED"
SHED = "SHED"  # evicted pre-admission by the load-shedding policy

_seq_counter = itertools.count(1)


class EngineQueueFull(RequestSheddedError, RuntimeError):
    """The bounded admission waitqueue is at capacity and the incoming
    request did not outrank anything waiting (backpressure — callers
    should retry/shed; the engine never buffers unboundedly). A
    ``RequestSheddedError``: overload is policy, not failure."""


class Request:
    """One sequence moving through the engine."""

    def __init__(self, prompt: List[int], max_new_tokens: int,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0,
                 seed: Optional[int] = None,
                 priority: int = 0):
        if not prompt:
            raise ValueError("empty prompt")
        self.seq_id = next(_seq_counter)
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.temperature = float(temperature)
        self.seed = seed
        # Admission class: 0 = most important. Under overload the
        # waitqueue admits better classes first and sheds worse ones.
        self.priority = int(priority)
        self.out_tokens: List[int] = []
        # TTFT decomposition stamps (monotonic; wall_submit anchors
        # span timestamps): queue wait = t_sched - t_submit, prefill =
        # t_prefill_done - t_sched, decode = t_finish - t_prefill_done.
        self.t_submit = _time.monotonic()
        self.wall_submit = _time.time()
        self.t_sched: Optional[float] = None
        self.t_prefill_done: Optional[float] = None
        # Disagg adoption stamp: when the sequence's prompt KV was
        # pulled p2p and grafted (transfer phase = t_transfer_done -
        # t_prefill_done); None for colocated requests.
        self.t_transfer_done: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_finish: Optional[float] = None
        self.trace = None  # tracing wire context ((trace_id, span_id))
        # Disagg prefill pool: keep KV blocks allocated after the last
        # prefill token (for p2p export) instead of freeing on finish.
        self.hold_after_prefill = False
        # (blocks, bytes) shipped for this sequence — llm.kv_ship span.
        self.kv_ship: Optional[Tuple[int, int]] = None
        # Prompt tokens whose KV is in the cache (prefix-cache hits at
        # admission + chunks computed so far). The request decodes only
        # once this reaches len(prompt).
        self.prefill_pos = 0
        self.cached_prompt_tokens = 0  # prefix-cache hits (observability)
        self.status = WAITING
        self.error: Optional[BaseException] = None
        self.preemptions = 0
        # Token stream to the consumer: ints, then one (sentinel, payload).
        self.output_queue: "queue.SimpleQueue" = queue.SimpleQueue()

    # Next position to be computed/written in the KV cache.
    @property
    def num_tokens(self) -> int:
        return len(self.prompt) + len(self.out_tokens)

    @property
    def last_token(self) -> int:
        return self.out_tokens[-1] if self.out_tokens else self.prompt[-1]

    @property
    def prefilling(self) -> bool:
        return self.prefill_pos < len(self.prompt)

    def finished(self) -> bool:
        return self.status in (FINISHED, CANCELLED, FAILED, SHED)


class Scheduler:
    """Waitqueue + running set over one PagedKVCache. NOT thread-safe on
    its own — the engine serializes all calls under its step lock."""

    def __init__(self, cache: PagedKVCache, *, max_num_seqs: int = 8,
                 prefill_token_budget: int = 2048,
                 max_queued_requests: int = 64):
        self.cache = cache
        self.max_num_seqs = int(max_num_seqs)
        self.prefill_token_budget = int(prefill_token_budget)
        self.max_queued_requests = int(max_queued_requests)
        self.waiting: "deque[Request]" = deque()
        self.running: List[Request] = []
        self._lock = threading.Lock()  # waitqueue only (submit vs step)
        # -- counters --
        self.num_admitted = 0
        self.num_preempted = 0
        self.park_events = 0  # iterations where KV-full parked admission
        self.prefill_chunks_scheduled = 0
        self.max_prefill_tokens_per_step = 0  # chunked-prefill stall bound
        self.coscheduled_steps = 0  # iterations with BOTH chunks + decodes
        # Load-shedding accounting ("shed-by-policy", distinct from
        # failures): requests refused or evicted pre-admission when the
        # bounded waitqueue overflowed, per priority class.
        self.shed_requests = 0
        self.shed_by_class: Dict[int, int] = {}
        self.submitted_by_class: Dict[int, int] = {}

    # ------------------------------------------------------------ admission
    def submit(self, req: Request) -> Optional[Request]:
        """Enqueue ``req`` in (priority, FIFO) order. At capacity the
        LOWEST-priority waiting request loses: if something waiting is
        strictly worse than the newcomer it is evicted and returned (the
        caller fails it with a typed ``RequestSheddedError``); otherwise
        the newcomer itself is shed by raising ``EngineQueueFull``.
        Overload therefore degrades by policy — the best classes keep
        their queue slots — instead of by arrival order."""
        with self._lock:
            self.submitted_by_class[req.priority] = \
                self.submitted_by_class.get(req.priority, 0) + 1
            victim: Optional[Request] = None
            if len(self.waiting) >= self.max_queued_requests:
                # Eviction candidates: requests that were never admitted
                # (preemptions == 0). A recompute-preempted request is
                # mid-generation — its consumer already holds streamed
                # tokens — so shedding it would break the "shed happens
                # pre-admission, retry is safe" contract.
                candidates = [w for w in self.waiting
                              if w.preemptions == 0]
                worst = max(
                    candidates,
                    key=lambda w: (w.priority, w.seq_id), default=None)
                if worst is None or worst.priority <= req.priority:
                    self.shed_requests += 1
                    self.shed_by_class[req.priority] = \
                        self.shed_by_class.get(req.priority, 0) + 1
                    raise EngineQueueFull(
                        f"waitqueue at capacity "
                        f"({self.max_queued_requests} requests) and no "
                        f"waiting request has lower priority than "
                        f"class {req.priority}",
                        priority=req.priority)
                self.waiting.remove(worst)
                self.shed_requests += 1
                self.shed_by_class[worst.priority] = \
                    self.shed_by_class.get(worst.priority, 0) + 1
                victim = worst
            # Stable priority insert: behind every waiting request of an
            # equal-or-better class (FIFO within a class).
            idx = len(self.waiting)
            for i, w in enumerate(self.waiting):
                if w.priority > req.priority:
                    idx = i
                    break
            self.waiting.insert(idx, req)
            return victim

    def remove_waiting(self, req: Request) -> bool:
        with self._lock:
            try:
                self.waiting.remove(req)
                return True
            except ValueError:
                return False

    def queue_depth(self) -> int:
        with self._lock:
            return len(self.waiting)

    # ------------------------------------------------------------- schedule
    def schedule(self) -> Tuple[List[Tuple[Request, int, int]],
                                List[Request]]:
        """Compose one iteration: (prefill chunks, decode batch). Every
        returned request has cache slots for the tokens this step will
        write."""
        self.running = [r for r in self.running if not r.finished()]

        # 1) Guarantee a writable slot for each fully-prefilled running
        #    sequence's next token; evict-on-OOM: preempt the youngest
        #    until the rest fit. (Mid-prefill sequences already own every
        #    block their prompt needs — allocated at admission — so only
        #    decode growth can run the pool dry.)
        decodes: List[Request] = []
        i = 0
        while i < len(self.running):
            req = self.running[i]
            if req.prefilling:
                i += 1
                continue
            if self.cache.ensure_slot(req.seq_id, req.num_tokens):
                decodes.append(req)
                i += 1
                continue
            victim = self.running[-1]
            if victim is req and len(self.running) == 1:
                # A single sequence that outgrew the whole pool cannot
                # make progress by eviction; fail it loudly.
                raise MemoryError(
                    f"sequence {req.seq_id} needs more KV blocks than "
                    f"the pool holds ({self.cache.usable_blocks})")
            self._preempt(victim)
            decodes = [r for r in decodes if r is not victim]
            # retry the same index (running list shrank behind it)

        # 2) Continue chunked prefills of already-running sequences
        #    (admission order) under the per-iteration token budget.
        chunks: List[Tuple[Request, int, int]] = []
        budget = self.prefill_token_budget
        for req in self.running:
            if budget <= 0:
                break
            if req.prefilling:
                n = min(len(req.prompt) - req.prefill_pos, budget)
                chunks.append((req, req.prefill_pos, n))
                budget -= n

        # 3) Admit from the waitqueue under the remaining budget / seq
        #    cap / pool headroom. Stop at the first request that doesn't
        #    fit: FIFO order is the fairness contract (no head-of-line
        #    skip). Admission allocates the FULL prompt's blocks (+1
        #    headroom token so the first decode step after prefill
        #    cannot immediately preempt someone), sharing every cached
        #    prefix block; only the unshared tail enters the chunk plan.
        parked = False
        while budget > 0:
            with self._lock:
                if not self.waiting:
                    break
                req = self.waiting[0]
                if len(self.running) >= self.max_num_seqs:
                    break
                cached = self.cache.allocate_prefix(
                    req.seq_id, req.prompt, extra_tokens=1)
                if cached is None:
                    parked = True
                    break
                self.waiting.popleft()
            req.status = RUNNING
            req.prefill_pos = cached
            req.cached_prompt_tokens = cached
            n = min(len(req.prompt) - cached, budget)
            chunks.append((req, cached, n))
            budget -= n
            if req.t_sched is None:
                req.t_sched = _time.monotonic()  # queue-wait boundary
            self.running.append(req)
            self.num_admitted += 1
        if parked:
            self.park_events += 1
        if chunks:
            self.prefill_chunks_scheduled += len(chunks)
            step_tokens = sum(n for _, _, n in chunks)
            self.max_prefill_tokens_per_step = max(
                self.max_prefill_tokens_per_step, step_tokens)
            if decodes:
                self.coscheduled_steps += 1
        return chunks, decodes

    def _preempt(self, req: Request) -> None:
        """Recompute-style eviction: drop the sequence's block refs and
        send it back to the FRONT of the waitqueue. Already-emitted
        tokens were already streamed; on re-admission the prompt is
        extended with them so the recompute continues where it left off
        (and its still-registered prefix blocks match again — a
        preempted sequence usually re-prefills only what the cache
        lost)."""
        self.cache.free(req.seq_id)
        req.prompt = req.prompt + req.out_tokens
        req.max_new_tokens -= len(req.out_tokens)
        req.out_tokens = []
        req.prefill_pos = 0
        req.status = WAITING
        req.preemptions += 1
        self.num_preempted += 1
        self.running = [r for r in self.running if r is not req]
        with self._lock:
            self.waiting.appendleft(req)

    # -------------------------------------------------------------- release
    def release(self, req: Request, status: str,
                error: Optional[BaseException] = None,
                free_blocks: bool = True) -> int:
        """Terminal transition: mark + drop block refs IMMEDIATELY (only
        refcount-0 blocks actually free — shared prefix blocks stay with
        their other holders). Safe to call for any state; returns blocks
        freed. ``free_blocks=False`` keeps the block table alive past
        the terminal transition — the disagg prefill pool's hold-for-
        export path, balanced by ``InferenceEngine.release_held``."""
        req.status = status
        req.error = error
        self.running = [r for r in self.running if r is not req]
        if not free_blocks:
            return 0
        return self.cache.free(req.seq_id)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            waiting = len(self.waiting)
        return {
            "waiting": waiting,
            "running": len(self.running),
            "max_num_seqs": self.max_num_seqs,
            "prefill_token_budget": self.prefill_token_budget,
            "max_queued_requests": self.max_queued_requests,
            "num_admitted": self.num_admitted,
            "num_preempted": self.num_preempted,
            "park_events": self.park_events,
            "prefill_chunks_scheduled": self.prefill_chunks_scheduled,
            "max_prefill_tokens_per_step": self.max_prefill_tokens_per_step,
            "coscheduled_steps": self.coscheduled_steps,
            "shed_requests": self.shed_requests,
            "shed_by_class": dict(self.shed_by_class),
            "submitted_by_class": dict(self.submitted_by_class),
        }
