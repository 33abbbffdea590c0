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

Padding buckets are powers of two. Padded rows aim at the NULL block and
their logits are ignored; attention masks every slot past a sequence's
context, so a sequence's tokens are the same whatever batch it shares an
iteration with (the concurrent-equals-sequential invariant).

The reference jits both programs with the pool donated; here they run
eagerly and update the pool tensors in place. Logits come to the host
once per step (``.cpu()``), the step's one sync, and sampling stays on
the host in numpy so seeded sampling matches the reference.

Not ported yet: tensor parallelism (``tp_size > 1``), speculative
decoding (``spec_k > 0``), the disaggregated-serving hold/adopt path, and
the tracing and flight-recorder hooks (they import the ``ray_tpu``
runtime).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

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
    prefill_chunk,
    serving_params,
)

__all__ = ["EngineConfig", "InferenceEngine"]

_DONE = "__done__"
_ERROR = "__error__"


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
    tp_size: int = 1                   # only 1 is ported
    spec_k: int = 0                    # only 0 is ported
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
    """See module docstring. Construct with a parameter tree (on any
    device; it is moved to ``config.device`` and cast once to the model
    dtype) or let the engine init one from ``param_seed``."""

    def __init__(self, config: Optional[EngineConfig] = None,
                 params: Optional[dict] = None):
        self.config = config or EngineConfig()
        if self.config.tp_size > 1:
            raise NotImplementedError(
                "tensor-parallel serving is not ported yet (tp_size > 1)")
        if self.config.spec_k > 0:
            raise NotImplementedError(
                "speculative decoding is not ported yet (spec_k > 0)")
        self.device = resolve_device(self.config.device)
        self.model_cfg = self.config.resolved_model()
        if params is None:
            params = init_params(self.model_cfg, self.config.param_seed,
                                 device=self.device)
        # One cast to the serving dtype instead of one per call (exact).
        self.params = serving_params(params, self.model_cfg, self.device)
        self.cache = PagedKVCache(
            self.model_cfg, self.config.num_blocks, self.config.block_size,
            dtype=self.config.cache_dtype,
            enable_prefix_caching=self.config.enable_prefix_caching,
            device=self.device)
        self.scheduler = Scheduler(
            self.cache,
            max_num_seqs=self.config.max_num_seqs,
            prefill_token_budget=self.config.prefill_token_budget,
            max_queued_requests=self.config.max_queued_requests)
        self._lock = threading.RLock()          # scheduler + cache + step
        self._work = threading.Event()          # submit -> loop wakeup
        self._stop = threading.Event()
        self._loop_thread: Optional[threading.Thread] = None
        self._requests: Dict[int, Request] = {}
        # -- counters --
        self.num_steps = 0
        self.num_prefill_tokens = 0      # prompt tokens actually computed
        self.num_generated_tokens = 0
        # Per-request TTFT decomposition records, bounded.
        self._timings: "deque" = deque(maxlen=2048)

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
        self._work.set()

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
               hold_after_prefill: bool = False) -> Request:
        """Enqueue a request. Past the bounded waitqueue the lowest
        priority class is shed with a typed ``RequestSheddedError``.
        Tokens arrive on ``req.output_queue`` as iterations commit them."""
        if hold_after_prefill:
            raise NotImplementedError(
                "hold_after_prefill (disaggregated prefill) is not ported "
                "yet")
        req = Request(
            prompt,
            max_new_tokens if max_new_tokens is not None
            else self.config.max_new_tokens_default,
            eos_token_id=(eos_token_id if eos_token_id is not None
                          else self.config.eos_token_id),
            temperature=temperature, seed=seed, priority=priority)
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
                 timeout_s: float = 120.0) -> Iterator[int]:
        """Streaming generator of token ids. Closing it mid-generation
        frees the sequence's private KV blocks immediately."""
        req = self.submit(prompt, max_new_tokens=max_new_tokens,
                          eos_token_id=eos_token_id,
                          temperature=temperature, seed=seed,
                          priority=priority)
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

    def _record_timing(self, req: Request, status: str):
        """TTFT decomposition record (queue / prefill / decode seconds)."""
        t_end = req.t_finish
        queue_s = ((req.t_sched - req.t_submit)
                   if req.t_sched is not None else t_end - req.t_submit)
        prefill_s = ((req.t_prefill_done - req.t_sched)
                     if req.t_sched is not None
                     and req.t_prefill_done is not None else 0.0)
        decode_s = ((t_end - req.t_prefill_done)
                    if req.t_prefill_done is not None else 0.0)
        self._timings.append({
            "status": status,
            "queue_s": queue_s,
            "prefill_s": prefill_s,
            "decode_s": decode_s,
            "ttft_s": ((req.t_first_token - req.t_submit)
                       if req.t_first_token is not None else None),
            "total_s": t_end - req.t_submit,
        })

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
        logits, self.cache.data = prefill_chunk(
            self.model_cfg, self.params, self.cache.data,
            self._upload(tokens), self._upload(starts), self._upload(lens),
            self._upload(bt))
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
            self._upload(tokens), self._upload(positions), self._upload(bt))
        self._emit(reqs, logits.cpu().numpy()[:len(reqs)])

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
                self._finish(req, FINISHED)

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
            "device": str(self.device),
            "steps": self.num_steps,
            "prefill_tokens": self.num_prefill_tokens,
            "generated_tokens": self.num_generated_tokens,
            "ttft_decomposition": self.ttft_decomposition(),
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
        for key in ("queue", "prefill", "decode", "ttft"):
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

