"""Replica scheduling (counterpart of ``ray_tpu/serve/router.py``):
power-of-two-choices on replica queue length, priority admission, and a
prefix-cache-aware tier for LLM deployments.

Prefix-aware routing: replicas that report a prefix digest (the LLM
engine's registered block-chain hashes, ``PagedKVCache.prefix_digest``)
are scored by **cached-prefix overlap** with the incoming prompt: the
router chains the prompt's block digests and counts how many LEADING
blocks each replica already holds. The best-overlap replica wins unless
it carries more than ``PREFIX_LOAD_SLACK`` requests above the least
loaded one. Requests with no overlap (or deployments that never report
digests) fall through to power-of-two-choices. ``random.Random(0)``
makes the choice deterministic.
"""

from __future__ import annotations

import random
import threading
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.exceptions import RequestSheddedError

# A cached-prefix hit must cover at least this many tokens to override
# the load-balancing choice (one block is the minimum shareable unit).
PREFIX_MIN_OVERLAP_TOKENS = 1
# Max extra in-flight requests the overlap winner may carry vs the
# least-loaded replica before locality yields to load (the
# locality_load_slack idiom from the task router).
PREFIX_LOAD_SLACK = 2

# Priority-admission policy: class p may occupy up to
# fraction[min(p, last)] of the deployment's max_ongoing_requests, so
# as load builds the worst classes hit their (smaller) ceiling and shed
# first while class 0 still admits up to the full cap — nested
# thresholds, the standard priority-shedding shape.
DEFAULT_CLASS_FRACTIONS = (1.0, 0.75, 0.5, 0.25)


class ReplicaSet:
    """Tracks live replica handles + their in-flight request counts."""

    def __init__(self):
        self._replicas: List[Any] = []
        # In-flight counts keyed by replica identity, not list index:
        # after update() replaces/removes replicas, index-keyed counts would
        # transfer to whichever replica now occupies that slot and skew the
        # power-of-two choice.
        self._inflight: Dict[int, int] = {}
        # Prefix-cache reports keyed the same way: id(replica) ->
        # (block_size, frozenset of chain digests).
        self._prefix: Dict[int, Tuple[int, frozenset]] = {}
        self._lock = threading.Lock()
        self._rng = random.Random(0)
        # Priority admission (None = unlimited, the default): total
        # in-flight bound + per-class fractions of it.
        self._max_ongoing: Optional[int] = None
        self._class_fractions: Tuple[float, ...] = DEFAULT_CLASS_FRACTIONS
        # -- counters (tests/dashboards read these) --
        self.prefix_routed = 0          # requests routed by overlap
        self.prefix_overlap_tokens = 0  # cumulative overlap they carried
        self.shed_total = 0             # requests refused by admission
        self.shed_by_class: Dict[int, int] = {}
        self.admitted_by_class: Dict[int, int] = {}

    def update(self, replicas: List[Any]):
        with self._lock:
            self._replicas = list(replicas)
            live = {id(r) for r in replicas}
            self._inflight = {
                k: v for k, v in self._inflight.items() if k in live
            }
            self._prefix = {
                k: v for k, v in self._prefix.items() if k in live
            }

    def size(self) -> int:
        with self._lock:
            return len(self._replicas)

    # ------------------------------------------------- priority admission
    def configure_admission(self, max_ongoing: Optional[int],
                            class_fractions=None) -> None:
        """Bound total in-flight requests across the deployment's
        replicas. ``None`` disables admission control (default).
        ``class_fractions[p]`` scales the bound per priority class
        (class 0 = first entry = most important; classes past the end
        use the last entry)."""
        with self._lock:
            self._max_ongoing = (None if max_ongoing is None
                                 else max(1, int(max_ongoing)))
            if class_fractions is not None:
                self._class_fractions = tuple(
                    float(f) for f in class_fractions) or \
                    DEFAULT_CLASS_FRACTIONS

    def _admit_locked(self, priority: int) -> None:
        """Admission check for one request of class ``priority``; raises
        a typed ``RequestSheddedError`` when the class's nested
        threshold is full. Caller holds the lock and increments the
        in-flight count right after (shed requests never count)."""
        cap = self._max_ongoing
        if cap is None:
            self.admitted_by_class[priority] = \
                self.admitted_by_class.get(priority, 0) + 1
            return
        p = max(0, int(priority))
        frac = self._class_fractions[min(p, len(self._class_fractions) - 1)]
        limit = max(1, int(cap * frac))
        total = sum(self._inflight.values())
        if total >= limit:
            self.shed_total += 1
            self.shed_by_class[p] = self.shed_by_class.get(p, 0) + 1
            # Retry hint grows with how far past the class ceiling the
            # deployment is running — a crude queueing-delay estimate.
            retry = min(2.0, 0.1 * (1.0 + total / limit))
            raise RequestSheddedError(
                f"deployment at {total} ongoing requests >= class-{p} "
                f"admission limit {limit} (cap {cap}); shed by policy",
                priority=p, retry_after_s=retry)
        self.admitted_by_class[p] = self.admitted_by_class.get(p, 0) + 1

    def admission_stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "max_ongoing_requests": self._max_ongoing,
                "class_fractions": list(self._class_fractions),
                "ongoing": sum(self._inflight.values()),
                "shed_total": self.shed_total,
                "shed_by_class": dict(self.shed_by_class),
                "admitted_by_class": dict(self.admitted_by_class),
            }

    # ---------------------------------------------------------- prefix tier
    def update_prefix_digest(self, key: int, block_size: int,
                             digests) -> None:
        """Record one replica's cached-prefix report (the controller
        polls ``prefix_digest()`` off the request path)."""
        with self._lock:
            self._prefix[key] = (int(block_size), frozenset(digests))

    def has_prefix_digests(self) -> bool:
        with self._lock:
            return bool(self._prefix)

    def _prefix_candidate(self, digests_by_bs) -> Optional[Any]:
        """Best replica by contiguous leading-block overlap, or None
        when nothing (usefully) matches / the winner is overloaded.
        Caller holds the lock; the prompt digests were hashed OUTSIDE
        it (``digests_by_bs``: block_size -> chain digests)."""
        best, best_tokens = None, 0
        for r in self._replicas:
            ent = self._prefix.get(id(r))
            if ent is None:
                continue
            bs, dset = ent
            digs = digests_by_bs.get(bs)
            if digs is None:
                continue  # report arrived between snapshot and scoring
            overlap = 0
            for d in digs:
                if d not in dset:
                    break
                overlap += 1
            tokens = overlap * bs
            if tokens > best_tokens:
                best, best_tokens = r, tokens
        if best is None or best_tokens < PREFIX_MIN_OVERLAP_TOKENS:
            return None
        min_inflight = min(
            (self._inflight.get(id(r), 0) for r in self._replicas),
            default=0)
        if self._inflight.get(id(best), 0) > min_inflight + \
                PREFIX_LOAD_SLACK:
            return None  # cached replica is a hotspot: balance instead
        self.prefix_routed += 1
        self.prefix_overlap_tokens += best_tokens
        return best

    def plan_prefix(self, prefix_tokens) -> int:
        """Best cached-prefix overlap (in TOKENS) any replica advertises
        for this prompt — the disagg pairing layer's tail-skip plan: a
        prefill replica ships only blocks past this overlap, betting the
        prefix tier routes the decode stream onto the same winner.
        Advisory only: the decode replica re-validates against its OWN
        cache at graft time and a stale plan falls back, so over-
        estimating here costs a re-prefill, never correctness."""
        if prefix_tokens is None:
            return 0
        with self._lock:
            sizes = {bs for bs, _ in self._prefix.values()}
        if not sizes:
            return 0
        from ray_tpu_torch.llm.kv_cache import chain_digests

        digests_by_bs = {bs: chain_digests(prefix_tokens, bs)
                         for bs in sizes}
        best = 0
        with self._lock:
            for r in self._replicas:
                ent = self._prefix.get(id(r))
                if ent is None:
                    continue
                bs, dset = ent
                digs = digests_by_bs.get(bs)
                if digs is None:
                    continue
                overlap = 0
                for d in digs:
                    if d not in dset:
                        break
                    overlap += 1
                best = max(best, overlap * bs)
        return best

    # -------------------------------------------------------------- choose
    def choose(self, prefix_tokens=None, priority: int = 0) -> (int, Any):
        """Prefix-overlap scoring when ``prefix_tokens`` is given and a
        replica reported digests; otherwise power of two choices: sample
        two replicas, pick the one with the shorter queue. Falls back to
        the single replica when size==1. When admission control is
        configured (``max_ongoing_requests``) the request is first
        admitted against its priority class's nested threshold — a shed
        raises ``RequestSheddedError`` without touching any replica.

        Returns (key, replica); pass the key back to release()."""
        # Hash the prompt OUTSIDE the lock (a 4k prompt is hundreds of
        # chained blake2b links — concurrent routing must not serialize
        # on it); only the cheap set-overlap scoring holds the lock.
        digests_by_bs = None
        if prefix_tokens is not None:
            with self._lock:
                sizes = {bs for bs, _ in self._prefix.values()}
            if sizes:
                from ray_tpu_torch.llm.kv_cache import chain_digests

                digests_by_bs = {
                    bs: chain_digests(prefix_tokens, bs) for bs in sizes
                }
        with self._lock:
            n = len(self._replicas)
            if n == 0:
                raise RuntimeError("no replicas available")
            self._admit_locked(priority)
            replica = None
            if digests_by_bs and n > 1 and self._prefix:
                replica = self._prefix_candidate(digests_by_bs)
            if replica is None:
                if n == 1:
                    replica = self._replicas[0]
                else:
                    a, b = self._rng.sample(range(n), 2)
                    ra, rb = self._replicas[a], self._replicas[b]
                    qa = self._inflight.get(id(ra), 0)
                    qb = self._inflight.get(id(rb), 0)
                    replica = ra if qa <= qb else rb
            key = id(replica)
            self._inflight[key] = self._inflight.get(key, 0) + 1
            return key, replica

    def release(self, key: int):
        with self._lock:
            if self._inflight.get(key, 0) > 0:
                self._inflight[key] -= 1

    def queue_lengths(self) -> List[int]:
        with self._lock:
            return [self._inflight.get(id(r), 0) for r in self._replicas]
