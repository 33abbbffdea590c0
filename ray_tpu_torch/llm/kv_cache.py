"""Paged KV cache with copy-on-write shared prefix blocks (counterpart of
``ray_tpu/llm/kv_cache.py``): fixed-size blocks in preallocated device
tensors plus host-side block-table, refcount and content-hash
bookkeeping (vLLM's BlockSpaceManager + automatic prefix caching).

The device side is two tensors ``[L, num_blocks, block_size, n_kv_heads,
head_dim]`` built once by ``models.init_kv_cache`` on the engine's device.
The model functions update them in place. The host side is integer
bookkeeping: a free list, per-sequence block tables and a prefix cache:

- Every FULL block of a prompt is content-hashed by its parent-chain
  digest ``digest_i = H(digest_{i-1}, tokens_i)``; a digest match means
  the whole token prefix up to that block is identical.
- ``allocate_prefix`` shares a new prompt's leading cached full blocks
  (refcount++), so the engine skips their prefill. At most
  ``len(prompt) - 1`` tokens are skipped, and a fully-cached prompt
  copies its final shared block on write (``cow_copies``).
- Freeing drops refcounts; registered zero-ref blocks park in an LRU
  cached-free tier that still serves prefix hits until reclaimed.

Block 0 is the NULL block: never handed out; every padded table entry
points at it, so prefill/decode scatter unconditionally and the
attention masks keep block 0 out of every softmax.

Aux pools (the speculative-decoding draft cache) ride the same block
tables: one host-side manager, several device pools. Every event that
moves bytes (COW copy, export, graft) covers every pool.

Under tensor parallelism (``mesh=``) the pool is held per shard: ``data``
is the list of per-shard ``{"k", "v"}`` pools, each with the
``n_kv_heads / tp`` KV heads of its shard on its device
(``kv_cache_specs``). Block ids stay global and the host bookkeeping is
unchanged; a COW copy, an export or a graft covers every shard (an
export joins the shards' heads, a graft splits them). Aux pools are not
supported under a mesh, as in the reference.

Export and graft (disaggregated serving) differ from the reference in
two places. The reference gathers outside the lock against a snapshot of
immutable JAX arrays; here the step loop updates the pools in place, so
the gather (``index_select``, which copies) runs under the lock and only
the copy to the host runs outside it. And bf16 has no numpy dtype, so the
payload carries CPU tensors under the reference's keys.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch.exceptions import KVCacheOOM
from ray_tpu_torch.models.transformer import init_kv_cache
from ray_tpu_torch.parallel.sharding import kv_cache_specs, shard_params

__all__ = ["KVCacheOOM", "PagedKVCache", "chain_digests"]

NULL_BLOCK = 0

# Truncated hex digest length. 16 hex chars = 64 bits per chained link —
# collisions are negligible at any realistic cache size, and compact
# digests keep the router's replica prefix reports small on the wire.
_DIGEST_LEN = 16


def chain_digests(tokens: Sequence[int], block_size: int) -> List[str]:
    """Parent-chained content digests of every FULL block of ``tokens``.

    ``out[i]`` commits to ``tokens[: (i+1)*block_size]`` — the whole
    prefix, not just block ``i`` — so matching ``out[i]`` against a
    registered block implies every earlier block matched too. Shared by
    the cache (registration/matching) and the Serve prefix router
    (scoring replicas by cached-prefix overlap).
    """
    out: List[str] = []
    parent = b""
    for i in range(len(tokens) // block_size):
        blk = tokens[i * block_size:(i + 1) * block_size]
        h = hashlib.blake2b(digest_size=16)
        h.update(parent)
        h.update(np.asarray(blk, np.int64).tobytes())
        parent = h.digest()
        out.append(h.hexdigest()[:_DIGEST_LEN])
    return out


class PagedKVCache:
    """Host-side block manager for one preallocated paged KV pool."""

    def __init__(self, model_cfg, num_blocks: int, block_size: int,
                 dtype=None, *, enable_prefix_caching: bool = True,
                 device="cuda", mesh=None, rules=None):
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is NULL)")
        self.model_cfg = model_cfg
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.enable_prefix_caching = bool(enable_prefix_caching)
        self.mesh = mesh
        if mesh is None:
            self.data = init_kv_cache(model_cfg, num_blocks, block_size,
                                      dtype, device=device)
        else:
            # Cut along n_kv_heads, each shard's heads on its device.
            self.data = shard_params(
                init_kv_cache(model_cfg, num_blocks, block_size, dtype,
                              device="cpu"),
                mesh, kv_cache_specs(rules))
        # LIFO free list, block 0 reserved as NULL.
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._tables: Dict[int, List[int]] = {}
        self._ref: Dict[int, int] = {}           # block -> refcount
        self._block_key: Dict[int, str] = {}     # block -> chain digest
        self._key_block: Dict[str, int] = {}     # chain digest -> block
        # refcount-0 registered blocks, LRU order (oldest first).
        self._cached_free: "OrderedDict[int, str]" = OrderedDict()
        # per-sequence prompt digests + how many blocks are registered.
        self._prompt_digests: Dict[int, List[str]] = {}
        self._registered_upto: Dict[int, int] = {}
        self._lock = threading.Lock()
        # name -> {"k", "v"} pools sharing this manager's block layout.
        self._aux: Dict[str, Dict[str, torch.Tensor]] = {}
        # -- accounting (engine tests/bench read these) --
        self.peak_blocks_in_use = 0
        self.total_blocks_allocated = 0
        self.total_blocks_freed = 0
        # -- prefix-cache counters --
        self.prefix_cache_queries = 0      # allocate_prefix calls
        self.prefix_cache_hits = 0         # queries with >= 1 cached token
        self.prefix_cache_query_tokens = 0  # prompt tokens seen by queries
        self.prefill_tokens_saved = 0      # tokens skipped via cache hits
        self.cow_copies = 0                # shared blocks copied on write
        self.cached_blocks_evicted = 0     # cached-free blocks reclaimed
        # -- disaggregated-serving shipping counters --
        self.blocks_exported = 0           # blocks packed for shipping
        self.blocks_grafted = 0            # shipped blocks written back in

    # ------------------------------------------------------------- capacity
    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1  # NULL block excluded

    @property
    def blocks_in_use(self) -> int:
        """Blocks referenced by live sequences (cached-free blocks are
        reusable on demand, so they count as free)."""
        return self.usable_blocks - self.free_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free) + len(self._cached_free)

    @property
    def cached_free_blocks(self) -> int:
        return len(self._cached_free)

    def blocks_for_tokens(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.block_size)

    def can_allocate(self, n_tokens: int) -> bool:
        return self.blocks_for_tokens(n_tokens) <= self.free_blocks

    # ----------------------------------------------------- internal helpers
    def _pop_block(self) -> Optional[int]:
        """One reusable block: plain free list first, else reclaim the
        LRU cached-free block (its digest entries are removed FIRST, so
        a racing admit can never match — and resurrect — a block whose
        bytes are about to be overwritten)."""
        if self._free:
            return self._free.pop()
        if self._cached_free:
            block, key = self._cached_free.popitem(last=False)
            self._deregister(block)
            self.cached_blocks_evicted += 1
            return block
        return None

    def _deregister(self, block: int) -> None:
        key = self._block_key.pop(block, None)
        if key is not None and self._key_block.get(key) == block:
            del self._key_block[key]

    def _release_block(self, block: int) -> int:
        """Drop one reference; returns 1 when the block became free."""
        n = self._ref.get(block, 1) - 1
        if n > 0:
            self._ref[block] = n
            return 0
        self._ref.pop(block, None)
        key = self._block_key.get(block)
        if key is not None and self.enable_prefix_caching:
            self._cached_free[block] = key
            self._cached_free.move_to_end(block)
        else:
            self._deregister(block)
            self._free.append(block)
        self.total_blocks_freed += 1
        return 1

    def _activate_cached(self, block: int) -> None:
        """A prefix hit on a cached-free block pulls it back live."""
        self._cached_free.pop(block, None)

    def _note_alloc(self, n: int) -> None:
        self.total_blocks_allocated += n
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.blocks_in_use)

    # ----------------------------------------------------------- allocation
    def allocate(self, seq_id: int, n_tokens: int) -> bool:
        """Give ``seq_id`` a fresh (non-prefix-matched) table covering
        ``n_tokens`` positions. Returns False (allocating nothing) when
        the pool can't cover it — the scheduler parks the request."""
        need = self.blocks_for_tokens(n_tokens)
        with self._lock:
            if seq_id in self._tables:
                raise ValueError(f"sequence {seq_id} already allocated")
            if need > self.free_blocks:
                return False
            blocks = [self._pop_block() for _ in range(need)]
            for b in blocks:
                self._ref[b] = 1
            self._tables[seq_id] = blocks
            self._note_alloc(need)
            return True

    def allocate_prefix(self, seq_id: int, prompt: Sequence[int],
                        extra_tokens: int = 1) -> Optional[int]:
        """Allocate ``seq_id``'s table for ``len(prompt) + extra_tokens``
        positions, SHARING every leading full block whose chain digest
        is already cached. Returns the number of prompt tokens whose KV
        is already present (the engine skips prefilling them), or None
        when the pool can't cover the unshared remainder.

        At most ``len(prompt) - 1`` tokens are reported cached (the last
        prompt position must be computed for its logits); when the match
        extends into the written range — a fully-cached prompt — the
        boundary shared block is copied on write here, so the prefill
        scatter never touches a block another sequence references.
        """
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        need = self.blocks_for_tokens(len(prompt) + extra_tokens)
        if not self.enable_prefix_caching:
            ok = self.allocate(seq_id, len(prompt) + extra_tokens)
            return 0 if ok else None
        digests = chain_digests(prompt, self.block_size)
        with self._lock:
            if seq_id in self._tables:
                raise ValueError(f"sequence {seq_id} already allocated")
            self.prefix_cache_queries += 1
            self.prefix_cache_query_tokens += len(prompt)
            matched: List[int] = []
            for d in digests:
                b = self._key_block.get(d)
                if b is None:
                    break
                matched.append(b)
            cached_len = min(len(matched) * self.block_size,
                             len(prompt) - 1)
            # A fully-cached prompt writes into its final matched block:
            # if that block has a LIVE holder the write will copy-on-
            # write, costing one extra block — reserve it up front so a
            # request that fits never parks on a failed COW pop.
            cow_blocks = 0
            if matched and cached_len < len(matched) * self.block_size:
                boundary = matched[cached_len // self.block_size]
                if self._ref.get(boundary, 0) >= 1:
                    cow_blocks = 1
            if need - len(matched) + cow_blocks > self.free_blocks - sum(
                    1 for b in matched if b in self._cached_free):
                # The fresh remainder doesn't fit even after reclaiming
                # every NON-matched cached-free block. (Matched blocks
                # sitting in cached-free must not be double-counted as
                # reclaimable — activating them below removes them from
                # that tier.)
                return None
            # Take the shared prefix: refcount++ (activating any block
            # parked in cached-free), then fresh blocks for the rest.
            for b in matched:
                self._activate_cached(b)
                self._ref[b] = self._ref.get(b, 0) + 1
            def _rollback(fresh):
                for f in fresh:
                    self._ref.pop(f, None)
                    self._free.append(f)
                for m in matched:
                    if self._release_block(m):
                        self.total_blocks_freed -= 1  # not a real free

            fresh: List[int] = []
            for _ in range(need - len(matched)):
                b = self._pop_block()
                if b is None:  # raced: roll everything back
                    _rollback(fresh)
                    return None
                self._ref[b] = 1
                fresh.append(b)
            table = matched + fresh
            # Fully-cached boundary: the prefill will write positions
            # [cached_len, ...) and cached_len falls INSIDE the last
            # matched block -> copy-on-write it now.
            if matched and cached_len < len(matched) * self.block_size:
                idx = cached_len // self.block_size
                try:
                    table[idx] = self._make_private(table[idx])
                except KVCacheOOM:
                    _rollback(fresh)
                    return None
            self._tables[seq_id] = table
            self._prompt_digests[seq_id] = digests
            self._registered_upto[seq_id] = 0
            self._note_alloc(need - len(matched))
            if cached_len > 0:
                self.prefix_cache_hits += 1
                self.prefill_tokens_saved += cached_len
            return cached_len

    def _make_private(self, block: int) -> int:
        """Return a privately-owned, unregistered block with ``block``'s
        content: the block itself if this sequence is the only holder
        (deregistered — its content is about to change), else a fresh
        copy-on-write clone."""
        if self._ref.get(block, 1) <= 1:
            self._deregister(block)
            return block
        new = self._pop_block()
        if new is None:
            raise KVCacheOOM("no free block for copy-on-write")
        self._copy_block_data(block, new)
        self._ref[block] -= 1
        self._ref[new] = 1
        self._note_alloc(1)  # COW is a real allocation: keep the
        self.cow_copies += 1  # allocated/freed/peak contract balanced
        return new

    def _main_pools(self) -> List[Dict[str, torch.Tensor]]:
        """The main pool's per-shard ``{"k", "v"}`` dicts (one without a
        mesh)."""
        return self.data if self.mesh is not None else [self.data]

    def _copy_block_data(self, src: int, dst: int) -> None:
        """Device-side block copy (K and V, all layers, every pool), in
        place on the pool tensors. The reference jits this with the pool
        donated so XLA updates in place; an indexed copy does the same
        here. Aux pools share the block layout, so a draft cache left
        pointing at the donor block would read another sequence's
        context."""
        with torch.no_grad():
            for pools in (*self._main_pools(), *self._aux.values()):
                for name in ("k", "v"):
                    pool = pools[name]
                    pool[:, dst] = pool[:, src]

    def ensure_slot(self, seq_id: int, position: int) -> bool:
        """Grow ``seq_id``'s table so ``position`` has a physical slot
        this sequence may WRITE (at most one new block per decode step;
        a shared or registered block containing the slot goes private
        first). False on pool-empty — the scheduler's eviction policy
        decides who pays."""
        with self._lock:
            table = self._tables[seq_id]
            need_len = position // self.block_size + 1
            if need_len <= len(table):
                idx = position // self.block_size
                b = table[idx]
                if self._ref.get(b, 1) > 1 or b in self._block_key:
                    try:
                        table[idx] = self._make_private(b)
                    except KVCacheOOM:
                        return False
                return True
            b = self._pop_block()
            if b is None:
                return False
            self._ref[b] = 1
            table.append(b)
            self._note_alloc(1)
            return True

    def free(self, seq_id: int) -> int:
        """Release ``seq_id``'s references. Returns the number of blocks
        that actually became free (shared blocks stay with their other
        holders; registered ones park in the cached-free tier)."""
        with self._lock:
            blocks = self._tables.pop(seq_id, None)
            self._prompt_digests.pop(seq_id, None)
            self._registered_upto.pop(seq_id, None)
            if not blocks:
                return 0
            return sum(self._release_block(b) for b in reversed(blocks))

    # ------------------------------------------------- aux pools + shipping
    def attach_aux(self, name: str, model_cfg, dtype=None) -> None:
        """Attach a second device pool (same ``num_blocks`` x
        ``block_size`` geometry, possibly another model config: the
        spec-decode draft cache) that rides this manager's block tables.
        Aux pools are copied on COW, packed by ``export_blocks`` and
        written by ``graft_blocks``."""
        if self.mesh is not None:
            raise ValueError("aux pools are not supported under tensor "
                             "parallelism")
        device = self.data["k"].device
        with self._lock:
            if name in self._aux:
                raise ValueError(f"aux pool {name!r} already attached")
            self._aux[name] = init_kv_cache(
                model_cfg, self.num_blocks, self.block_size, dtype,
                device=device)

    def aux_data(self, name: str) -> Dict[str, torch.Tensor]:
        return self._aux[name]

    def set_aux_data(self, name: str, data: Dict[str, torch.Tensor]
                     ) -> None:
        self._aux[name] = data

    def export_blocks(self, seq_id: int, start_block: int = 0) -> dict:
        """Pack ``seq_id``'s block data from ``start_block`` on into a
        host payload (per-layer block ranges of every pool), what a
        disaggregated prefill replica publishes. ``start_block`` ships
        only the tail a decode replica's prefix cache lacks.

        Payload keys are the reference's: ``start_block``, ``blocks``,
        ``block_size``, and when any block ships ``k``/``v`` ``[L, n,
        block_size, n_kv_heads, head_dim]`` and ``aux: {name: {k, v}}``,
        as CPU tensors in the pools' dtypes."""
        with self._lock:
            blocks = list(self._tables[seq_id])[start_block:]
            payload = {
                "start_block": int(start_block),
                "blocks": len(blocks),
                "block_size": self.block_size,
            }
            if blocks:
                # The pools change in place under the step loop: gather
                # (a copy) under the lock; a sharded pool's heads join.
                def gather(pools):
                    out = {}
                    for n in ("k", "v"):
                        parts = [p[n].index_select(1, torch.tensor(
                            blocks, dtype=torch.long, device=p[n].device))
                            for p in pools]
                        out[n] = parts[0] if len(parts) == 1 else torch.cat(
                            [t.to(parts[0].device) for t in parts], dim=3)
                    return out

                gathered = [gather(self._main_pools())] + [
                    gather([p]) for p in self._aux.values()]
            self.blocks_exported += len(blocks)
        if blocks:
            host = [{n: t.cpu() for n, t in g.items()} for g in gathered]
            payload.update(host[0])
            payload["aux"] = dict(zip(self._aux, host[1:]))
        return payload

    def graft_blocks(self, seq_id: int, payload: dict,
                     start_block: Optional[int] = None) -> int:
        """Write a peer's exported block payload into ``seq_id``'s table,
        from ``start_block`` on (default: the payload's own start). A
        graft start past the payload's start skips leading payload blocks
        (this pool's prefix cache covered more than the shipping plan
        assumed; shared blocks are never written). Every target block
        must be privately owned and unregistered. Returns blocks grafted.

        Callers serialize against the engine's step loop (the engine
        grafts under its step lock)."""
        if int(payload["block_size"]) != self.block_size:
            raise ValueError(
                f"payload block_size {payload['block_size']} != pool "
                f"block_size {self.block_size}")
        src_start = int(payload["start_block"])
        n = int(payload["blocks"])
        sb = src_start if start_block is None else int(start_block)
        off = sb - src_start
        if off < 0:
            raise ValueError(
                f"graft start {sb} precedes payload start {src_start}")
        with self._lock:
            table = self._tables[seq_id]
            dst = table[sb:src_start + n]
            if not dst:
                return 0
            for b in dst:
                if self._ref.get(b, 0) != 1 or b in self._block_key:
                    raise ValueError(
                        f"graft target block {b} is shared or "
                        f"registered: grafting would corrupt another "
                        f"sequence's context")
            pairs = [(self._main_pools(), payload)] + [
                ([self._aux[a]], p) for a, p in payload.get("aux", {}).items()
                if a in self._aux]
            with torch.no_grad():
                for pools, part in pairs:
                    for name in ("k", "v"):
                        src = part[name][:, off:off + len(dst)]
                        heads = 0   # a sharded pool takes its own heads
                        for pool in pools:
                            t = pool[name]
                            width = t.shape[3]
                            piece = src[:, :, :, heads:heads + width]
                            idx = torch.tensor(dst, dtype=torch.long,
                                               device=t.device)
                            t.index_copy_(1, idx, piece.to(device=t.device,
                                                           dtype=t.dtype))
                            heads += width
            self.blocks_grafted += len(dst)
            return len(dst)

    # -------------------------------------------------------- prefix cache
    def register_prefix(self, seq_id: int, upto_tokens: int) -> int:
        """Register ``seq_id``'s full prompt blocks covering
        ``[0, upto_tokens)`` as shareable (called by the engine after
        each prefill chunk lands, so a concurrent same-prefix request
        can hit blocks mid-prefill). Returns blocks newly registered."""
        if not self.enable_prefix_caching:
            return 0
        with self._lock:
            digests = self._prompt_digests.get(seq_id)
            if digests is None:
                return 0
            table = self._tables.get(seq_id, [])
            start = self._registered_upto.get(seq_id, 0)
            upto = min(upto_tokens // self.block_size, len(digests),
                       len(table))
            new = 0
            for i in range(start, upto):
                d = digests[i]
                b = table[i]
                if d in self._key_block or b in self._block_key:
                    continue  # another block is already canonical
                self._key_block[d] = b
                self._block_key[b] = d
                new += 1
            self._registered_upto[seq_id] = max(start, upto)
            return new

    def prefix_digest(self, limit: Optional[int] = None) -> List[str]:
        """Report of every registered chain digest (live and cached-
        free): what a Serve replica publishes so the router can score it
        by cached-prefix overlap. Unbounded by default (at most
        ``usable_blocks`` entries); with ``limit``, the FIRST-registered
        digests are kept: registration runs prefix to tail, so a
        truncated report loses long chains' tails, never their heads."""
        with self._lock:
            out = list(self._key_block.keys())
        return out if limit is None else out[:limit]

    def refcount(self, block: int) -> int:
        with self._lock:
            return self._ref.get(block, 0)

    # -------------------------------------------------------------- queries
    def table(self, seq_id: int) -> List[int]:
        with self._lock:
            return list(self._tables[seq_id])

    def num_seqs(self) -> int:
        with self._lock:
            return len(self._tables)

    def padded_tables(self, seq_ids: List[int],
                      pad_len: Optional[int] = None) -> np.ndarray:
        """[B, M] int32 block-table batch, rows padded with NULL_BLOCK."""
        with self._lock:
            tables = [self._tables[s] for s in seq_ids]
        m = max((len(t) for t in tables), default=1)
        m = max(m, pad_len or 1)
        out = np.full((len(tables), m), NULL_BLOCK, np.int32)
        for i, t in enumerate(tables):
            out[i, :len(t)] = t
        return out

    def stats(self) -> Dict[str, int]:
        with self._lock:
            saved = self.prefill_tokens_saved
            seen = self.prefix_cache_query_tokens
            return {
                "num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "usable_blocks": self.usable_blocks,
                "blocks_in_use": self.blocks_in_use,
                "free_blocks": self.free_blocks,
                "cached_free_blocks": len(self._cached_free),
                "peak_blocks_in_use": self.peak_blocks_in_use,
                "total_blocks_allocated": self.total_blocks_allocated,
                "total_blocks_freed": self.total_blocks_freed,
                "live_sequences": len(self._tables),
                "prefix_caching_enabled": int(self.enable_prefix_caching),
                "prefix_cache_queries": self.prefix_cache_queries,
                "prefix_cache_hits": self.prefix_cache_hits,
                "prefill_tokens_saved": saved,
                "prefix_cache_hit_rate": (saved / seen) if seen else 0.0,
                "cow_copies": self.cow_copies,
                "cached_blocks_evicted": self.cached_blocks_evicted,
                "blocks_exported": self.blocks_exported,
                "blocks_grafted": self.blocks_grafted,
                "aux_pools": list(self._aux),
            }
