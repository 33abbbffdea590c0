"""Actor-plane collective groups (counterpart of
``ray_tpu/collective/collective.py``): named groups of actors that
exchange tensors out of program, with the reference's group management
(``init_collective_group`` / ``create_collective_group``, rank and world
size) and rendezvous.

Every rank posts its contribution to the runtime's internal KV under a
``(group, epoch, round, rank)`` key, polls for the full round, and
combines locally, the same on every rank: the rendezvous of a gloo/TCP
store backend. The KV lives in this process (every port actor is a
thread of it), and a contribution is stored through the object store's
serialization: a CUDA tensor stays on its device (one device copy at
post, another at each read), so a group of actors on the card reduces on
the card. For data-parallel tensors inside one program, the in-program
collectives of ``collective/ops.py`` are the fast path.

Round keys are collected with a two-round lag: a rank entering round
``r`` has finished reading round ``r-1``, so each rank deletes its own
``r-2`` key on completing ``r``, with no coordination.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import torch


def _mean(t: torch.Tensor) -> torch.Tensor:
    if not (t.is_floating_point() or t.is_complex()):
        t = t.to(torch.float64)  # numpy's mean of integers
    return t.mean(0)


_REDUCERS = {
    "sum": lambda t: t.sum(0),
    "mean": _mean,
    "max": lambda t: t.amax(0),
    "min": lambda t: t.amin(0),
    "product": lambda t: t.prod(0),
}

_DEFAULT_TIMEOUT = 60.0
_POLL_S = 0.005

# Which rank this thread holds in each group, and the per-(group, rank)
# round counters. One actor is one thread, so thread identity tells the
# actors of this process apart.
_rank_of: Dict[tuple, int] = {}  # (group, thread-ident) -> rank
_seq: Dict[tuple, int] = {}      # (group, rank) -> collective round
_p2p_send: Dict[tuple, int] = {}  # (group, src, dst) -> send round
_p2p_recv: Dict[tuple, int] = {}  # (group, src, dst) -> recv round
_epoch_of: Dict[str, str] = {}    # group -> epoch this process joined
_lock = threading.Lock()


def _worker():
    from ray_tpu_torch._private.worker import auto_init

    return auto_init()


def _post(w, key: bytes, value) -> None:
    serialized = w.serialization_context.serialize(value)
    # A head-backed KV (a driver or node daemon attached to a head)
    # carries bytes: the wire form, tensors as host bytes.
    w.kv_put(key, serialized if getattr(w, "head_client", None) is None
             else serialized.to_bytes())


def _read(w, stored, device=None):
    """A posted value; one that crossed a head-backed KV comes back on
    the host and moves to ``device`` (the caller's tensor's)."""
    if isinstance(stored, (bytes, bytearray, memoryview)):
        from ray_tpu_torch._private.serialization import SerializedObject

        value = w.serialization_context.deserialize(
            SerializedObject.from_bytes(stored))
        if device is not None and isinstance(value, torch.Tensor):
            value = value.to(device)
        return value
    return w.serialization_context.deserialize(stored)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.as_tensor(x)


def _meta_key(group: str) -> bytes:
    return f"col|{group}|meta".encode()


def _parse_meta(raw: bytes) -> tuple:
    """The meta value is 'world_size|epoch'. The epoch changes every
    time the group is (re)created, so a rank that survived a destroy and
    re-create resets its stale counters on re-join."""
    ws, epoch = raw.decode().split("|", 1)
    return int(ws), epoch


def _group_epoch(group: str) -> str:
    with _lock:
        return _epoch_of.get(group, "")


def _round_key(group: str, seq: int, rank: int,
               epoch: Optional[str] = None) -> bytes:
    e = _group_epoch(group) if epoch is None else epoch
    return f"col|{group}|{e}|r{seq}|{rank}".encode()


def _p2p_key(group: str, src: int, dst: int, seq: int) -> bytes:
    return f"col|{group}|{_group_epoch(group)}|p2p|{src}|{dst}|{seq}" \
        .encode()


def init_collective_group(world_size: int, rank: int,
                          backend: str = "store",
                          group_name: str = "default") -> None:
    """Join the calling actor (thread) to a named group. ``backend`` is
    advisory, as in the reference."""
    w = _worker()
    existing = w.kv_get(_meta_key(group_name))
    if existing is None:
        w.kv_put(_meta_key(group_name),
                 f"{world_size}|{uuid.uuid4().hex[:8]}".encode(),
                 overwrite=False)
        existing = w.kv_get(_meta_key(group_name))
    ws, epoch = _parse_meta(existing)
    if ws != world_size:
        raise ValueError(
            f"group {group_name!r} exists with world_size "
            f"{ws} != {world_size}")
    with _lock:
        _rank_of[(group_name, threading.get_ident())] = rank
        if _epoch_of.get(group_name) != epoch:
            # The group was re-created since this process last joined:
            # stale round counters of the previous epoch reset.
            for k in [k for k in _seq if k[0] == group_name]:
                _seq.pop(k, None)
            for d in (_p2p_send, _p2p_recv):
                for k in [k for k in d if k[0] == group_name]:
                    d.pop(k, None)
            _epoch_of[group_name] = epoch
        _seq.setdefault((group_name, rank), 0)


def create_collective_group(actors: List[Any], world_size: int,
                            ranks: List[int],
                            backend: str = "store",
                            group_name: str = "default") -> None:
    """Driver-side declaration: each actor joins through its
    ``collective_join(world_size, rank, backend, group_name)`` method
    (the reference's convention)."""
    import ray_tpu_torch

    if len(actors) != len(ranks):
        raise ValueError("actors and ranks must align")
    refs = [a.collective_join.remote(world_size, r, backend, group_name)
            for a, r in zip(actors, ranks)]
    ray_tpu_torch.get(refs, timeout=_DEFAULT_TIMEOUT)


def _my_rank(group_name: str) -> int:
    key = (group_name, threading.get_ident())
    with _lock:
        if key not in _rank_of:
            raise RuntimeError(
                f"caller has not joined group {group_name!r}; call "
                f"init_collective_group first")
        return _rank_of[key]


def _world_size(group_name: str) -> int:
    raw = _worker().kv_get(_meta_key(group_name))
    if raw is None:
        raise RuntimeError(f"no collective group {group_name!r}")
    return _parse_meta(raw)[0]


def get_rank(group_name: str = "default") -> int:
    return _my_rank(group_name)


def get_collective_group_size(group_name: str = "default") -> int:
    return _world_size(group_name)


def _collect(group_name: str, value, combine, timeout: float):
    """Store rendezvous: post this rank's contribution, poll for the
    round, combine locally (in rank order, alike on every rank)."""
    w = _worker()
    ws = _world_size(group_name)
    rank = _my_rank(group_name)
    with _lock:
        seq = _seq[(group_name, rank)]
        _seq[(group_name, rank)] = seq + 1
    own_key = _round_key(group_name, seq, rank)
    _post(w, own_key, value)
    vals: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    while True:
        for r in range(ws):
            if r not in vals:
                stored = w.kv_get(_round_key(group_name, seq, r))
                if stored is not None:
                    vals[r] = _read(w, stored, getattr(value, "device",
                                                       None))
        if len(vals) == ws:
            break
        if time.monotonic() > deadline:
            # Withdraw, so a later round cannot complete against stale
            # data, and rewind the round counter for a clean retry.
            w.kv_del(own_key)
            with _lock:
                _seq[(group_name, rank)] = seq
            raise TimeoutError(
                f"collective on group {group_name!r}: only "
                f"{len(vals)}/{ws} ranks arrived within {timeout}s")
        time.sleep(_POLL_S)
    if seq >= 2:  # two-round-lag collection of this rank's old key
        w.kv_del(_round_key(group_name, seq - 2, rank))
    return combine([vals[r] for r in range(ws)])


def allreduce(tensor, group_name: str = "default", op: str = "sum",
              timeout: float = _DEFAULT_TIMEOUT) -> torch.Tensor:
    return _collect(group_name, _as_tensor(tensor),
                    lambda vals: _REDUCERS[op](torch.stack(vals)), timeout)


def allgather(tensor, group_name: str = "default",
              timeout: float = _DEFAULT_TIMEOUT) -> List[torch.Tensor]:
    return list(_collect(group_name, _as_tensor(tensor), list, timeout))


def reducescatter(tensor, group_name: str = "default", op: str = "sum",
                  timeout: float = _DEFAULT_TIMEOUT) -> torch.Tensor:
    ws = _world_size(group_name)
    rank = _my_rank(group_name)
    t = _as_tensor(tensor)
    if t.shape[0] % ws:
        raise ValueError(
            f"leading dim {t.shape[0]} not divisible by world size {ws}")
    full = _collect(group_name, t,
                    lambda vals: _REDUCERS[op](torch.stack(vals)), timeout)
    chunk = full.shape[0] // ws
    return full[rank * chunk:(rank + 1) * chunk].clone()


def broadcast(tensor, src_rank: int = 0, group_name: str = "default",
              timeout: float = _DEFAULT_TIMEOUT) -> torch.Tensor:
    return _collect(group_name, _as_tensor(tensor),
                    lambda vals: vals[src_rank], timeout)


def barrier(group_name: str = "default",
            timeout: float = _DEFAULT_TIMEOUT) -> None:
    _collect(group_name, None, lambda vals: None, timeout)


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    w = _worker()
    src = _my_rank(group_name)
    with _lock:
        seq = _p2p_send.get((group_name, src, dst_rank), 0)
        _p2p_send[(group_name, src, dst_rank)] = seq + 1
    _post(w, _p2p_key(group_name, src, dst_rank, seq), _as_tensor(tensor))


def recv(src_rank: int, group_name: str = "default",
         timeout: float = _DEFAULT_TIMEOUT) -> torch.Tensor:
    w = _worker()
    dst = _my_rank(group_name)
    with _lock:
        seq = _p2p_recv.get((group_name, src_rank, dst), 0)
        _p2p_recv[(group_name, src_rank, dst)] = seq + 1
    key = _p2p_key(group_name, src_rank, dst, seq)
    deadline = time.monotonic() + timeout
    while True:
        stored = w.kv_get(key)
        if stored is not None:
            w.kv_del(key)
            return _read(w, stored)
        if time.monotonic() > deadline:
            # Rewind, so a retry (or the late message) still lines up
            # with this sequence number instead of skipping it forever.
            with _lock:
                _p2p_recv[(group_name, src_rank, dst)] = seq
            raise TimeoutError(f"recv({src_rank}->{dst}) timed out")
        time.sleep(_POLL_S)


def destroy_collective_group(group_name: str = "default") -> None:
    w = _worker()
    for key in w.kv_keys(f"col|{group_name}|".encode()):
        w.kv_del(key)
    with _lock:
        for k in [k for k in _rank_of if k[0] == group_name]:
            _rank_of.pop(k, None)
        for k in [k for k in _seq if k[0] == group_name]:
            _seq.pop(k, None)
        for d in (_p2p_send, _p2p_recv):
            for k in [k for k in d if k[0] == group_name]:
                d.pop(k, None)
        # A re-created group mints a fresh epoch; forgetting ours makes
        # the next init_collective_group adopt it and reset counters.
        _epoch_of.pop(group_name, None)
