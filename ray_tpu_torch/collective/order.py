"""The order of the backward's exchanges across processes
(``collective/ops.py``, ``parallel/ring_attention.py``,
``parallel/ulysses.py``, ``parallel/moe.py``).

The backward's exchanges across processes run in one order in every
process, however many devices a process drives. Autograd runs a node on
the thread of its inputs' device, one thread a device, so with several
devices the order in which two ready exchange nodes run follows the
timing of the other devices' threads, and two processes could post two
exchanges on one process group in opposite orders: a deadlock, or, for
two point-to-point exchanges of one shape (ring attention's K and V
hops), cotangents silently swapped. So every exchange across processes
that autograd records in one scope joins a chain (``_Chain``): its
Function takes the previous exchange's token (a 0-d tensor that the
previous one returns) as an input and returns a token of its own. The
backward of the later exchange hands the earlier one a zero cotangent
for its token, so autograd makes the earlier node ready only once the
later one has run: the backward posts the exchanges in the reverse of
the forward's order, which is program order and the same in every
process. No thread waits for another: a node is simply not ready before
its turn. A chain lives only as long as its scope: ``backward_order()``
opens one for a block whose graph is backwarded as a whole (the
training step's forward, each recorded call of the pipeline), and each
op of ``collective/ops.py``, as ring attention, Ulysses and MoE's
dispatch and combine, runs in the caller's chain (``in_order``) or,
called outside any, in one of its own for that call. So on a process of several devices, calls
composed into one graph go under one ``backward_order()``. Exchanges
made inside a backward (a checkpoint's recompute, whose graph autograd
discards) join no chain; the training step refuses ``remat`` where they
would cross processes from several devices. The chain also makes a
process run an exchange's backward whenever a later exchange's runs,
even where its loss reads none of the op's results (the cotangents are
then zeros). Only an exchange that neither its loss nor a later
exchange reaches has no backward; its peers would then wait for its
cotangents until ``distributed.TIMEOUT``.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional

import torch


class _Chain:
    """The exchanges across processes of one scope, in the order the
    forward made them: ``last`` is the newest one's token."""

    def __init__(self):
        self.last: Optional[torch.Tensor] = None


_local = threading.local()


@contextlib.contextmanager
def backward_order():
    """A chain of its own for the exchanges across processes made inside
    the block: their backward runs in reverse order among themselves and
    nothing links them to the exchanges made before or after it. The
    chain ends with the block."""
    prev = getattr(_local, "chain", None)
    _local.chain = _Chain()
    try:
        yield
    finally:
        _local.chain = prev


def in_order(fn):
    """``fn``'s exchanges across processes join the caller's chain, or,
    outside any ``backward_order()``, one of their own for the call."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        if getattr(_local, "chain", None) is not None:
            return fn(*args, **kwargs)
        with backward_order():
            return fn(*args, **kwargs)
    return run


def ordered(function, *args) -> tuple:
    """``function.apply(*args, after)`` in the scope's chain:
    ``function`` returns its results and a token, and its backward a zero
    cotangent for ``after`` (``link`` and ``unlink``). Outside a scope,
    with autograd off, inside a backward or on inputs that need no
    gradient, it joins no chain. Returns the results."""
    chain = getattr(_local, "chain", None)
    if not torch.is_grad_enabled() or \
            torch._C._current_graph_task_id() != -1 or \
            not any(isinstance(a, torch.Tensor) and a.requires_grad
                    for a in args):
        chain = None
    out = function.apply(*args, None if chain is None else chain.last)
    if chain is not None:
        chain.last = out[-1]
    return out[:-1]


def link(ctx, after: Optional[torch.Tensor],
         device: torch.device) -> torch.Tensor:
    """In an ordered Function's forward: keep what its backward needs and
    make its token on ``device``."""
    ctx.after = None if after is None else after.device
    return torch.zeros((), device=device)


def unlink(ctx) -> Optional[torch.Tensor]:
    """In an ordered Function's backward: the cotangent of ``after``."""
    return None if ctx.after is None else torch.zeros((), device=ctx.after)
