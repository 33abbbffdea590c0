"""One device program per call, captured as a CUDA graph on the card.

The reference jits each of its RL programs (the rollout's ``lax.scan``,
the PPO update, DQN's ``train_many``) into one XLA program. Here such a
program is a Python function over static tensors: ``GraphProgram(fn,
...)`` calls ``fn()`` eagerly on the CPU, and on the card captures it once
as a ``torch.cuda.CUDAGraph`` at its first call and replays the graph on
every call after, so one call costs one graph launch on the host. ``fn``
reads its inputs from tensors it closes over (the caller copies fresh
values into them with ``copy_`` before a call) and updates its state in
place; its result is a tensor or a tuple of tensors that the next call
overwrites.

Capture needs one eager warm-up run on a side stream first (lazy
initialisation of cuBLAS and autograd must not happen while capturing).
That run is undone: the tensors in ``state`` and the generators in
``generators`` are restored, so the first replay starts where an eager
call would have, and a replay draws the same numbers as an eager call
from the same generator state (the generators are registered with the
graph). A capture that fails raises: nothing falls back to eager on the
card.

Programs run in several threads of one process: each remote env runner
is an actor thread, beside the learner's thread. A capture must see no
other device work of the process while it runs: on the H100 a capture in
one thread was invalidated by runner actors being built in others, in
the thread-local capture mode too, and a default-priority
``torch.cuda.Stream()`` may be the very pool stream another thread is
capturing on. So:

- ``_GATE`` keeps captures and the RL device work of other threads
  apart. A capture is exclusive: it waits until no ``device_work()``
  section runs and holds new ones off until it ends (so two captures,
  which share ``torch.cuda.graph``'s one capture stream, never overlap
  either). A runner's construction and every step of a sample, a
  learner's copies into a program's inputs, and every replay run inside
  ``device_work()``, which any number of threads hold at once: replays
  of different threads still overlap on the card. A thread never
  captures while it holds a ``device_work()`` section, so the gate
  cannot deadlock.
- Python's cyclic garbage collector is off during a capture: it could
  destroy an unreachable program's CUDA graph inside the capture, which
  CUDA refuses there.
- The capture itself is in ``capture_error_mode="thread_local"``, and a
  runner's stream comes from the high-priority pool, which no capture
  draws from (rl/env_runner.py).

A program replays on the calling thread's current stream, so a runner on
its own stream overlaps the learner on the card.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from typing import Callable, Iterable

import torch


class _CaptureGate:
    """Many ``work()`` sections at once, or one ``capture()``; a waiting
    capture holds new work off, so a stream of work cannot starve it."""

    def __init__(self):
        self._cv = threading.Condition()
        self._working = 0
        self._capturing = False
        self._waiting = 0

    @contextlib.contextmanager
    def work(self):
        with self._cv:
            self._cv.wait_for(
                lambda: not self._capturing and not self._waiting)
            self._working += 1
        try:
            yield
        finally:
            with self._cv:
                self._working -= 1
                self._cv.notify_all()

    @contextlib.contextmanager
    def capture(self):
        with self._cv:
            self._waiting += 1
            self._cv.wait_for(
                lambda: not self._capturing and not self._working)
            self._waiting -= 1
            self._capturing = True
        try:
            yield
        finally:
            with self._cv:
                self._capturing = False
                self._cv.notify_all()


_GATE = _CaptureGate()


def device_work():
    """A section of RL device work that no capture may overlap."""
    return _GATE.work()


class GraphProgram:
    """``fn`` run eagerly on the CPU, or as one CUDA graph replayed per
    call on the card. ``replays`` counts the graph's replays; setting
    ``graph`` to False before the first call runs ``fn`` eagerly on the
    card too (the twin that a graph is checked against)."""

    def __init__(self, fn: Callable, device: torch.device,
                 state: Iterable[torch.Tensor] = (),
                 generators: Iterable[torch.Generator] = ()):
        self.fn = fn
        self.device = device
        self.state = list(state)
        self.generators = list(generators)
        self.graph = device.type == "cuda"
        self._graph = None
        self._out = None
        self.replays = 0

    def __call__(self):
        if not self.graph:
            return self.fn()
        if self._graph is None:
            self._capture()
        with device_work():
            self._graph.replay()
        self.replays += 1
        return self._out

    def _capture(self):
        enabled = gc.isenabled()
        with _GATE.capture():
            gc.collect()
            gc.disable()
            try:
                self._capture_alone()
            finally:
                if enabled:
                    gc.enable()

    def _capture_alone(self):
        with torch.no_grad():
            saved = [t.detach().clone() for t in self.state]
        gen_states = [g.get_state() for g in self.generators]
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.fn()
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self.fn()
        with torch.no_grad():
            for t, s in zip(self.state, saved):
                t.copy_(s)
        for g, s in zip(self.generators, gen_states):
            g.set_state(s)
        self._graph, self._out = graph, out
