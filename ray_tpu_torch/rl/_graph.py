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
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


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
        self._graph.replay()
        self.replays += 1
        return self._out

    def _capture(self):
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
        with torch.cuda.graph(graph):
            out = self.fn()
        with torch.no_grad():
            for t, s in zip(self.state, saved):
                t.copy_(s)
        for g, s in zip(self.generators, gen_states):
            g.set_state(s)
        self._graph, self._out = graph, out
