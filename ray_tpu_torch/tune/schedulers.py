"""Trial schedulers (copy of ``ray_tpu/tune/schedulers.py``): FIFO, ASHA,
HyperBand's brackets of ASHA, the median stopping rule and population
based training, each deciding from the results it is fed alone."""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class FIFOScheduler:
    """No early stopping."""

    def on_result(self, trial_id: str, result: Dict[str, Any]) -> str:
        return CONTINUE


class ASHAScheduler:
    """Asynchronous Successive Halving: rungs at base^k steps; a trial
    reaching a rung survives only if in the top 1/reduction_factor of
    completed results at that rung."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4):
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace = grace_period
        self.rf = reduction_factor
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        self._rung_results: Dict[int, List[float]] = {
            r: [] for r in self.rungs}
        self._trial_iters: Dict[str, int] = {}

    def on_result(self, trial_id: str, result: Dict[str, Any]) -> str:
        it = self._trial_iters.get(trial_id, 0) + 1
        self._trial_iters[trial_id] = it
        value = float(result[self.metric])
        if self.mode == "min":
            value = -value
        for rung in self.rungs:
            if it == rung:
                peers = self._rung_results[rung]
                peers.append(value)
                k = max(1, len(peers) // self.rf)
                top_k = sorted(peers, reverse=True)[:k]
                if value < min(top_k):
                    return STOP
        if it >= self.max_t:
            return STOP
        return CONTINUE


class HyperBandScheduler:
    """HyperBand proper (async formulation, reference:
    schedulers/async_hyperband.py): `brackets` parallel ASHA instances
    with geometrically staggered grace periods — late-bracket trials
    get longer minimum budgets, hedging against slow starters that
    aggressive early halving would kill. Trials round-robin across
    brackets at registration. BOHB = this scheduler + TPESearcher as
    the search_alg."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4, brackets: int = 3):
        self._brackets: List[ASHAScheduler] = []
        for s in range(max(int(brackets), 1)):
            grace = min(grace_period * reduction_factor ** s, max_t)
            self._brackets.append(ASHAScheduler(
                metric, mode, max_t=max_t, grace_period=grace,
                reduction_factor=reduction_factor))
        self._of: Dict[str, ASHAScheduler] = {}
        self._rr = 0

    def register(self, trial_id: str, config: Dict[str, Any]):
        self._of[trial_id] = self._brackets[self._rr
                                            % len(self._brackets)]
        self._rr += 1

    def on_result(self, trial_id: str, result: Dict[str, Any]) -> str:
        bracket = self._of.get(trial_id)
        if bracket is None:  # unregistered trial: assign round-robin
            self.register(trial_id, {})
            bracket = self._of[trial_id]
        return bracket.on_result(trial_id, result)


class MedianStoppingRule:
    """Stop a trial whose best result is below the median of running
    averages of completed peers at the same step."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 grace_period: int = 5):
        self.metric = metric
        self.mode = mode
        self.grace = grace_period
        self._history: Dict[str, List[float]] = {}

    def on_result(self, trial_id: str, result: Dict[str, Any]) -> str:
        value = float(result[self.metric])
        if self.mode == "min":
            value = -value
        hist = self._history.setdefault(trial_id, [])
        hist.append(value)
        step = len(hist)
        if step < self.grace:
            return CONTINUE
        peer_means = [
            sum(h[:step]) / min(len(h), step)
            for tid, h in self._history.items()
            if tid != trial_id and len(h) >= step
        ]
        if not peer_means:
            return CONTINUE
        peer_means.sort()
        median = peer_means[len(peer_means) // 2]
        if max(hist) < median:
            return STOP
        return CONTINUE


class PopulationBasedTraining:
    """PBT: on each perturbation interval, bottom-quantile trials exploit a
    top-quantile trial's config (and checkpoint, when the trainable reports
    one) and explore by resampling/perturbing hyperparams."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25, seed: int = 0):
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self._rng = random.Random(seed)
        self._scores: Dict[str, float] = {}
        self._configs: Dict[str, Dict[str, Any]] = {}
        self._iters: Dict[str, int] = {}

    def register(self, trial_id: str, config: Dict[str, Any]):
        self._configs[trial_id] = dict(config)

    def on_result(self, trial_id: str, result: Dict[str, Any]) -> str:
        value = float(result[self.metric])
        if self.mode == "min":
            value = -value
        self._scores[trial_id] = value
        self._iters[trial_id] = self._iters.get(trial_id, 0) + 1
        return CONTINUE

    def maybe_exploit(self, trial_id: str) -> Optional[Dict[str, Any]]:
        """Called by the controller at perturbation intervals: returns a new
        config if this trial should exploit+explore, else None."""
        if self._iters.get(trial_id, 0) % self.interval != 0:
            return None
        if len(self._scores) < 2:
            return None
        ranked = sorted(self._scores, key=self._scores.get, reverse=True)
        k = max(1, int(len(ranked) * self.quantile))
        if trial_id not in ranked[-k:]:
            return None
        donor = self._rng.choice(ranked[:k])
        new_cfg = dict(self._configs[donor])
        for key, mut in self.mutations.items():
            if isinstance(mut, list):
                new_cfg[key] = self._rng.choice(mut)
            elif callable(mut):
                new_cfg[key] = mut()
            else:  # numeric: perturb 0.8x / 1.2x
                new_cfg[key] = new_cfg.get(key, 1.0) * self._rng.choice(
                    [0.8, 1.2])
        self._configs[trial_id] = new_cfg
        return new_cfg
