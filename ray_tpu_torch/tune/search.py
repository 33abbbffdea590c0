"""Search algorithms (copy of ``ray_tpu/tune/search.py``): the Searcher
protocol external optimizers adapt to, BasicVariantGenerator, and a
model-based TPE searcher (Bergstra et al. 2011). Only ``math`` and
``random``: for the same seed and results, the suggestions equal the
reference's.

``TuneConfig(search_alg=...)`` plugs any Searcher into the Tuner: the
controller calls ``suggest(trial_id)`` at SUBMIT time — completed
trials have already fed ``on_trial_complete`` — so model-based
searchers are informed by everything finished so far. BOHB-style
search = ``HyperBandScheduler`` (bracketed halving) + ``TPESearcher``
(model-based suggestion).
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.search_space import (
    Domain,
    _Choice,
    _LogUniform,
    _RandInt,
    _Uniform,
    generate_variants,
)


class Searcher:
    """Protocol: set_search_space once, then suggest/on_trial_complete.
    External optimizers (optuna/hyperopt adapters) implement exactly
    this surface."""

    def set_search_space(self, space: Dict[str, Any]) -> None:
        self._space = dict(space or {})

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]]) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Grid/random expansion as a Searcher (the default path exposed
    through the pluggable seam)."""

    def __init__(self, num_samples: int = 1, seed: int = 0):
        self._num_samples = num_samples
        self._seed = seed
        self._queue: Optional[List[Dict[str, Any]]] = None

    def _fill(self):
        if self._queue is None:
            self._queue = list(generate_variants(
                self._space, self._num_samples, seed=self._seed))

    def total_trials(self, num_samples: int) -> int:
        """Grid expansion can exceed num_samples; the Tuner sizes its
        trial table from this (so grid variants are never truncated)."""
        self._num_samples = max(self._num_samples, num_samples)
        self._fill()
        return len(self._queue)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        self._fill()
        return self._queue.pop(0) if self._queue else None


def _domains(space: Dict[str, Any]) -> Dict[str, Any]:
    """Tunable dimensions of a space: Domain objects plus grid_search
    lists (treated as categorical); constants pass through at suggest
    time."""
    dims = {}
    for k, v in space.items():
        if isinstance(v, Domain):
            dims[k] = v
        elif isinstance(v, dict) and "grid_search" in v:
            dims[k] = _Choice(v["grid_search"])
    return dims


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator: completed trials split into a
    good set (top ``gamma`` fraction) and a bad set; candidates sample
    from per-dimension kernel densities fit on the GOOD set and are
    ranked by the density ratio l(x)/g(x). Categorical dimensions use
    smoothed category frequencies. Random until ``n_startup``
    observations exist."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 n_startup: int = 8, n_candidates: int = 24,
                 gamma: float = 0.25, seed: int = 0):
        self.metric = metric
        self.mode = mode
        self.n_startup = n_startup
        self.n_candidates = n_candidates
        self.gamma = gamma
        self._rng = random.Random(seed)
        self._obs: List[tuple] = []  # (config, score)
        self._last_configs: Dict[str, Dict[str, Any]] = {}

    # ------------------------------------------------------------- protocol
    def on_trial_complete(self, trial_id, result) -> None:
        if not result or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        self._obs.append((dict(self._last_configs.pop(trial_id, {})),
                          score))

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        dims = _domains(self._space)
        consts = {k: v for k, v in self._space.items() if k not in dims}
        if len(self._obs) < self.n_startup:
            cfg = {k: d.sample(self._rng) for k, d in dims.items()}
        else:
            cfg = self._tpe_suggest(dims)
        cfg.update(consts)
        self._last_configs[trial_id] = cfg
        return cfg

    # ------------------------------------------------------------------ TPE
    def _tpe_suggest(self, dims) -> Dict[str, Any]:
        ranked = sorted(self._obs, key=lambda o: -o[1])
        n_good = max(1, int(len(ranked) * self.gamma))
        good = [c for c, _ in ranked[:n_good]]
        bad = [c for c, _ in ranked[n_good:]] or good
        best_cfg, best_ratio = None, -math.inf
        for _ in range(self.n_candidates):
            cfg, ratio = {}, 0.0
            for k, d in dims.items():
                value, r = self._sample_dim(d, [g.get(k) for g in good],
                                            [b.get(k) for b in bad])
                cfg[k] = value
                ratio += r
            if ratio > best_ratio:
                best_cfg, best_ratio = cfg, ratio
        return best_cfg

    @staticmethod
    def _clip_to_domain(domain, value):
        if isinstance(domain, _Uniform):
            return min(max(value, domain.lo), domain.hi)
        if isinstance(domain, _LogUniform):  # lo/hi stored in log space
            return min(max(value, math.exp(domain.lo)),
                       math.exp(domain.hi))
        if isinstance(domain, _RandInt):  # hi exclusive
            return min(max(value, domain.lo), domain.hi - 1)
        return value

    def _sample_dim(self, domain, good_vals, bad_vals):
        good_vals = [v for v in good_vals if v is not None]
        bad_vals = [v for v in bad_vals if v is not None]
        if isinstance(domain, _Choice) or (
                good_vals and isinstance(good_vals[0], str)):
            options = getattr(domain, "options", None) or sorted(
                set(good_vals) | set(bad_vals))
            weights = [1.0 + good_vals.count(o) for o in options]
            value = self._rng.choices(options, weights=weights)[0]
            g = weights[options.index(value)] / sum(weights)
            bw = [1.0 + bad_vals.count(o) for o in options]
            b = bw[options.index(value)] / sum(bw)
            return value, math.log(g / b)
        # Numeric: sample from a kernel centred on a random GOOD value,
        # CLIPPED back inside the declared domain (a gaussian tail must
        # not hand the trainable an out-of-range config).
        if not good_vals:
            return domain.sample(self._rng), 0.0
        lo = min(good_vals + bad_vals)
        hi = max(good_vals + bad_vals)
        width = (hi - lo) or abs(hi) or 1.0
        bw = width / max(len(good_vals), 2)
        centre = self._rng.choice(good_vals)
        value = self._rng.gauss(centre, bw)
        value = self._clip_to_domain(domain, value)
        is_int = isinstance(good_vals[0], int)
        value = int(round(value)) if is_int else value
        value = self._clip_to_domain(domain, value)

        def kde(vals):
            if not vals:
                return 1e-12
            return sum(
                math.exp(-0.5 * ((value - v) / bw) ** 2)
                for v in vals) / (len(vals) * bw * math.sqrt(2 * math.pi))

        return value, math.log(max(kde(good_vals), 1e-12)
                               / max(kde(bad_vals), 1e-12))
