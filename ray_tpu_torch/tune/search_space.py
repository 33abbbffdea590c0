"""Search-space primitives and variant generation (copy of
``ray_tpu/tune/search_space.py``).

Every draw comes from one ``random.Random(seed)``, so the variants of a
space for a seed equal the reference's value for value."""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, List


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class _Choice(Domain):
    def __init__(self, options):
        self.options = list(options)

    def sample(self, rng):
        return rng.choice(self.options)


class _Uniform(Domain):
    def __init__(self, lo, hi):
        self.lo, self.hi = lo, hi

    def sample(self, rng):
        return rng.uniform(self.lo, self.hi)


class _LogUniform(Domain):
    def __init__(self, lo, hi):
        import math

        self.lo, self.hi = math.log(lo), math.log(hi)

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(self.lo, self.hi))


class _RandInt(Domain):
    def __init__(self, lo, hi):
        self.lo, self.hi = lo, hi

    def sample(self, rng):
        return rng.randrange(self.lo, self.hi)


class _QRandInt(Domain):
    def __init__(self, lo, hi, q):
        self.lo, self.hi, self.q = lo, hi, q

    def sample(self, rng):
        v = rng.randrange(self.lo, self.hi + 1)
        return (v // self.q) * self.q


class _Randn(Domain):
    def __init__(self, mean, sd):
        self.mean, self.sd = mean, sd

    def sample(self, rng):
        return rng.gauss(self.mean, self.sd)


class _Grid:
    def __init__(self, values):
        self.values = list(values)


def choice(options) -> Domain:
    return _Choice(options)


def uniform(lo: float, hi: float) -> Domain:
    return _Uniform(lo, hi)


def loguniform(lo: float, hi: float) -> Domain:
    return _LogUniform(lo, hi)


def randint(lo: int, hi: int) -> Domain:
    return _RandInt(lo, hi)


def qrandint(lo: int, hi: int, q: int) -> Domain:
    return _QRandInt(lo, hi, q)


def randn(mean: float = 0.0, sd: float = 1.0) -> Domain:
    return _Randn(mean, sd)


def grid_search(values) -> Dict[str, Any]:
    return {"grid_search": list(values)}


def generate_variants(param_space: Dict[str, Any], num_samples: int,
                      seed: int = 0) -> List[Dict[str, Any]]:
    """Grid axes expand exhaustively; Domain axes sample per variant;
    constants pass through. num_samples repeats the whole expansion
    (reference BasicVariantGenerator semantics)."""
    rng = random.Random(seed)
    grid_keys = [k for k, v in param_space.items()
                 if isinstance(v, dict) and "grid_search" in v]
    grids = [param_space[k]["grid_search"] for k in grid_keys]
    variants: List[Dict[str, Any]] = []
    for _ in range(num_samples):
        for combo in itertools.product(*grids) if grids else [()]:
            cfg = {}
            for k, v in param_space.items():
                if k in grid_keys:
                    cfg[k] = combo[grid_keys.index(k)]
                elif isinstance(v, Domain):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            variants.append(cfg)
    return variants
