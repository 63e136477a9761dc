"""The one generator of traffic: it reads a mix's parameters from
`traffic/<name>.json` and draws what the seed decides.

Every seed gets the same set of sizes in another order, so two seeds do
the same work and differ only in its order and its tokens: a mix names a
distribution of prompt lengths and the size of the set, the set is that
distribution's quantiles at (i + 0.5) / n, and the seed permutes it.
"""
from __future__ import annotations

import math
import statistics

import numpy as np

_MASK = (1 << 63) - 1


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one draw of a run (the run's seed and the draw's
    index), so that no two draws of a run share a stream."""
    h = seed & _MASK
    for k in keys:
        h = (h * 6364136223846793005 + 1442695040888963407 + k) & _MASK
    return h


def quantile(spec: dict, q: float) -> float:
    if spec["dist"] == "uniform":
        return spec["low"] + q * (spec["high"] - spec["low"])
    if spec["dist"] == "lognormal":
        z = statistics.NormalDist().inv_cdf(q)
        return min(spec["high"], max(spec["low"],
                                     spec["median"] * math.exp(spec["sigma"]
                                                               * z)))
    raise ValueError(f"unknown distribution {spec['dist']!r}")


def value_set(spec: dict) -> list[float]:
    n = spec["set"]
    return [quantile(spec, (i + 0.5) / n) for i in range(n)]


def lengths(spec: dict, seed: int) -> list[int]:
    """The set of prompt lengths, rounded to `round_to`, in the seed's
    order; a run cycles through it."""
    r = spec.get("round_to", 1)
    vals = [int(round(v / r)) * r for v in value_set(spec)]
    order = np.random.default_rng(sub_seed(seed, 1)).permutation(len(vals))
    return [vals[i] for i in order]
