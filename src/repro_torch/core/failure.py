"""Failure modeling (paper §3): gamma-distributed time-to-failure, fitting,
and the emulator's failure injector.

A copy of ``repro.core.failure`` (numpy only): the same seeds give the
reference's failure events exactly.

The paper finds production time-to-failure is gamma-distributed (RMSE 4.4 %
vs the empirical survival curve), the hazard is near-uniform after an
infant-mortality spike, and MTBF decreases linearly with node count.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class GammaFailureModel:
    shape: float = 0.85   # k < 1: slight infant mortality, matching Fig. 3b
    scale: float = 25.0   # hours

    @property
    def mtbf(self) -> float:
        return self.shape * self.scale

    def sample(self, rng: np.random.Generator, size=None):
        return rng.gamma(self.shape, self.scale, size=size)

    def survival(self, t):
        """P(TTF > t) via the regularized upper incomplete gamma."""
        from math import exp
        t = np.asarray(t, dtype=np.float64)
        # series/continued-fraction free: use scipy-free approximation via
        # numerical integration of the pdf (fine for plotting/fitting use).
        ts = np.linspace(0, max(float(np.max(t)), 1e-6), 4097)
        pdf = self.pdf(ts)
        cdf = np.cumsum((pdf[1:] + pdf[:-1]) * 0.5 * np.diff(ts))
        cdf = np.concatenate([[0.0], cdf])
        return 1.0 - np.interp(t, ts, cdf)

    def pdf(self, t):
        t = np.maximum(np.asarray(t, dtype=np.float64), 1e-12)
        k, th = self.shape, self.scale
        return t ** (k - 1) * np.exp(-t / th) / (math.gamma(k) * th ** k)

    def hazard(self, t):
        s = np.maximum(self.survival(t), 1e-12)
        return self.pdf(t) / s

    @classmethod
    def fit(cls, samples) -> "GammaFailureModel":
        """Method-of-moments fit (paper fits a gamma to TTF data)."""
        x = np.asarray(samples, dtype=np.float64)
        mean, var = float(np.mean(x)), float(np.var(x))
        var = max(var, 1e-12)
        return cls(shape=mean * mean / var, scale=var / mean)

    def fit_rmse(self, samples) -> float:
        """RMSE between empirical and model survival curves (paper: 4.4 %)."""
        x = np.sort(np.asarray(samples, dtype=np.float64))
        emp = 1.0 - np.arange(1, x.size + 1) / x.size
        mod = self.survival(x)
        return float(np.sqrt(np.mean((emp - mod) ** 2)))


@dataclass
class FailureEvent:
    time: float            # sim hours
    shard_ids: tuple       # failed Emb PS shards
    fraction: float        # |shard_ids| / N_emb


class FailureInjector:
    """Samples failure times and failed-shard subsets for the emulator.

    ``uniform=True`` mirrors the paper's emulation (failure probability is
    near-constant, §3.1, so failures are injected uniformly at random);
    otherwise inter-failure gaps are drawn from the gamma model.  Pinned
    scenarios (deterministic tests) pass explicit ``times`` and optionally
    ``shard_sets``; both override the sampled schedule.
    """

    def __init__(self, n_failures, fail_fraction, n_shards, T_total,
                 seed=0, uniform=True, gamma: GammaFailureModel = None,
                 times=None, shard_sets=None):
        rng = np.random.default_rng(seed)
        if times is not None:
            order = np.argsort(np.asarray(times, dtype=float))
            times = np.asarray(times, dtype=float)[order]
            if shard_sets is not None:
                assert len(shard_sets) == len(times)
                shard_sets = [shard_sets[i] for i in order]
        elif uniform:
            times = np.sort(rng.uniform(0, T_total, size=n_failures))
        else:
            gamma = gamma or GammaFailureModel()
            gaps = gamma.sample(rng, size=max(n_failures * 4, 16))
            times = np.cumsum(gaps)
            times = times[times < T_total][:n_failures]
        k = max(1, int(round(fail_fraction * n_shards)))
        self.events = []
        for i, t in enumerate(times):
            if shard_sets is not None:
                ids = tuple(sorted(int(j) for j in shard_sets[i]))
            else:
                ids = tuple(sorted(rng.choice(n_shards, size=k,
                                              replace=False)))
            self.events.append(FailureEvent(float(t), ids,
                                            len(ids) / n_shards))

    def between(self, t0, t1):
        return [e for e in self.events if t0 < e.time <= t1]
