"""Tree-structured Parzen Estimator (TPE) hyperparameter search
(carried over from cpflow_tpu/search/tpe.py as it is: numpy only, and
importing the original would import JAX through cpflow_tpu/__init__.py).

The reference drives its adaptive synthesis with hyperopt's TPE over the
2-dimensional space [quniform(num_cp_gates), lognormal(r)]
(main.py:763-810). hyperopt is not available here, so this is a
self-contained TPE with the same observable behavior:

  * startup phase samples from the prior;
  * afterwards, observations are split into good/bad by the gamma-quantile
    of the objective, adaptive-Parzen density estimators are fit to each,
    and the candidate maximizing g(x)/b(x) among `n_ei_candidates` draws
    from g is suggested (Bergstra et al., NeurIPS 2011 — the algorithm
    hyperopt implements).

Host-side, numpy only. Trials keep a hyperopt-like record schema (a list of
result dicts with a 'loss' key) so Results.best_hyperparameters and
plot_trials read identically (main.py:471-502).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


# --------------------------------------------------------------------------
# Search-space dimensions
# --------------------------------------------------------------------------

@dataclasses.dataclass
class QUniformInt:
    """Integer drawn uniformly on [low, high] with step q
    (hyperopt's scope.int(hp.quniform(...)), main.py:764-766)."""
    label: str
    low: float
    high: float
    q: float = 1.0

    def sample_prior(self, rng: np.random.Generator) -> int:
        v = rng.uniform(self.low, self.high)
        return int(np.clip(np.round(v / self.q) * self.q, self.low, self.high))

    def to_internal(self, value) -> float:
        return float(value)

    def from_internal(self, x: float) -> int:
        return int(np.clip(np.round(x / self.q) * self.q, self.low, self.high))

    def prior_mu_sigma(self):
        return (self.low + self.high) / 2.0, (self.high - self.low)


@dataclasses.dataclass
class LogNormal:
    """exp(Normal(mu, sigma)) (hp.lognormal, main.py:767)."""
    label: str
    mu: float      # mean of the underlying normal (log domain)
    sigma: float

    def sample_prior(self, rng: np.random.Generator) -> float:
        return float(np.exp(rng.normal(self.mu, self.sigma)))

    def to_internal(self, value) -> float:
        return math.log(value)

    def from_internal(self, x: float) -> float:
        return float(np.exp(x))

    def prior_mu_sigma(self):
        return self.mu, self.sigma


Dimension = Any  # QUniformInt | LogNormal


# --------------------------------------------------------------------------
# Adaptive Parzen estimator (1-d)
# --------------------------------------------------------------------------

class _Parzen:
    def __init__(self, obs: np.ndarray, prior_mu: float, prior_sigma: float):
        mus = np.concatenate([[prior_mu], obs])
        order = np.argsort(mus)
        sorted_mus = mus[order]

        sigmas = np.empty_like(sorted_mus)
        if len(sorted_mus) == 1:
            sigmas[0] = prior_sigma
        else:
            left = np.diff(sorted_mus, prepend=sorted_mus[0])
            right = np.diff(sorted_mus, append=sorted_mus[-1])
            sigmas = np.maximum(left, right)
        # clip bandwidths relative to the prior width
        sigmas = np.clip(sigmas, prior_sigma / max(100.0, len(mus)), prior_sigma)
        # the prior component keeps the full prior width
        prior_pos = int(np.nonzero(order == 0)[0][0])
        sigmas[prior_pos] = prior_sigma

        self.mus = sorted_mus
        self.sigmas = sigmas
        self.weights = np.full(len(sorted_mus), 1.0 / len(sorted_mus))

    def sample(self, rng: np.random.Generator, size: int) -> np.ndarray:
        idx = rng.choice(len(self.mus), size=size, p=self.weights)
        return rng.normal(self.mus[idx], self.sigmas[idx])

    def logpdf(self, xs: np.ndarray) -> np.ndarray:
        xs = np.asarray(xs, dtype=float)[:, None]
        z = (xs - self.mus[None, :]) / self.sigmas[None, :]
        comp = (-0.5 * z ** 2
                - np.log(self.sigmas[None, :] * math.sqrt(2 * math.pi))
                + np.log(self.weights[None, :]))
        m = comp.max(axis=1, keepdims=True)
        return (m + np.log(np.exp(comp - m).sum(axis=1, keepdims=True))).ravel()


# --------------------------------------------------------------------------
# Trials store + suggestion
# --------------------------------------------------------------------------

class Trials:
    """Record of evaluated configurations (hyperopt.Trials stand-in).

    .results  — list of user result dicts, each with at least 'loss';
    .vals     — list of parameter-value lists (same order as space dims).
    """

    def __init__(self):
        self.results: List[Dict] = []
        self.vals: List[List[Any]] = []

    @property
    def trials(self) -> List[Dict]:
        # hyperopt exposes .trials with one entry per evaluation; the
        # reference only uses len(trials.trials) (main.py:805)
        return [{'result': r} for r in self.results]

    def record(self, values: Sequence[Any], result: Dict) -> None:
        self.vals.append(list(values))
        self.results.append(dict(result))

    def losses(self) -> np.ndarray:
        return np.array([r.get('loss', np.inf) for r in self.results], dtype=float)

    def __len__(self):
        return len(self.results)


def suggest(space: Sequence[Dimension], trials: Trials,
            rng: np.random.Generator, gamma: float = 0.25,
            n_startup: int = 20, n_ei_candidates: int = 24) -> List[Any]:
    """Propose the next configuration."""
    n = len(trials)
    if n < n_startup:
        return [dim.sample_prior(rng) for dim in space]

    losses = trials.losses()
    finite = np.isfinite(losses)
    if finite.sum() < 2:
        return [dim.sample_prior(rng) for dim in space]

    n_good = max(1, min(int(np.ceil(gamma * math.sqrt(n))), 25))
    order = np.argsort(losses, kind='stable')
    good_idx = set(order[:n_good].tolist())

    suggestion = []
    for d, dim in enumerate(space):
        internal = np.array([dim.to_internal(v[d]) for v in trials.vals])
        good = internal[[i in good_idx for i in range(n)]]
        bad = internal[[i not in good_idx for i in range(n)]]
        mu0, sigma0 = dim.prior_mu_sigma()
        g = _Parzen(good, mu0, sigma0)
        b = _Parzen(bad if len(bad) else np.array([]), mu0, sigma0)

        cands = g.sample(rng, n_ei_candidates)
        # evaluate EI surrogate on the *rounded* external values for
        # discrete dims so ties collapse correctly
        ext = [dim.from_internal(c) for c in cands]
        cands_eval = np.array([dim.to_internal(e) for e in ext])
        score = g.logpdf(cands_eval) - b.logpdf(cands_eval)
        best = int(np.argmax(score))
        suggestion.append(ext[best])

    return suggestion


def fmin(objective: Callable[[List[Any]], Dict], space: Sequence[Dimension],
         trials: Trials, max_evals: int,
         rng: Optional[np.random.Generator] = None,
         gamma: float = 0.25, n_startup: int = 20) -> Dict:
    """Run TPE until `max_evals` total evaluations are recorded in `trials`
    (mirrors the reference's one-trial-at-a-time fmin loop, main.py:801-810).

    `objective` receives the parameter list and returns a result dict with a
    'loss' key; the dict is stored in trials.results.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    while len(trials) < max_evals:
        values = suggest(space, trials, rng, gamma=gamma, n_startup=n_startup)
        result = objective(values)
        trials.record(values, result)
    best_i = int(np.argmin(trials.losses()))
    return {'values': trials.vals[best_i], 'result': trials.results[best_i]}
