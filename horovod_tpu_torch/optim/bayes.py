"""Gaussian-process Bayesian optimization for the autotuner (port of
``horovod_tpu/optim/bayes.py``, numpy only).

A numpy twin of the reference's GP/BO pair
(``horovod/common/optim/gaussian_process.cc`` and
``bayesian_optimization.cc:1-194``, themselves a C++ adaptation of the
Krasser GP tutorial): an RBF-kernel GP posterior over observed
(config, score) samples and an expected-improvement (EI) acquisition
proposing the next configuration to try. Two deliberate departures from
the reference's mechanics (same role, simpler machinery, no new deps):

* kernel hyperparameters come from a small log-marginal-likelihood grid
  instead of L-BFGS gradient ascent;
* EI is maximized over a dense random candidate set within bounds
  instead of L-BFGS with random restarts — with 2–3 tuned knobs a few
  hundred candidates cover the box better than gradient polish.
"""

from __future__ import annotations

import math

import numpy as np

_SQRT2 = math.sqrt(2.0)


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / _SQRT2))


def _norm_pdf(z: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


class GaussianProcessRegressor:
    """RBF-kernel GP with observation noise ``alpha`` (the reference's
    ``GaussianProcessRegressor(alpha)``); inputs are expected normalized
    to comparable scales by the caller."""

    def __init__(self, alpha: float = 1e-10):
        self.alpha = float(alpha)
        self._X = None
        self._y = None
        self._L = None
        self._w = None
        self.length_scale = 1.0
        self.sigma_f = 1.0

    def _kernel(self, A, B, length_scale, sigma_f):
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return sigma_f ** 2 * np.exp(-0.5 * d2 / length_scale ** 2)

    def _log_marginal(self, X, y, length_scale, sigma_f):
        K = self._kernel(X, X, length_scale, sigma_f)
        K[np.diag_indices_from(K)] += self.alpha
        try:
            L = np.linalg.cholesky(K)
        except np.linalg.LinAlgError:
            return -np.inf
        w = np.linalg.solve(L.T, np.linalg.solve(L, y))
        return float(-0.5 * y @ w - np.log(np.diag(L)).sum()
                     - 0.5 * len(y) * math.log(2 * math.pi))

    def fit(self, X: np.ndarray, y: np.ndarray) -> None:
        X = np.atleast_2d(np.asarray(X, float))
        y = np.asarray(y, float).ravel()
        # hyperparameters by log-marginal-likelihood grid (the reference
        # runs L-BFGS on the same objective)
        best, best_lml = (1.0, 1.0), -np.inf
        for ls in (0.2, 0.5, 1.0, 2.0):
            for sf in (0.5, 1.0, 2.0):
                lml = self._log_marginal(X, y, ls, sf)
                if lml > best_lml:
                    best, best_lml = (ls, sf), lml
        self.length_scale, self.sigma_f = best
        K = self._kernel(X, X, *best)
        K[np.diag_indices_from(K)] += self.alpha
        self._L = np.linalg.cholesky(K)
        self._w = np.linalg.solve(self._L.T, np.linalg.solve(self._L, y))
        self._X, self._y = X, y

    def predict(self, Xs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Posterior mean and stddev at ``Xs``."""
        Xs = np.atleast_2d(np.asarray(Xs, float))
        Ks = self._kernel(Xs, self._X, self.length_scale, self.sigma_f)
        mu = Ks @ self._w
        v = np.linalg.solve(self._L, Ks.T)
        var = (self.sigma_f ** 2 - (v ** 2).sum(0)).clip(min=0.0)
        return mu, np.sqrt(var)


class BayesianOptimization:
    """Propose-the-next-config loop (reference ``BayesianOptimization``):
    ``add_sample`` observations, ``next_sample`` the EI argmax."""

    def __init__(self, bounds, alpha: float, xi: float = 0.01,
                 seed: int = 0, n_candidates: int = 512):
        self.bounds = [(float(lo), float(hi)) for lo, hi in bounds]
        self.xi = float(xi)
        self.gpr = GaussianProcessRegressor(alpha)
        self._rng = np.random.default_rng(seed)
        self.n_candidates = n_candidates
        self._X: list[np.ndarray] = []
        self._y: list[float] = []

    def add_sample(self, x, y: float) -> None:
        self._X.append(np.asarray(x, float))
        self._y.append(float(y))

    def clear(self) -> None:
        self._X.clear()
        self._y.clear()

    def _unit(self, X):
        lo = np.array([b[0] for b in self.bounds])
        hi = np.array([b[1] for b in self.bounds])
        return (np.atleast_2d(X) - lo) / np.where(hi > lo, hi - lo, 1.0)

    def next_sample(self, candidates=None) -> tuple[np.ndarray, float]:
        """(proposed x, max expected improvement). ``candidates`` narrows
        the proposal set to given points (e.g. a discrete knob grid —
        continuous proposals rounded to a coarse grid collapse back onto
        the incumbent and never explore); default is uniform-random in
        bounds. With <2 samples the proposal is random (nothing to model
        yet)."""
        if candidates is not None:
            cands = np.atleast_2d(np.asarray(candidates, float))
        else:
            lo = np.array([b[0] for b in self.bounds])
            hi = np.array([b[1] for b in self.bounds])
            cands = self._rng.uniform(lo, hi,
                                      size=(self.n_candidates, len(lo)))
        if len(self._y) < 2:
            return cands[self._rng.integers(len(cands))], float("inf")
        y = np.asarray(self._y)
        mu_y, sd_y = y.mean(), y.std()
        if len(y) >= 3 and sd_y > 0:  # reference NextSample normalization
            y = (y - mu_y) / sd_y
        self.gpr.fit(self._unit(np.vstack(self._X)), y)
        mu, sigma = self.gpr.predict(self._unit(cands))
        mu_best = self.gpr.predict(self._unit(np.vstack(self._X)))[0].max()
        imp = mu - mu_best - self.xi
        with np.errstate(divide="ignore", invalid="ignore"):
            z = np.where(sigma > 0, imp / sigma, 0.0)
        ei = np.where(sigma > 0, imp * _norm_cdf(z) + sigma * _norm_pdf(z),
                      0.0)
        i = int(np.argmax(ei))
        return cands[i], float(ei[i])
