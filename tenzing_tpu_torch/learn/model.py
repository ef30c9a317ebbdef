"""Ridge regression with a bootstrap ensemble: a prediction and its
uncertainty.

Counterpart of ``tenzing_tpu/learn/model.py``, copied as numpy.  The corpus
is small (hundreds to a few thousand distinct schedules) and the features
are low-dimensional summaries (learn/features.py), so the model is an
ensemble of ridge regressors, each fit on a bootstrap resample: the
ensemble mean is the prediction, its spread the uncertainty the screen
escalates on (learn/surrogate.py).  A closed-form solve per member, and a
JSON save and load that carries the feature names: loading refuses a model
whose names differ from the featurizer's.  The JSON is the reference's, so
a model moves between the two packages unchanged.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

import numpy as np


def spearman(a: Sequence[float], b: Sequence[float]) -> float:
    """Spearman rank correlation (Pearson over average ranks — ties get the
    mean of their positions, so duplicate predictions do not inflate the
    score).  The metric the acceptance gate is stated in: the surrogate's
    job is *ranking* schedules, not absolute timing."""
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    if a.shape != b.shape or a.size < 2:
        raise ValueError("spearman needs two equal-length series, n >= 2")

    def ranks(x: np.ndarray) -> np.ndarray:
        order = np.argsort(x, kind="stable")
        r = np.empty(len(x), dtype=float)
        r[order] = np.arange(len(x), dtype=float)
        # average ties
        for v in np.unique(x):
            m = x == v
            if m.sum() > 1:
                r[m] = r[m].mean()
        return r

    ra, rb = ranks(a), ranks(b)
    sa, sb = ra.std(), rb.std()
    if sa == 0.0 or sb == 0.0:
        return 0.0
    return float(((ra - ra.mean()) * (rb - rb.mean())).mean() / (sa * sb))


class RidgeEnsemble:
    """Bootstrap ensemble of ridge regressors over standardized features.

    ``fit`` standardizes X column-wise and centers y, then solves
    ``(Z'Z + lam * n * I) w = Z'y`` per member on a seeded bootstrap
    resample; ``predict`` returns (mean, std) across members.  All state is
    plain arrays, so (de)serialization is a dict of lists."""

    def __init__(self, n_members: int = 16, ridge: float = 1e-3,
                 seed: int = 0,
                 feature_names: Optional[List[str]] = None):
        self.n_members = int(n_members)
        self.ridge = float(ridge)
        self.seed = int(seed)
        self.feature_names = list(feature_names) if feature_names else None
        self._mu: Optional[np.ndarray] = None   # feature means
        self._sigma: Optional[np.ndarray] = None  # feature stds (0 -> 1)
        self._y_mu: float = 0.0
        self._w: Optional[np.ndarray] = None    # (n_members, d)
        self.n_train: int = 0

    @property
    def fitted(self) -> bool:
        return self._w is not None

    def fit(self, X, y) -> "RidgeEnsemble":
        X = np.asarray(X, dtype=float)
        y = np.asarray(y, dtype=float)
        if X.ndim != 2 or len(X) != len(y) or len(y) < 2:
            raise ValueError("fit needs X (n, d) and y (n,), n >= 2")
        n, d = X.shape
        self._mu = X.mean(axis=0)
        sigma = X.std(axis=0)
        sigma[sigma == 0.0] = 1.0  # constant columns contribute nothing
        self._sigma = sigma
        self._y_mu = float(y.mean())
        Z = (X - self._mu) / self._sigma
        yc = y - self._y_mu
        rng = np.random.RandomState(self.seed)
        ws = []
        lam = self.ridge * n
        eye = np.eye(d)
        for _ in range(self.n_members):
            idx = rng.randint(0, n, size=n)
            Zi, yi = Z[idx], yc[idx]
            ws.append(np.linalg.solve(Zi.T @ Zi + lam * eye, Zi.T @ yi))
        self._w = np.stack(ws)
        self.n_train = n
        return self

    def predict(self, X) -> Tuple[np.ndarray, np.ndarray]:
        """(mean, std) of the ensemble's predictions, shape (n,) each."""
        if not self.fitted:
            raise RuntimeError("predict before fit/load")
        X = np.asarray(X, dtype=float)
        one = X.ndim == 1
        if one:
            X = X[None, :]
        Z = (X - self._mu) / self._sigma
        preds = Z @ self._w.T + self._y_mu  # (n, n_members)
        mean, std = preds.mean(axis=1), preds.std(axis=1)
        return (mean[0], std[0]) if one else (mean, std)

    # -- persistence -------------------------------------------------------

    def to_json(self) -> dict:
        if not self.fitted:
            raise RuntimeError("save before fit")
        return {
            "kind": "ridge_ensemble",
            "n_members": self.n_members,
            "ridge": self.ridge,
            "seed": self.seed,
            "n_train": self.n_train,
            "feature_names": self.feature_names,
            "mu": self._mu.tolist(),
            "sigma": self._sigma.tolist(),
            "y_mu": self._y_mu,
            "w": self._w.tolist(),
        }

    @classmethod
    def from_json(cls, j: dict,
                  expect_features: Optional[List[str]] = None
                  ) -> "RidgeEnsemble":
        if j.get("kind") != "ridge_ensemble":
            raise ValueError(f"not a ridge_ensemble model: {j.get('kind')!r}")
        names = j.get("feature_names")
        if expect_features is not None and (
                names is None or list(names) != list(expect_features)):
            # a model saved without names cannot prove it matches the
            # current featurizer — treat it as a mismatch rather than
            # skipping the check (the "fails loudly, never mis-predicts"
            # guarantee of the contract)
            raise ValueError(
                "model feature contract mismatch: saved "
                f"{'no' if names is None else len(names)} feature names, "
                f"featurizer has {len(expect_features)} — retrain against "
                "the current learn/features.py")
        m = cls(n_members=j["n_members"], ridge=j["ridge"], seed=j["seed"],
                feature_names=names)
        m._mu = np.asarray(j["mu"], dtype=float)
        m._sigma = np.asarray(j["sigma"], dtype=float)
        m._y_mu = float(j["y_mu"])
        m._w = np.asarray(j["w"], dtype=float)
        m.n_train = int(j.get("n_train", 0))
        return m

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)

    @classmethod
    def load(cls, path: str,
             expect_features: Optional[List[str]] = None) -> "RidgeEnsemble":
        with open(path) as f:
            return cls.from_json(json.load(f), expect_features)
