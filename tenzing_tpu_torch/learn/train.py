"""The corpus -> surrogate training recipe.

Counterpart of ``tenzing_tpu/learn/train.py``: ingestion, featurization,
the ridge-ensemble fit and the in-sample Spearman, in one function that the
driver's ``--learn-train`` calls.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from tenzing_tpu_torch.learn.dataset import Corpus
from tenzing_tpu_torch.learn.features import FEATURE_NAMES
from tenzing_tpu_torch.learn.model import RidgeEnsemble, spearman

# below this the bootstrap ensemble cannot even resample meaningfully —
# a model "trained" on 2-3 rows would predict noise with false confidence
MIN_TRAIN_ROWS = 4


def train_from_corpus(
    paths: List[str], graph, nbytes: Optional[Dict[str, int]] = None,
    trace_paths: Optional[List[str]] = None, log=None,
) -> Tuple[Optional[RidgeEnsemble], Dict[str, Any]]:
    """``(model, info)`` from recorded search databases.

    ``info`` always carries ``files``/``rows``; a corpus too small to
    trust adds ``error`` and returns ``model=None``, otherwise ``info``
    adds the in-sample ``train_spearman``.  ``nbytes`` must be the same
    buffer-size map the caller will featurize with at predict time
    (the train/serve feature contract, learn/features.py)."""
    corpus = Corpus.from_files(paths, graph, log=log)
    if trace_paths:
        corpus.attach_traces(trace_paths, log=log)
    info: Dict[str, Any] = {"files": len(paths), "rows": len(corpus.rows)}
    if len(corpus.rows) < MIN_TRAIN_ROWS:
        info["error"] = (
            f"corpus too small to train (< {MIN_TRAIN_ROWS} rows)")
        return None, info
    X, y = corpus.matrices(nbytes=nbytes)
    model = RidgeEnsemble(feature_names=list(FEATURE_NAMES))
    model.fit(X, y)
    pred, _ = model.predict(X)
    info["train_spearman"] = round(spearman(pred, y), 4)
    return model, info
