"""The learned schedule-cost surrogate, trained on the measurement corpus.

Counterpart of ``tenzing_tpu/learn/``.  The search databases
(``--dump-csv``) and telemetry bundles (``--trace-out``) a run writes are
training data: this package turns them into a model that ranks schedules
before they are measured, and puts it in front of the solvers as a
screening benchmarker.

* :mod:`~tenzing_tpu_torch.learn.dataset`: databases and traces ->
  regime-normalized rows keyed by ``canonical_key``;
* :mod:`~tenzing_tpu_torch.learn.features`: the deterministic feature
  vector (the reference's names, in order);
* :mod:`~tenzing_tpu_torch.learn.model`: the numpy ridge and bootstrap
  ensemble, a prediction and its uncertainty, JSON save and load;
* :mod:`~tenzing_tpu_torch.learn.surrogate`: ``SurrogateBenchmarker`` and
  ``ScreeningBenchmarker``;
* :mod:`~tenzing_tpu_torch.learn.train`: the training recipe.

The driver's flags: ``--learn-train GLOB... [--learn-trace GLOB...]
--learn-model PATH`` trains, ``--learn-screen --learn-model PATH`` screens
the search with the model.  A model used on the card is trained on the
card's own databases.
"""

from tenzing_tpu_torch.learn.dataset import Corpus, CorpusRow
from tenzing_tpu_torch.learn.features import FEATURE_NAMES, featurize
from tenzing_tpu_torch.learn.model import RidgeEnsemble, spearman
from tenzing_tpu_torch.learn.surrogate import (
    ScreeningBenchmarker,
    SurrogateBenchmarker,
)
from tenzing_tpu_torch.learn.train import train_from_corpus

__all__ = [
    "Corpus",
    "CorpusRow",
    "FEATURE_NAMES",
    "RidgeEnsemble",
    "ScreeningBenchmarker",
    "SurrogateBenchmarker",
    "featurize",
    "spearman",
    "train_from_corpus",
]
