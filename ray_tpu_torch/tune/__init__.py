"""ray_tpu_torch.tune: hyperparameter search (counterpart of
``ray_tpu/tune``).

``Tuner.fit`` runs each trial as a task on the one-process runtime and
drives them through the trial controller (reports and acks over the
worker's KV); search spaces (grid, choice, uniform, loguniform, randint,
qrandint, randn), the basic variant and TPE searchers, and the FIFO,
ASHA, HyperBand, median-stopping and PBT schedulers.
"""

from ray_tpu_torch.tune.search_space import (
    choice,
    grid_search,
    loguniform,
    qrandint,
    randint,
    randn,
    uniform,
)
from ray_tpu_torch.tune.tuner import (
    ResultGrid,
    TrialResult,
    TuneConfig,
    Tuner,
    report,
)
from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
)
from ray_tpu_torch.tune.search import (
    BasicVariantGenerator,
    Searcher,
    TPESearcher,
)

__all__ = [
    "ASHAScheduler",
    "BasicVariantGenerator",
    "FIFOScheduler",
    "HyperBandScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "Searcher",
    "TPESearcher",
    "ResultGrid",
    "TrialResult",
    "TuneConfig",
    "Tuner",
    "choice",
    "grid_search",
    "loguniform",
    "qrandint",
    "randint",
    "randn",
    "report",
    "uniform",
]
