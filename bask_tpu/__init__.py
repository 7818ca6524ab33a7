"""bask-tpu: fully-Bayesian Bayesian optimization in JAX, on accelerators.

A from-scratch rebuild of the capabilities of kiudee/bayes-skopt ("bask"):
fully-Bayesian Gaussian-process regression (on-device MCMC over kernel
hyperparameters), marginalized acquisition functions, an ask/tell
Optimizer, and a sklearn-compatible BayesSearchCV — designed for an
accelerator (vmapped walker ensembles, fused acquisition passes, shardable over a
``jax.sharding.Mesh``).

Public API mirrors the reference package exports
(reference ``bask/__init__.py:12-35``).
"""

from .acquisition import (  # noqa: F401
    LCB,
    PVRS,
    Expectation,
    ExpectedImprovement,
    MaxValueSearch,
    ThompsonSampling,
    TopTwoEI,
    VarianceReduction,
    evaluate_acquisitions,
)
from .models.bayesgpr import BayesGPR  # noqa: F401
from .optimizer import ACQUISITION_FUNC, Optimizer  # noqa: F401
from .space import (  # noqa: F401
    Categorical,
    Integer,
    Real,
    Space,
    normalize_dimensions,
)
from .utils.init_seq import r2_sequence, sb_sequence  # noqa: F401
from .utils.median import geometric_median  # noqa: F401
from .utils.priors import (  # noqa: F401
    construct_default_kernel,
    guess_priors,
    make_roundflat,
)
from .utils.progress import get_progress_bar  # noqa: F401
from .utils.result import create_result, expected_minimum  # noqa: F401
from .utils.serialization import (  # noqa: F401
    load_gpr,
    load_optimizer,
    save_gpr,
    save_optimizer,
)
from .utils.aot import disable_aot_cache, enable_aot_cache  # noqa: F401
from .utils.validation import validate_zeroone  # noqa: F401
from .utils.warmup import warmup_optimizer  # noqa: F401


def __getattr__(name):
    # BayesSearchCV pulls in sklearn; import it lazily so the core
    # library works without scikit-learn installed.
    if name == "BayesSearchCV":
        from .searchcv import BayesSearchCV

        return BayesSearchCV
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__version__ = "0.6.0"

__all__ = [
    "BayesGPR",
    "Optimizer",
    "ACQUISITION_FUNC",
    "evaluate_acquisitions",
    "ExpectedImprovement",
    "TopTwoEI",
    "Expectation",
    "LCB",
    "MaxValueSearch",
    "ThompsonSampling",
    "VarianceReduction",
    "PVRS",
    "Space",
    "Real",
    "Integer",
    "Categorical",
    "normalize_dimensions",
    "geometric_median",
    "guess_priors",
    "construct_default_kernel",
    "make_roundflat",
    "r2_sequence",
    "sb_sequence",
    "validate_zeroone",
    "create_result",
    "expected_minimum",
    "warmup_optimizer",
    "enable_aot_cache",
    "disable_aot_cache",
    "__version__",
]
