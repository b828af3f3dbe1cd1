"""brancher_torch: the PyTorch / CUDA port of ``brancher_tpu``.

The same symbolic random-variable DSL, compiled model and vectorized NUTS
as the JAX package, written with PyTorch tensors for an NVIDIA H100, with
the fused GLM potentials as hand-written CUDA kernels (``csrc/``).  It
imports neither JAX nor ``brancher_tpu``; each module names its JAX
counterpart.  Entry points run on ``config.device`` ("cuda") unless the
caller passes ``device="cpu"``.  Importing the package builds nothing:
kernels compile with ``nvcc`` at first use.
"""

from .config import RuntimeConfig, config
from .variables import (
    DeterministicVariable,
    PartialLink,
    ProbabilisticModel,
    RandomVariable,
    Variable,
    var2link,
)
from .standard_variables import *  # noqa: F401,F403
from .compiler import CompiledModel, compile_model
from .stochastic_processes import (
    ARProcess,
    EmissionHMMVariable,
    GaussianProcess,
    HMMVariable,
    MarkovProcess,
)
from .model_comparison import compare, loo, waic
from .transformations import (
    PlanarFlow,
    Sigmoid as SigmoidFlow,
    TransformedVariable,
    TriangularLinear,
)

__version__ = "0.1.0"
