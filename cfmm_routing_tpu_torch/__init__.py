"""cfmm_routing_tpu_torch: the CFMM optimal router in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

Public surface:

    from cfmm_routing_tpu_torch import api                      # workloads
    from cfmm_routing_tpu_torch import ProblemSpec, PoolTable   # problems
    from cfmm_routing_tpu_torch import AdmmSolver, AdmmOptions  # solver
    from cfmm_routing_tpu_torch import certify                  # certificates

Entry points run on the current CUDA device unless ``device="cpu"`` is
passed; on CPU tensors every kernel runs its plain PyTorch version.  The
CUDA kernels (``csrc/``) are compiled with ``nvcc`` at first use.
"""
from .models.pools import (  # noqa: F401
    BoundedProductPool,
    ConstantSumPool,
    GeoMeanPool,
    Pool,
    ProductPool,
)
from .models.utility import ConcaveUtility, Objective  # noqa: F401
from .solver.admm import AdmmOptions, AdmmSolver, RouteResult  # noqa: F401
from .solver.certify import Certificate, certify, dual_bound  # noqa: F401
from .solver.compiler import (  # noqa: F401
    CompiledProblem,
    PoolTable,
    ProblemSpec,
    compile_spec,
    compile_table,
)
from .solver.precondition import (  # noqa: F401
    Equilibration,
    equilibrate,
    unscale_result,
)
from . import api  # noqa: F401,E402
