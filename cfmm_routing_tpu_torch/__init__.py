"""cfmm_routing_tpu_torch: the CFMM optimal router in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

Public surface:

    from cfmm_routing_tpu_torch import api                      # workloads
    from cfmm_routing_tpu_torch import ProblemSpec, PoolTable   # problems
    from cfmm_routing_tpu_torch import AdmmSolver, AdmmOptions  # solver
    from cfmm_routing_tpu_torch import ChunkedDriver            # long runs
    from cfmm_routing_tpu_torch import certify                  # certificates

Entry points run on the current CUDA device unless ``device="cpu"`` is
passed; on CPU tensors every kernel runs its plain PyTorch version.  The
CUDA kernels (``csrc/``) are compiled with ``nvcc`` at first use, and on
the card the solvers replay their iteration blocks as CUDA graphs
(``solver/graphs.py``).  ``__all__`` is the JAX package's, less the
sharded names that are not ported yet (``ROADMAP.md`` item 14).
"""
from .models.pools import (  # noqa: F401
    BoundedProductPool,
    ConstantSumPool,
    GeoMeanPool,
    Pool,
    ProductPool,
)
from .models.utility import (  # noqa: F401
    ConcaveUtility,
    CustomUtility,
    Objective,
)
from .solver.admm import AdmmOptions, AdmmSolver, RouteResult  # noqa: F401
from .solver.certify import (  # noqa: F401
    Certificate,
    InfeasibilityCertificate,
    certify,
    certify_infeasible,
    dual_bound,
)
from .solver.compiler import (  # noqa: F401
    CompiledProblem,
    PoolTable,
    ProblemSpec,
    compile_spec,
    compile_table,
)
from .solver.driver import ChunkedDriver, SolveLog  # noqa: F401
from .solver.precondition import (  # noqa: F401
    Equilibration,
    equilibrate,
    unscale_result,
)
from .solver.fold import (  # noqa: F401
    fold_compiled,
    solve_batch_folded,
    solve_batch_reserves_folded,
)
from .solver.refine import RefineResult, refine  # noqa: F401
from .solver.refine_device import (  # noqa: F401
    DeltaAdmmSolver,
    refine_device,
    refine_sweep,
)
from . import api  # noqa: F401,E402

__version__ = "0.1.0"

__all__ = [
    "AdmmOptions",
    "AdmmSolver",
    "BoundedProductPool",
    "Certificate",
    "ChunkedDriver",
    "CompiledProblem",
    "ConcaveUtility",
    "ConstantSumPool",
    "CustomUtility",
    "Equilibration",
    "GeoMeanPool",
    "InfeasibilityCertificate",
    "Objective",
    "Pool",
    "PoolTable",
    "ProblemSpec",
    "ProductPool",
    "RefineResult",
    "RouteResult",
    "SolveLog",
    "certify",
    "certify_infeasible",
    "compile_spec",
    "compile_table",
    "equilibrate",
    "refine",
    "refine_device",
    "refine_sweep",
    "fold_compiled",
    "solve_batch_folded",
    "solve_batch_reserves_folded",
    "DeltaAdmmSolver",
    "unscale_result",
    "__version__",
]
