"""quasinewtonmethods_jl_tpu — accelerator-native quasi-Newton log-density maximization.

A JAX/XLA framework with the capabilities of
chriselrod/QuasiNewtonMethods.jl: BFGS maximization of statistical
log-densities with a backtracking (quadratic/cubic) line search, built for
MAP/mode-finding workloads such as HMC chain initialization — re-designed
for an accelerator rather than ported:

  * the two-callback protocol (logdensity / ∂logdensity!, reference
    src/QuasiNewtonMethods.jl:8-9) becomes a pure function + jax.value_and_grad
    (analytic override via ``value_and_grad_fn``);
  * the preallocated SIMD-padded ``BFGSState`` struct (:84-106) becomes a
    static-shape pytree carried through one jitted ``lax.while_loop``;
  * the fused LoopVectorization rank-2 update kernel (:34-69) becomes one
    fused batch-minor update over an (n, n, batch) stack that XLA compiles;
  * whole solves batch in masked lockstep (``optimize_batched``) and shard
    over device meshes — the accelerator answer to the reference's
    one-state-per-thread ``PtrBFGSState`` design (:117-121);
  * an L-BFGS two-loop path covers the large-n regime the dense-B reference
    cannot reach.

Maximization convention throughout: objectives are log-densities to be
maximized; ascent directions are +B⁻¹∇.
"""

from .api import ProbabilityModel
from .batched_solve import (
    optimize_batched_compacted,
    optimize_batched_fused,
    optimize_batched_fused_from_state,
)
from .ops.bfgs import bfgs_update, initial_inv_hessian
from .ops.linesearch import BackTracking, LineSearchResult, backtracking_linesearch
from .ops.wolfe import Wolfe, WolfeResult, wolfe_linesearch
from .implicit import ImplicitOptions, optimize_implicit
from .least_squares import (
    LeastSquaresResult,
    LMState,
    least_squares,
    least_squares_from_state,
)
from .trust_region import (
    TRResult,
    TRState,
    optimize_tr,
    optimize_tr_from_state,
)
from .cg_solve import (
    CGResult,
    CGState,
    optimize_cg,
    optimize_cg_from_state,
)
from .constrained import (
    AugLagResult,
    optimize_auglag,
)
from .svgd import (
    SVGDResult,
    SVGDState,
    svgd_sample,
    svgd_sample_from_state,
)
from .ensemble import (
    EnsembleResult,
    EnsembleState,
    ensemble_autocorr_time,
    ensemble_sample,
    ensemble_sample_from_state,
)
from .mclmc import (
    MCLMCResult,
    MCLMCState,
    mclmc_sample,
    mclmc_sample_from_state,
)
from .lbfgs_batched_solve import optimize_lbfgs_batched_fused_from_state
from .minimize import minimize
from .lbfgs_solve import LBFGSResult, optimize_lbfgs, optimize_lbfgs_from_state
from .multistart import MultistartResult, optimize_multistart
from .parallel.batch import optimize_batched, optimize_lbfgs_batched
from .polish import PolishResult, polish_newton
from .pytree import (
    least_squares_pytree,
    minimize_pytree,
    optimize_auglag_pytree,
    optimize_cg_pytree,
    optimize_tr_pytree,
    PytreeSampleResult,
    map_then_sample_pytree,
    optimize_batched_pytree,
    optimize_lbfgs_pytree,
    optimize_pytree,
    pytree_names,
)
from .diagnostics import (
    ChainDiagnostics,
    diagnose_chains,
    diagnose_chains_device,
    energy_bfmi,
    energy_bfmi_device,
    PosteriorSummary,
    posterior_summary,
    ess,
    ess_device,
    rank_normalized_rhat,
    rank_normalized_rhat_device,
    split_rhat,
    split_rhat_device,
    tail_ess,
    tail_ess_device,
)
from .laplace import laplace_evidence
from .workflow import MapThenSampleResult, map_then_sample
from .sampling import (
    ChEESResult,
    ChEESState,
    LowRankMass,
    HMCResult,
    HMCState,
    NUTSResult,
    NUTSState,
    DepthSortInfo,
    chain_init_from_map,
    chees_sample,
    chees_sample_from_state,
    hmc_sample,
    hmc_sample_from_state,
    nuts_sample,
    nuts_sample_depth_sorted,
    nuts_sample_from_state,
)
from .solve import (
    MAX_ITERATIONS_DEFAULT,
    OptimizeResult,
    optimize,
    optimize_from_state,
)
from .state import BFGSState, LBFGSState, Status, init_bfgs_state, init_lbfgs_state
from . import transforms
from .ais import AISResult, ais_evidence
from .bridge import BridgeResult, bridge_evidence
from .loo import LOOResult, WAICResult, loo_compare, loo_psis, waic
from .pathfinder import PathfinderResult, pathfinder, psis_smooth
from .tempering import (
    PTResult,
    PTState,
    geometric_ladder,
    pt_sample,
    pt_sample_from_state,
)
from .transforms import TransformedModel, transform_objective

def _resolve_version() -> str:
    """Single-source the version from package metadata (the reference keeps
    one version in Project.toml, released by TagBot —
    /root/reference/.github/workflows/TagBot.yml). Installed: read the
    distribution metadata; from a source checkout: parse pyproject.toml."""
    try:
        from importlib.metadata import version

        return version("quasinewtonmethods-jl-tpu")
    except Exception:
        pass
    import pathlib
    import re

    pyproject = pathlib.Path(__file__).resolve().parent.parent / "pyproject.toml"
    try:
        m = re.search(
            r'^version\s*=\s*"([^"]+)"', pyproject.read_text(), re.MULTILINE
        )
        if m:
            return m.group(1)
    except OSError:
        pass
    return "0.0.0"


__version__ = _resolve_version()

__all__ = [
    "ProbabilityModel",
    "BackTracking",
    "LineSearchResult",
    "backtracking_linesearch",
    "Wolfe",
    "WolfeResult",
    "wolfe_linesearch",
    "bfgs_update",
    "initial_inv_hessian",
    "ChEESResult",
    "ChEESState",
    "ChainDiagnostics",
    "diagnose_chains",
    "diagnose_chains_device",
    "energy_bfmi",
    "energy_bfmi_device",
    "PosteriorSummary",
    "posterior_summary",
    "ess",
    "ess_device",
    "rank_normalized_rhat",
    "rank_normalized_rhat_device",
    "split_rhat",
    "split_rhat_device",
    "tail_ess",
    "tail_ess_device",
    "HMCResult",
    "HMCState",
    "LowRankMass",
    "NUTSResult",
    "NUTSState",
    "laplace_evidence",
    "AISResult",
    "ais_evidence",
    "BridgeResult",
    "bridge_evidence",
    "LOOResult",
    "WAICResult",
    "loo_compare",
    "loo_psis",
    "waic",
    "MapThenSampleResult",
    "map_then_sample",
    "chain_init_from_map",
    "chees_sample",
    "chees_sample_from_state",
    "hmc_sample",
    "hmc_sample_from_state",
    "nuts_sample",
    "nuts_sample_depth_sorted",
    "nuts_sample_from_state",
    "DepthSortInfo",
    "minimize",
    "optimize",
    "optimize_batched",
    "optimize_batched_compacted",
    "optimize_batched_fused",
    "optimize_batched_fused_from_state",
    "optimize_from_state",
    "optimize_lbfgs",
    "optimize_lbfgs_batched",
    "optimize_lbfgs_batched_fused_from_state",
    "optimize_lbfgs_from_state",
    "optimize_implicit",
    "ImplicitOptions",
    "LeastSquaresResult",
    "LMState",
    "least_squares",
    "least_squares_from_state",
    "TRResult",
    "TRState",
    "optimize_tr",
    "optimize_tr_from_state",
    "CGResult",
    "CGState",
    "optimize_cg",
    "optimize_cg_from_state",
    "AugLagResult",
    "optimize_auglag",
    "SVGDResult",
    "SVGDState",
    "EnsembleResult",
    "EnsembleState",
    "ensemble_autocorr_time",
    "ensemble_sample",
    "ensemble_sample_from_state",
    "MCLMCResult",
    "MCLMCState",
    "mclmc_sample",
    "mclmc_sample_from_state",
    "svgd_sample",
    "svgd_sample_from_state",
    "optimize_batched_pytree",
    "optimize_lbfgs_pytree",
    "optimize_cg_pytree",
    "optimize_tr_pytree",
    "optimize_auglag_pytree",
    "least_squares_pytree",
    "minimize_pytree",
    "map_then_sample_pytree",
    "pytree_names",
    "PytreeSampleResult",
    "optimize_multistart",
    "optimize_pytree",
    "MultistartResult",
    "LBFGSResult",
    "OptimizeResult",
    "MAX_ITERATIONS_DEFAULT",
    "BFGSState",
    "LBFGSState",
    "Status",
    "PolishResult",
    "polish_newton",
    "init_bfgs_state",
    "init_lbfgs_state",
    "transforms",
    "TransformedModel",
    "transform_objective",
    "pathfinder",
    "PathfinderResult",
    "psis_smooth",
    "PTResult",
    "PTState",
    "geometric_ladder",
    "pt_sample",
    "pt_sample_from_state",
    "__version__",
]
