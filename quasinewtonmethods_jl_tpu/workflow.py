"""One-call MAP-then-sample pipeline — the reference's intended workflow
as a single entry point.

The reference is "the inner MAP engine for HMC chain initialization"
(reference README.md:14); everything around it lived in other packages.
Here the whole loop is in-framework, and `map_then_sample` packages it:

    1. batched MAP solve from jittered starts (the fleet engines),
    2. chain initialization + dense-B preconditioner from the fleet
       (`chain_init_from_map`),
    3. sampling — ChEES (fleet-adaptive, the default), dense-mass
       HMC, or NUTS,
    4. convergence diagnostics (split R-hat + ESS) over the draws.

Each stage is the same public API a user would call by hand; the pipeline
adds the glue, the failure handling (no converged lanes -> ValueError
naming the failure statuses), and one place to read the results.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .diagnostics import ChainDiagnostics, diagnose_chains_device
from .parallel.batch import optimize_batched
from .sampling import chain_init_from_map, get_sampler
from .state import Status

__all__ = ["MapThenSampleResult", "map_then_sample"]


class MapThenSampleResult(NamedTuple):
    """Everything the pipeline produced, stage by stage.

    samples: (n_samples, chains, n) post-warmup draws
    diagnostics: per-dimension split R-hat / ESS / moments (None when
        compute_diagnostics=False was requested)
    map_result: the full batched MAP fleet result
    x_map: (n,) the best converged mode
    mass: the preconditioner handed to the sampler — (n, n) B for
        map_engine='bfgs', (n,) compact-form diag(H) for 'lbfgs', or
        None when the sampler adapts its own
    sampler_result: the sampler's own result object (adapted state etc.)
    """

    samples: jax.Array
    diagnostics: Optional[ChainDiagnostics]
    map_result: object
    x_map: jax.Array
    mass: Optional[jax.Array]
    sampler_result: object
    polish_result: object = None  # PolishResult when polish_steps > 0
    depth_sort_info: object = None  # DepthSortInfo when depth_sort=True
    # transform= only: the constrained-space view of the run. `samples` /
    # `x_map` stay in unconstrained z (that is what resume/state expects);
    # these are forward-mapped once, on device.
    samples_constrained: Optional[jax.Array] = None
    x_map_constrained: Optional[jax.Array] = None
    # compute_evidence= only: log marginal likelihood. 'laplace' = the
    # curvature Gaussian at the best mode; 'ais' = annealed importance
    # sampling from the fleet's Laplace base (asymptotically exact);
    # 'bridge' = bridge sampling over this run's own draws (consistent,
    # zero extra model gradients). evidence_extra carries the
    # AISResult/BridgeResult with its reliability diagnostic
    # (weight ESS / re2). Identical for a transformed model:
    # ∫p(x)dx = ∫p(f(z))|J|dz, so the z-space run's evidence IS the
    # constrained model's evidence.
    log_evidence: Optional[jax.Array] = None
    evidence_extra: object = None


def map_then_sample(
    obj,
    key: jax.Array,
    x0: jax.Array,  # (n,) center for jittered starts, or (chains, n) starts
    n_chains: int = 64,
    sampler: str = "chees",
    map_engine: str = "bfgs",
    n_samples: int = 1000,
    n_warmup: int = 500,
    init_scale: float = 1.0,
    jitter: float = 0.05,
    map_tol: Optional[float] = None,
    compute_diagnostics: bool = True,
    value_and_grad_fn: Optional[Callable] = None,
    map_kwargs: Optional[dict] = None,
    polish_steps: int = 0,
    mass_form: str = "auto",
    mesh: Optional[Mesh] = None,
    mesh_axis: str = "data",
    depth_sort: bool = False,
    transform=None,
    init: str = "map",
    pathfinder_kwargs: Optional[dict] = None,
    svgd_kwargs: Optional[dict] = None,
    compute_evidence: Optional[str] = None,
    ais_kwargs: Optional[dict] = None,
    **sampler_kwargs,
) -> MapThenSampleResult:
    """MAP fleet -> preconditioner -> sampler -> diagnostics, in one call.

    ``x0``: either an (n,) center (starts are x0 + init_scale * normal)
    or explicit (chains, n) starts; integer input is promoted to float.
    ``sampler``: 'chees' (default — fleet-adaptive trajectories +
    diagonal mass, accelerator-native), 'hmc' (dense-B preconditioned, fixed
    path length), 'nuts', 'pt' (replica exchange — multimodal
    posteriors; ladder kwargs like ``n_temps``/``beta_min`` pass through
    ``sampler_kwargs``; it too gets the MAP-fleet mass), 'ensemble'
    (the gradient-free affine-invariant stretch move — walkers start at
    the jittered MAP ball; no mass handoff, affine invariance IS the
    metric), or 'mclmc' (microcanonical Langevin — unadjusted,
    fixed-cost, two gradients per draw; the MAP mass's DIAGONAL becomes
    its preconditioner and warmup tunes eps to the energy-error target;
    see `mclmc_sample` for the bias contract).
    ``map_engine``: 'bfgs' (dense B, the
    reference algorithm), 'lbfgs' (the large-n fleet engine — the
    handed-over mass is then the compact-form diag(H), O(m²·n), so the
    pipeline never materializes an n×n matrix), or 'lm' (Gaussian-
    likelihood models: Levenberg–Marquardt on
    ``map_kwargs={'residual_fn': ..., 'data': ..., ...}`` — ~half the
    iterations of BFGS, no line search, and the handed-over mass is the
    exact Gauss–Newton covariance inv(JTJ) instead of a secant estimate.
    ``obj`` must agree with −½Σρ(rᵢ²) up to a constant: put Gaussian
    priors in the residuals as augmented rows, or close over shared
    data in ``residual_fn`` instead of tiling a ``data`` pytree), or
    'tr' (stiff/locally indefinite surfaces: the trust-region
    Newton–Krylov fleet; the handed-over mass is the EXACT inverse
    observed information from one `jax.hessian` at the best mode —
    identity fallback in-band if H is indefinite there), or 'cg' (the
    O(n)-state nonlinear-CG fleet for very large n; matrix-free like
    'tr', so it shares 'tr''s exact-Hessian handoff — note that handoff
    is O(n²), so at truly large n prefer 'lbfgs' whose mass stays
    compact). The MAP fleet's
    converged-lane-averaged curvature becomes the mass for 'hmc'
    ('chees'/'nuts' adapt their own diagonal by default; pass
    ``mass=...`` through ``sampler_kwargs`` to override). ``map_tol`` defaults by dtype — 1e-3 for f32 (the
    repo's f32 fleet contract) and 1e-6 otherwise. ``map_kwargs`` /
    ``sampler_kwargs`` OVERRIDE the pipeline's defaults on collision
    (e.g. map_kwargs={'tol': ...} wins over map_tol). Raises ValueError
    when NO lane converges (statuses quoted); on partial convergence
    failed lanes' chain starts are replaced by the best converged mode
    (jittered) so no chain starts off-mode.

    ``polish_steps > 0`` inserts the evidence-grade stage between MAP and
    handoff: `polish_newton` refines the converged lanes' iterates (the
    chain inits and x_map come from the polished modes). ``mass_form='lowrank'`` (with
    map_engine='lbfgs') hands the sampler a `LowRankMass` built from the
    best lane's ring instead of the diagonal (see chain_init_from_map).

    ``mesh`` (round 4): a `jax.sharding.Mesh` shards the chains axis over
    ``mesh_axis`` for EVERY stage — MAP fleet, polish, sampler, and
    on-device diagnostics — the one-call multi-chip pipeline that
    previously required hand-composing `optimize_batched_sharded` +
    `sample_sharded` plus the failure-handling glue. n_chains must
    divide evenly over the axis. Same seeds → same draws as the
    unsharded pipeline (GSPMD partitions the identical program;
    parity-tested on a virtual CPU mesh).

    ``depth_sort`` (round 4, ``sampler='nuts'`` only, single-chip):
    after warmup, sampling runs through `nuts_sample_depth_sorted` —
    chains sort into depth-homogeneous sub-fleets when the probed
    tree-depth persistence/spread says the geometry can pay. When the
    probe says no, the pipeline's draws are bitwise what
    ``depth_sort=False`` produces (chunked-run identity + the sorted
    path's identical fallback). Depth-sort tuning knobs
    (``groups``, ``probe_draws``, ``min_persistence``,
    ``min_depth_spread``) pass through ``sampler_kwargs``; the decision
    record lands in the result's ``depth_sort_info``.

    ``transform`` (round 4): a `qnm.transforms` bijection for constrained
    parameters. ``x0`` is then given in CONSTRAINED x-space (the space
    the user's model and ``obj`` live in); the pipeline wraps ``obj``
    via `transform_objective` and runs every stage in unconstrained z.
    The result's ``samples``/``x_map`` stay in z (resume state lives
    there); ``samples_constrained``/``x_map_constrained`` carry the
    forward-mapped view, and diagnostics are computed on the CONSTRAINED
    draws (the user-facing scale, per the Stan convention). A supplied
    ``value_and_grad_fn`` is interpreted in x-space and pulled back
    through the transform.

    ``compute_evidence`` (round 4): 'laplace' evaluates the exact-Hessian
    Laplace log-evidence at the best converged mode; 'ais' runs
    `ais_evidence` from the (x_map, mass) base; 'bridge' runs
    `bridge_evidence` on THIS run's draws against the (x_map, mass)
    proposal — no gradients and no extra sampling, and it integrates
    every basin the chains visited (pair with sampler='pt' for
    multimodal targets). ``ais_kwargs`` pass through to the chosen
    estimator; the `AISResult`/`BridgeResult` with its reliability
    diagnostic (weight ESS / re2) lands in ``evidence_extra``.
    Evaluated at the UNPOLISHED fleet modes; with ``transform=`` the
    value is the constrained model's evidence (the Jacobian is part of
    the z-density). Requires init='map' and (for 'ais'/'bridge') an
    array mass — not 'lowrank'.

    ``init='pathfinder'`` (round 4): replace the MAP-fleet + curvature
    handoff with multi-path Pathfinder — chain starts are its
    PSIS-resampled draws (already posterior-shaped, not mode-jittered)
    and the sampler metric is the selected low-rank inverse Hessian
    (``pf.mass()``). ``x0`` must then be an (n,) center; tuning knobs
    (``n_paths``, ``max_iters``, ``elbo_draws``, ...) go in
    ``pathfinder_kwargs``; the `PathfinderResult` lands in the result's
    ``map_result`` and ``x_map`` is the best path's Gaussian mean. Check
    ``map_result.khat`` — above 0.7 the variational starts are
    unreliable and warmup should do the heavy lifting (raise
    ``n_warmup``). Incompatible with ``polish_steps`` (no fleet to
    polish). Composes with ``transform=`` (pathfinder runs in z).

    ``init='svgd'`` (round 4) instead transports a particle fleet to the
    posterior deterministically (`svgd_sample`; knobs in
    ``svgd_kwargs``): chain starts are the particles (posterior-shaped
    spread, already decorrelated), the 'hmc'/'pt' mass is the
    SPD-guarded particle covariance, and the `SVGDResult` lands in
    ``map_result``. chees/nuts still self-adapt their metric — SVGD's
    high-dimensional covariance is underestimated (variance collapse;
    see the `svgd_sample` docstring). Same restrictions as
    'pathfinder': (n,) center, no polish, no compute_evidence.
    """
    if init not in ("map", "pathfinder", "svgd"):
        raise ValueError(
            f"init must be 'map', 'pathfinder', or 'svgd', got {init!r}"
        )
    if compute_evidence not in (None, "laplace", "ais", "bridge"):
        raise ValueError(
            f"compute_evidence must be None, 'laplace', 'ais' or "
            f"'bridge', got {compute_evidence!r}"
        )
    if compute_evidence is not None and init != "map":
        raise ValueError(
            "compute_evidence needs the MAP fleet's mode/curvature — "
            "use init='map', or run qnm.ais_evidence with an explicit "
            f"(mu, cov) base on the init={init!r} output"
        )
    if init != "map" and polish_steps > 0:
        raise ValueError(
            f"init={init!r} has no MAP fleet to polish; drop "
            "polish_steps or use init='map'"
        )
    sample_fn = get_sampler(sampler)
    x0 = jnp.asarray(x0)
    if not jnp.issubdtype(x0.dtype, jnp.floating):
        x0 = x0.astype(jnp.result_type(float))

    # Constrained parameters: wrap the objective once and run the WHOLE
    # pipeline in unconstrained z (MAP fleet, polish, mass, sampler,
    # resume state). `x0` is given in CONSTRAINED x-space — the space the
    # user's model lives in — and is unconstrained here; the constrained
    # view of the outputs is forward-mapped once at the end.
    if transform is not None:
        from .transforms import TransformedModel, forward_draws

        obj = TransformedModel(obj, transform, value_and_grad_fn=value_and_grad_fn)
        value_and_grad_fn = None  # consumed: the wrapper pulls it back
        x0 = obj.unconstrain(x0)
    k_init, k_jit, k_sample = jax.random.split(key, 3)
    if x0.ndim == 1:
        x0s = x0[None, :] + init_scale * jax.random.normal(
            k_init, (n_chains, x0.shape[0]), x0.dtype
        )
    elif x0.ndim == 2:
        x0s = x0
        n_chains = x0.shape[0]
    else:
        raise ValueError(f"x0 must be (n,) or (chains, n), got {x0.shape}")

    # Multi-chip: shard the chains axis over `mesh_axis` and run every
    # stage inside the mesh context — GSPMD partitions the fleet solve,
    # the sampler scan, and the diagnostics reductions alike (the chains
    # are independent; cross-device traffic is only the fleet-adaptive
    # reductions and loop predicates, a few scalars per step over ICI).
    # The glue (status readback, best-mode argmax, fallback fill) is
    # unchanged — those are (chains,)-sized host/device ops.
    if mesh is not None:
        n_shards = mesh.shape[mesh_axis]
        if x0s.shape[0] % n_shards != 0:
            raise ValueError(
                f"n_chains ({x0s.shape[0]}) must divide evenly over mesh "
                f"axis {mesh_axis!r} ({n_shards} shards)"
            )

        def _shard(arr):
            spec = P(mesh_axis, *([None] * (arr.ndim - 1)))
            return jax.device_put(arr, NamedSharding(mesh, spec))

        mesh_ctx = lambda: mesh  # noqa: E731 — Mesh is a context manager
        x0s = _shard(x0s)
    else:
        _shard = lambda arr: arr  # noqa: E731
        mesh_ctx = contextlib.nullcontext

    if init == "pathfinder":
        if x0.ndim != 1:
            raise ValueError(
                "init='pathfinder' takes an (n,) center (chain starts are "
                f"its resampled draws), got x0 shape {x0.shape}"
            )
        from .pathfinder import pathfinder as _run_pathfinder

        pk = dict(
            n_draws=n_chains,
            init_scale=init_scale,
            value_and_grad_fn=value_and_grad_fn,
        )
        if map_tol is not None:
            pk["tol"] = map_tol
        pk.update(pathfinder_kwargs or {})  # explicit kwargs win
        pf = _run_pathfinder(obj, k_init, x0, **pk)
        if not bool(jnp.any(jnp.isfinite(pf.elbo))):
            counts = {
                Status(s).name: int(c)
                for s, c in zip(*np.unique(np.asarray(pf.status),
                                           return_counts=True))
            }
            raise ValueError(
                f"pathfinder stage failed: no path produced a finite ELBO "
                f"(statuses: {counts}); improve x0 or lower init_scale"
            )
        fleet = pf
        pol = None
        chains = pf.draws  # n_draws=n_chains above
        mass = pf.mass()
        x_map = pf.mu[jnp.argmax(pf.elbo)]
    elif init == "svgd":
        # deterministic particle transport: chain starts are the SVGD
        # fleet (posterior-shaped spread, no warmup needed to decorrelate
        # them). Mass: the particle covariance for 'hmc'/'pt' — but note
        # SVGD UNDERESTIMATES high-d covariance (variance collapse, see
        # svgd_sample docstring), so chees/nuts keep their own
        # self-adaptation (the mass override below is hmc/pt-only).
        if x0.ndim != 1:
            raise ValueError(
                "init='svgd' takes an (n,) center (chain starts are its "
                f"particles), got x0 shape {x0.shape}"
            )
        from .svgd import svgd_sample as _run_svgd

        starts = x0[None, :] + init_scale * jax.random.normal(
            k_init, (n_chains, x0.shape[0]), x0.dtype
        )
        sk = dict(value_and_grad_fn=value_and_grad_fn)
        sk.update(svgd_kwargs or {})  # explicit kwargs win
        with mesh_ctx():
            sv = _run_svgd(obj, _shard(starts), **sk)
            ok_sv = jnp.isfinite(sv.logp)
            if not bool(jnp.any(ok_sv)):
                raise ValueError(
                    "svgd stage failed: every particle's objective is "
                    "non-finite; improve x0 or lower init_scale"
                )
            parts = sv.particles
            n = parts.shape[-1]
            w_sv = ok_sv.astype(parts.dtype)
            w_sv = w_sv / jnp.sum(w_sv)
            mu_sv = jnp.einsum("b,bn->n", w_sv, parts)
            C = parts - mu_sv[None, :]
            cov_sv = jnp.einsum("b,bi,bj->ij", w_sv, C, C)
            # SPD in-band: jittered toward its own diagonal scale; a
            # degenerate fleet (particles < n or collapsed) falls back
            # to the diagonal variances
            jitter_sv = 1e-6 * jnp.trace(cov_sv) / n
            cov_j = cov_sv + jitter_sv * jnp.eye(n, dtype=parts.dtype)
            chol_sv = jnp.linalg.cholesky(cov_j)
            diag_sv = jnp.maximum(jnp.diagonal(cov_sv), 1e-10)
            mass = jnp.where(
                jnp.all(jnp.isfinite(chol_sv)),
                cov_j,
                jnp.eye(n, dtype=parts.dtype) * diag_sv[None, :],
            )
        fleet = sv
        pol = None
        chains = parts
        x_map = parts[jnp.argmax(jnp.where(ok_sv, sv.logp, -jnp.inf))]
    else:
        fleet, pol, chains, mass, x_map = _map_stage(
            obj, x0s, x0.dtype, map_engine, map_tol, map_kwargs,
            value_and_grad_fn, polish_steps, jitter, k_jit, mass_form,
            mesh_ctx,
        )

    kw = dict(
        n_samples=n_samples, n_warmup=n_warmup,
        value_and_grad_fn=value_and_grad_fn,
    )
    if sampler in ("hmc", "pt", "mclmc"):
        # the dense-B handoff is the point of 'hmc'; 'pt' (replica
        # exchange, multimodal targets) has no self-adaptation either;
        # 'mclmc' preconditions on the mass's diagonal
        kw["mass"] = mass
    elif mass_form == "lowrank" or init == "pathfinder":
        # an explicitly requested low-rank metric (or the pathfinder
        # handoff, whose selected metric IS the point) overrides the
        # default self-adaptation of chees/nuts
        kw["mass"] = mass
    kw.update(sampler_kwargs)  # explicit sampler kwargs win
    ds_info = None
    if depth_sort:
        if sampler != "nuts":
            raise ValueError(
                f"depth_sort=True requires sampler='nuts' (got "
                f"{sampler!r}); ChEES/HMC trajectories are fleet-shared "
                "— there is no per-chain tree depth to sort on"
            )
        if mesh is not None:
            raise ValueError(
                "depth_sort=True is single-chip (the sort is a host-side "
                "permutation of the fleet state); drop mesh= or depth_sort"
            )
        from .sampling import nuts_sample, nuts_sample_depth_sorted

        ds_keys = (
            "groups", "probe_draws", "min_persistence", "min_depth_spread"
        )
        ds_kw = {k: kw.pop(k) for k in ds_keys if k in kw}
        n_total = kw.pop("n_samples")
        warm = nuts_sample(
            obj, k_sample, chains, n_samples=0,
            total_warmup=kw["n_warmup"], **kw,
        )
        # the depth-sorted entry takes sampling-phase config only
        for k in ("n_warmup", "step_size", "mass_rank"):
            kw.pop(k, None)
        res, ds_info = nuts_sample_depth_sorted(
            obj, warm.state, n_total, **ds_kw, **kw
        )
        kw["n_samples"] = n_total  # the diagnostics gate below reads it
    else:
        with mesh_ctx():
            res = sample_fn(obj, k_sample, _shard(chains), **kw)

    # transform=: the user-facing scale is constrained x — report the
    # draws and diagnostics there (the Stan convention); z-space outputs
    # stay on the result for resume. forward_draws is elementwise/cumsum,
    # so it fuses and (under a mesh) partitions without a gather.
    samples_c = x_map_c = None
    if transform is not None:
        with mesh_ctx():
            samples_c = forward_draws(transform, res.samples)
        x_map_c = transform.forward(x_map)
    diag_samples = res.samples if samples_c is None else samples_c

    if not compute_diagnostics:
        diag = None
    elif kw["n_samples"] >= 8:
        # ON-DEVICE diagnostics (diagnose_chains_device): the draws stay on
        # the device; only four (n,)-sized summaries reach the host
        # (fetching every draw for host FFTs costs far more transfer than
        # compute).
        # Under a mesh the draws stay SHARDED over chains: split R-hat's
        # per-chain moments are chain-local, and the cross-chain means /
        # Geyer ESS pooling lower to all-reduces — no gather of the draw
        # array (asserted by tests/test_workflow.py's sharded-parity test).
        with mesh_ctx():
            diag = diagnose_chains_device(diag_samples)
    else:
        # too few draws for split R-hat / ESS: report moments, NaN stats —
        # never discard a completed pipeline over its diagnostics
        pooled = np.asarray(diag_samples).reshape(-1, diag_samples.shape[-1])
        nan = np.full(pooled.shape[-1], np.nan)
        diag = ChainDiagnostics(
            rhat=nan, ess=nan.copy(), mean=pooled.mean(axis=0),
            std=pooled.std(axis=0, ddof=1) if pooled.shape[0] > 1 else nan.copy(),
        )

    # --- evidence (optional): the fleet's mode/curvature is already in
    # hand, so Laplace is one Hessian at x* and AIS anneals from the
    # (x_map, mass) base. In transform mode this is the CONSTRAINED
    # model's evidence too (the Jacobian is part of the z-density).
    log_ev, ev_extra = None, None
    if compute_evidence == "laplace":
        from .laplace import laplace_evidence

        with mesh_ctx():
            lz = laplace_evidence(fleet, obj=obj)
        ok = fleet.status == Status.CONVERGED
        log_ev = lz[jnp.argmax(jnp.where(ok, fleet.fun, -jnp.inf))]
    elif compute_evidence == "ais":
        from .ais import ais_evidence

        if mass is None or isinstance(mass, tuple) or not hasattr(
            mass, "ndim"
        ):
            raise ValueError(
                "compute_evidence='ais' needs an array mass (dense B or "
                "diag) from the MAP handoff; mass_form='lowrank' is not "
                "supported — call qnm.ais_evidence with an explicit base"
            )
        ak = dict(ais_kwargs or {})
        ev = ais_evidence(
            obj, jax.random.fold_in(key, 3), (x_map, mass),
            value_and_grad_fn=value_and_grad_fn, **ak,
        )
        log_ev, ev_extra = ev.logZ, ev
    elif compute_evidence == "bridge":
        # post-hoc: reuses THIS run's z-space draws + the MAP base —
        # no gradients, no extra sampling; the cheapest consistent
        # estimator once the pipeline has run. Integrates exactly the
        # mass the chains visited (sampler='pt' makes that multimodal).
        from .bridge import bridge_evidence

        if mass is None or isinstance(mass, tuple) or not hasattr(
            mass, "ndim"
        ):
            raise ValueError(
                "compute_evidence='bridge' needs an array mass (dense B "
                "or diag) from the MAP handoff; mass_form='lowrank' is "
                "not supported — call qnm.bridge_evidence with an "
                "explicit base"
            )
        ev = bridge_evidence(
            obj, jax.random.fold_in(key, 3), res.samples, (x_map, mass),
            **dict(ais_kwargs or {}),
        )
        log_ev, ev_extra = ev.logZ, ev

    return MapThenSampleResult(
        samples=res.samples,
        diagnostics=diag,
        map_result=fleet,
        x_map=x_map,
        mass=kw.get("mass"),
        sampler_result=res,
        polish_result=pol,
        depth_sort_info=ds_info,
        samples_constrained=samples_c,
        x_map_constrained=x_map_c,
        log_evidence=log_ev,
        evidence_extra=ev_extra,
    )


def _map_stage(
    obj, x0s, dtype, map_engine, map_tol, map_kwargs, value_and_grad_fn,
    polish_steps, jitter, k_jit, mass_form, mesh_ctx,
):
    """Stages 1-2 of the pipeline (MAP fleet -> polish -> handoff); split
    out so init='pathfinder' can swap them wholesale."""
    if map_tol is None:
        # the repo's precision contract: f32 is throughput mode, tol >= ~1e-3
        map_tol = 1e-3 if dtype == jnp.float32 else 1e-6
    mk = dict(tol=map_tol, value_and_grad_fn=value_and_grad_fn)
    mk.update(map_kwargs or {})  # explicit map_kwargs win
    with mesh_ctx():
        if map_engine == "lbfgs":
            from .parallel.batch import optimize_lbfgs_batched

            fleet = optimize_lbfgs_batched(obj, x0s, **mk)
        elif map_engine == "bfgs":
            fleet = optimize_batched(obj, x0s, **mk)
        elif map_engine == "lm":
            # Gaussian-likelihood models: the MAP is a nonlinear
            # least-squares problem — Levenberg–Marquardt finds it in ~half
            # the iterations of BFGS with no line search, and hands the
            # sampler the exact Gauss-Newton information inv(JTJ) instead
            # of a secant estimate. `obj` (the sampler's logdensity) must
            # agree with -1/2*sum(rho(r^2)) up to a constant — Gaussian
            # priors belong IN the residuals (the standard augmented-rows
            # trick); the pipeline cannot check this, it documents it.
            from .least_squares import least_squares

            lm_kw = dict(mk)
            if lm_kw.pop("value_and_grad_fn", None) is not None:
                raise ValueError(
                    "map_engine='lm' differentiates the residual_fn "
                    "directly; value_and_grad_fn does not apply"
                )
            residual_fn = lm_kw.pop("residual_fn", None)
            if residual_fn is None:
                raise ValueError(
                    "map_engine='lm' needs map_kwargs={'residual_fn': ...}"
                    " (plus optional 'data', 'bounds', 'loss', ...)"
                )
            fleet = least_squares(residual_fn, x0s, **lm_kw)
            # least_squares MINIMIZES ½‖r‖²; the pipeline's convention is
            # maximized logdensity (best-mode argmax, polish handoff).
            # -fun IS the Gaussian log-likelihood up to its constant —
            # and last_value/grad flip WITH it so the presented result
            # stays internally consistent (fun == last_value on
            # convergence, grad in the maximization orientation). JTJ and
            # .state keep the LM engine's native orientation (curvature
            # of ½‖r‖²; the state resumes through
            # least_squares_from_state unchanged).
            fleet = fleet._replace(
                fun=-fleet.fun,
                last_value=-fleet.last_value,
                grad=-fleet.grad,
            )
        elif map_engine == "tr":
            # stiff / locally indefinite MAP surfaces: the trust-region
            # Newton-Krylov engine. It carries no curvature matrix
            # (matrix-free HVPs), so the mass handoff is built AFTER the
            # solve from the exact Hessian at the best mode (below) —
            # observed information, sharper than any secant estimate.
            from .trust_region import optimize_tr

            fleet = optimize_tr(obj, x0s, **mk)
        elif map_engine == "cg":
            # very-large-n MAP fleets where even the L-BFGS ring binds:
            # the O(n)-state nonlinear-CG engine. Matrix-free like 'tr',
            # so the mass handoff shares 'tr''s exact-Hessian path below.
            from .cg_solve import optimize_cg

            fleet = optimize_cg(obj, x0s, **mk)
        else:
            raise ValueError(
                f"unknown map_engine {map_engine!r}; use 'bfgs', 'lbfgs',"
                " 'lm', 'tr', or 'cg'"
            )

    # one status readback serves both the failure check and the masks
    statuses = np.asarray(fleet.status)
    converged = statuses == Status.CONVERGED
    if not converged.any():
        counts = {
            Status(s).name: int(c)
            for s, c in zip(*np.unique(statuses, return_counts=True))
        }
        raise ValueError(
            f"MAP stage failed: no lane converged (statuses: {counts}); "
            "loosen map_tol or improve the starts"
        )

    pol = None
    if polish_steps > 0:
        from .polish import polish_newton

        with mesh_ctx():
            pol = polish_newton(
                obj, fleet, steps=polish_steps,
                value_and_grad_fn=value_and_grad_fn,
            )
        # the polished modes (same dtype) feed the handoff; curvature
        # state (B / rings) stays the solver's — polish refines iterates
        fleet = fleet._replace(
            x=pol.x.astype(fleet.x.dtype),
            fun=pol.fun.astype(fleet.fun.dtype),
        )

    if map_engine in ("tr", "cg"):
        # these engines are matrix-free (no carried curvature): hand over
        # the EXACT observed information instead — one jax.hessian at the
        # best converged mode, mass = inv(-H). Sharper than any secant
        # estimate; O(n²) like polish/laplace (large-n users take 'lbfgs').
        if mass_form != "auto":
            raise ValueError(
                f"map_engine={map_engine!r} hands over the exact-Hessian "
                f"inverse; mass_form={mass_form!r} does not apply "
                "(use 'auto')"
            )
        from .api import as_logdensity

        conv_j = jnp.asarray(converged)
        best_tr = jnp.argmax(jnp.where(conv_j, fleet.fun, -jnp.inf))
        with mesh_ctx():
            H = jax.hessian(as_logdensity(obj))(fleet.x[best_tr])
            n = fleet.x.shape[-1]
            eye = jnp.eye(n, dtype=fleet.x.dtype)
            minv = jnp.linalg.inv(-H)
            # indefinite/singular H at a non-interior or flat mode:
            # identity metric, in-band. Positive definiteness needs a
            # real test — an indefinite inverse can be finite with an
            # all-positive diagonal — so check via Cholesky of −H
            # (NaN factor iff not PD), plus finiteness of the inverse.
            chol = jnp.linalg.cholesky(-H)
            spd = jnp.all(jnp.isfinite(chol)) & jnp.all(
                jnp.isfinite(minv)
            )
            mass = jnp.where(spd, minv, eye)
        chains = fleet.x + jitter * jax.random.normal(
            k_jit, fleet.x.shape, fleet.x.dtype
        )
    else:
        chains, mass = chain_init_from_map(
            fleet, jitter=jitter, key=k_jit, mass_form=mass_form
        )
        conv_j = jnp.asarray(converged)
    # best converged mode, device-side (multistart's -inf-masked argmax)
    best = jnp.argmax(jnp.where(conv_j, fleet.fun, -jnp.inf))
    x_map = fleet.x[best]
    # never seed a chain from a failed lane's off-mode iterate
    fallback = x_map[None, :] + jitter * jax.random.normal(
        jax.random.fold_in(k_jit, 1), chains.shape, chains.dtype
    )
    chains = jnp.where(conv_j[:, None], chains, fallback)
    return fleet, pol, chains, mass, x_map
