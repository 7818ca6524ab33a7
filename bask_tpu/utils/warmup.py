"""Ahead-of-time compile warmup for production BO loops.

Each (bucket, n_steps) combination compiles its own device programs,
and a compile in the middle of a BO loop stalls it. This helper
pre-compiles every device
program a BO run will touch — ML-II value+grad, the MCMC chain, the
posterior refresh, and the acquisition pass — for the padding buckets
the run will traverse, so the loop itself never stalls mid-flight.

Compile-cache hits rely on bask-tpu's static-argument invariants
(CLAUDE.md): kernel specs are frozen dataclasses hashing by value,
guessed priors are module-level functions, and acquisition instances are
reused from the optimizer. Call with the SAME ``gp_samples`` /
``gp_burnin`` / ``n_samples`` the real ``tell`` loop will use — they
feed static chain lengths and draw counts.
"""

from __future__ import annotations

import warnings
from typing import Iterable

import numpy as np

__all__ = ["warmup_optimizer"]


def warmup_optimizer(
    opt,
    n_observations: Iterable[int],
    gp_samples: int = 100,
    gp_burnin: int = 10,
    n_samples: int = 0,
    rng_seed: int = 0,
):
    """Pre-compile the tell-path programs of ``opt`` for each padding
    bucket covered by ``n_observations``.

    Runs miniature synthetic ``tell`` cycles on a throwaway clone that
    shares ``opt``'s kernel / prior / acquisition instances (the jit
    cache keys). Returns the list of warmed bucket sizes.
    """
    from ..models.bayesgpr import _bucket
    from ..optimizer import Optimizer

    clone = Optimizer(
        dimensions=opt.space.dimensions,
        n_points=opt.n_points,
        n_initial_points=0,
        init_strategy=None,
        gp_kernel=opt.gp._user_kernel,
        gp_kwargs=dict(
            alpha=opt.gp.alpha,
            normalize_y=opt.gp.normalize_y,
            warp_inputs=opt.gp.warp_inputs,
            noise=opt.gp.noise,
            # the move mixture is a jit static: a demix loop warmed
            # with the stretch program would stall on a mid-run compile
            moves=opt.gp.moves,
            # laplace cold init adds a Hessian program — precompile it
            chain_init=getattr(opt.gp, "chain_init", "ball"),
            # the MAP warm start drives a different value+grad program
            ml2_objective=getattr(opt.gp, "ml2_objective", "lml"),
        ),
        gp_priors=opt.gp_priors,
        acq_func=opt.acq_func,
        acq_func_kwargs=opt.acq_func_kwargs,
        random_state=rng_seed,
        # a mesh changes the compiled programs (sharded inputs + the
        # walker count rounds to 2*n_devices multiples) — the clone must
        # warm the SAME programs the real loop will run
        mesh=getattr(opt, "mesh", None),
        # per-refit sampler overrides (moves=, a=) are jit statics too
        gp_sample_kwargs=getattr(opt, "gp_sample_kwargs", {}),
        # the polish ascent is its own jitted program set (n_steps/lr
        # are statics) — a polished loop warmed without it would stall
        # on a mid-run compile at the first real tell
        acq_polish=getattr(opt, "acq_polish", 0),
        acq_polish_starts=getattr(opt, "acq_polish_starts", 4),
        acq_polish_lr=getattr(opt, "acq_polish_lr", 0.05),
    )
    if "until_rhat" not in clone.gp_sample_kwargs:
        # the default convergence-honest COLD fit warm-extends the chain
        # in 300-step legs; ONE leg on the synthetic data compiles the
        # same leg program (n_steps=300 is the jit static) without
        # sampling a throwaway posterior to convergence. Applied only to
        # the bucket-filling cold tell below — the warm tell must keep
        # the real loop's deferred-fetch path (until_rhat would skip it).
        cold_kwargs = dict(
            clone.gp_sample_kwargs,
            until_rhat=1.1, max_extensions=1, extension_steps=300,
        )
    else:
        cold_kwargs = clone.gp_sample_kwargs
    warm_kwargs = clone.gp_sample_kwargs
    rng = np.random.RandomState(rng_seed)
    d = opt.space.transformed_n_dims
    buckets = sorted({_bucket(max(int(n), 1)) for n in n_observations})
    for b in buckets:
        # fill the bucket up to one point below (b >= 64 always): any n
        # in (b-64, b] pads to the same shapes, hence the same programs
        X = rng.uniform(size=(b - 1, d))
        y = np.sin(3.0 * X[:, 0]) + 0.1 * rng.randn(X.shape[0])
        pts = opt.space.inverse_transform(X)
        clone.gp_sample_kwargs = cold_kwargs
        try:
            with warnings.catch_warnings():
                # the cold tell's until_rhat budget is 1 leg BY DESIGN
                # (compile the extension program, don't converge a
                # throwaway synthetic posterior) — its non-convergence
                # warning is meaningless here and would alarm users
                warnings.filterwarnings(
                    "ignore", message=".*did not reach R-hat.*"
                )
                clone.tell(
                    pts,
                    list(y),
                    replace=True,
                    n_samples=n_samples,
                    gp_samples=gp_samples,
                    gp_burnin=gp_burnin,
                )
        finally:
            clone.gp_sample_kwargs = warm_kwargs
        # one more point inside the same bucket drives the WARM tell —
        # the overlapped sample+acquisition path with its packed
        # single-fetch program — so the production loop's steady state
        # is fully compiled too, not just the cold fit path
        x1 = opt.space.inverse_transform(rng.uniform(size=(1, d)))[0]
        clone.tell(
            x1,
            float(np.sin(3.0 * rng.uniform())),
            n_samples=n_samples,
            gp_samples=gp_samples,
            gp_burnin=gp_burnin,
        )
    return buckets
