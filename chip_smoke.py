"""Smoke test of the main path on one GPU (or, with --four-cards, on four).

    python chip_smoke.py               # five phases on one card
    python chip_smoke.py --four-cards  # the multi-device paths only

One process opens the card(s); the only child process is ``nvidia-smi``,
which does not use JAX. Everything runs in float32 as ``Optimizer``
users run it; float64 is used only for the references, on the same card.

Phases (one card):

1. LML parity: the f32 walker-batched LML (``linalg.batched_lml``) at
   the north-star shape (d=15, n=500 padded to 512, 100 walkers) and at
   n=4096 with 8 walkers, against a float64 ``masked_lml``; a singular
   gram (duplicate points, zero jitter) must give -inf on both paths.
2. ``BayesGPR.fit`` at the north-star problem (100 walkers, default
   sampler) plus the Laplace-init Hessian (second-order AD).
3. ``Optimizer`` ask/tell: 500 told points, 5 rounds with ``pvrs``, 5
   with ``ei``; then ``ask(n_points=16)`` at n=1000 over 65,536
   candidates (the pathwise Thompson batch).
4. Acquisition parity: EI and PVRS scores over 100 hyperposterior draws
   x 512 train points x 512 candidates, f32 against float64.
5. The tests marked ``chip`` (``tests/test_chip.py``), in-process.

Each phase prints its result, its error against the reference with the
tolerance, and cold (first call, compiles included) and warm seconds,
labelled with the card and its power limit. The last line of standard
output is ``{"ok": true, "device": {...}}`` only when every phase
passed; the exit code is non-zero otherwise, and when JAX finds no GPU.

The persistent compile cache follows ``JAX_COMPILATION_CACHE_DIR`` when
it is set, else ``<repo>/.jax_cache``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
D = 15

# f32 LML tolerance, relative to max(1, |lml|): unit roundoff (6e-8)
# times twice the condition bound of the gram, n * amplitude / noise
# (amplitude ~1, noise variance ~0.05 for the walkers used here), which
# bounds the error of the quadratic term |L^-1 y|^2.
def lml_tolerance(n_pad: int, noise: float = 0.05) -> float:
    return 2 * 6e-8 * n_pad / noise


# f32 acquisition tolerance, relative to the largest float64 score of
# the pass: the predictive solves see the same conditioning as the LML.
ACQ_TOL = 1e-2


def card_label() -> str:
    """``name, power.limit`` of the card(s), from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    if not lines:
        return f"nvidia-smi failed: {out.stderr.strip()}"
    return lines[0] if len(set(lines)) == 1 else " | ".join(lines)


def compile_cache_dir() -> str:
    """JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; only when it is
    unset is the fixed in-repo directory configured."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    path = os.path.join(REPO, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


# ---------------------------------------------------------------------------
# Problem builders (the north-star recipe of bench.py at any size)
# ---------------------------------------------------------------------------


def north_star_kernel(d=D, white=True):
    from bask_tpu.ops import kernels as bk

    k = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern(
        (0.3,) * d, (0.05, 2.0), nu=2.5
    )
    return k + bk.WhiteKernel(0.05, (1e-5, 1e5)) if white else k


def north_star_xy(n_obs, d=D, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.uniform(size=(n_obs, d))
    y = np.sum((X - 0.5) ** 2, axis=1) + 0.05 * rng.randn(n_obs)
    return X, (y - y.mean()) / y.std()


def padded(X, y, n_pad, jitter=1e-6):
    n, d = X.shape
    Xp = np.full((n_pad, d), 0.5)
    Xp[:n] = X
    yp = np.zeros(n_pad)
    yp[:n] = y
    return Xp, yp, np.full(n_pad, jitter), np.arange(n_pad) < n


def walker_thetas(n_theta, walkers, seed=1):
    pos = 0.05 * np.random.RandomState(seed).randn(walkers, n_theta)
    pos[:, -1] += math.log(0.05)  # white-noise channel near the truth
    return pos


def _timed(fn, *args):
    """(result, cold seconds, warm seconds): two calls, each ending in
    ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, cold, time.perf_counter() - t0


def _rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref) / np.maximum(1.0, np.abs(ref))))


# ---------------------------------------------------------------------------
# Phases. Each returns a dict with "ok"; sizes are arguments so the CPU
# tests can run every phase at a tiny size.
# ---------------------------------------------------------------------------


def phase_lml(shapes=((500, 512, 100), (4000, 4096, 8)), d=D):
    import jax
    import jax.numpy as jnp

    from bask_tpu.ops import linalg

    kernel = north_star_kernel(d)
    checks = []
    for n_obs, n_pad, walkers in shapes:
        Xp, yp, a, m = padded(*north_star_xy(n_obs, d), n_pad)
        th = walker_thetas(kernel.n_theta, walkers)
        f32 = jax.jit(
            lambda t, X, y, a, m: linalg.batched_lml(kernel, t, X, y, a, m)
        )
        args = tuple(jnp.asarray(v, jnp.float32) for v in (th, Xp, yp, a))
        got, cold, warm = _timed(f32, *args, jnp.asarray(m))
        with jax.enable_x64(True):
            ref = jax.jit(
                jax.vmap(
                    lambda t, X, y, a, m: linalg.masked_lml(
                        kernel, t, X, y, a, m
                    ),
                    in_axes=(0, None, None, None, None),
                )
            )(*(jnp.asarray(v, jnp.float64) for v in (th, Xp, yp, a)),
              jnp.asarray(m))
            ref = np.asarray(ref)
        err, tol = _rel_err(got, ref), lml_tolerance(n_pad)
        checks.append({
            "shape": [walkers, n_pad], "max_rel_err": err, "tol": tol,
            "finite": bool(np.isfinite(np.asarray(got)).all()),
            "cold_s": cold, "warm_s": warm,
            "ok": bool(np.isfinite(np.asarray(got)).all() and err <= tol),
        })

    # singular gram: exact duplicate points, zero jitter, no noise term
    n_obs, n_pad = shapes[0][0], shapes[0][1]
    half, _ = north_star_xy(n_obs // 2, d)
    Xdup = np.concatenate([half, half])
    Xp, yp, _, m = padded(Xdup, north_star_xy(len(Xdup), d)[1], n_pad)
    zero = np.zeros(n_pad)
    kdeg = north_star_kernel(d, white=False)
    th = np.tile(kdeg.theta0, (2, 1))
    deg32 = np.asarray(linalg.batched_lml(
        kdeg, *(jnp.asarray(v, jnp.float32) for v in (th, Xp, yp, zero)),
        jnp.asarray(m),
    ))
    with jax.enable_x64(True):
        deg64 = float(linalg.masked_lml(
            kdeg, *(jnp.asarray(v, jnp.float64) for v in (th[0], Xp, yp, zero)),
            jnp.asarray(m),
        ))
    deg_ok = bool(np.all(deg32 == -np.inf) and deg64 == -np.inf)
    checks.append({"singular_gram_f32": deg32.tolist(),
                   "singular_gram_f64": deg64, "ok": deg_ok})
    return {"checks": checks, "ok": all(c["ok"] for c in checks)}


def phase_fit(n_obs=500, walkers=100, steps=300, d=D, seed=0):
    import jax
    import jax.numpy as jnp

    from bask_tpu.models.bayesgpr import BayesGPR, _log_post_hessian
    from bask_tpu.utils.diagnostics import split_rhat

    X, y = north_star_xy(n_obs, d)
    times = []
    for _ in range(2):  # cold (compiles), then warm
        gp = BayesGPR(north_star_kernel(d, white=False), random_state=seed)
        t0 = time.perf_counter()
        gp.fit(X, y, n_desired_samples=walkers * steps,
               n_walkers_per_thread=walkers, progress=False)
        jax.block_until_ready(gp._post.L)
        times.append(time.perf_counter() - t0)
    chain = np.asarray(gp.chain_steps_)
    acc = gp.n_accepted_ / max(gp.n_proposals_, 1)
    rhat = (float(np.max(split_rhat(chain))) if chain.shape[0] >= 4
            else None)
    H = np.asarray(_log_post_hessian(
        gp._data, jnp.asarray(gp.theta, gp._dtype()), kernel=gp._spec,
        priors=gp._resolve_priors(None), n_warp=0,
    ))
    finite = bool(np.isfinite(chain).all())
    return {
        "chain_shape": list(chain.shape), "chain_finite": finite,
        "acceptance": acc, "split_rhat": rhat,
        "laplace_hessian_finite": bool(np.isfinite(H).all()),
        "cold_s": times[0], "warm_s": times[1],
        "ok": finite and 0.05 < acc < 0.99,
    }


def _quadratic(x, rng):
    x = np.asarray(x, float)
    return float(np.sum((x - 0.3) ** 2) + 0.01 * rng.randn())


def phase_ask_tell(n_obs=500, rounds=5, batch_n=1000, batch_cands=65536,
                   batch=16, d=D, seed=0, cold_until_rhat="default"):
    """``cold_until_rhat``: the first fit's convergence target; the
    library default unless a test shrinks the run."""
    from bask_tpu.optimizer import ACQUISITION_FUNC, Optimizer

    rng = np.random.RandomState(seed)
    dims = [(0.0, 1.0)] * d
    X0 = rng.uniform(size=(n_obs, d))
    y0 = [_quadratic(x, rng) for x in X0]
    kw = {} if cold_until_rhat == "default" else {
        "gp_sample_kwargs": {"until_rhat": cold_until_rhat}}
    opt = Optimizer(dims, acq_func="pvrs", random_state=seed, **kw)
    t0 = time.perf_counter()
    opt.tell(X0.tolist(), y0)
    cold = time.perf_counter() - t0
    ok, tell_s = True, {}
    for acq in ("pvrs", "ei"):
        opt.acq_func = ACQUISITION_FUNC[acq]
        ts = []
        for _ in range(rounds):
            x = opt.ask()
            ok &= bool(np.all(np.isfinite(x))) and all(0 <= v <= 1 for v in x)
            t0 = time.perf_counter()
            opt.tell(list(x), _quadratic(x, rng))
            ts.append(time.perf_counter() - t0)
        tell_s[acq] = ts

    Xb = rng.uniform(size=(batch_n, d))
    opt_b = Optimizer(
        dims, n_points=batch_cands, acq_func="ei", random_state=seed + 1,
        # the batch step tests the pathwise ask, not refit convergence
        gp_sample_kwargs={"until_rhat": None},
    )
    opt_b.tell(Xb.tolist(), [_quadratic(x, rng) for x in Xb])
    ask_s, pts = [], None
    for _ in range(2):
        t0 = time.perf_counter()
        pts = np.asarray(opt_b.ask(n_points=batch))
        ask_s.append(time.perf_counter() - t0)
    batch_ok = (
        pts.shape == (batch, d) and bool(np.isfinite(pts).all())
        and bool(((pts >= 0) & (pts <= 1)).all())
        and len({tuple(p) for p in pts}) == batch
    )
    return {
        "n_told": len(opt.yi), "cold_tell_s": cold, "tell_s": tell_s,
        "best_y": float(min(opt.yi)),
        "batch_ask": {"n": batch_n, "candidates": batch_cands,
                      "points": batch, "ok": batch_ok,
                      "cold_s": ask_s[0], "warm_s": ask_s[1]},
        "ok": bool(ok and batch_ok),
    }


def phase_acq(draws=100, n_train=512, n_cand=512, n_probe=10, d=D, seed=0):
    import jax
    import jax.numpy as jnp

    from bask_tpu import acquisition as acq
    from bask_tpu.models import gp as gpc

    kernel = north_star_kernel(d)
    Xp, yp, a, m = padded(*north_star_xy(n_train - 12, d, seed), n_train)
    rows = walker_thetas(kernel.n_theta, draws)
    Xc = np.random.RandomState(seed + 3).uniform(size=(n_cand, d))
    white = kernel.n_theta - 1
    ei = acq.ExpectedImprovement()

    def scores(rows, X, y, a, Xc):
        data = gpc.make_data(X, y, a, jnp.asarray(m))
        mu, std, _ = acq._per_draw_predictions(
            rows, data, Xc, jax.random.PRNGKey(0), kernel=kernel, n_warp=0,
            white_idx=white, need_sample=False,
        )
        ei_v = jax.vmap(lambda mu_s, sd_s: ei(mu_s, sd_s))(mu, std)
        pv = jax.vmap(lambda t: acq._variance_explained_body(
            kernel, t, gpc.posterior(kernel, t, data), data, Xc,
            Xc[:n_probe],
        ))(rows)
        return ei_v, pv

    fn = jax.jit(scores)
    args = (rows, Xp, yp, a, Xc)
    (ei32, pv32), cold, warm = _timed(
        fn, *(jnp.asarray(v, jnp.float32) for v in args))
    with jax.enable_x64(True):
        ei64, pv64 = jax.jit(scores)(
            *(jnp.asarray(v, jnp.float64) for v in args))
        ei64, pv64 = np.asarray(ei64), np.asarray(pv64)
    out = {"shape": [draws, n_train, n_cand], "tol": ACQ_TOL,
           "cold_s": cold, "warm_s": warm}
    ok = True
    for name, got, ref in (("ei", ei32, ei64), ("pvrs", pv32, pv64)):
        got = np.asarray(got, np.float64)
        err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        finite = bool(np.isfinite(got).all())
        out[name] = {"max_err_rel_to_max": err, "finite": finite}
        ok &= finite and err <= ACQ_TOL
    out["ok"] = bool(ok)
    return out


def phase_chip_tests():
    import pytest

    # the test configuration keeps an explicitly non-CPU platform
    os.environ["JAX_PLATFORMS"] = "cuda"
    rc = pytest.main([
        "-q", "-p", "no:cacheprovider", "-m", "chip",
        os.path.join(REPO, "tests", "test_chip.py"),
    ])
    return {"pytest_rc": int(rc), "ok": int(rc) == 0}


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------


def _peaks(devices):
    """Each device's peak bytes in use (None where the backend keeps no
    statistics, as the CPU does)."""
    return [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in devices]


def phase_walker_mesh(n_devices=4, n_obs=500, walkers=128, steps=20, d=D,
                      seed=0):
    import jax
    import jax.numpy as jnp

    from bask_tpu.models.bayesgpr import BayesGPR
    from bask_tpu.ops import linalg
    from bask_tpu.parallel.mesh import shard_walkers, walker_mesh

    mesh = walker_mesh(n_devices)
    X, y = north_star_xy(n_obs, d)
    kernel = north_star_kernel(d)
    Xp, yp, a, msk = padded(X, y, 512)
    th = jnp.asarray(walker_thetas(kernel.n_theta, walkers), jnp.float32)
    args = tuple(jnp.asarray(v, jnp.float32) for v in (Xp, yp, a))

    fit_s = {}

    def fit(m):
        gp = BayesGPR(north_star_kernel(d, white=False), random_state=seed)
        t0 = time.perf_counter()
        gp.fit(X, y, n_desired_samples=walkers * steps,
               n_walkers_per_thread=walkers, progress=False, mesh=m)
        chain = np.asarray(gp.chain_steps_)
        fit_s["mesh" if m is not None else "one_card"] = (
            time.perf_counter() - t0)
        return chain

    def lml(m):
        return jax.jit(lambda t, X, y, a, mk: linalg.batched_lml(
            kernel, t, X, y, a, mk, mesh=m))(
                th if m is None else shard_walkers(th, m), *args,
                jnp.asarray(msk))

    # the mesh runs first, so the peaks show what they put on each card
    chain_sh, lml_sh = fit(mesh), lml(mesh)
    peaks = _peaks(mesh.devices.ravel())
    chain_one, lml_one = fit(None), lml(None)
    lml_err = _rel_err(lml_sh, lml_one)
    return {
        "chain_shape": list(chain_sh.shape),
        "chain_max_abs_diff_vs_one_card": float(
            np.max(np.abs(chain_sh - chain_one))),
        "lml_devices": sorted(d.id for d in lml_sh.sharding.device_set),
        "lml_max_rel_err_vs_one_card": lml_err,
        "peak_bytes_in_use_after_mesh_runs": peaks,
        "cold_fit_s": fit_s,
        "ok": bool(np.isfinite(chain_sh).all() and lml_err <= 1e-5),
    }


def phase_row_sharded(n_devices=4, n=16384, n_query=64, d=D, seed=0):
    import jax
    import jax.numpy as jnp

    from bask_tpu.models import gp as gpc
    from bask_tpu.ops import linalg
    from bask_tpu.ops.dist_chol import row_sharded_lml, row_sharded_predict
    from bask_tpu.parallel.mesh import walker_mesh

    mesh = walker_mesh(n_devices, axis="rows")
    kernel = north_star_kernel(d)
    Xp, yp, a, m = padded(*north_star_xy(n - 16, d, seed), n)
    theta = kernel.theta0
    Xq = np.random.RandomState(seed + 5).uniform(size=(n_query, d))

    def sharded(theta, X, y, a, m, Xq):
        lml = row_sharded_lml(kernel, theta, X, y, a, m, mesh=mesh)
        mean, std = row_sharded_predict(kernel, theta, X, y, a, m, Xq,
                                        mesh=mesh)
        return lml, mean, std

    args32 = tuple(jnp.asarray(v, jnp.float32)
                   for v in (theta, Xp, yp, a)) + (jnp.asarray(m),)
    (lml, mean, std), cold, warm = _timed(
        jax.jit(sharded), *args32, jnp.asarray(Xq, jnp.float32))
    peaks = _peaks(mesh.devices.ravel())

    with jax.enable_x64(True):
        t64, X64, y64, a64 = (jnp.asarray(v, jnp.float64)
                              for v in (theta, Xp, yp, a))
        data = gpc.make_data(X64, y64, a64, jnp.asarray(m))

        @jax.jit
        def dense(t, Xq):
            post = gpc.posterior(kernel, t, data)
            mu, sd = gpc.predict(kernel, t, post, data, Xq, return_std=True)
            return linalg.masked_lml(kernel, t, X64, y64, a64, data.mask), mu, sd

        lml64, mu64, sd64 = (np.asarray(v) for v in dense(
            t64, jnp.asarray(Xq, jnp.float64)))
    errs = {
        "lml_rel": _rel_err(lml, lml64),
        "mean_abs": float(np.max(np.abs(np.asarray(mean) - mu64))),
        "std_abs": float(np.max(np.abs(np.asarray(std) - sd64))),
    }
    # y is standardized, so the LML rule doubles as an absolute bound
    # on the predictive mean and std
    tol = dict.fromkeys(errs, lml_tolerance(n))
    return {
        "n": n, "errors": errs, "tol": tol,
        "lml_devices": sorted(dv.id for dv in lml.sharding.device_set),
        "peak_bytes_in_use_after_sharded_run": peaks, "cold_s": cold,
        "warm_s": warm,
        "ok": all(errs[k] <= tol[k] for k in errs),
    }


# ---------------------------------------------------------------------------


def _run(name, fn, label):
    t0 = time.perf_counter()
    try:
        res = fn()
    except Exception:
        traceback.print_exc()
        res = {"ok": False, "error": traceback.format_exc(limit=3)}
    res["phase_s"] = time.perf_counter() - t0
    print(f"[{label}] {name}: {json.dumps(res, default=float)}", flush=True)
    return bool(res.get("ok"))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four-cards" in argv
    try:
        import bask_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke.py must run from the repository: {e}",
              file=sys.stderr)
        return 2
    import jax

    devices = jax.devices()
    dev = devices[0]
    import jaxlib

    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}; "
          f"devices {devices}", flush=True)
    if dev.platform != "gpu":
        print(f"no GPU: JAX platform is {dev.platform!r}", file=sys.stderr)
        return 2
    need = 4 if four else 1
    if len(devices) < need:
        print(f"need {need} GPUs, found {len(devices)}", file=sys.stderr)
        return 2
    label = card_label()
    print(f"card: {label}", flush=True)
    print(f"compile cache: {compile_cache_dir()}", flush=True)

    if four:
        phases = (("walker_mesh", phase_walker_mesh),
                  ("row_sharded", phase_row_sharded))
    else:
        phases = (("lml_parity", phase_lml), ("fit", phase_fit),
                  ("ask_tell", phase_ask_tell), ("acq_parity", phase_acq),
                  ("chip_tests", phase_chip_tests))
    ok = all([_run(name, fn, label) for name, fn in phases])
    if not ok:
        print("chip smoke FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())
