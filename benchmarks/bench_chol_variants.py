"""Factorization variants inside the walker-batched LML and the
north-star chain, on the GPU.

Times, in ONE process and in alternating order, the f32 batched LML
(``linalg.batched_lml``, Const*Matern(2.5)+White, d=15) with

    blocked-xla        the blocked recursion, XLA Cholesky + Newton base
    blocked-triton     the same recursion, base case from the Triton-route
                       Pallas kernel (``ops/triton_chol_base.py``; the
                       GPU default)
    blocked-nb-alt     the Triton-base recursion with the other panel
                       width (256 at n <= 512, 128 above)
    library            ``FAST_CHOLESKY="off"``: jnp.linalg.cholesky +
                       solve_triangular

at (walkers, n) = (100, 512) and (8, 4096), each against a float64
``masked_lml`` reference. A variant that fails to compile is recorded
with its error and skipped. At (100, 512) it also sums the device time
of one profiler trace per call of each blocked LML variant and of the
plain vmapped ``masked_gram`` alone, with the heaviest events by name
(traces kept under ``DIR/trace_*``). Last, the north-star chain (100
walkers x 300 stretch steps, ``bench.build_north_star``) is timed with
each factorization variant.

Run on the card:  python benchmarks/bench_chol_variants.py [--out DIR]
Results go to ``DIR/chol_variants.json`` (default ``bench_results``).
"""

import glob
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REPS = 30
SHAPES = ((100, 512), (8, 4096))
ORDER = ("blocked-xla", "blocked-triton", "blocked-nb-alt", "library")
CHAIN_ORDER = ("blocked-xla", "blocked-triton", "library")
CHAIN_STEPS = 300


def _problem(W, n, d=15, seed=0):
    from bask_tpu.ops import kernels as bk

    rng = np.random.RandomState(seed)
    n_real = n - 12
    X = np.full((n, d), 0.5)
    X[:n_real] = rng.uniform(size=(n_real, d))
    y = np.zeros(n)
    y[:n_real] = rng.randn(n_real)
    kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern(
        (0.3,) * d, (0.05, 2.0), nu=2.5
    ) + bk.WhiteKernel(0.05, (1e-5, 1e5))
    thetas = kernel.theta0[None, :] + 0.05 * rng.randn(W, kernel.n_theta)
    mask = np.arange(n) < n_real
    return kernel, thetas, X, y, np.full(n, 1e-6), mask


class _Variant:
    """Module state of one variant, set while a program is traced (the
    factorization choices are read at trace time)."""

    def __init__(self, name, base_kernel):
        self.name = name
        self.base_kernel = base_kernel

    def __enter__(self):
        from bask_tpu.ops import fast_cholesky as fc, linalg

        self.saved = (fc._base_chol_inv, linalg.FAST_CHOLESKY, fc.pick_nb)
        name = self.name
        if name == "blocked-xla":
            fc._base_chol_inv = fc._xla_base_chol_inv
        elif name.startswith("blocked"):
            fc._base_chol_inv = self.base_kernel
        if name == "blocked-nb-alt":
            fc.pick_nb = lambda n: 128 if n > 512 else 256
        elif name == "library":
            linalg.FAST_CHOLESKY = "off"
        return self

    def __exit__(self, *exc):
        from bask_tpu.ops import fast_cholesky as fc, linalg

        fc._base_chol_inv, linalg.FAST_CHOLESKY, fc.pick_nb = self.saved


def _variant_fn(variant, kernel, args):
    import jax

    from bask_tpu.ops import linalg

    with variant:
        def f(th, X, y, a, m):
            return linalg.batched_lml(kernel, th, X, y, a, m)

        return jax.jit(f).lower(*args).compile()


def _time(fn, args, reps):
    import jax

    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, ts


def _device_ns(fn, args, tdir, calls=5):
    """Summed device-event duration per call of ``fn``, from one trace,
    plus the heaviest events by name."""
    import jax

    jax.block_until_ready(fn(*args))
    with jax.profiler.trace(tdir):
        for _ in range(calls):
            jax.block_until_ready(fn(*args))
    path = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    by_name, total = {}, 0
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                total += ev.duration_ns
                rec = by_name.setdefault(ev.name, [0, 0])
                rec[0] += ev.duration_ns
                rec[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]
    return total / calls, [
        {"name": k, "ns_per_call": v[0] / calls, "count_per_call": v[1] / calls}
        for k, v in top
    ]


def run(shapes, out_dir, reps, base_kernel, label):
    import jax
    import jax.numpy as jnp

    from bask_tpu.ops import linalg

    results = []
    for W, n in shapes:
        kernel, th, X, y, a, m = _problem(W, n)
        args32 = tuple(
            jnp.asarray(v, jnp.float32) for v in (th, X, y, a)
        ) + (jnp.asarray(m),)
        with jax.enable_x64(True):
            ref = np.asarray(jax.jit(jax.vmap(
                lambda t: linalg.masked_lml(
                    kernel, t, jnp.asarray(X), jnp.asarray(y),
                    jnp.asarray(a), jnp.asarray(m))
            ))(jnp.asarray(th, jnp.float64)))
        row = {"walkers": W, "n": n, "variants": {}}
        fns = {}
        for name in ORDER:
            t0 = time.perf_counter()
            try:
                fns[name] = _variant_fn(
                    _Variant(name, base_kernel), kernel, args32)
                row["variants"][name] = {"compile_s": time.perf_counter() - t0}
            except Exception:
                row["variants"][name] = {"error": traceback.format_exc(limit=4)}
                print(f"({W},{n}) {name}: FAILED to compile\n"
                      f"{row['variants'][name]['error']}", flush=True)
        times = {name: [] for name in fns}
        for sweep in (ORDER, ORDER[::-1], ORDER, ORDER[::-1]):
            for name in sweep:
                if name not in fns:
                    continue
                out, ts = _time(fns[name], args32, reps)
                times[name] += ts
                got = np.asarray(out, np.float64)
                row["variants"][name]["max_rel_err_vs_f64"] = float(np.max(
                    np.abs(got - ref) / np.maximum(1.0, np.abs(ref))))
                row["variants"][name]["finite"] = bool(np.isfinite(got).all())
        for name, ts in times.items():
            q = statistics.quantiles(ts, n=4)
            v = row["variants"][name]
            v.update(median_ms=statistics.median(ts) * 1e3,
                     iqr_ms=[q[0] * 1e3, q[2] * 1e3])
            print(f"({W},{n}) {name}: {v['median_ms']:.3f} ms (IQR "
                  f"{q[0]*1e3:.3f}-{q[2]*1e3:.3f}), max rel err "
                  f"{v['max_rel_err_vs_f64']:.2e} [{label}]", flush=True)
        if (W, n) == shapes[0]:
            row["device_us"] = _device_split(kernel, args32, fns, out_dir,
                                             label)
        results.append(row)
    return results


def _device_split(kernel, args32, fns, out_dir, label):
    """Summed device time per call: each traced blocked LML variant, and
    the plain vmapped ``masked_gram`` alone."""
    import jax

    from bask_tpu.ops import linalg

    th, X, _, a, m = args32
    gram = jax.jit(jax.vmap(lambda t: linalg.masked_gram(kernel, t, X, a, m)))
    ns, top = _device_ns(gram, (th,), os.path.join(out_dir, "trace_gram"))
    out = {"gram-plain": {"us": ns / 1e3, "top": top}}
    for name in ("blocked-xla", "blocked-triton"):
        if name in fns:
            ns, top = _device_ns(fns[name], args32,
                                 os.path.join(out_dir, f"trace_lml_{name}"))
            out[name] = {"us": ns / 1e3, "top": top}
    for name in ("blocked-xla", "blocked-triton"):
        if out.get(name, {}).get("us"):
            out[name]["gram_plain_share"] = out["gram-plain"]["us"] / out[name]["us"]
    print("device us per call: " + ", ".join(
        f"{k} {v['us']:.1f}" for k, v in out.items() if "us" in v)
        + f" [{label}]", flush=True)
    return out


def run_chain(base_kernel, label, steps=CHAIN_STEPS, reps=3):
    """The north-star chain (100 walkers x ``steps`` stretch steps) under
    each variant: compile, then ``reps`` warm runs per variant in
    alternating order."""
    import jax
    import jax.numpy as jnp

    import bench
    from bask_tpu.parallel.mcmc import run_ensemble

    out = {}
    progs = {}
    for name in CHAIN_ORDER:
        with _Variant(name, base_kernel):
            _, _, log_prob, pos0 = bench.build_north_star(jnp.float32)
            fn = jax.jit(lambda p, k, lp=log_prob: run_ensemble(lp, p, k, steps))
            t0 = time.perf_counter()
            try:
                progs[name] = fn.lower(pos0, jax.random.PRNGKey(1)).compile()
                out[name] = {"compile_s": time.perf_counter() - t0, "warm_s": []}
            except Exception:
                out[name] = {"error": traceback.format_exc(limit=4)}
    for sweep in (CHAIN_ORDER, CHAIN_ORDER[::-1], CHAIN_ORDER)[:reps]:
        for name in sweep:
            if name not in progs:
                continue
            jax.block_until_ready(progs[name](pos0, jax.random.PRNGKey(0)))
            t0 = time.perf_counter()
            _, final = jax.block_until_ready(
                progs[name](pos0, jax.random.PRNGKey(1)))
            out[name]["warm_s"].append(time.perf_counter() - t0)
            out[name]["acceptance"] = float(final.accepted) / (
                steps * pos0.shape[0])
            out[name]["finite"] = bool(np.isfinite(np.asarray(final.log_prob)).all())
    for name, v in out.items():
        if "warm_s" in v:
            v["median_s"] = statistics.median(v["warm_s"])
            print(f"chain {pos0.shape[0]}x{steps} {name}: {v['median_s']:.4f} s "
                  f"warm (runs {v['warm_s']}), acc {v['acceptance']:.3f} "
                  f"[{label}]", flush=True)
    return out


def main():
    out_dir = "bench_results"
    if "--out" in sys.argv:
        out_dir = sys.argv[sys.argv.index("--out") + 1]
    os.makedirs(out_dir, exist_ok=True)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_chol_variants needs a GPU; found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {card}; device_kind {dev.device_kind}", flush=True)

    from bask_tpu.ops.triton_chol_base import chol_inv_base

    results = {"card": card, "device_kind": dev.device_kind,
               "shapes": run(SHAPES, out_dir, REPS, chol_inv_base, card)}
    results["chain"] = run_chain(chol_inv_base, card)
    with open(os.path.join(out_dir, "chol_variants.json"), "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
