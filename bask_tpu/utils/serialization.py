"""Checkpoint / resume for BayesGPR and Optimizer state.

The reference has no on-disk checkpointing (a ``backup_file`` stub is
commented out at ``bask/bayesgpr.py:525-527``); its only resume mechanism
is the in-memory ``pos_`` warm start. bask-tpu keeps that warm-start
semantics AND adds explicit serialization: kernel specs, chain/walker
state, observations, and RNG state round-trip through a single ``.npz``
file, so a long BO run survives preemption — table stakes for
production accelerator jobs.
"""

from __future__ import annotations

import json

import numpy as np

from ..ops import kernels as bk
from .. import space as sp

__all__ = [
    "kernel_to_dict",
    "kernel_from_dict",
    "save_optimizer",
    "load_optimizer",
    "save_gpr",
    "load_gpr",
]


def _json_default(obj):
    """json.dumps fallback: NumPy scalars/arrays show up in Xi /
    acq_func_kwargs whenever users tell() numpy values."""
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(
        f"Object of type {type(obj).__name__} is not JSON serializable"
    )


def _jsonable_or_warn(d: dict, name: str) -> dict:
    """Return ``d`` if it JSON-serializes, else warn and drop it —
    checkpoint writing must degrade, not crash, on exotic values (same
    contract custom acq_func / gp_priors get)."""
    import json as _json
    import warnings as _warnings

    try:
        _json.dumps(d, default=_json_default)
        return d
    except TypeError:
        _warnings.warn(
            f"save_optimizer: {name} contains values that cannot be "
            "serialized and was dropped from the checkpoint — re-assign "
            f"opt.{name} after load_optimizer.",
            UserWarning,
            stacklevel=3,
        )
        return {}


# -- kernel spec <-> dict ----------------------------------------------------


def kernel_to_dict(k: bk.Kernel) -> dict:
    if isinstance(k, bk.CompoundKernel):
        return {
            "type": "CompoundKernel",
            "kernels": [kernel_to_dict(kk) for kk in k.kernels],
        }
    if isinstance(k, bk.Sum) or isinstance(k, bk.Product):
        return {
            "type": type(k).__name__,
            "k1": kernel_to_dict(k.k1),
            "k2": kernel_to_dict(k.k2),
        }
    if isinstance(k, bk.Exponentiation):
        return {
            "type": "Exponentiation",
            "kernel": kernel_to_dict(k.kernel),
            "exponent": k.exponent,
        }
    if isinstance(k, bk.ConstantKernel):
        return {
            "type": "ConstantKernel",
            "value": k.constant_value,
            "bounds": k.constant_value_bounds,
        }
    if isinstance(k, bk.WhiteKernel):
        return {
            "type": "WhiteKernel",
            "value": k.noise_level,
            "bounds": k.noise_level_bounds,
        }
    if isinstance(k, bk.Matern):
        ls = k.length_scale
        return {
            "type": "Matern",
            "value": list(ls) if np.iterable(ls) else ls,
            "bounds": k.length_scale_bounds,
            "nu": k.nu,
        }
    if isinstance(k, bk.RBF):
        ls = k.length_scale
        return {
            "type": "RBF",
            "value": list(ls) if np.iterable(ls) else ls,
            "bounds": k.length_scale_bounds,
        }
    raise TypeError(f"Cannot serialize kernel {type(k).__name__}")


def _bounds(b):
    return tuple(b) if isinstance(b, list) else b


def kernel_from_dict(d: dict) -> bk.Kernel:
    t = d["type"]
    if t == "CompoundKernel":
        return bk.CompoundKernel(
            tuple(kernel_from_dict(kk) for kk in d["kernels"])
        )
    if t in ("Sum", "Product"):
        cls = bk.Sum if t == "Sum" else bk.Product
        return cls(kernel_from_dict(d["k1"]), kernel_from_dict(d["k2"]))
    if t == "Exponentiation":
        return bk.Exponentiation(kernel_from_dict(d["kernel"]), d["exponent"])
    if t == "ConstantKernel":
        return bk.ConstantKernel(d["value"], _bounds(d["bounds"]))
    if t == "WhiteKernel":
        return bk.WhiteKernel(d["value"], _bounds(d["bounds"]))
    if t == "Matern":
        v = d["value"]
        return bk.Matern(
            tuple(v) if isinstance(v, list) else v,
            _bounds(d["bounds"]),
            nu=d["nu"],
        )
    if t == "RBF":
        v = d["value"]
        return bk.RBF(
            tuple(v) if isinstance(v, list) else v, _bounds(d["bounds"])
        )
    raise TypeError(f"Unknown kernel type {t}")


# -- dimension <-> dict ------------------------------------------------------


def _dim_to_dict(d) -> dict:
    if isinstance(d, sp.Real):
        return {
            "type": "Real",
            "low": d.low,
            "high": d.high,
            "prior": d.prior,
            "name": d.name,
        }
    if isinstance(d, sp.Integer):
        return {
            "type": "Integer",
            "low": d.low,
            "high": d.high,
            "prior": d.prior,
            "name": d.name,
        }
    if isinstance(d, sp.Categorical):
        return {
            "type": "Categorical",
            "categories": d.categories,
            "name": d.name,
        }
    raise TypeError(f"Cannot serialize dimension {d!r}")


def _dim_from_dict(d: dict):
    t = d["type"]
    if t == "Real":
        return sp.Real(d["low"], d["high"], prior=d["prior"], name=d["name"])
    if t == "Integer":
        return sp.Integer(
            d["low"], d["high"], prior=d.get("prior", "uniform"), name=d["name"]
        )
    if t == "Categorical":
        return sp.Categorical(d["categories"], name=d["name"])
    raise TypeError(f"Unknown dimension type {t}")


# -- GPR state ---------------------------------------------------------------


def _gpr_state(gp) -> dict:
    arrays = {}
    meta = {
        "alpha": gp.alpha,
        "normalize_y": gp.normalize_y,
        "warp_inputs": gp.warp_inputs,
        "noise": gp.noise,
        "noise_": gp.noise_,
        "lml_value": gp.log_marginal_likelihood_value_,
        "kernel_user": kernel_to_dict(gp._user_kernel),
        # the pristine post-fit spec (incl. White); the fitted theta is
        # persisted separately as gpr_theta and rebaked on restore
        "kernel_fitted": (
            kernel_to_dict(gp._spec) if gp._spec is not None else None
        ),
        "y_mean": getattr(gp, "y_train_mean_", 0.0),
        "y_std": getattr(gp, "y_train_std_", 1.0),
        "n_accepted": getattr(gp, "n_accepted_", None),
        "n_proposals": getattr(gp, "n_proposals_", None),
        # constructor-default move mixture (jit static; a resumed
        # optimizer must keep sampling with the same moves)
        "moves": getattr(gp, "moves", None),
        # cold-chain init policy (round 5: "ball" | "laplace")
        "chain_init": getattr(gp, "chain_init", "ball"),
        # huge-n ML-II warm-start subsample size (round 5)
        "ml2_subsample": getattr(gp, "ml2_subsample", None),
        # warm-start objective: "lml" (reference parity) | "map"
        "ml2_objective": getattr(gp, "ml2_objective", "lml"),
    }
    for name in ("chain_", "chain_steps_", "pos_", "warp_alphas_", "warp_betas_", "_theta"):
        v = getattr(gp, name)
        if v is not None:
            arrays[f"gpr{name}"] = np.asarray(v)
    # chain_ is normally a reshaped view of chain_steps_ — don't store
    # the same samples twice in the checkpoint
    if (
        "gprchain_" in arrays
        and "gprchain_steps_" in arrays
        and arrays["gprchain_"].size == arrays["gprchain_steps_"].size
    ):
        del arrays["gprchain_"]
    if gp._X_orig is not None:
        arrays["gpr_X"] = gp._X_orig
        arrays["gpr_y"] = gp._y_orig
    if gp._noise_vector is not None:
        arrays["gpr_noise_vector"] = gp._noise_vector
    return {"meta": meta, "arrays": arrays}


def _restore_gpr(gp, meta, arrays):
    from ..models.bayesgpr import _canonical_moves

    if "moves" in meta:
        # json round-trips the tuples as lists; re-canonicalize so the
        # restored value stays a hashable jit static. Assign even when
        # the stored value is None: moves=None is the EXPLICIT
        # pure-stretch sampler, and leaving the constructor's "auto"
        # default in place would silently switch a resumed optimizer
        # to the demix mixture (non-reproducible chains).
        gp.moves = _canonical_moves(meta["moves"])
    else:
        # pre-moves checkpoint (0.4-era): those chains sampled pure
        # stretch — preserve that on resume rather than "auto"
        gp.moves = None
    gp.chain_init = meta.get("chain_init", "ball")
    gp.ml2_subsample = meta.get("ml2_subsample", None)
    gp.ml2_objective = meta.get("ml2_objective", "lml")
    gp.noise_ = meta["noise_"]
    gp.log_marginal_likelihood_value_ = meta["lml_value"]
    if meta["kernel_fitted"] is not None:
        gp.kernel_ = kernel_from_dict(meta["kernel_fitted"])
    gp.y_train_mean_ = meta["y_mean"]
    gp.y_train_std_ = meta["y_std"]
    if meta.get("n_proposals") is not None:
        gp.n_accepted_ = meta["n_accepted"]
        gp.n_proposals_ = meta["n_proposals"]
    for name in ("chain_", "chain_steps_", "pos_", "warp_alphas_", "warp_betas_"):
        key = f"gpr{name}"
        if key in arrays:
            setattr(gp, name, arrays[key])
    if gp.chain_ is None and gp.chain_steps_ is not None:
        # deduplicated checkpoint: rebuild the flat view
        gp.chain_ = gp.chain_steps_.reshape(
            -1, gp.chain_steps_.shape[-1]
        )
    if "gpr_X" in arrays:
        gp._X_orig = arrays["gpr_X"]
        gp._y_orig = arrays["gpr_y"]
        gp._noise_vector = arrays.get("gpr_noise_vector")
        gp._upload()
    if "gpr_theta" in arrays or "gpr__theta" in arrays:
        theta = arrays.get("gpr__theta", arrays.get("gpr_theta"))
        if gp._X_orig is not None:
            gp.theta = theta  # triggers posterior refresh
        else:
            gp._theta = theta
    return gp


def save_gpr(gp, path: str) -> None:
    state = _gpr_state(gp)
    np.savez_compressed(
        path, __meta__=json.dumps(state["meta"]), **state["arrays"]
    )


def load_gpr(path: str):
    from ..models.bayesgpr import BayesGPR

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    gp = BayesGPR(
        kernel=kernel_from_dict(meta["kernel_user"]),
        alpha=meta["alpha"],
        normalize_y=meta["normalize_y"],
        warp_inputs=meta["warp_inputs"],
        noise=meta["noise"],
    )
    return _restore_gpr(gp, meta, arrays)


# -- Optimizer state ---------------------------------------------------------


def save_optimizer(opt, path: str, pickle_unsupported: bool = False) -> None:
    """Serialize an Optimizer (observations + GP + RNG) to ``path``.

    Built-in acquisitions round-trip by registry name. Custom acquisition
    instances and callable ``gp_priors`` have no npz representation; with
    ``pickle_unsupported=True`` they are embedded as pickle blobs
    (restored only by ``load_optimizer(path, allow_pickle=True)`` — an
    explicit opt-in on BOTH ends, because unpickling executes code).
    Without the opt-in the save warns and the restored optimizer falls
    back to "pvrs" / guessed priors, as before.
    """
    import pickle
    import warnings

    from ..optimizer import ACQUISITION_FUNC

    gstate = _gpr_state(opt.gp)
    pickle_arrays = {}
    acq_name = None
    for name, fn in ACQUISITION_FUNC.items():
        # match by type: the registry holds instances, users may pass
        # their own fresh instance of the same builtin class
        if fn is opt.acq_func or type(fn) is type(opt.acq_func):
            acq_name = name
            break
    def _try_pickle(obj, key, what):
        """Embed ``obj`` as a pickle blob; on failure warn and degrade
        (the checkpoint must never be lost to an unpicklable object)."""
        try:
            pickle_arrays[key] = np.frombuffer(
                pickle.dumps(obj), dtype=np.uint8
            )
            return True
        except Exception as exc:
            warnings.warn(
                f"save_optimizer: {what} could not be pickled ({exc!r}); "
                "saving the checkpoint without it — re-assign it after "
                "load_optimizer.",
                stacklevel=3,
            )
            return False

    if acq_name is None:
        if pickle_unsupported and _try_pickle(
            opt.acq_func, "pickle_acq", "the custom acquisition function"
        ):
            acq_name = "__pickled__"
        elif not pickle_unsupported:
            warnings.warn(
                "save_optimizer: acquisition function "
                f"{type(opt.acq_func).__name__!r} is not in ACQUISITION_FUNC "
                "and cannot be serialized; the restored optimizer will use "
                "'pvrs'. Pass pickle_unsupported=True to embed it as a "
                "pickle blob, or re-assign opt.acq_func after "
                "load_optimizer.",
                stacklevel=2,
            )
    if opt.gp_priors is not None:
        if pickle_unsupported:
            _try_pickle(opt.gp_priors, "pickle_priors", "gp_priors")
        else:
            warnings.warn(
                "save_optimizer: gp_priors are callables and are not "
                "serialized; the restored optimizer will guess priors from "
                "the kernel. Pass pickle_unsupported=True to embed them as "
                "a pickle blob, or re-assign opt.gp_priors after "
                "load_optimizer.",
                stacklevel=2,
            )
    meta = {
        "dimensions": [_dim_to_dict(d) for d in opt.space.dimensions],
        "n_points": opt.n_points,
        "n_initial_points": opt.n_initial_points_,
        "n_initial_remaining": opt._n_initial_points,
        "init_strategy": opt.init_strategy,
        "acq_func": acq_name or "pvrs",
        "acq_func_kwargs": opt.acq_func_kwargs,
        "gp_sample_kwargs": _jsonable_or_warn(
            getattr(opt, "gp_sample_kwargs", {}), "gp_sample_kwargs"
        ),
        "acq_polish": getattr(opt, "acq_polish", 0),
        "acq_polish_starts": getattr(opt, "acq_polish_starts", 4),
        "acq_polish_lr": getattr(opt, "acq_polish_lr", 0.05),
        "Xi": opt.Xi,
        "yi": opt.yi,
        "noisei": opt.noisei,
        "next_x": opt._next_x,
        "gpr": gstate["meta"],
    }
    rng_state = opt.rng.get_state()
    arrays = dict(gstate["arrays"])
    arrays.update(pickle_arrays)
    arrays["rng_keys"] = rng_state[1]
    meta["rng"] = [rng_state[0], int(rng_state[2]), int(rng_state[3]), float(rng_state[4])]
    # the GP's own RNG stream (MCMC keys, sample_y seeds) must also
    # round-trip for deterministic resume
    gp_state = opt.gp.random_state.get_state()
    arrays["gp_rng_keys"] = gp_state[1]
    meta["gp_rng"] = [
        gp_state[0], int(gp_state[2]), int(gp_state[3]), float(gp_state[4])
    ]
    if getattr(opt, "_init_rng", None) is not None:
        init_state = opt._init_rng.get_state()
        arrays["init_rng_keys"] = init_state[1]
        meta["init_rng"] = [
            init_state[0],
            int(init_state[2]),
            int(init_state[3]),
            float(init_state[4]),
        ]
    np.savez_compressed(
        path, __meta__=json.dumps(meta, default=_json_default), **arrays
    )


def load_optimizer(path: str, allow_pickle: bool = False):
    """Restore an Optimizer saved by :func:`save_optimizer`.

    ``allow_pickle=True`` additionally restores custom acquisition
    instances / callable gp_priors embedded by
    ``save_optimizer(..., pickle_unsupported=True)``. SECURITY: the
    blobs execute arbitrary code on load — only enable this for
    checkpoints you wrote yourself.
    """
    import pickle
    import warnings

    from ..optimizer import Optimizer

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        arrays = {k: z[k] for k in z.files if k != "__meta__"}

    acq_func = meta["acq_func"]
    if acq_func == "__pickled__":
        if allow_pickle and "pickle_acq" in arrays:
            warnings.warn(
                "load_optimizer: restoring a pickled custom acquisition "
                "function — unpickling executes code; only load "
                "checkpoints you trust.",
                stacklevel=2,
            )
            acq_func = pickle.loads(arrays["pickle_acq"].tobytes())
        else:
            warnings.warn(
                "load_optimizer: checkpoint contains a pickled custom "
                "acquisition function; pass allow_pickle=True to restore "
                "it. Falling back to 'pvrs'.",
                stacklevel=2,
            )
            acq_func = "pvrs"

    opt = Optimizer(
        dimensions=[_dim_from_dict(d) for d in meta["dimensions"]],
        n_points=meta["n_points"],
        n_initial_points=meta["n_initial_points"],
        init_strategy=meta["init_strategy"],
        gp_kernel=kernel_from_dict(meta["gpr"]["kernel_user"]),
        acq_func=acq_func,
        acq_func_kwargs=meta["acq_func_kwargs"],
        gp_sample_kwargs=meta.get("gp_sample_kwargs") or {},
        acq_polish=meta.get("acq_polish", 0),
        acq_polish_starts=meta.get("acq_polish_starts", 4),
        acq_polish_lr=meta.get("acq_polish_lr", 0.05),
        gp_kwargs=dict(
            alpha=meta["gpr"]["alpha"],
            normalize_y=meta["gpr"]["normalize_y"],
            warp_inputs=meta["gpr"]["warp_inputs"],
            noise=meta["gpr"]["noise"],
        ),
    )
    opt.Xi = [list(x) for x in meta["Xi"]]
    opt.yi = list(meta["yi"])
    opt.noisei = list(meta["noisei"])
    opt._n_initial_points = meta["n_initial_remaining"]
    opt._next_x = meta["next_x"]
    rng_meta = meta["rng"]
    opt.rng.set_state(
        (rng_meta[0], arrays["rng_keys"], rng_meta[1], rng_meta[2], rng_meta[3])
    )
    if "init_rng_keys" in arrays and getattr(opt, "_init_rng", None) is not None:
        ir = meta["init_rng"]
        opt._init_rng.set_state(
            (ir[0], arrays["init_rng_keys"], ir[1], ir[2], ir[3])
        )
    if "gp_rng_keys" in arrays:
        gr = meta["gp_rng"]
        opt.gp.random_state.set_state(
            (gr[0], arrays["gp_rng_keys"], gr[1], gr[2], gr[3])
        )
    if "pickle_priors" in arrays:
        if allow_pickle:
            warnings.warn(
                "load_optimizer: restoring pickled gp_priors — "
                "unpickling executes code; only load checkpoints you "
                "trust.",
                stacklevel=2,
            )
            opt.gp_priors = pickle.loads(arrays["pickle_priors"].tobytes())
        else:
            warnings.warn(
                "load_optimizer: checkpoint contains pickled gp_priors; "
                "pass allow_pickle=True to restore them. Falling back to "
                "kernel-guessed priors.",
                stacklevel=2,
            )
    _restore_gpr(opt.gp, meta["gpr"], arrays)
    return opt
