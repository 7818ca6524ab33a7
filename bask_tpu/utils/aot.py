"""Cross-process AOT executable cache for the jitted hot paths.

Compiling the scan-heavy MCMC chain is the largest cold-start cost of a
new process. This module caches the *compiled executable* itself on
disk via ``jax.experimental.serialize_executable``: a fresh process
re-traces the program (seconds), hashes the lowered StableHLO, and
loads the serialized executable instead of compiling. (XLA's own
persistent compile cache, ``JAX_COMPILATION_CACHE_DIR``, is the
alternative at the level of single compilations.)

Opt-in:

    from bask_tpu import enable_aot_cache
    enable_aot_cache("~/.cache/bask_tpu_aot")   # or set BASK_TPU_AOT_CACHE

Every call the facades route through :func:`aot_call` (the MCMC chain,
the chunked progress chain, the chain-state init) then consults the
cache. Keys include the jax/jaxlib versions and the device fingerprint,
so stale executables from a different toolchain or chip are never
loaded; any load/serialize failure falls back to a normal compile.

The reference has no equivalent (it has no compile step).
"""

from __future__ import annotations

import hashlib
import os
import pickle
import threading

import jax

__all__ = ["enable_aot_cache", "disable_aot_cache", "aot_call"]

def _normalize_dir(path):
    if not path:
        return None
    path = os.path.abspath(os.path.expanduser(path))
    os.makedirs(path, exist_ok=True)
    return path


_LOCK = threading.Lock()
_DIR: str | None = _normalize_dir(os.environ.get("BASK_TPU_AOT_CACHE"))
_MEMO: dict = {}


def enable_aot_cache(path: str) -> str:
    """Enable the persistent executable cache rooted at ``path``."""
    global _DIR
    path = _normalize_dir(path)
    with _LOCK:
        _DIR = path
        _MEMO.clear()
    return path


def disable_aot_cache() -> None:
    global _DIR
    with _LOCK:
        _DIR = None
        _MEMO.clear()


def _fingerprint() -> str:
    import platform as _platform

    dev = jax.devices()[0]
    parts = [
        jax.__version__,
        dev.platform,
        getattr(dev, "device_kind", ""),
        str(jax.device_count()),
    ]
    if dev.platform == "cpu":
        # XLA:CPU AOT executables embed host ISA features; never reuse
        # an executable from a different machine (SIGILL risk)
        parts += [_platform.node(), _platform.machine()]
    return "|".join(parts)


def _sig_key(jitted, args, kwargs):
    """In-process memo key: function identity + static leaves + avals
    (incl. shardings) of the array leaves. No tracing needed."""
    leaves, treedef = jax.tree_util.tree_flatten(
        (args, tuple(sorted(kwargs.items())))
    )
    parts = []
    for leaf in leaves:
        if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            parts.append(
                (
                    "arr",
                    tuple(leaf.shape),
                    str(leaf.dtype),
                    str(getattr(leaf, "sharding", "")),
                )
            )
        else:
            parts.append(("obj", leaf))
    return (id(jitted), treedef, tuple(parts))


def aot_call(jitted, *args, **kwargs):
    """Call ``jitted(*args, **kwargs)``; when the cache is enabled,
    route through a disk-persistent compiled executable.

    Calling contract: every DYNAMIC argument is positional, every
    STATIC argument is a keyword (compiled executables accept only the
    dynamic arguments — statics are burned in at lowering time).
    """
    if _DIR is None:
        return jitted(*args, **kwargs)
    try:
        key = _sig_key(jitted, args, kwargs)
    except TypeError:  # unhashable leaf — stay on the normal jit path
        return jitted(*args, **kwargs)
    fn = _MEMO.get(key)
    if fn is None:
        fn = _load_or_compile(jitted, args, kwargs)
        with _LOCK:
            _MEMO[key] = fn
    return fn(*args)


def _load_or_compile(jitted, args, kwargs):
    from jax.experimental import serialize_executable as se

    lowered = jitted.lower(*args, **kwargs)
    digest = hashlib.sha256(
        (_fingerprint() + "\0").encode() + lowered.as_text().encode()
    ).hexdigest()[:32]
    payload_path = os.path.join(_DIR, digest + ".jaxexec")
    trees_path = os.path.join(_DIR, digest + ".trees")

    if os.path.exists(payload_path) and os.path.exists(trees_path):
        try:
            with open(payload_path, "rb") as fh:
                payload = fh.read()
            with open(trees_path, "rb") as fh:
                in_tree, out_tree, device_ids = pickle.load(fh)
            # restore the exact device assignment the executable was
            # compiled for (deserialize_and_load defaults to ALL local
            # devices, which breaks single-device programs on a
            # multi-device host)
            execution_devices = None
            if device_ids is not None:
                by_id = {d.id: d for d in jax.devices()}
                execution_devices = [by_id[i] for i in device_ids]
            return se.deserialize_and_load(
                payload, in_tree, out_tree,
                execution_devices=execution_devices,
            )
        except Exception:
            pass  # corrupt/incompatible entry — recompile below

    compiled = lowered.compile()
    try:
        payload, in_tree, out_tree = se.serialize(compiled)
        try:
            device_ids = [
                d.id
                for d in compiled._executable.xla_executable.local_devices()
            ]
        except Exception:
            device_ids = None
        tmp = payload_path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(payload)
        os.replace(tmp, payload_path)
        tmp = trees_path + ".tmp"
        with open(tmp, "wb") as fh:
            pickle.dump((in_tree, out_tree, device_ids), fh)
        os.replace(tmp, trees_path)
    except Exception:
        pass  # backend without serialization support — in-process only
    return compiled
