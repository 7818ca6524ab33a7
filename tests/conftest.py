"""Test configuration.

Tests run on a virtual 8-device CPU mesh (multi-device sharding is
validated without accelerators) with float64 enabled for numerical
parity against the NumPy/SciPy/sklearn oracles.

An explicitly set non-CPU ``JAX_PLATFORMS`` (e.g. ``cuda``) is honoured
instead, so the ``chip``-marked tests can reach a GPU; ``chip_smoke.py``
runs them that way. Every other test expects the CPU configuration.
"""

import os

_ON_ACCELERATOR = os.environ.get("JAX_PLATFORMS", "cpu") not in ("", "cpu")
if not _ON_ACCELERATOR:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _ON_ACCELERATOR:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


# XLA:CPU segfaults inside backend_compile_and_load after a few hundred
# live compiled executables accumulate in one process (reproduced
# deterministically at the ~276th test of a full run, on a clean tree,
# with the crashing test passing in ANY smaller subset — an upstream
# LLVM-JIT code-memory issue, not a test bug). Dropping jax's
# executable caches every ~100 tests keeps the live-code footprint
# bounded; the handful of session-cached programs recompile on next
# use (costs ~1 min over the full suite).
_N_TESTS_BETWEEN_CACHE_CLEARS = 100
_test_count = {"n": 0}


def pytest_runtest_setup(item):
    _test_count["n"] += 1
    if _test_count["n"] % _N_TESTS_BETWEEN_CACHE_CLEARS == 0:
        import gc

        jax.clear_caches()
        gc.collect()


# ---------------------------------------------------------------------------
# Fast/slow split: the full suite is ~51 min on this 8-virtual-device
# CPU setup (round-5 measurement); the default per-commit target is the
# fast tier (`pytest -m 'not slow'`, ~9 min — nox session `tests`),
# with the full suite in nox `tests_all` / the CI slow job. Heavy tests
# are listed by base nodeid in tests/slow_manifest.txt (parametrized
# variants inherit) so test files stay unmarked and every file keeps
# its sub-9s smoke coverage in the fast tier. Regenerate the manifest
# per its header after big suite changes.
# ---------------------------------------------------------------------------
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _chip_only(request):
    """Tests marked ``chip`` need a GPU: decided here, per test, never at
    import (every xdist worker must collect the same tests)."""
    if request.node.get_closest_marker("chip") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; run on the card via `python chip_smoke.py`")


_MANIFEST = os.path.join(os.path.dirname(__file__), "slow_manifest.txt")


def _slow_bases():
    bases = set()
    try:
        with open(_MANIFEST) as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith("#"):
                    bases.add(line)
    except OSError:
        pass
    return bases


def pytest_collection_modifyitems(config, items):
    bases = _slow_bases()
    if not bases:
        return
    rootdir = str(config.rootdir)
    for item in items:
        nodeid = item.nodeid.split("[")[0]
        if not nodeid.startswith("tests/"):
            # invoked from a subdirectory: normalize to repo-relative
            path = str(item.path)
            if path.startswith(rootdir):
                nodeid = (
                    path[len(rootdir):].lstrip("/")
                    + "::"
                    + item.nodeid.split("::", 1)[-1].split("[")[0]
                )
        if nodeid in bases:
            item.add_marker(pytest.mark.slow)
