"""Test configuration: run JAX on 8 virtual CPU devices.

Sharded code paths are exercised without a multi-device machine via
``xla_force_host_platform_device_count`` (SURVEY.md §4). Must run before jax
import anywhere in the test session.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platform_name", "cpu")

assert jax.default_backend() == "cpu", (
    f"tests must run on CPU, got {jax.default_backend()}")
assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"

# Persistent compilation cache for the suite (compile-bound on CPU).
# Key the dir by the host's CPU feature flags: XLA:CPU AOT executables
# from a DIFFERENT microarchitecture load with a feature-mismatch
# warning and then SEGFAULT mid-suite (observed 2026-08-19 after a host
# swap: crash in compilation_cache.get_executable_and_time), so a host
# change must start a fresh cache rather than reuse a stale one.
import hashlib

try:
    with open("/proc/cpuinfo") as _f:
        _flags = next((ln for ln in _f if ln.startswith("flags")), "")
except OSError:  # non-Linux fallback: per-platform cache
    import platform

    _flags = platform.processor()
_tag = hashlib.sha1(_flags.encode()).hexdigest()[:10]
jax.config.update("jax_compilation_cache_dir", f"/tmp/jax_cache_{_tag}")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def make_adata(n_obs=200, n_vars=30, sparse=False, seed=0, with_spatial=True):
    from spatialcore_tpu import SpatialData

    rng = np.random.default_rng(seed)
    counts = rng.poisson(2.0, size=(n_obs, n_vars)).astype(np.float32)
    X = sp.csr_matrix(counts) if sparse else counts
    obs = pd.DataFrame({
        "cell_type": pd.Categorical(rng.choice(["T cell", "B cell", "Macrophage"], n_obs)),
        "total_counts": counts.sum(axis=1),
    }, index=[f"cell_{i}" for i in range(n_obs)])
    var = pd.DataFrame(index=[f"GENE{j}" for j in range(n_vars)])
    adata = SpatialData(X=X, obs=obs, var=var)
    if with_spatial:
        adata.obsm["spatial"] = rng.uniform(0, 1000, size=(n_obs, 2)).astype(np.float32)
    return adata


@pytest.fixture
def adata():
    return make_adata()


@pytest.fixture
def adata_sparse():
    return make_adata(sparse=True)
