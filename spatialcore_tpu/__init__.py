"""spatialcore_tpu — accelerator-native spatial statistics for spatial transcriptomics.

A from-scratch JAX/XLA framework with the capabilities of the
SpatialCore reference library (see SURVEY.md): spatial autocorrelation
(Moran's I, Geary's C, Lee's L, local variants with permutation nulls),
neighborhood/niche analysis, spatial domain extraction without an R bridge,
threshold-based classification, and a full cell-type annotation pipeline —
all built on fixed-degree sparse neighbor graphs and counter-based PRNG
permutations that shard across device meshes.

Module availability follows the reference façade
(/root/reference/src/spatialcore/__init__.py:14-99): ``core`` is mandatory;
heavier modules import lazily and degrade to helpful errors when optional
dependencies are missing.
"""

from __future__ import annotations

import importlib
import os as _os
from types import ModuleType
from typing import Dict, List, Mapping, Optional

__version__ = "0.1.0"


def _compile_cache_dir(env: Mapping[str, str], configured: Optional[str],
                       package_file: str) -> Optional[str]:
    """Where the package should put JAX's persistent compilation cache.

    ``None`` when the user already chose: ``JAX_COMPILATION_CACHE_DIR``
    (JAX reads it itself) or an explicit ``jax.config`` setting. Otherwise
    a fixed ``<checkout>/.cache/jax`` beside the package, so repeated runs
    from one checkout find their compiled programs again.
    """
    if env.get("JAX_COMPILATION_CACHE_DIR") or configured:
        return None
    checkout = _os.path.dirname(_os.path.dirname(
        _os.path.abspath(package_file)))
    return _os.path.join(checkout, ".cache", "jax")


def _enable_persistent_compile_cache() -> None:
    """Opt into JAX's persistent compilation cache (the 1M-cell graph and
    permutation programs take seconds to minutes to compile)."""
    import jax

    cache_dir = _compile_cache_dir(_os.environ,
                                   jax.config.jax_compilation_cache_dir,
                                   __file__)
    if cache_dir is not None:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_persistent_compile_cache()

from . import core  # mandatory
from .core import get_logger, update_metadata


def __getattr__(name):
    # container and h5ad IO need pandas/h5py: resolve them on first use
    if name in ("SpatialData", "read_h5ad", "write_h5ad"):
        return getattr(core, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


_OPTIONAL_MODULES = ["ops", "spatial", "stats", "annotation", "plotting",
                     "parallel", "utils", "nmf", "diffusion", "r_bridge"]
_module_errors: Dict[str, str] = {}


class _UnavailableModule(ModuleType):
    """Placeholder raising a helpful ImportError on any attribute access."""

    def __init__(self, name: str, error: str):
        super().__init__(name)
        self._name = name
        self._error = error

    def __getattr__(self, item):
        raise ImportError(
            f"spatialcore_tpu.{self._name} is unavailable: {self._error}")


def _try_import(name: str):
    try:
        mod = importlib.import_module(f".{name}", __name__)
        if getattr(mod, "__file__", None) is None:  # bare namespace dir
            raise ImportError(f"module '{name}' has no __init__.py")
        return mod
    except ImportError as e:  # missing optional dependency
        _module_errors[name] = str(e)
        return _UnavailableModule(name, str(e))


ops = _try_import("ops")
spatial = _try_import("spatial")
stats = _try_import("stats")
annotation = _try_import("annotation")
plotting = _try_import("plotting")
parallel = _try_import("parallel")
utils = _try_import("utils")
nmf = _try_import("nmf")
diffusion = _try_import("diffusion")
r_bridge = _try_import("r_bridge")


def available_modules() -> List[str]:
    """Names of successfully imported top-level modules."""
    out = ["core"]
    for m in _OPTIONAL_MODULES:
        if m not in _module_errors:
            out.append(m)
    return out


def print_info() -> None:
    """Print version and module availability."""
    print(f"spatialcore_tpu {__version__}")
    for m in ["core"] + _OPTIONAL_MODULES:
        status = "ok" if m not in _module_errors else f"unavailable ({_module_errors[m]})"
        print(f"  {m:12s} {status}")


__all__ = [
    "__version__", "SpatialData", "read_h5ad", "write_h5ad", "get_logger",
    "update_metadata", "core", "ops", "spatial", "stats", "annotation",
    "plotting", "parallel", "utils", "nmf", "diffusion", "r_bridge",
    "available_modules", "print_info",
]
