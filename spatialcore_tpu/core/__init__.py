"""Cross-cutting runtime: container, IO, logging, provenance, caching, RNG.

The AnnData-style container, h5ad IO and gene maps need pandas (and h5py);
they load on first use, so the device kernels (``ops``, ``parallel``)
import with only JAX, NumPy and SciPy installed.
"""

import importlib

from .cache import cache_result, clear_cache, get_cache_path
from .logging import get_logger, setup_file_logging, setup_logging
from .metadata import (
    MetadataTracker,
    get_operations,
    prepare_metadata_for_h5ad,
    restore_metadata_from_h5ad,
    update_metadata,
)
from .normalization import (
    check_normalization_status,
    find_raw_counts_source,
    log1p,
    normalize_log1p_from_raw,
    normalize_total,
)
from .rng import batch_permutations, key_for, permutation_keys

#: names served lazily by :func:`__getattr__`, by submodule
_LAZY = {
    "container": ("AlignedDict", "Raw", "SpatialData", "concat"),
    "genes": ("download_ensembl_mapping", "is_ensembl_id",
              "load_ensembl_to_hugo_mapping", "normalize_gene_names"),
    "io": ("read_h5ad", "write_h5ad"),
}
_LAZY_HOME = {name: mod for mod, names in _LAZY.items() for name in names}


def __getattr__(name):
    mod = _LAZY_HOME.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{mod}", __name__), name)
    globals()[name] = value
    return value

__all__ = [
    "AlignedDict", "Raw", "SpatialData", "concat",
    "read_h5ad", "write_h5ad",
    "get_logger", "setup_logging", "setup_file_logging",
    "MetadataTracker", "update_metadata", "get_operations",
    "prepare_metadata_for_h5ad", "restore_metadata_from_h5ad",
    "cache_result", "clear_cache", "get_cache_path",
    "check_normalization_status", "find_raw_counts_source",
    "normalize_total", "log1p", "normalize_log1p_from_raw",
    "normalize_gene_names", "load_ensembl_to_hugo_mapping", "is_ensembl_id",
    "download_ensembl_mapping",
    "key_for", "permutation_keys", "batch_permutations",
]
