"""Device compute kernels: graphs, autocorrelation, clustering, thresholds."""

from .fdr import apply_fdr, benjamini_hochberg, bonferroni
from .graph import (
    SpatialGraph,
    build_graph,
    graph_moments,
    knn_exact,
    knn_grid,
    radius_neighbors,
    spatial_lag,
)
from .banded import (
    NullPlan,
    banded_getis,
    banded_lees_l,
    banded_local_geary,
    banded_local_moran,
    banded_permutation_test,
    build_null_plan,
)
from .lee import LeesLResult, lees_l_pairs
from .streaming import streaming_moran_null
from .moran import (
    LocalMoranResult,
    QUADRANT_LABELS,
    classify_quadrants,
    geary_analytic_moments,
    geary_observed,
    correlogram_kernel,
    local_moran,
    moran_analytic_moments,
    moran_observed,
    p_from_z,
    permutation_test_global,
    standardize,
)

__all__ = [
    "SpatialGraph", "build_graph", "graph_moments", "knn_exact", "knn_grid",
    "radius_neighbors", "spatial_lag",
    "standardize", "moran_observed", "geary_observed",
    "moran_analytic_moments", "geary_analytic_moments", "p_from_z",
    "permutation_test_global", "local_moran", "LocalMoranResult",
    "classify_quadrants", "QUADRANT_LABELS",
    "lees_l_pairs", "LeesLResult",
    "NullPlan", "build_null_plan", "banded_permutation_test",
    "banded_lees_l", "banded_local_moran", "banded_local_geary",
    "banded_getis",
    "streaming_moran_null", "correlogram_kernel",
    "apply_fdr", "benjamini_hochberg", "bonferroni",
]
