"""CellxGene Census access: curated registry + SOMA queries (gated).

Parity with /root/reference/src/spatialcore/annotation/cellxgene.py:
the pinned dataset registry (:102-155 — dataset IDs are public Census
identifiers, reproduced as facts), ``download_cellxgene_reference``
(:178-250), ``query_cellxgene_census`` (:253-495 — structured filters,
memory-efficient ID→sample→fetch flow, token-containment parent/child
hierarchy pruning, label/ontology conflict warnings) and
``list_available_datasets`` (:158-175). All network work requires the
optional ``cellxgene_census`` dependency.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional, Set, Union

import pandas as pd

from ..core.compat import param_aliases
from ..core.logging import get_logger

logger = get_logger("annotation.cellxgene")

# Pinned, public Census dataset pointers (key → metadata). The IDs are
# CellxGene collection facts; descriptions are ours.
CELLXGENE_DATASETS: Dict[str, Dict] = {
    "healthy_human_liver": {
        "dataset_id": "4f88c1be-5156-463d-b64d-a3a3a8e0da6d",
        "description": "Healthy human liver sc/snRNA-seq cell types",
        "tissue": "liver",
        "cell_type_column": "cell_type",
        "expected_cells": "~100,000",
    },
    "colon_immune_niches": {
        "dataset_id": "2872f4b0-b171-46e2-abc6-befcf6de6306",
        "description": "Microbial and immune niches of the human colon",
        "tissue": "colon",
        "cell_type_column": "cell_type",
        "expected_cells": "~41,650",
    },
    "colon_ulcerative_colitis": {
        "dataset_id": "4dd00779-7f73-4f50-89bb-e2d3c6b71b18",
        "description": "Human colon during ulcerative colitis",
        "tissue": "colon",
        "cell_type_column": "cell_type",
        "expected_cells": "~34,772",
    },
    "colon_crohns_immune": {
        "dataset_id": "518d9049-2a76-44f8-8abc-1e2b59ab5ba1",
        "description": "Crohn's disease colon immune cells",
        "tissue": "colon",
        "cell_type_column": "cell_type",
        "expected_cells": "~152,509",
    },
    "human_lung_cell_atlas": {
        "dataset_id": "f72958f5-7f42-4ebb-98da-445b0c6de516",
        "description": "Human Lung Cell Atlas (Azimuth finest level)",
        "tissue": "lung",
        "cell_type_column": "ann_finest_level",
        "expected_cells": "~584,884",
    },
    "lung_covid": {
        "dataset_id": "d8da613f-e681-4c69-b463-e94f5e66847f",
        "description": "Single-cell lung atlas of lethal COVID-19",
        "tissue": "lung",
        "cell_type_column": "cell_type",
        "expected_cells": "~116,313",
    },
    "crc_htan_epithelial_discovery": {
        "dataset_id": "e40c6272-af77-4a10-9385-62a398884f27",
        "description": "HTAN VUMC CRC polyps, epithelial (discovery)",
        "tissue": "colon",
        "cell_type_column": "cell_type",
        "expected_cells": "~65,088",
    },
}

# Back-compat name for the registry dict.
CELLXGENE_REGISTRY = CELLXGENE_DATASETS

_TOKEN_SPLIT = re.compile(r"[^a-z0-9]+")


def _label_tokens(label) -> Set[str]:
    """Lowercase alphanumeric token set of a label."""
    if label is None:
        return set()
    return {t for t in _TOKEN_SPLIT.sub(" ", str(label).lower()).split()
            if t}


def _parent_child_conflicts(
    obs: pd.DataFrame,
    label_column: str = "cell_type",
    ontology_column: str = "cell_type_ontology_term_id",
    min_parent_tokens: int = 2,
) -> Dict[str, List[str]]:
    """Parent CL ID → child CL IDs, by strict label-token containment.

    A term is a parent of another when its token set is a proper subset
    of the other's (e.g. "t cell" ⊂ "cd4 t cell") — the reference's
    hierarchy heuristic (cellxgene.py:52-94).
    """
    pairs = obs[[label_column, ontology_column]].dropna().astype(str)
    pairs = pairs[pairs[ontology_column].str.startswith("CL:")]
    if pairs.empty:
        return {}
    id_to_label = (pairs.groupby(ontology_column)[label_column]
                   .agg(lambda v: v.value_counts().idxmax()))
    id_tokens = {i: _label_tokens(l) for i, l in id_to_label.items()}
    conflicts: Dict[str, List[str]] = {}
    for pid, ptok in id_tokens.items():
        if len(ptok) < min_parent_tokens:
            continue
        kids = [cid for cid, ctok in id_tokens.items()
                if cid != pid and len(ctok) > len(ptok)
                and ptok < ctok]
        if kids:
            conflicts[pid] = kids
    return conflicts


def _require_census():
    try:
        import cellxgene_census

        return cellxgene_census
    except ImportError as e:
        raise ImportError(
            "CellxGene access requires the optional 'cellxgene-census' "
            "dependency (network access needed). Download the reference "
            "h5ad manually and pass a local path instead.") from e


@param_aliases(name_or_filter="dataset_key", output_path="output_dir")
def download_cellxgene_reference(
    dataset_key: str,
    output_dir: Union[str, Path],
    force: bool = False,
) -> Path:
    """Download a pinned registry dataset's source h5ad into a directory.

    Skips the download when ``{dataset_key}.h5ad`` already exists unless
    ``force`` (reference cellxgene.py:178-250).
    """
    if dataset_key not in CELLXGENE_DATASETS:
        raise ValueError(
            f"Unknown dataset: '{dataset_key}'. Available: "
            + ", ".join(CELLXGENE_DATASETS))
    census = _require_census()
    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_file = out_dir / f"{dataset_key}.h5ad"
    if out_file.exists() and not force:
        logger.info(f"Dataset already cached: {out_file}")
        return out_file
    info = CELLXGENE_DATASETS[dataset_key]
    logger.info(f"Downloading {dataset_key} ({info['dataset_id']}, "
                f"{info['expected_cells']} cells)")
    census.download_source_h5ad(info["dataset_id"], to_path=str(out_file))
    logger.info(f"Downloaded → {out_file}")
    return out_file


@param_aliases(seed="random_state")
def query_cellxgene_census(
    tissue: Optional[str] = None,
    disease: Optional[str] = None,
    cell_type: Optional[str] = None,
    assay: Optional[str] = None,
    organism: str = "Homo sapiens",
    obs_columns: Optional[List[str]] = None,
    max_cells: Optional[int] = None,
    output_path: Optional[Union[str, Path]] = None,
    random_state: int = 0,
    validate_labels: bool = True,
    resolve_hierarchy: str = "none",
    value_filter: Optional[str] = None,
    census_version: str = "stable",
):
    """SOMA query → (stratified sample) → AnnData, memory-efficient.

    Filters combine with AND; ``value_filter`` passes a raw SOMA filter
    string instead (an extra of this build). With ``max_cells`` set, step 1 reads
    only obs joinids + labels, step 2 samples stratified by cell type,
    step 3 fetches just the sampled rows; without it every matching cell
    downloads. ``resolve_hierarchy='remove_parents'`` drops cells labeled
    with a parent term when child terms are present (token containment);
    ``validate_labels`` logs label↔ontology conflicts. Saves to
    ``output_path`` when given; returns the AnnData either way
    (reference cellxgene.py:253-495).
    """
    census = _require_census()
    if value_filter is None:
        clauses = [f"{k} == '{v}'" for k, v in
                   [("tissue_general", tissue), ("disease", disease),
                    ("cell_type", cell_type), ("assay", assay)]
                   if v is not None]
        if not clauses:
            raise ValueError(
                "Provide at least one filter (tissue/disease/cell_type/"
                "assay) or a raw value_filter")
        value_filter = " and ".join(clauses)
    organism_key = organism.strip().lower().replace(" ", "_")
    fetch_cols = ["soma_joinid", "cell_type",
                  "cell_type_ontology_term_id", "disease", "assay",
                  "tissue"]
    if obs_columns:
        fetch_cols += [c for c in obs_columns if c not in fetch_cols]

    logger.info(f"Census query: {value_filter!r}"
                + (f" (max {max_cells:,} cells)" if max_cells else ""))
    with census.open_soma(census_version=census_version) as soma:
        exp = soma["census_data"][organism_key]
        obs = exp.obs.read(
            value_filter=value_filter, column_names=fetch_cols,
        ).concat().to_pandas()
        if obs.empty:
            raise ValueError(f"No cells match filter: {value_filter!r}")

        if resolve_hierarchy == "remove_parents":
            conflicts = _parent_child_conflicts(obs)
            if conflicts:
                drop_ids = set(conflicts)
                before = len(obs)
                obs = obs[~obs["cell_type_ontology_term_id"]
                          .astype(str).isin(drop_ids)]
                logger.info(
                    f"remove_parents: dropped {before - len(obs):,} cells "
                    f"labeled with {len(drop_ids)} parent terms")
        if max_cells and len(obs) > max_cells:
            from .loading import stratified_sample_indices

            labels = obs["cell_type"].astype(str).to_numpy()
            rows = stratified_sample_indices(labels, max_cells,
                                             random_state)
            obs = obs.iloc[rows]
        joinids = obs["soma_joinid"].to_numpy()
        logger.info(f"Fetching {len(joinids):,} cells")
        adata = census.get_anndata(
            soma, organism=organism_key, obs_coords=joinids.tolist())

    if validate_labels and "cell_type_ontology_term_id" in adata.obs:
        per_label = (adata.obs[["cell_type",
                                "cell_type_ontology_term_id"]]
                     .dropna().astype(str)
                     .groupby("cell_type")["cell_type_ontology_term_id"]
                     .nunique())
        bad = per_label[per_label > 1]
        if len(bad):
            logger.warning(
                f"{len(bad)} labels map to multiple ontology IDs: "
                f"{sorted(bad.index)[:5]}")

    if output_path is not None:
        out = Path(output_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        adata.write_h5ad(out)
        logger.info(f"Census reference → {out}")
    return adata


def list_available_datasets() -> pd.DataFrame:
    """The pinned registry as a DataFrame (one row per dataset)."""
    return pd.DataFrame(
        [{"key": k, **v} for k, v in CELLXGENE_DATASETS.items()])
