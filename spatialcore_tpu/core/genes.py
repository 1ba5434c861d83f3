"""Gene identifier normalization (Ensembl → HUGO).

Behavioral parity with /root/reference/src/spatialcore/core/utils.py:24-391:
BioMart TSV download (gated on network availability), ``~/.cache`` caching,
Ensembl-ID heuristics, feature_name fallback and ``.raw`` alignment. A small
curated built-in mapping of common genes ships with the package so the code
path works offline; users point ``cache_path`` at a full BioMart TSV for
complete coverage.
"""

from __future__ import annotations

import json
from importlib import resources
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import pandas as pd

from .logging import get_logger

logger = get_logger("core.genes")

BIOMART_URL = "http://www.ensembl.org/biomart/martservice"

_BIOMART_QUERY = (
    '<?xml version="1.0" encoding="UTF-8"?><!DOCTYPE Query>'
    '<Query virtualSchemaName="default" formatter="TSV" header="1" uniqueRows="1" '
    'count="" datasetConfigVersion="0.6">'
    '<Dataset name="hsapiens_gene_ensembl" interface="default">'
    '<Attribute name="ensembl_gene_id"/><Attribute name="hgnc_symbol"/>'
    '<Attribute name="external_gene_name"/></Dataset></Query>'
)

_ENSEMBL_PREFIXES = ("ENSG", "ENST", "ENSMUSG", "ENSMUS")


def is_ensembl_id(gene_name) -> bool:
    """True if ``gene_name`` looks like a human/mouse Ensembl gene/transcript ID."""
    if not gene_name or not isinstance(gene_name, str):
        return False
    return gene_name.startswith(_ENSEMBL_PREFIXES)


def default_cache_path() -> Path:
    return Path.home() / ".cache" / "spatialcore_tpu" / "ensembl_to_hugo.tsv"


def download_ensembl_mapping(
    output_path: Union[str, Path],
    force: bool = False,
    timeout: float = 30.0,
) -> Path:
    """Download the Ensembl→HGNC TSV from BioMart (requires network)."""
    import shutil
    import urllib.parse
    import urllib.request

    output_path = Path(output_path)
    if output_path.exists() and not force:
        return output_path
    output_path.parent.mkdir(parents=True, exist_ok=True)
    url = f"{BIOMART_URL}?query={urllib.parse.quote(_BIOMART_QUERY)}"
    logger.info("Downloading Ensembl→HUGO mapping from BioMart...")
    with urllib.request.urlopen(url, timeout=timeout) as resp, open(output_path, "wb") as f:
        shutil.copyfileobj(resp, f)
    return output_path


def _load_builtin_mapping() -> Dict[str, str]:
    with resources.files("spatialcore_tpu.data.gene_mappings").joinpath(
            "ensembl_to_hugo_builtin.json").open() as f:
        return json.load(f)


def load_ensembl_to_hugo_mapping(
    cache_path: Optional[Union[str, Path]] = None,
    auto_download: bool = False,
) -> Dict[str, str]:
    """Load the Ensembl→HUGO mapping.

    Resolution order: explicit/cached TSV → (optional) BioMart download →
    built-in curated subset. The TSV format matches BioMart's export
    (columns ``Gene stable ID`` and ``HGNC symbol``).
    """
    path = Path(cache_path) if cache_path is not None else default_cache_path()
    if not path.exists() and auto_download:
        try:
            download_ensembl_mapping(path)
        except Exception as e:  # no network on air-gapped compute hosts
            logger.warning(f"BioMart download failed ({e}); using built-in subset")
    if path.exists():
        df = pd.read_csv(path, sep="\t")
        df = df.dropna(subset=["HGNC symbol"])
        df = df[df["HGNC symbol"].astype(str).str.len() > 0]
        mapping = dict(zip(df["Gene stable ID"], df["HGNC symbol"]))
        logger.info(f"Loaded {len(mapping):,} Ensembl→HUGO mappings from {path}")
        return mapping
    mapping = _load_builtin_mapping()
    logger.info(f"Using built-in Ensembl→HUGO subset ({len(mapping):,} genes)")
    return mapping


def _convert_names(
    names: np.ndarray, mapping: Dict[str, str]
) -> Tuple[np.ndarray, Dict[str, int]]:
    out, n_conv, n_hugo, n_unmapped = [], 0, 0, 0
    for g in names:
        g = str(g)
        if is_ensembl_id(g):
            base = g.split(".", 1)[0]  # tolerate versioned IDs (ENSG...\.\d+)
            if base in mapping:
                out.append(mapping[base])
                n_conv += 1
            else:
                out.append(g)
                n_unmapped += 1
        else:
            out.append(g)
            n_hugo += 1
    stats = {"total_genes": len(names), "converted_ensembl": n_conv,
             "already_hugo": n_hugo, "unmapped_ensembl": n_unmapped}
    return np.array(out), stats


def _normalize_var_names(var_names: pd.Index, var_df: pd.DataFrame,
                         mapping: Dict[str, str]):
    first = str(var_names[0])
    non_symbol = first.isdigit() or first.startswith("ENSG") or first.startswith("ENST")
    base = var_names.values
    used_feature_name = False
    if non_symbol and "feature_name" in var_df.columns:
        base = var_df["feature_name"].values.astype(str)
        used_feature_name = True
    converted, stats = _convert_names(np.asarray(base), mapping)
    return converted, stats, non_symbol, used_feature_name


def normalize_gene_names(adata, ensembl_to_hugo: Optional[Dict[str, str]] = None,
                         copy: bool = False):
    """Rewrite ``var_names`` (and ``.raw``) to HUGO symbols where resolvable.

    Handles CellxGene-style numeric/Ensembl var_names with a ``feature_name``
    column, versioned Ensembl IDs, and makes names unique afterwards. Safe to
    call on data that already uses symbols.
    """
    if copy:
        adata = adata.copy()
    if ensembl_to_hugo is None:
        ensembl_to_hugo = load_ensembl_to_hugo_mapping()

    converted, stats, non_symbol, used_feature = _normalize_var_names(
        adata.var_names, adata.var, ensembl_to_hugo)

    if non_symbol or stats["converted_ensembl"] > 0:
        adata.var_names = pd.Index(converted)
        adata.var_names_make_unique()
        logger.info(
            f"Gene mapping: {stats['converted_ensembl']:,} converted, "
            f"{stats['already_hugo']:,} already symbols, "
            f"{stats['unmapped_ensembl']:,} unmapped"
            + (" (via feature_name)" if used_feature else ""))
    if stats["unmapped_ensembl"] > 0:
        logger.warning(f"{stats['unmapped_ensembl']:,} Ensembl IDs not in mapping; "
                       "left unchanged")

    if adata.raw is not None:
        raw_conv, raw_stats, _, raw_used = _normalize_var_names(
            adata.raw.var_names, adata.raw.var, ensembl_to_hugo)
        raw_index = pd.Index(raw_conv)
        if raw_used or not raw_index.equals(adata.raw.var_names):
            adata.raw.var.index = raw_index
            # make unique in place
            tmp = adata.raw.to_adata()
            tmp.var_names_make_unique()
            adata.raw.var.index = tmp.var_names
            logger.info("Updated raw.var_names to normalized symbols")
    return adata
