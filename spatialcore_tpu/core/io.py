"""h5ad read/write implemented directly on h5py.

The environment (and an accelerator host generally) need not carry the anndata stack,
so we speak the anndata on-disk format directly: dense / CSR / CSC matrices,
dataframes with numeric, string, bool and categorical columns, and nested
``uns`` dicts. Files written here open in real anndata and vice versa for
the subset of types we emit.

Each element carries the (encoding-type, encoding-version) pair that
anndata >= 0.8 registers readers for — "array"/"string-array"/"string"/
"numeric-scalar"/"dataframe"/"categorical" at 0.2.0, "dict"/"csr_matrix"/
"csc_matrix"/"raw" at 0.1.0 — since its IO registry raises on unknown pairs.
Boolean arrays/scalars are written as native HDF5 bools (what anndata emits);
the legacy ``__spatialcore_bool__`` uint8 marker from earlier files is still
understood on read.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Union

import h5py
import numpy as np
import pandas as pd
import scipy.sparse as sp

from .container import Raw, SpatialData
from .logging import get_logger

logger = get_logger("core.io")

_STR_DTYPE = h5py.string_dtype(encoding="utf-8")


# ---------------------------------------------------------------------------
# Writers
# ---------------------------------------------------------------------------

# versions anndata >= 0.8 registers readers for (its registry hard-fails
# on unknown (type, version) pairs)
_ENC_VERSIONS = {
    "anndata": "0.1.0",
    "array": "0.2.0",
    "string-array": "0.2.0",
    "string": "0.2.0",
    "numeric-scalar": "0.2.0",
    "dataframe": "0.2.0",
    "categorical": "0.2.0",
    "dict": "0.1.0",
    "csr_matrix": "0.1.0",
    "csc_matrix": "0.1.0",
    "raw": "0.1.0",
}


def _set_enc(obj, enc_type: str) -> None:
    obj.attrs["encoding-type"] = enc_type
    obj.attrs["encoding-version"] = _ENC_VERSIONS[enc_type]


def _write_array(group: h5py.Group, name: str, value) -> None:
    if sp.issparse(value):
        _write_sparse(group, name, value)
        return
    arr = np.asarray(value)
    if arr.dtype == object or arr.dtype.kind in "US":
        ds = group.create_dataset(name, data=arr.astype(object), dtype=_STR_DTYPE)
        _set_enc(ds, "string-array")
    elif arr.dtype == bool:
        ds = group.create_dataset(name, data=arr)  # native HDF5 bool enum
        _set_enc(ds, "array")
    else:
        ds = group.create_dataset(name, data=arr)
        _set_enc(ds, "array")


def _write_sparse(group: h5py.Group, name: str, mat: sp.spmatrix) -> None:
    fmt = "csr" if sp.issparse(mat) and mat.format == "csr" else "csc"
    mat = mat.tocsr() if fmt == "csr" else mat.tocsc()
    g = group.create_group(name)
    _set_enc(g, f"{fmt}_matrix")
    g.attrs["shape"] = np.array(mat.shape, dtype=np.int64)
    g.create_dataset("data", data=mat.data)
    g.create_dataset("indices", data=mat.indices.astype(np.int32)
                     if mat.shape[max(0, 1)] < 2**31 else mat.indices)
    g.create_dataset("indptr", data=mat.indptr)


def _write_scalar(group: h5py.Group, name: str, value) -> None:
    if isinstance(value, str):
        ds = group.create_dataset(name, data=value, dtype=_STR_DTYPE)
        _set_enc(ds, "string")
    elif isinstance(value, bool) or isinstance(value, np.bool_):
        ds = group.create_dataset(name, data=np.bool_(value))
        _set_enc(ds, "numeric-scalar")
    elif value is None:
        ds = group.create_dataset(name, data="__none__", dtype=_STR_DTYPE)
        _set_enc(ds, "string")
        ds.attrs["__spatialcore_none__"] = True
    else:
        ds = group.create_dataset(name, data=value)
        _set_enc(ds, "numeric-scalar")


def _write_dataframe(group: h5py.Group, name: str, df: pd.DataFrame) -> None:
    g = group.create_group(name)
    _set_enc(g, "dataframe")
    index_name = df.index.name or "_index"
    g.attrs["_index"] = index_name
    g.attrs["column-order"] = np.array(list(df.columns), dtype=object) \
        if len(df.columns) else np.empty(0, dtype=_STR_DTYPE)
    if pd.api.types.is_numeric_dtype(df.index):
        # preserve numeric indexes (e.g. RangeIndex of a uns DataFrame);
        # obs/var string indexes keep the anndata string convention
        _write_array(g, index_name, df.index.to_numpy())
    else:
        _write_array(g, index_name, df.index.astype(str).to_numpy())
    for col in df.columns:
        series = df[col]
        if isinstance(series.dtype, pd.CategoricalDtype):
            cg = g.create_group(str(col))
            _set_enc(cg, "categorical")
            cg.attrs["ordered"] = bool(series.cat.ordered)
            _write_array(cg, "codes", series.cat.codes.to_numpy().astype(np.int32))
            _write_array(cg, "categories", series.cat.categories.astype(str).to_numpy())
        else:
            vals = series.to_numpy()
            if vals.dtype == object:
                vals = np.array([("" if v is None else str(v)) for v in vals], dtype=object)
            _write_array(g, str(col), vals)


def _write_mapping(group: h5py.Group, name: str, mapping: dict) -> None:
    g = group.create_group(name)
    _set_enc(g, "dict")
    for k, v in mapping.items():
        _write_any(g, str(k), v)


def _write_any(group: h5py.Group, name: str, value: Any) -> None:
    if isinstance(value, pd.DataFrame):
        _write_dataframe(group, name, value)
    elif isinstance(value, dict):
        _write_mapping(group, name, value)
    elif sp.issparse(value):
        _write_sparse(group, name, value)
    elif isinstance(value, (np.ndarray, list, tuple, pd.Index, pd.Series)) \
            or (hasattr(value, "shape") and hasattr(value, "dtype")
                and not isinstance(value, np.generic)):
        # the shape+dtype duck-type covers device-resident jax arrays:
        # h5ad is a host format, so the device->host readback happens
        # exactly here, at the IO boundary. np.generic scalars are
        # excluded — they must keep the 'numeric-scalar'/'string'
        # encodings anndata readers expect (review finding)
        if isinstance(value, (pd.Index, pd.Series)):
            value = value.to_numpy()
        _write_array(group, name, np.asarray(value))
    elif np.isscalar(value) or value is None:
        _write_scalar(group, name, value)
    else:
        logger.warning(f"uns['{name}']: unsupported type {type(value)}; storing repr()")
        _write_scalar(group, name, repr(value))


def write_h5ad(adata: SpatialData, path: Union[str, Path]) -> None:
    """Write a :class:`SpatialData` to an anndata-compatible ``.h5ad`` file."""
    from .metadata import prepare_metadata_for_h5ad

    adata = adata  # written in place; metadata stringified on a shallow basis
    prepare_metadata_for_h5ad(adata)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        _set_enc(f, "anndata")
        if adata.X is not None:
            _write_array(f, "X", adata.X)
        _write_dataframe(f, "obs", adata.obs)
        _write_dataframe(f, "var", adata.var)
        for attr in ("obsm", "varm", "obsp", "layers"):
            g = f.create_group(attr)
            _set_enc(g, "dict")
            for k, v in getattr(adata, attr).items():
                _write_any(g, k, v)
        _write_mapping(f, "uns", adata.uns)
        if adata.raw is not None:
            rg = f.create_group("raw")
            _set_enc(rg, "raw")
            _write_array(rg, "X", adata.raw.X)
            _write_dataframe(rg, "var", adata.raw.var)
    from .metadata import restore_metadata_from_h5ad
    restore_metadata_from_h5ad(adata)


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

def _read_any(node) -> Any:
    if isinstance(node, h5py.Dataset):
        enc = node.attrs.get("encoding-type", "")
        value = node[()]
        if node.attrs.get("__spatialcore_none__"):
            return None
        if enc == "string" or (node.shape == () and isinstance(value, bytes)):
            return value.decode() if isinstance(value, bytes) else str(value)
        if enc == "string-array" or (hasattr(value, "dtype") and value.dtype == object):
            return np.array([v.decode() if isinstance(v, bytes) else v
                             for v in np.asarray(value).ravel()]).reshape(np.asarray(value).shape)
        if node.shape == ():
            if node.attrs.get("__spatialcore_bool__"):
                return bool(value)
            return value.item() if hasattr(value, "item") else value
        if node.attrs.get("__spatialcore_bool__"):
            return np.asarray(value).astype(bool)
        return np.asarray(value)
    # group
    enc = node.attrs.get("encoding-type", "")
    if enc in ("csr_matrix", "csc_matrix"):
        shape = tuple(node.attrs["shape"])
        cls = sp.csr_matrix if enc == "csr_matrix" else sp.csc_matrix
        return cls((node["data"][()], node["indices"][()], node["indptr"][()]),
                   shape=shape)
    if enc == "dataframe":
        return _read_dataframe(node)
    if enc == "categorical":
        codes = node["codes"][()]
        cats = _read_any(node["categories"])
        return pd.Categorical.from_codes(codes, categories=list(cats))
    # generic dict
    return {k: _read_any(v) for k, v in node.items()}


def _read_dataframe(group: h5py.Group) -> pd.DataFrame:
    index_name = group.attrs.get("_index", "_index")
    if isinstance(index_name, bytes):
        index_name = index_name.decode()
    index = _read_any(group[index_name])
    col_order = group.attrs.get("column-order", [])
    cols = [c.decode() if isinstance(c, bytes) else str(c) for c in col_order]
    if not cols:
        cols = [k for k in group.keys() if k != index_name]
    data = {}
    for col in cols:
        if col not in group:
            continue
        val = _read_any(group[col])
        data[col] = val
    df = pd.DataFrame(data, index=pd.Index(np.asarray(index), name=None))
    return df


def read_h5ad(path: Union[str, Path]) -> SpatialData:
    """Read an ``.h5ad`` file (anndata format) into :class:`SpatialData`."""
    from .metadata import restore_metadata_from_h5ad

    with h5py.File(path, "r") as f:
        X = _read_any(f["X"]) if "X" in f else None
        obs = _read_dataframe(f["obs"]) if "obs" in f else None
        var = _read_dataframe(f["var"]) if "var" in f else None
        adata = SpatialData(X=X, obs=obs, var=var)
        for attr in ("obsm", "varm", "obsp", "layers"):
            if attr in f:
                for k, v in f[attr].items():
                    getattr(adata, attr)[k] = _read_any(v)
        if "uns" in f:
            adata.uns = _read_any(f["uns"])
        if "raw" in f and "X" in f["raw"]:
            raw_var = _read_dataframe(f["raw"]["var"])
            adata.raw = Raw(_read_any(f["raw"]["X"]), raw_var, adata.obs_names)
    restore_metadata_from_h5ad(adata)
    return adata
