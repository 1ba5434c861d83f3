"""SpatialData: the in-memory data bus of spatialcore_tpu.

The reference library uses AnnData as its universal container ("AnnData is the
bus", SURVEY.md §1). This environment has no anndata dependency, so we ship a
lightweight, API-compatible container with the fields every public function
needs: ``X``, ``obs``, ``var``, ``obsm``, ``varm``, ``obsp``, ``uns``,
``layers`` and ``raw``. On-disk interop with the h5ad format lives in
``core/io.py`` so real AnnData users can exchange files with this library.

Design notes (device-first):
- ``X`` may be a numpy array, a scipy sparse matrix, or a jax Array. Compute
  layers convert to device arrays at the kernel boundary; the container itself
  is host-side and framework-neutral.
- Views are not implemented; ``__getitem__`` always copies (the reference's
  public API uses ``copy=False`` in-place conventions on the full object, and
  its internal subsetting immediately ``.copy()``s, e.g.
  /root/reference/src/spatialcore/spatial/autocorrelation.py:573).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import pandas as pd
import scipy.sparse as sp

Matrix = Union[np.ndarray, sp.spmatrix]


def _n_rows(x) -> int:
    return x.shape[0]


class Raw:
    """Frozen snapshot of (X, var) before a transformation, like AnnData.raw."""

    def __init__(self, X: Matrix, var: pd.DataFrame, obs_names: pd.Index):
        self.X = X
        self.var = var
        self._obs_names = obs_names

    @property
    def var_names(self) -> pd.Index:
        return self.var.index

    @property
    def n_vars(self) -> int:
        return self.var.shape[0]

    @property
    def shape(self):
        return (self.X.shape[0], self.var.shape[0])

    def copy(self) -> "Raw":
        return Raw(_copy_matrix(self.X), self.var.copy(), self._obs_names)

    def __getitem__(self, idx) -> "Raw":
        oidx, vidx = idx if isinstance(idx, tuple) else (idx, slice(None))
        oidx = _resolve_index(oidx, self._obs_names)
        vidx = _resolve_index(vidx, self.var.index)
        X = self.X[oidx][:, vidx] if sp.issparse(self.X) else self.X[np.ix_(oidx, vidx)]
        return Raw(X, self.var.iloc[vidx].copy(), self._obs_names[oidx])

    def to_adata(self) -> "SpatialData":
        return SpatialData(X=_copy_matrix(self.X), var=self.var.copy(),
                           obs=pd.DataFrame(index=self._obs_names))


def _is_device_array(x) -> bool:
    """True for jax arrays (module check keeps this file jax-import-free).

    Only jax arrays get the share-don't-copy treatment: they are
    immutable, so sharing the buffer IS a safe copy, and np.array(x)
    would force a full device->host readback. Other shape+dtype
    array-likes (pd.Categorical, torch tensors, h5py datasets) are
    mutable and must keep copy/convert semantics (review finding:
    a broad duck-type aliased pd.Categorical across .copy()).
    """
    mod = type(x).__module__ or ""
    return mod.startswith(("jax", "jaxlib"))


def _copy_matrix(X):
    if X is None:
        return None
    if sp.issparse(X):
        return X.copy()
    if _is_device_array(X):
        return X
    return np.array(X, copy=True)


def _resolve_index(idx, names: pd.Index) -> np.ndarray:
    """Resolve obs/var indexers (slice, bool mask, int array, name list) to ints."""
    n = len(names)
    if isinstance(idx, slice):
        return np.arange(n)[idx]
    idx = np.atleast_1d(np.asarray(idx))  # adata[5] / adata[:, 'GENE']
    if idx.dtype == bool:
        if idx.shape[0] != n:
            raise IndexError(f"Boolean mask length {idx.shape[0]} != axis length {n}")
        return np.flatnonzero(idx)
    if idx.dtype.kind in "iu":
        return idx.astype(np.int64)
    # names
    indexer = names.get_indexer(idx)
    if (indexer < 0).any():
        missing = list(np.asarray(idx)[indexer < 0][:5])
        raise KeyError(f"Names not found in axis: {missing}")
    return indexer


class AlignedDict(dict):
    """Dict of arrays whose first dimension(s) must match an axis length."""

    def __init__(self, parent: "SpatialData", axes: Sequence[int], data=None):
        super().__init__()
        self._parent = parent
        self._axes = tuple(axes)  # which container axes each array dim aligns to
        if data:
            for k, v in data.items():
                self[k] = v

    def __setitem__(self, key: str, value):
        # numpy stays as-is; jax arrays are stored AS-IS too (np.asarray
        # on a device-resident array would force a full device->host
        # readback — this dict is the bus for [N, G]-scale statistic
        # outputs). Everything else (lists, Series, pd.Categorical, …)
        # normalizes to numpy as before.
        if not (sp.issparse(value) or isinstance(value, np.ndarray)
                or _is_device_array(value)):
            value = np.asarray(value)
        expected = [self._parent.shape[ax] for ax in self._axes]
        if len(value.shape) < len(expected):
            raise ValueError(
                f"Value for key '{key}' has shape {value.shape}; "
                f"expected at least {len(expected)} dims aligned to {expected}")
        for dim, exp in enumerate(expected):
            if value.shape[dim] != exp:
                raise ValueError(
                    f"Value for key '{key}' has shape {value.shape}; "
                    f"dim {dim} must equal {exp}"
                )
        super().__setitem__(key, value)

    # dict.update / setdefault / |= do NOT call __setitem__ — route them
    # through it so misaligned arrays can't bypass validation
    def update(self, *args, **kwargs):
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    def __ior__(self, other):
        self.update(other)
        return self

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return self[key]


class SpatialData:
    """AnnData-compatible annotated data matrix: obs (cells) × var (genes)."""

    def __init__(
        self,
        X: Optional[Matrix] = None,
        obs: Optional[pd.DataFrame] = None,
        var: Optional[pd.DataFrame] = None,
        obsm: Optional[Mapping[str, Any]] = None,
        varm: Optional[Mapping[str, Any]] = None,
        obsp: Optional[Mapping[str, Any]] = None,
        uns: Optional[Dict[str, Any]] = None,
        layers: Optional[Mapping[str, Any]] = None,
        raw: Optional[Raw] = None,
    ):
        if X is None and obs is None:
            raise ValueError("Provide at least X or obs")
        # convert BEFORE reading shapes: a dict obs with X=None crashed on
        # obs.shape
        if obs is not None and not isinstance(obs, pd.DataFrame):
            obs = pd.DataFrame(obs)
        if var is not None and not isinstance(var, pd.DataFrame):
            var = pd.DataFrame(var)
        n_obs = _n_rows(X) if X is not None else obs.shape[0]
        n_vars = X.shape[1] if X is not None else (var.shape[0] if var is not None else 0)

        if obs is None:
            obs = pd.DataFrame(index=pd.Index([str(i) for i in range(n_obs)], name=None))
        if var is None:
            var = pd.DataFrame(index=pd.Index([str(i) for i in range(n_vars)], name=None))

        if obs.shape[0] != n_obs:
            raise ValueError(f"obs has {obs.shape[0]} rows but X has {n_obs}")
        if X is not None and var.shape[0] != X.shape[1]:
            raise ValueError(f"var has {var.shape[0]} rows but X has {X.shape[1]} columns")

        self.X = X
        self.obs = obs
        self.var = var
        self.uns: Dict[str, Any] = dict(uns) if uns else {}
        self.obsm = AlignedDict(self, (0,), obsm)
        self.varm = AlignedDict(self, (1,), varm)
        self.obsp = AlignedDict(self, (0, 0), obsp)
        self.layers = AlignedDict(self, (0, 1), layers)
        self.raw = raw

    # -- basic properties ---------------------------------------------------
    @property
    def n_obs(self) -> int:
        return self.obs.shape[0]

    @property
    def n_vars(self) -> int:
        return self.var.shape[0]

    @property
    def shape(self):
        return (self.n_obs, self.n_vars)

    @property
    def obs_names(self) -> pd.Index:
        return self.obs.index

    @obs_names.setter
    def obs_names(self, names):
        self.obs.index = pd.Index(names)

    @property
    def var_names(self) -> pd.Index:
        return self.var.index

    @var_names.setter
    def var_names(self, names):
        self.var.index = pd.Index(names)

    def var_names_make_unique(self, join: str = "-") -> None:
        names = self.var.index.astype(str)
        counts: Dict[str, int] = {}
        out = []
        dup = set(names[names.duplicated()])
        for name in names:
            if name in dup:
                k = counts.get(name, 0)
                counts[name] = k + 1
                out.append(name if k == 0 else f"{name}{join}{k}")
            else:
                out.append(name)
        self.var.index = pd.Index(out)

    # -- copy / subset ------------------------------------------------------
    def copy(self) -> "SpatialData":
        new = SpatialData(
            X=_copy_matrix(self.X),
            obs=self.obs.copy(),
            var=self.var.copy(),
            uns=_deep_copy_uns(self.uns),
            raw=self.raw.copy() if self.raw is not None else None,
        )
        for k, v in self.obsm.items():
            new.obsm[k] = _copy_matrix(v)
        for k, v in self.varm.items():
            new.varm[k] = _copy_matrix(v)
        for k, v in self.obsp.items():
            new.obsp[k] = _copy_matrix(v)
        for k, v in self.layers.items():
            new.layers[k] = _copy_matrix(v)
        return new

    def __getitem__(self, idx) -> "SpatialData":
        oidx, vidx = idx if isinstance(idx, tuple) else (idx, slice(None))
        oi = _resolve_index(oidx, self.obs_names)
        vi = _resolve_index(vidx, self.var_names)
        X = None
        if self.X is not None:
            X = self.X[oi][:, vi] if sp.issparse(self.X) else self.X[np.ix_(oi, vi)]
        new = SpatialData(
            X=X,
            obs=self.obs.iloc[oi].copy(),
            var=self.var.iloc[vi].copy(),
            uns=_deep_copy_uns(self.uns),
            raw=self.raw[oi] if self.raw is not None else None,
        )
        for k, v in self.obsm.items():
            new.obsm[k] = v[oi].copy()
        for k, v in self.varm.items():
            new.varm[k] = v[vi].copy()
        for k, v in self.obsp.items():
            new.obsp[k] = v[oi][:, oi].copy() if sp.issparse(v) else v[np.ix_(oi, oi)].copy()
        for k, v in self.layers.items():
            new.layers[k] = v[oi][:, vi].copy() if sp.issparse(v) else v[np.ix_(oi, vi)].copy()
        return new

    # -- convenience --------------------------------------------------------
    def get_matrix(self, layer: Optional[str] = None) -> Matrix:
        """Return ``X`` or a named layer; ``layer='raw'`` resolves ``.raw.X``."""
        if layer is None:
            if self.X is None:
                raise ValueError("This object has no X matrix")
            return self.X
        if layer == "raw":
            if self.raw is None:
                raise ValueError("layer='raw' requested but .raw is not set")
            return self.raw.X
        if layer not in self.layers:
            raise KeyError(f"Layer '{layer}' not found; available: {list(self.layers)}")
        return self.layers[layer]

    def store_raw(self) -> None:
        """Snapshot current (X, var) into ``.raw`` (like ``adata.raw = adata``)."""
        self.raw = Raw(_copy_matrix(self.X), self.var.copy(), self.obs_names)

    def __repr__(self) -> str:
        parts = [f"SpatialData n_obs × n_vars = {self.n_obs} × {self.n_vars}"]
        for attr in ("obs", "var"):
            cols = list(getattr(self, attr).columns)
            if cols:
                parts.append(f"    {attr}: {', '.join(map(repr, cols[:12]))}")
        for attr in ("obsm", "varm", "obsp", "layers", "uns"):
            keys = list(getattr(self, attr).keys())
            if keys:
                parts.append(f"    {attr}: {', '.join(map(repr, keys[:12]))}")
        return "\n".join(parts)


def _deep_copy_uns(d):
    if isinstance(d, dict):
        return {k: _deep_copy_uns(v) for k, v in d.items()}
    # lists/tuples recurse too: the provenance ledger's ``operations`` list
    # must not be shared between copies (an append on one copy would leak
    # into every other — caught by the round-3 int8 provenance test)
    if isinstance(d, list):
        return [_deep_copy_uns(v) for v in d]
    if isinstance(d, tuple):
        return tuple(_deep_copy_uns(v) for v in d)
    if isinstance(d, pd.DataFrame):
        return d.copy()
    if isinstance(d, np.ndarray):
        return d.copy()
    return d


def concat(
    objs: Sequence[SpatialData],
    join: str = "inner",
    label: Optional[str] = None,
    keys: Optional[Sequence[str]] = None,
    index_unique: Optional[str] = None,
) -> SpatialData:
    """Concatenate along obs, joining vars (like ``anndata.concat``).

    Mirrors the subset of ``sc.concat`` behavior the reference pipeline uses
    (/root/reference/src/spatialcore/annotation/training.py via ``sc.concat``):
    inner/outer var join, optional batch ``label`` column from ``keys``.
    """
    if not objs:
        raise ValueError("No objects to concatenate")
    if join not in ("inner", "outer"):
        raise ValueError("join must be 'inner' or 'outer'")

    var_sets = [o.var_names for o in objs]
    if join == "inner":
        shared = var_sets[0]
        for v in var_sets[1:]:
            shared = shared.intersection(v)
        all_vars = shared
    else:
        all_vars = var_sets[0]
        for v in var_sets[1:]:
            all_vars = all_vars.union(v)

    mats, obs_frames = [], []
    for i, o in enumerate(objs):
        idx = o.var_names.get_indexer(all_vars)
        if join == "inner":
            Xi = o.X[:, idx]
        else:
            if sp.issparse(o.X):
                Xi = sp.lil_matrix((o.n_obs, len(all_vars)), dtype=o.X.dtype)
                present = idx >= 0
                Xi[:, np.flatnonzero(present)] = o.X[:, idx[present]]
                Xi = Xi.tocsr()
            else:
                Xi = np.zeros((o.n_obs, len(all_vars)), dtype=o.X.dtype)
                present = idx >= 0
                Xi[:, present] = o.X[:, idx[present]]
        mats.append(Xi)
        obs_i = o.obs.copy()
        if label is not None:
            obs_i[label] = keys[i] if keys is not None else str(i)
        if index_unique is not None:
            suffix = keys[i] if keys is not None else str(i)
            obs_i.index = [f"{n}{index_unique}{suffix}" for n in obs_i.index]
        obs_frames.append(obs_i)

    X = sp.vstack([sp.csr_matrix(m) for m in mats]) if any(sp.issparse(m) for m in mats) \
        else np.vstack(mats)
    obs = pd.concat(obs_frames, axis=0, join="outer")
    var = pd.DataFrame(index=all_vars)
    return SpatialData(X=X, obs=obs, var=var)
