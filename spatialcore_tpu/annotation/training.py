"""Reference combination, balanced subsampling, and classifier training.

Parity targets in /root/reference/src/spatialcore/annotation/training.py:
``combine_references`` (:84-457), ``train_celltypist_model`` (:556-729, here
a JAX/optax multinomial logistic regression instead of sklearn SGD),
``subsample_balanced`` "Cap & Fill" source-aware balancing (:1218-1618),
color schemes (:818-900) and ``save_model_artifacts`` (:907-1021). Training
runs entirely on-device: standardized minibatches, class-balanced
cross-entropy, deterministic counter-based shuffling.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import scipy.sparse as sp

from ..core import container as _container
from ..core.compat import param_aliases
from ..core.genes import normalize_gene_names
from ..core.io import read_h5ad
from ..core.logging import get_logger
from ..core.normalization import check_normalization_status, normalize_log1p_from_raw
from ..core.rng import key_for, np_rng
from .model import _CLIP_Z, CellTypeModel

logger = get_logger("annotation.training")

# Labels that poison a training reference (uncertain / artifact classes).
DEFAULT_EXCLUDE_LABELS = [
    "unknown", "unassigned", "na", "n/a", "nan", "none", "null",
    "doublet", "multiplet", "low quality", "low_count", "low count",
    "filtered", "ambiguous", "undetermined",
]

HIGH_CONTRAST_PALETTE = [
    "#e6194B", "#3cb44b", "#ffe119", "#4363d8", "#f58231",
    "#911eb4", "#42d4f4", "#f032e6", "#bfef45", "#fabed4",
    "#469990", "#dcbeff", "#9A6324", "#fffac8", "#800000",
    "#aaffc3", "#808000", "#ffd8b1", "#000075", "#a9a9a9",
]


def _is_excluded(label: str, exclude: Sequence[str]) -> bool:
    return str(label).strip().lower() in {e.lower() for e in exclude}


# ---------------------------------------------------------------------------
# combine_references
# ---------------------------------------------------------------------------


@param_aliases(references="reference_paths", cell_type_column="label_columns",
               panel_genes="target_genes",
               max_cells_per_reference="max_cells_per_ref",
               seed="random_state")
def combine_references(
    reference_paths: Sequence,
    label_columns: Union[str, Sequence[str]] = "cell_type",
    output_column: str = "original_label",
    max_cells_per_ref: Optional[int] = 100_000,
    target_genes: Optional[Sequence[str]] = None,
    normalize_data: bool = True,
    random_state: int = 0,
    validate_labels: bool = True,
    min_cells_per_type: int = 10,
    strict_validation: bool = False,
    cache_dir: Optional[Union[str, Path]] = None,
    exclude_labels: Optional[Sequence[str]] = None,
    filter_min_cells: bool = True,
    normalize_genes: bool = True,
    source_column: str = "reference_source",
):
    """Merge reference datasets into one training SpatialData.

    Per reference: load (path, gs://..s3:// URI, or SpatialData), validate
    its label column (``validate_labels``; ``strict_validation`` raises on
    any issue), copy labels to ``output_column``, optionally cap cells
    (stratified, ``max_cells_per_ref``), map Ensembl→HUGO names, subset to
    ``target_genes``, re-normalize to log1p-10k (``normalize_data``, from
    raw counts when present), then inner-join shared genes, concatenate,
    drop excluded labels and — when ``filter_min_cells`` — types below
    ``min_cells_per_type`` (ref training.py:84-457). ``label_columns`` is
    one column name for all references or a per-reference list; cloud URIs
    download into ``cache_dir``.
    """
    from .acquisition import resolve_uri_to_local
    from .validation import validate_cell_type_column

    if exclude_labels is None:
        exclude_labels = DEFAULT_EXCLUDE_LABELS
    if not reference_paths:
        raise ValueError("At least one reference is required")
    if isinstance(label_columns, str):
        label_columns = [label_columns] * len(reference_paths)
    if len(label_columns) != len(reference_paths):
        raise ValueError(
            f"label_columns has {len(label_columns)} entries for "
            f"{len(reference_paths)} references")

    loaded = []
    for i, (ref, label_col) in enumerate(zip(reference_paths,
                                             label_columns)):
        name = f"ref{i}"
        if isinstance(ref, (str, Path)):
            if str(ref).startswith(("gs://", "s3://")):
                ref = resolve_uri_to_local(str(ref), cache_dir=cache_dir)
            name = Path(ref).stem
            logger.info(f"Loading reference {name} from {ref}")
            adata = read_h5ad(ref)
        else:
            adata = ref.copy()
            name = adata.uns.get("reference_name", name)
        if label_col not in adata.obs.columns:
            raise ValueError(
                f"Reference {name}: column '{label_col}' not found "
                f"in obs (has {list(adata.obs.columns)[:8]}...)")
        if validate_labels:
            res = validate_cell_type_column(
                adata, label_col, min_cells_per_type=min_cells_per_type)
            if res.errors and strict_validation:
                raise ValueError(
                    f"Reference {name}: label validation failed — "
                    + "; ".join(i.message for i in res.errors))
            for issue in res.errors:
                logger.warning(f"Reference {name}: {issue.message}")
        labels = adata.obs[label_col].astype(str)
        if labels.isna().any() or (labels == "nan").mean() > 0.05:
            logger.warning(f"Reference {name}: >5% null labels")

        if max_cells_per_ref and adata.n_obs > max_cells_per_ref:
            idx = _stratified_indices(
                labels.to_numpy(), max_cells_per_ref,
                np_rng(random_state, "combine_cap", i))
            adata = adata[np.sort(idx)]
        if normalize_genes:
            normalize_gene_names(adata)
        if target_genes is not None:
            keep = [g for g in adata.var_names if g in set(target_genes)]
            if not keep:
                raise ValueError(
                    f"Reference {name} shares no genes with the panel")
            adata = adata[:, keep]
        if normalize_data:
            ensure_normalized(adata)
        adata.obs[output_column] = adata.obs[label_col].astype(str)
        adata.obs[source_column] = name
        loaded.append(adata)

    shared = set(loaded[0].var_names)
    for adata in loaded[1:]:
        shared &= set(adata.var_names)
    if not shared:
        raise ValueError("References share no genes after name mapping")
    shared_genes = sorted(shared)
    logger.info(f"{len(shared_genes)} shared genes across "
                f"{len(loaded)} references")
    loaded = [a[:, shared_genes] for a in loaded]
    combined = _container.concat(loaded)

    labels = combined.obs[output_column].astype(str)
    keep_mask = ~labels.map(lambda l: _is_excluded(l, exclude_labels))
    counts = labels[keep_mask].value_counts()
    small = set(counts[counts < min_cells_per_type].index)
    if small and filter_min_cells:
        logger.info(f"Dropping {len(small)} cell types below "
                    f"{min_cells_per_type} cells: {sorted(small)[:5]}...")
        keep_mask &= ~labels.isin(small)
    elif small:
        logger.warning(f"{len(small)} cell types below {min_cells_per_type} "
                       f"cells kept (filter_min_cells=False): "
                       f"{sorted(small)[:5]}...")
    n_dropped = int((~keep_mask).sum())
    if n_dropped:
        logger.info(f"Excluding {n_dropped:,} cells "
                    "(bad labels / tiny types)")
    combined = combined[keep_mask.to_numpy()]
    logger.info(f"Combined reference: {combined.n_obs:,} cells × "
                f"{combined.n_vars:,} genes, "
                f"{combined.obs[output_column].nunique()} types")
    return combined


def _stratified_indices(labels: np.ndarray, n_target: int, rng) -> np.ndarray:
    """Proportional per-class sample of ``n_target`` indices."""
    classes, counts = np.unique(labels, return_counts=True)
    frac = n_target / labels.shape[0]
    out = []
    for cls, cnt in zip(classes, counts):
        idx = np.nonzero(labels == cls)[0]
        take = max(1, int(round(cnt * frac)))
        out.append(rng.choice(idx, size=min(take, cnt), replace=False))
    idx = np.concatenate(out)
    if idx.size > n_target:
        idx = rng.choice(idx, size=n_target, replace=False)
    return idx


def ensure_normalized(adata, target_sum: float = 1e4,
                      unsafe_force: bool = False, copy: bool = False):
    """Guarantee X is log1p target-sum normalized (safe paths only).

    Safe: raw counts found anywhere (re-normalize from them) or X already
    verified log1p_10k. Anything else raises unless ``unsafe_force``
    (reference loading.py:344-488).
    """
    if copy:
        adata = adata.copy()
    status = check_normalization_status(adata)
    state = status["x_state"]
    if state == "log1p_10k":
        return adata
    if status.get("raw_source") is not None:
        normalize_log1p_from_raw(adata, target_sum=target_sum)
        return adata
    if unsafe_force:
        logger.warning(
            f"ensure_normalized: X state '{state}' is not verifiable; "
            "proceeding because unsafe_force=True")
        return adata
    raise ValueError(
        f"Cannot safely normalize: X looks like '{state}' and no raw "
        "counts were found in layers/raw. Provide raw counts, pre-normalize "
        "to log1p 10k, or pass unsafe_force=True.")


# ---------------------------------------------------------------------------
# subsample_balanced — "Cap & Fill"
# ---------------------------------------------------------------------------


def _source_targets(counts: Dict[str, int], target_total: int,
                    min_cells_per_source: int,
                    source_balance: str = "proportional") -> Dict[str, int]:
    """Per-source allocation for one cell type's target total.

    Behavioral port of the reference ``_calculate_source_targets``
    (/root/reference/src/spatialcore/annotation/training.py:1543-1618):

    * ``"proportional"`` — each source contributes ``ceil(target · share)``
      of its availability share, floored at ``min_cells_per_source`` when it
      has that many cells (like the reference, this can slightly overshoot
      the target; only shortfall is redistributed, never trimmed).
    * ``"equal"`` — ``target // n_sources`` each (+1 for the first
      ``remainder`` sources in sorted order), capped at availability.

    Shortfall (sources without enough cells) is redistributed to sources
    with remaining capacity in sorted-name order.
    """
    if source_balance not in ("proportional", "equal"):
        raise ValueError(
            f"source_balance must be 'proportional' or 'equal', "
            f"got {source_balance!r}")
    sources = sorted(counts)
    total_available = sum(counts.values())
    alloc: Dict[str, int] = {}
    if source_balance == "proportional":
        for s in sources:
            available = counts[s]
            target = int(np.ceil(target_total * available / total_available))
            if available >= min_cells_per_source:
                target = max(target, min_cells_per_source)
            alloc[s] = min(target, available)
    else:
        per_source = target_total // len(sources)
        remainder = target_total % len(sources)
        for i, s in enumerate(sources):
            alloc[s] = min(per_source + (1 if i < remainder else 0),
                           counts[s])
    shortfall = target_total - sum(alloc.values())
    if shortfall > 0:
        for s in sources:
            if shortfall <= 0:
                break
            capacity = counts[s] - alloc[s]
            if capacity > 0:
                extra = min(capacity, shortfall)
                alloc[s] += extra
                shortfall -= extra
    return alloc


def _resolve_target_totals(
    type_counts: Dict[str, int],
    min_cells_per_type: int,
    max_cells_per_type: int,
    props: Optional[Dict[str, float]],
) -> Dict[str, int]:
    """Per-type target counts, honoring ``target_proportions``.

    Behavioral port of the reference ``_resolve_target_totals``
    (/root/reference/src/spatialcore/annotation/training.py:1101-1215):
    types at/below ``min_cells_per_type`` keep everything; without
    proportions each type is capped at ``max_cells_per_type``. With
    proportions, a fixed-point iteration finds the output size T such that
    each proportioned type contributes ``clip(prop·T, min_cells_per_type,
    available)`` and the rest contribute their capped counts.
    """
    if not props:
        return {ct: (int(n) if n <= min_cells_per_type
                     else int(min(max_cells_per_type, n)))
                for ct, n in type_counts.items()}

    missing = sorted(set(props) - set(type_counts))
    if missing:
        raise ValueError(
            "target_proportions include cell types not found in data: "
            + ", ".join(missing))
    eps = 1e-6
    sum_props = float(sum(props.values()))
    non_prop = [ct for ct in type_counts if ct not in props]
    if sum_props > 1.0 + eps:
        raise ValueError(
            f"target_proportions sum to {sum_props:.4f}, must be <= 1.0")
    if sum_props >= 1.0 - eps and non_prop:
        raise ValueError(
            "target_proportions sum to 1.0 but there are cell types without "
            "target proportions. Provide proportions for all types or "
            "reduce the total.")

    fixed: Dict[str, int] = {}
    variable_avail: Dict[str, int] = {}
    for ct, n in type_counts.items():
        if ct in props and n > min_cells_per_type:
            variable_avail[ct] = int(n)
        elif n <= min_cells_per_type:
            fixed[ct] = int(n)
        else:
            fixed[ct] = int(min(max_cells_per_type, n))
    fixed_total = sum(fixed.values())
    if not variable_avail:
        return fixed

    sum_var = sum(props[ct] for ct in variable_avail)
    if sum_var >= 1.0 - eps and fixed_total > 0:
        raise ValueError(
            "target_proportions leave no room for fixed counts. "
            "Reduce target_proportions or min_cells_per_type.")

    total = fixed_total
    if sum_var > eps and (1.0 - sum_var) > eps:
        total = int(round(fixed_total / (1.0 - sum_var)))
    total = max(total, fixed_total)

    targets_var: Dict[str, int] = {}
    for _ in range(50):
        targets_var = {
            ct: int(min(max(min_cells_per_type, int(props[ct] * total)), n))
            for ct, n in variable_avail.items()}
        new_total = fixed_total + sum(targets_var.values())
        if new_total == total:
            break
        total = new_total
    else:
        raise RuntimeError(
            "Failed to resolve target_proportions. "
            "Check target_proportions and cell counts.")

    targets = dict(fixed)
    targets.update(targets_var)
    total = sum(targets.values())
    for ct, prop in props.items():
        n = int(type_counts[ct])
        desired = int(prop * total)
        if n <= min_cells_per_type:
            logger.warning(
                f"Target proportion for '{ct}' cannot be met: only {n} "
                f"cells available (min_cells_per_type={min_cells_per_type}).")
        elif desired < min_cells_per_type:
            logger.warning(
                f"Target proportion for '{ct}' below min_cells_per_type; "
                f"using floor {min_cells_per_type} instead of {desired}.")
        elif desired > n:
            logger.warning(
                f"Target proportion for '{ct}' exceeds availability; "
                f"capping at {n} instead of {desired}.")
    return targets


@param_aliases(cell_type_column="label_column", seed="random_state")
def subsample_balanced(
    adata,
    label_column: str = "cell_type",
    max_cells_per_type: int = 5000,
    min_cells_per_type: int = 50,
    min_cells_per_source: int = 50,
    source_column: str = "reference_source",
    source_balance: str = "proportional",
    group_by_column: Optional[str] = None,
    target_proportions=None,
    random_state: int = 0,
    copy: bool = True,
):
    """Cap & Fill balancing: cap each cell type, fill fairly across sources.

    Types at/below ``min_cells_per_type`` keep all cells; larger types are
    capped at ``max_cells_per_type`` and downsampled with per-source targets
    from ``_source_targets`` (``source_balance`` "proportional" or "equal")
    so no single reference dominates. ``group_by_column`` (e.g. the CL ID
    column) groups labels semantically before balancing (reference
    training.py:1375-1389).

    ``target_proportions`` — a ``{cell_type: fraction}`` dict (or path to a
    JSON file of one) pinning each type's share of the FINAL output; per-type
    totals come from the fixed-point solver ``_resolve_target_totals``
    (reference training.py:1101-1215). ``copy=True`` (the reference
    default) materializes the subset; ``copy=False`` returns a slice.
    """
    group_col = group_by_column or label_column
    if group_col not in adata.obs.columns:
        raise ValueError(f"Column '{group_col}' not found in obs")
    if isinstance(target_proportions, (str, Path)):
        with open(target_proportions) as f:
            target_proportions = json.load(f)
    # fillna BEFORE grouping: astype(str) preserves NaN (pandas string
    # dtype) and nan != nan would silently drop every ungrouped cell
    groups = (adata.obs[group_col].astype(str).fillna("__ungrouped__")
              .to_numpy())
    has_source = source_column in adata.obs.columns
    sources = (adata.obs[source_column].astype(str).fillna("all").to_numpy()
               if has_source else np.full(adata.n_obs, "all"))

    group_order = pd.unique(groups)
    type_counts = {g: int((groups == g).sum()) for g in group_order}
    targets = _resolve_target_totals(type_counts, min_cells_per_type,
                                     max_cells_per_type, target_proportions)

    keep = []
    for gi, group in enumerate(group_order):
        g_idx = np.nonzero(groups == group)[0]
        target = targets[group]
        if g_idx.size <= target:
            keep.append(g_idx)
            continue
        counts = pd.Series(sources[g_idx]).value_counts().to_dict()
        alloc = _source_targets(counts, target, min_cells_per_source,
                                source_balance)
        rng = np_rng(random_state, "cap_fill", gi)
        for s, n_take in alloc.items():
            s_idx = g_idx[sources[g_idx] == s]
            if n_take >= s_idx.size:
                keep.append(s_idx)
            else:
                keep.append(rng.choice(s_idx, size=n_take, replace=False))
    idx = np.sort(np.concatenate(keep))
    logger.info(f"subsample_balanced: {adata.n_obs:,} → {idx.size:,} cells "
                f"(cap {max_cells_per_type}/type, "
                f"source_balance={source_balance})")
    sub = adata[idx]
    if copy and hasattr(sub, "copy"):
        sub = sub.copy()
    return sub


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def train_cell_type_model(
    adata,
    cell_type_column: str = "cell_type",
    epochs: int = 30,
    batch_size: int = 1024,
    learning_rate: float = 0.05,
    l2: float = 1e-4,
    balance_cell_type: bool = True,
    seed: int = 0,
    model_name: str = "spatialcore_tpu_model",
    checkpoint_dir=None,
    checkpoint_every: int = 10,
    resume: bool = True,
) -> CellTypeModel:
    """Train the multinomial LR classifier on log1p expression.

    Deterministic minibatch SGD (adamw) over standardized genes with
    class-balanced cross-entropy — the celltypist.train replacement
    (reference training.py:667-689). Runs as one jitted ``lax.scan`` per
    epoch. With ``checkpoint_dir`` set, params + optimizer state are
    checkpointed via orbax every ``checkpoint_every`` epochs and training
    resumes from the latest checkpoint when ``resume`` (aux-subsystem
    parity, SURVEY.md §5 checkpoint/resume).
    """
    start = time.time()
    if cell_type_column not in adata.obs.columns:
        raise ValueError(f"Column '{cell_type_column}' not found in obs")
    X = adata.X
    if sp.issparse(X):
        X = np.asarray(X.todense())
    X = np.asarray(X, np.float32)
    labels = adata.obs[cell_type_column].astype(str).to_numpy()
    classes = sorted(pd.unique(labels).tolist())
    if len(classes) < 2:
        raise ValueError("Need at least 2 cell types to train")
    class_to_idx = {c: i for i, c in enumerate(classes)}
    y = np.array([class_to_idx[l] for l in labels], np.int32)
    n, g = X.shape
    c = len(classes)
    logger.info(f"Training LR: {n:,} cells × {g:,} genes → {c} classes "
                f"({epochs} epochs, batch {batch_size})")

    mean = X.mean(axis=0)
    std = X.std(axis=0)
    std = np.where(std < 1e-8, 1.0, std).astype(np.float32)
    Z = np.clip((X - mean) / std, -_CLIP_Z, _CLIP_Z).astype(np.float32)

    if balance_cell_type:
        freq = np.bincount(y, minlength=c).astype(np.float64)
        cw = (n / (c * freq)).astype(np.float32)
    else:
        cw = np.ones(c, np.float32)

    batch_size = min(batch_size, n)
    steps = max(n // batch_size, 1)
    opt = optax.adamw(learning_rate, weight_decay=l2)

    Zj = jnp.asarray(Z)
    yj = jnp.asarray(y)
    cwj = jnp.asarray(cw)

    def loss_fn(params, xb, yb):
        W, b = params
        logits = xb @ W + b
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(logp, yb[:, None], axis=1)[:, 0]
        return jnp.mean(nll * cwj[yb])

    @jax.jit
    def epoch(params, opt_state, perm):
        def step(carry, s):
            params, opt_state = carry
            idx = jax.lax.dynamic_slice(perm, (s * batch_size,),
                                        (batch_size,))
            loss, grads = jax.value_and_grad(loss_fn)(
                params, Zj[idx], yj[idx])
            updates, opt_state = opt.update(grads, opt_state, params)
            return (optax.apply_updates(params, updates), opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            step, (params, opt_state), jnp.arange(steps))
        return params, opt_state, jnp.mean(losses)

    params = (jnp.zeros((g, c), jnp.float32), jnp.zeros((c,), jnp.float32))
    opt_state = opt.init(params)

    manager = None
    start_epoch = 0
    if checkpoint_dir is not None:
        import orbax.checkpoint as ocp
        from pathlib import Path as _Path

        manager = ocp.CheckpointManager(
            _Path(checkpoint_dir).absolute(),
            options=ocp.CheckpointManagerOptions(max_to_keep=2))
        latest = manager.latest_step()
        if resume and latest is not None:
            restored = manager.restore(
                latest, args=ocp.args.StandardRestore(
                    {"params": params, "opt_state": opt_state}))
            params = tuple(restored["params"])
            opt_state = jax.tree.map(lambda x: x, restored["opt_state"])
            start_epoch = latest + 1
            logger.info(f"  resumed from checkpoint epoch {latest}")

    loss = jnp.float32(float("nan"))
    for e in range(start_epoch, epochs):
        perm = jax.random.permutation(key_for(seed, "train_epoch", e), n)
        params, opt_state, loss = epoch(params, opt_state, perm)
        if e % max(epochs // 5, 1) == 0 or e == epochs - 1:
            logger.info(f"  epoch {e + 1}/{epochs}: loss={float(loss):.4f}")
        if manager is not None and (
                (e + 1) % checkpoint_every == 0 or e == epochs - 1):
            import orbax.checkpoint as ocp

            manager.save(e, args=ocp.args.StandardSave(
                {"params": params, "opt_state": opt_state}))
    if manager is not None:
        manager.wait_until_finished()
        manager.close()
    if start_epoch >= epochs:
        # fully resumed: compute a forward-only loss over the full data for
        # metadata (running epoch() here would apply a discarded epoch of
        # optimizer updates and report a stale shuffle's mean loss)
        loss = jax.jit(loss_fn)(params, Zj, yj)

    W, b = (np.asarray(p) for p in params)
    model = CellTypeModel(
        genes=list(adata.var_names), classes=classes, W=W, b=b,
        scaler_mean=mean.astype(np.float32), scaler_std=std,
        metadata={
            "model_name": model_name,
            "n_training_cells": int(n),
            "epochs": epochs, "batch_size": batch_size,
            "learning_rate": learning_rate, "l2": l2,
            "balance_cell_type": balance_cell_type, "seed": seed,
            "final_loss": float(loss),
            "trained_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        })
    logger.info(f"Training done in {time.time() - start:.1f}s "
                f"(final loss {float(loss):.4f})")
    return model


@param_aliases(cell_type_column="label_column", seed="random_state")
def train_celltypist_model(
    adata,
    label_column: str = "cell_type",
    model_name: str = "custom_model",
    output_path: Optional[Union[str, Path]] = None,
    use_SGD: bool = True,
    mini_batch: bool = True,
    balance_cell_type: bool = True,
    feature_selection: bool = False,
    n_jobs: int = -1,
    max_iter: int = 100,
    epochs: int = 30,
    batch_size: int = 1024,
    batch_number: int = 200,
    learning_rate: float = 0.05,
    l2: float = 1e-4,
    random_state: int = 0,
    checkpoint_dir=None,
    checkpoint_every: int = 10,
    resume: bool = True,
) -> CellTypeModel:
    """Reference-signature trainer (ref training.py:556-729), device path.

    Thin front-end over ``train_cell_type_model``: the device implementation
    is always on-device minibatch SGD, so ``use_SGD``/``mini_batch``/
    ``n_jobs`` are accepted for drop-in compatibility and logged when they
    request the sklearn-only paths; ``max_iter`` substitutes for ``epochs``
    when ``mini_batch=False`` (the reference's full-batch mode), and
    ``batch_number`` caps the number of minibatch steps per epoch by
    raising ``batch_size`` when needed. ``feature_selection`` runs the
    celltypist two-pass scheme for real: train, keep the union of each
    class's top-300 |weight| genes, retrain on the subset.
    ``output_path`` saves the artifacts directory after training.
    """
    if not use_SGD or n_jobs != -1:
        logger.info("train_celltypist_model: use_SGD/n_jobs are sklearn "
                    "knobs; this build always runs on-device SGD")
    n_epochs = epochs if mini_batch else max_iter
    n = adata.n_obs
    eff_batch = batch_size
    if mini_batch and batch_number and n // batch_size > batch_number:
        eff_batch = int(np.ceil(n / batch_number))
        logger.info(f"train_celltypist_model: batch_size {batch_size} → "
                    f"{eff_batch} to honor batch_number={batch_number}")

    kwargs = dict(cell_type_column=label_column, epochs=n_epochs,
                  batch_size=eff_batch, learning_rate=learning_rate, l2=l2,
                  balance_cell_type=balance_cell_type, seed=random_state,
                  model_name=model_name, checkpoint_dir=checkpoint_dir,
                  checkpoint_every=checkpoint_every, resume=resume)
    model = train_cell_type_model(adata, **kwargs)

    if feature_selection:
        top = 300
        order = np.argsort(-np.abs(model.W), axis=0)[:top]   # [top, C]
        keep = np.zeros(model.n_genes, bool)
        keep[np.unique(order)] = True
        genes = [g for g, k in zip(model.genes, keep) if k]
        logger.info(f"feature_selection: retraining on {len(genes)}/"
                    f"{model.n_genes} top-|W| genes")
        sub = adata[:, genes]
        model = train_cell_type_model(sub, **kwargs)
        model.metadata["feature_selection"] = True

    if output_path is not None:
        save_model_artifacts(model, output_path, model_name=model_name)
    return model


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------


@param_aliases(classes="cell_types")
def generate_color_scheme(
    cell_types: Sequence[str],
    custom_colors: Optional[Dict[str, str]] = None,
    palette: Optional[Sequence[str]] = None,
) -> Dict[str, str]:
    """Deterministic type→hex colors (sorted labels, cycled palette).

    ``custom_colors`` entries override the palette assignment per type
    (reference training.py:845-900).
    """
    base = list(palette or HIGH_CONTRAST_PALETTE)
    colors = {c: base[i % len(base)] for i, c in enumerate(sorted(cell_types))}
    if custom_colors:
        colors.update({c: v for c, v in custom_colors.items()
                       if c in colors})
    return colors


@param_aliases(colors="custom_colors")
def save_model_artifacts(
    model: CellTypeModel,
    output_dir: Union[str, Path],
    model_name: Optional[str] = None,
    training_metadata: Optional[Dict] = None,
    custom_colors: Optional[Dict[str, str]] = None,
) -> Dict[str, Path]:
    """Save model (.npz), metadata (.json), and colors (.json).

    ``model_name`` overrides the name baked into the model's metadata;
    ``training_metadata`` is merged into the saved metadata JSON
    (reference training.py:907-1021).
    """
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    name = model_name or model.metadata.get("model_name", "model")
    if training_metadata:
        model.metadata = {**model.metadata, **dict(training_metadata)}
    model.metadata["model_name"] = name
    model_path = model.save(out / f"{name}.npz")
    colors = generate_color_scheme(model.classes,
                                   custom_colors=custom_colors)
    colors_path = out / f"{name}_colors.json"
    with open(colors_path, "w") as f:
        json.dump(colors, f, indent=2)
    return {"model": model_path,
            "metadata": model_path.with_suffix(".json"),
            "colors": colors_path}


def get_panel_genes(adata) -> list:
    """The query panel gene list (pipeline Stage 1, reference training.py:460)."""
    return list(adata.var_names)


@param_aliases(model="combined_adata")
def get_training_summary(combined_adata,
                         label_column: str = "cell_type"):
    """Cell-type distribution of the combined training data.

    Returns a DataFrame with cell_type / n_cells / pct_total (reference
    training.py:787-809). Passing a trained ``CellTypeModel`` instead
    returns the legacy dict summary of the model itself.
    """
    if isinstance(combined_adata, CellTypeModel):
        model = combined_adata
        return {"model_name": model.metadata.get("model_name"),
                "n_genes": model.n_genes, "n_classes": model.n_classes,
                "classes": model.classes,
                "n_training_cells": model.metadata.get("n_training_cells"),
                "final_loss": model.metadata.get("final_loss")}
    counts = combined_adata.obs[label_column].value_counts()
    return pd.DataFrame({
        "cell_type": counts.index.astype(str),
        "n_cells": counts.to_numpy(),
        "pct_total": 100.0 * counts.to_numpy() / combined_adata.n_obs,
    })
