"""Raster geometry kernels: morphology + connected components on device.

Replaces the reference's R subprocess geometry (sf/GEOS buffer-union-shrink +
concaveman hulls, /root/reference/src/spatialcore/spatial/r_functions.R:34-124)
with a JAX raster pipeline (SURVEY.md §7 decision 4):

    rasterize target cells → dilate by r_buffer (disk conv)
    → erode by r_shrink (dual of dilate) → connected components
    (pointer-jumping min-label propagation) → per-cell lookup.

Morphology runs as 2D convolutions with disk kernels (dense device math), the
component labeling as a ``lax.while_loop`` whose body is one 3×3 min-window
plus two gather path-compression steps — O(log diameter) iterations instead
of O(diameter) naive flooding. Grid resolution is the fidelity knob vs the
exact vector geometry.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_BG = jnp.int32(2 ** 30)  # background sentinel, larger than any flat index


def disk_kernel(radius_px: int) -> np.ndarray:
    """Binary disk of the given pixel radius (inclusive)."""
    r = int(radius_px)
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    return (x * x + y * y <= r * r).astype(np.float32)


def _conv2d_same(img: jax.Array, kernel: jax.Array) -> jax.Array:
    return jax.lax.conv_general_dilated(
        img[None, None, :, :], kernel[None, None, :, :],
        window_strides=(1, 1), padding="SAME")[0, 0]


def dilate(mask: jax.Array, radius_px: int) -> jax.Array:
    """Binary dilation by a disk: any covered pixel becomes foreground."""
    if radius_px <= 0:
        return mask
    k = jnp.asarray(disk_kernel(radius_px))
    return (_conv2d_same(mask.astype(jnp.float32), k) > 0.5)


def erode(mask: jax.Array, radius_px: int) -> jax.Array:
    """Binary erosion by a disk: keep pixels whose whole disk is foreground.

    Outside-the-image counts as BACKGROUND (the complement-dilation dual
    with zero padding silently treated it as foreground, so border-touching
    masks never eroded at the border).
    """
    if radius_px <= 0:
        return mask
    k = jnp.asarray(disk_kernel(radius_px))
    ksum = jnp.sum(k)
    return _conv2d_same(mask.astype(jnp.float32), k) > ksum - 0.5


@functools.partial(jax.jit, static_argnames=("max_iter",))
def connected_components(mask: jax.Array, max_iter: int = 256) -> jax.Array:
    """8-connected component labels for a binary [H, W] mask.

    Returns int32 [H, W]: for foreground pixels the minimum flat index of
    their component (a stable, deterministic component id); background gets
    a large sentinel. Pointer-jumping: each iteration takes the 3×3
    neighborhood min then twice compresses paths via ``L = L[L]`` gathers,
    which converges in ~log(diameter) iterations.
    """
    H, W = mask.shape
    hw = H * W
    flat_ids = jnp.arange(hw, dtype=jnp.int32).reshape(H, W)
    labels = jnp.where(mask, flat_ids, _BG)

    def neighbor_min(lab):
        padded = jnp.pad(lab, 1, constant_values=_BG)
        m = lab
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                m = jnp.minimum(m, padded[1 + dy:1 + dy + H,
                                          1 + dx:1 + dx + W])
        return jnp.where(mask, m, _BG)

    def compress(lab):
        flat = lab.ravel()
        safe = jnp.minimum(flat, hw - 1)
        return jnp.where(mask, jnp.minimum(lab, flat[safe].reshape(H, W)),
                         _BG)

    def cond(state):
        lab, prev, it = state
        return (it < max_iter) & jnp.any(lab != prev)

    def body(state):
        lab, _, it = state
        new = neighbor_min(lab)
        new = compress(compress(new))
        return new, lab, it + 1

    init = (compress(neighbor_min(labels)), labels, jnp.int32(0))
    labels, _, _ = jax.lax.while_loop(cond, body, init)
    return labels


class RasterDomains(NamedTuple):
    labels: jax.Array      # int32 [H, W] component ids (_BG for background)
    mask: jax.Array        # bool  [H, W] final shrunken foreground
    cell_label: jax.Array  # int32 [N] per-cell component id (_BG outside)


@functools.partial(jax.jit, static_argnames=("shape", "r_buffer", "r_shrink"))
def buffer_union_shrink(
    pix_yx: jax.Array,       # int32 [Nt, 2] target-cell pixel coords
    all_pix_yx: jax.Array,   # int32 [N, 2] pixel coords of cells to assign
    shape: Tuple[int, int],
    r_buffer: int,
    r_shrink: int,
) -> RasterDomains:
    """Full raster Buffer-Union-Shrink + labeling + cell assignment."""
    H, W = shape
    grid = jnp.zeros((H, W), bool).at[pix_yx[:, 0], pix_yx[:, 1]].set(True)
    grown = dilate(grid, r_buffer)
    shrunk = erode(grown, r_shrink)
    labels = connected_components(shrunk)
    cell_label = labels[all_pix_yx[:, 0], all_pix_yx[:, 1]]
    return RasterDomains(labels=labels, mask=shrunk, cell_label=cell_label)


def label_adjacency(labels_np: np.ndarray, reach_px: int = 2):
    """Pairs of distinct component ids within ``reach_px`` of each other.

    Host-side: a handful of array shifts over the label image (components
    after erosion are disjoint, so raster adjacency stands in for the
    reference's ``st_intersects`` on hull polygons, r_functions.R:203).
    """
    bg = int(_BG)
    pairs = set()
    H, W = labels_np.shape
    for dy in range(-reach_px, reach_px + 1):
        for dx in range(-reach_px, reach_px + 1):
            if dy == 0 and dx == 0:
                continue
            a = labels_np[max(0, dy):H + min(0, dy),
                          max(0, dx):W + min(0, dx)]
            b = labels_np[max(0, -dy):H + min(0, -dy),
                          max(0, -dx):W + min(0, -dx)]
            both = (a != bg) & (b != bg) & (a != b)
            if both.any():
                for u, v in zip(a[both].ravel(), b[both].ravel()):
                    pairs.add((min(int(u), int(v)), max(int(u), int(v))))
    return pairs


def extract_boundaries(labels_np: np.ndarray, origin, pixel_size: float):
    """Per-component boundary-pixel coordinates (marching-squares-lite).

    Returns {component_id: [M, 2] float coords} — boundary pixel centers in
    data units, the raster stand-in for the reference's concave hull
    polygons. Suitable for plotting domain outlines.
    """
    bg = int(_BG)
    H, W = labels_np.shape
    fg = labels_np != bg
    interior = np.ones_like(fg)
    interior[1:, :] &= fg[:-1, :]
    interior[:-1, :] &= fg[1:, :]
    interior[:, 1:] &= fg[:, :-1]
    interior[:, :-1] &= fg[:, 1:]
    boundary = fg & ~interior
    out = {}
    ys, xs = np.nonzero(boundary)
    labs = labels_np[ys, xs]
    for lab in np.unique(labs):
        sel = labs == lab
        coords = np.column_stack([
            origin[0] + (xs[sel] + 0.5) * pixel_size,
            origin[1] + (ys[sel] + 0.5) * pixel_size,
        ])
        out[int(lab)] = coords.astype(np.float32)
    return out


def extract_boundary_polygons(labels_np: np.ndarray, origin,
                              pixel_size: float):
    """Ordered closed contour chains per component (marching squares).

    Unlike :func:`extract_boundaries` (an unordered boundary-pixel cloud),
    this walks the pixel-edge graph into ORDERED vertex loops — the
    GIS-style polygon export matching the reference's concave-hull
    deliverable (r_functions.R:77-84). Directed edges keep the component on
    the left, so outer rings and hole rings come out with opposite
    orientation. Returns {component_id: [loop [M, 2] float32, ...]} in data
    units; vertices are raster-corner positions (fidelity = pixel size).
    """
    from collections import defaultdict

    bg = int(_BG)
    out = {}
    H, W = labels_np.shape
    fg_all = labels_np != bg
    # ONE pass over the image per direction (the per-label version
    # rescanned the full [H, W] grid once per component — O(L·H·W) host
    # work and tens of GB of traffic at a few hundred domains); a
    # boundary edge exists wherever the neighbor pixel carries a
    # DIFFERENT label (background or another component)
    diff = {}
    for name, (dr, dc) in (("up", (-1, 0)), ("down", (1, 0)),
                           ("left", (0, -1)), ("right", (0, 1))):
        nb = np.full_like(labels_np, bg)
        rs = slice(max(dr, 0), H + min(dr, 0))
        rd = slice(max(-dr, 0), H + min(-dr, 0))
        cs = slice(max(dc, 0), W + min(dc, 0))
        cd = slice(max(-dc, 0), W + min(-dc, 0))
        nb[rd, cd] = labels_np[rs, cs]
        diff[name] = fg_all & (nb != labels_np)
    # corner coordinates: (x=c, y=r); component kept on the left
    edge_parts, lab_parts = [], []
    r, c = np.nonzero(diff["up"])         # bg above: (c, r) -> (c+1, r)
    edge_parts.append(np.stack([c, r, c + 1, r], 1))
    lab_parts.append(labels_np[r, c])
    r, c = np.nonzero(diff["right"])      # bg right: (c+1, r) -> (c+1, r+1)
    edge_parts.append(np.stack([c + 1, r, c + 1, r + 1], 1))
    lab_parts.append(labels_np[r, c])
    r, c = np.nonzero(diff["down"])       # bg below: (c+1, r+1) -> (c, r+1)
    edge_parts.append(np.stack([c + 1, r + 1, c, r + 1], 1))
    lab_parts.append(labels_np[r, c])
    r, c = np.nonzero(diff["left"])       # bg left: (c, r+1) -> (c, r)
    edge_parts.append(np.stack([c, r + 1, c, r], 1))
    lab_parts.append(labels_np[r, c])
    E_all = np.concatenate(edge_parts, 0)
    lab_all = np.concatenate(lab_parts, 0)
    order = np.argsort(lab_all, kind="stable")
    E_sorted, lab_sorted = E_all[order], lab_all[order]
    starts = np.searchsorted(lab_sorted,
                             np.unique(lab_sorted))

    for li, lab in enumerate(np.unique(lab_sorted)):
        stop = (starts[li + 1] if li + 1 < len(starts)
                else len(lab_sorted))
        E = E_sorted[starts[li]:stop]
        # chain directed edges into loops
        by_start = defaultdict(list)
        for i, (x0, y0, x1, y1) in enumerate(E):
            by_start[(int(x0), int(y0))].append(i)
        used = np.zeros(len(E), bool)
        loops = []
        for i0 in range(len(E)):
            if used[i0]:
                continue
            loop = [(int(E[i0, 0]), int(E[i0, 1]))]
            cur = i0
            while True:
                used[cur] = True
                end = (int(E[cur, 2]), int(E[cur, 3]))
                loop.append(end)
                nxt = None
                for j in by_start.get(end, ()):
                    if not used[j]:
                        nxt = j
                        break
                if nxt is None:
                    break
                cur = nxt
            if len(loop) >= 4 and loop[0] == loop[-1]:
                arr = np.asarray(loop, np.float64)
                arr[:, 0] = origin[0] + arr[:, 0] * pixel_size
                arr[:, 1] = origin[1] + arr[:, 1] * pixel_size
                loops.append(arr.astype(np.float32))
        loops.sort(key=len, reverse=True)
        out[int(lab)] = loops
    return out
