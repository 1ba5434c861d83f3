"""Mesh construction and canonical shardings for spatialcore_tpu.

Axes: ``cells`` (data-parallel over the cell dimension) × ``genes``
(model-parallel over the gene/permutation dimension). On a single chip every
sharding degenerates to replication, so the same code runs everywhere.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def auto_mesh(
    n_devices: Optional[int] = None,
    cell_shards: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A (cells × genes) mesh over the available devices.

    By default all devices go to the ``genes`` axis — permutation nulls over
    genes are embarrassingly parallel, the fixed-degree graph stays
    replicated, and no collectives hit the hot loop. Pass ``cell_shards`` to
    split the cell axis instead (e.g. when N is too large per device).

    Multi-host: when run under multiple JAX processes, the host dimension
    folds into the ``cells`` axis — cell sharding has no hot-loop
    collectives (only the one-time standardize psum and output layout), so
    cross-host traffic crosses the network exactly once per statistic,
    while the gene/permutation axis stays inside each host's device
    interconnect.
    """
    if devices is None and jax.process_count() > 1:
        from jax.experimental import mesh_utils

        n_local = jax.local_device_count()
        n_hosts = jax.process_count()
        cs = cell_shards or n_hosts
        if cs % n_hosts != 0:
            raise ValueError(
                f"cell_shards={cs} must be a multiple of the host count "
                f"{n_hosts} (the DCN dimension folds into the cells axis)")
        per_host_cells = cs // n_hosts
        if n_local % per_host_cells != 0:
            raise ValueError(
                f"cell_shards={cs} does not tile {n_hosts} hosts × "
                f"{n_local} local devices")
        arr = mesh_utils.create_hybrid_device_mesh(
            (per_host_cells, n_local // per_host_cells),
            (n_hosts, 1),
        )  # [n_hosts*per_host_cells, local/per_host_cells]
        return Mesh(arr, ("cells", "genes"))
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    cs = cell_shards or 1
    if n % cs != 0:
        raise ValueError(f"cell_shards={cs} does not divide {n} devices")
    arr = np.array(devs).reshape(cs, n // cs)
    return Mesh(arr, ("cells", "genes"))


def gene_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """[..., genes]-last sharding: shard the trailing gene axis."""
    spec = [None] * (ndim - 1) + ["genes"]
    return NamedSharding(mesh, P(*spec))


def cell_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """[cells, ...] sharding: shard the leading cell axis."""
    spec = ["cells"] + [None] * (ndim - 1)
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
