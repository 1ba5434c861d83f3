"""Seeded, device-independent randomness utilities.

The reference derives permutations from ``np.random.default_rng(seed)``
(/root/reference/src/spatialcore/spatial/autocorrelation.py:839), which is
reproducible only serially. Here every random stream is a counter-based JAX
threefry key derived from ``(seed, *stream_ids)`` so results are bitwise
identical regardless of device count, sharding, or evaluation order
(SURVEY.md §7 design decision 2).
"""

from __future__ import annotations

from typing import Union

import jax
import jax.numpy as jnp
import numpy as np


def key_for(seed: int, *stream: Union[int, str]) -> jax.Array:
    """Derive a PRNG key from a base seed and a hierarchical stream path.

    String components are hashed stably (FNV-1a, not Python's randomized
    ``hash``) so e.g. ``key_for(0, "moran", gene_idx, perm_idx)`` is stable
    across processes.
    """
    key = jax.random.key(seed)
    for part in stream:
        if isinstance(part, str):
            part = _fnv1a(part)
        if isinstance(part, (int, np.integer)):
            part = np.uint32(int(part) & 0xFFFFFFFF)
        else:  # traced value inside jit/vmap
            part = jnp.asarray(part).astype(jnp.uint32)
        key = jax.random.fold_in(key, part)
    return key


def _fnv1a(s: str) -> int:
    h = 0x811C9DC5
    for ch in s.encode():
        h = ((h ^ ch) * 0x01000193) & 0xFFFFFFFF
    return h


def np_rng(seed: int, *stream: Union[int, str]) -> np.random.Generator:
    """Host-side numpy Generator seeded from the same hierarchical path.

    For cheap host decisions (subsampling, plot sampling) that must be
    reproducible but never touch the device.
    """
    parts = [seed] + [_fnv1a(p) if isinstance(p, str) else int(p)
                      for p in stream]
    return np.random.default_rng(parts)


def permutation_keys(seed: int, n_permutations: int, stream: str = "perm") -> jax.Array:
    """A stacked array of ``n_permutations`` independent keys."""
    base = key_for(seed, stream)
    return jax.random.split(base, n_permutations)


def batch_permutations(
    seed: int,
    n: int,
    n_permutations: int,
    stream: str = "perm",
) -> jax.Array:
    """Generate ``[n_permutations, n]`` int32 permutation index rows.

    Each row p is an independent uniform permutation of ``arange(n)`` keyed by
    ``(seed, stream, p)`` — placement-independent and bitwise reproducible.
    """
    keys = permutation_keys(seed, n_permutations, stream)
    perm_one = lambda k: jax.random.permutation(k, n).astype(jnp.int32)
    return jax.vmap(perm_one)(keys)


# ---------------------------------------------------------------------------
# Feistel pseudo-random permutations (sort-free, O(n) elementwise)
# ---------------------------------------------------------------------------

_FEISTEL_ROUNDS = 8


def _feistel_bijection(x: jax.Array, round_keys: jax.Array, bits: int) -> jax.Array:
    """Keyed bijection on [0, 4**bits) via a balanced Feistel network.

    ``x`` uint32; each round mixes the low half with a multiply-xor-shift
    hash of the high half. Bijectivity holds for any round function, so the
    result is a valid permutation regardless of hash quality; 8 rounds make
    it statistically indistinguishable from uniform for Monte-Carlo use.
    """
    mask = jnp.uint32((1 << bits) - 1)
    left = (x >> bits).astype(jnp.uint32)
    right = (x & mask).astype(jnp.uint32)
    for r in range(_FEISTEL_ROUNDS):
        h = (right ^ round_keys[r]) * jnp.uint32(0x9E3779B1)
        h = h ^ (h >> 15)
        h = h * jnp.uint32(0x85EBCA77)
        h = h ^ (h >> 13)
        left, right = right, (left ^ h) & mask
    return ((left.astype(jnp.uint32) << bits) | right).astype(jnp.uint32)


def feistel_apply(key: jax.Array, idx: jax.Array, n: int) -> jax.Array:
    """Evaluate the keyed Feistel permutation at arbitrary positions.

    ``feistel_apply(key, idx, n)[p] == feistel_permutation(key, n)[idx[p]]``
    bitwise, without materializing the full [n] permutation or paying a
    random gather to reorder it — the bijection is pure elementwise math,
    so composing with a fixed relabeling (``idx``) is free. The banded
    null kernels precompute their padded relabel indices once and call
    this per draw: one row gather per draw instead of three
    (raw-permutation reorder + relabel compose + value rows).

    ``idx`` must contain values in [0, n); duplicates are fine (the
    result then repeats the corresponding permutation entries).
    """
    if n < 2:
        return jnp.zeros(idx.shape, jnp.int32)
    bits = max((int(n - 1).bit_length() + 1) // 2, 1)
    if (1 << (2 * bits)) < n:
        bits += 1
    round_keys = jax.random.randint(
        key, (_FEISTEL_ROUNDS,), 0, jnp.iinfo(jnp.int32).max,
        dtype=jnp.int32).astype(jnp.uint32)
    y = _feistel_bijection(idx.astype(jnp.uint32), round_keys, bits)

    def cond(y):
        return jnp.any(y >= n)

    def body(y):
        return jnp.where(y >= n, _feistel_bijection(y, round_keys, bits), y)

    y = jax.lax.while_loop(cond, body, y)
    return y.astype(jnp.int32)


def feistel_permutation(key: jax.Array, n: int) -> jax.Array:
    """Pseudo-random permutation of ``arange(n)`` without a device sort.

    ``jax.random.permutation`` sorts random keys — O(n log n), which
    dominates fast permutation-null kernels at n=1M. This builds
    the permutation as pure elementwise math: a keyed Feistel bijection on
    the next power-of-4 domain, shrunk to [0, n) by cycle-walking (iterate
    the bijection until the value lands in range — exactly uniform over the
    subdomain's induced permutations, Black & Rogaway 2002).

    Deterministic per (key, n), independent of device count/sharding.
    """
    if n < 2:
        return jnp.zeros((n,), jnp.int32)
    return feistel_apply(key, jnp.arange(n, dtype=jnp.uint32), n)
