"""Sort + dedup + count aggregation on device.

Reference analog: zotmer kmerize's in-RAM ``buffer.sort(); dedup -> (kmer,
count)`` step (SURVEY.md section 3.1). Device shape: ``lax.sort`` over the
(hi, lo) u32 key pair, then segment-extent counting -- for the kmerize path all weights are 0/1 and invalid
entries carry the sentinel key, so a segment's count is simply its extent
(last_pos - first_pos + 1). No scan, no scatter-add contention.

Outputs keep static shapes: capacity-N arrays, ``n_unique`` valid entries up
front, sentinel keys / zero counts beyond (SURVEY.md section 7 "dynamic output
sizes").
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from zotpu.kernels.pack import SENT32


def sort_by_key(hi, lo, *payload):
    """Lexicographic sort by (hi, lo), carrying payload arrays along."""
    return jax.lax.sort((hi, lo) + tuple(payload), num_keys=2)


def _boundaries(hi, lo):
    n = hi.shape[0]
    first = jnp.concatenate([
        jnp.ones((1,), bool),
        (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1]),
    ])
    last = jnp.concatenate([first[1:], jnp.ones((1,), bool)])
    return first, last


@jax.jit
def dedup_mark_sorted(hi, lo):
    """Sorted (hi, lo) with sentinel padding -> dups sentinel-MARKED in place.

    Every non-sentinel entry counts 1 (kmerize path). Returns
    (uhi, ulo, counts, n_unique) with capacity n, where each key segment's
    FIRST occurrence keeps the key and carries the segment count, and every
    duplicate/invalid row becomes sentinel with count 0 -- rows are NOT
    compacted to the front. Consumers that re-sort their input anyway
    (``setops.set_op``, the accumulator merge) accept this directly, which
    keeps the second full-width stable sort (the most expensive op after the
    key sort itself, ~1/3 of the round-1 step) OFF the hot path; call
    ``compact_sorted`` only where a dense ``[:n]`` prefix is required.

    Segment counts come from a reverse-cummin of next-boundary positions:
    scans only, no scatter or gather.
    """
    n = hi.shape[0]
    first, _ = _boundaries(hi, lo)
    is_valid = ~((hi == SENT32) & (lo == SENT32))
    pos = jnp.arange(n, dtype=jnp.int32)
    # next_first[i] = position of the next segment start after i (n if none):
    # inclusive reverse cummin of (first ? pos : n), shifted left by one.
    arr = jnp.where(first, pos, n)
    inc = jax.lax.cummin(arr, axis=0, reverse=True)
    next_first = jnp.concatenate([inc[1:], jnp.full((1,), n, jnp.int32)])
    counts = (next_first - pos).astype(jnp.uint32)
    keep = first & is_valid
    uhi = jnp.where(keep, hi, SENT32)
    ulo = jnp.where(keep, lo, SENT32)
    cnt = jnp.where(keep, counts, jnp.uint32(0))
    n_unique = jnp.sum(keep.astype(jnp.int32))
    return uhi, ulo, cnt, n_unique


@jax.jit
def compact_sorted(hi, lo, cnt):
    """Move valid (non-sentinel) rows to the front, preserving key order.

    Scatter-free: ONE stable sort on the validity flag (rows are already in
    key order among themselves, so a stable flag sort yields the sorted dense
    prefix). This is the op ``dedup_mark_sorted`` deliberately defers."""
    flag = ((hi == SENT32) & (lo == SENT32)).astype(jnp.uint32)
    flag, uhi, ulo, c = jax.lax.sort((flag, hi, lo, cnt), num_keys=1,
                                     is_stable=True)
    kept = flag == 0
    uhi = jnp.where(kept, uhi, SENT32)
    ulo = jnp.where(kept, ulo, SENT32)
    c = jnp.where(kept, c, jnp.uint32(0))
    return uhi, ulo, c


@jax.jit
def dedup_count_sorted(hi, lo):
    """Sorted (hi, lo) with sentinel padding -> unique keys + u32 counts,
    COMPACTED to the front: (uhi, ulo, counts, n_unique); rows >= n_unique
    are sentinel/0. Mark + compact; prefer ``dedup_mark_sorted`` on hot paths
    whose consumers re-sort anyway."""
    uhi, ulo, cnt, n_unique = dedup_mark_sorted(hi, lo)
    uhi, ulo, cnt = compact_sorted(uhi, ulo, cnt)
    return uhi, ulo, cnt, n_unique


@functools.partial(jax.jit, static_argnames=("compact",))
def kmer_sort_dedup(hi, lo, w, compact: bool = True):
    """Full single-chip sort+dedup: pack output -> sorted unique keys+counts.

    compact=False returns the sentinel-marked (uncompacted) form for
    consumers that re-sort (the device accumulator), compact=True the
    mark+stable-compaction form."""
    del w  # validity is already encoded as the sentinel key
    hi, lo = jax.lax.sort((hi, lo), num_keys=2)
    if compact:
        return dedup_count_sorted(hi, lo)
    return dedup_mark_sorted(hi, lo)


def saturating_add_u32(a, b):
    """u32 + u32 saturating at 0xFFFFFFFF (semantics.py count policy)."""
    s = a + b
    return jnp.where(s < a, jnp.uint32(0xFFFFFFFF), s)
