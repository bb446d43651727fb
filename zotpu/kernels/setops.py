"""Vectorized sorted-set algebra on device.

Reference analog: zotmer's two-pointer merge / set-op sweeps
(SURVEY.md sections 3.2-3.3). Device shape: concatenate the two sorted
unique inputs with per-side count tags, ``lax.sort``, then combine neighbours
-- because both inputs are unique, every key segment has at most 2 members, so
the combine is a single shifted compare instead of a scan. Outputs are
compacted to the front of a static-capacity array (nA + nB) with sentinel
padding and a valid count.

N-way merge = a tree of these pairwise merges (workloads/merge.py), matching
the reference's k-way heap merge semantics (counts saturate per semantics.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from zotpu.kernels.pack import SENT32
from zotpu.kernels.sortdedup import saturating_add_u32


def _combine_sorted(hi, lo, ca, cb, op: str):
    """Post-merge combine: a SORTED stream of tagged (key, ca, cb) rows (each
    side's keys unique, so segments have <= 2 members) -> per-key policy.
    Returns (keep_first mask, counts)."""
    first = jnp.concatenate([jnp.ones((1,), bool),
                             (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])])
    same_next = jnp.concatenate([~first[1:], jnp.zeros((1,), bool)])
    nca = jnp.concatenate([ca[1:], jnp.zeros((1,), jnp.uint32)])
    ncb = jnp.concatenate([cb[1:], jnp.zeros((1,), jnp.uint32)])
    # Each input is unique, so a 2-member segment has one entry per side.
    tot_a = ca + jnp.where(same_next, nca, jnp.uint32(0))
    tot_b = cb + jnp.where(same_next, ncb, jnp.uint32(0))

    valid = ~((hi == SENT32) & (lo == SENT32))
    if op in ("merge", "union"):
        keep = valid
        cnt = saturating_add_u32(tot_a, tot_b)
    elif op == "intersect":
        keep = valid & (tot_a > 0) & (tot_b > 0)
        cnt = saturating_add_u32(tot_a, tot_b)
    elif op == "diff":
        keep = valid & (tot_a > 0) & (tot_b == 0)
        cnt = tot_a
    else:
        raise ValueError(f"unknown set op {op!r}")
    return first & keep, cnt


def _compact_kept(hi, lo, cnt, keep_first):
    """Scatter-free compaction: a stable sort on the keep flag moves kept
    rows to the front preserving key order."""
    flag = (~keep_first).astype(jnp.uint32)
    flag, out_hi, out_lo, out_c = jax.lax.sort((flag, hi, lo, cnt), num_keys=1,
                                               is_stable=True)
    kept = flag == 0
    out_hi = jnp.where(kept, out_hi, SENT32)
    out_lo = jnp.where(kept, out_lo, SENT32)
    out_c = jnp.where(kept, out_c, jnp.uint32(0))
    n_out = jnp.sum(keep_first.astype(jnp.int32))
    return out_hi, out_lo, out_c, n_out


@functools.partial(jax.jit, static_argnames=("op",))
def set_op(hi_a, lo_a, c_a, hi_b, lo_b, c_b, op: str = "merge"):
    """Combine two sorted unique (key, count) arrays.

    op: "merge"/"union" (keep all, counts summed), "intersect" (keys in both,
    counts summed), "diff" (keys in A only, counts from A).
    Inputs use sentinel-key padding; rows may also be sentinel-MARKED
    (uncompacted) -- this path re-sorts the concatenation, so row order is
    irrelevant. Returns (hi, lo, counts, n_out) with capacity len(A)+len(B).
    """
    ca = jnp.concatenate([c_a.astype(jnp.uint32), jnp.zeros_like(c_b, jnp.uint32)])
    cb = jnp.concatenate([jnp.zeros_like(c_a, jnp.uint32), c_b.astype(jnp.uint32)])
    hi = jnp.concatenate([hi_a, hi_b])
    lo = jnp.concatenate([lo_a, lo_b])
    hi, lo, ca, cb = jax.lax.sort((hi, lo, ca, cb), num_keys=2)
    keep_first, cnt = _combine_sorted(hi, lo, ca, cb, op)
    return _compact_kept(hi, lo, cnt, keep_first)


@jax.jit
def cardinalities(hi_a, lo_a, hi_b, lo_b):
    """(|A|, |B|, |A∩B|, |A∪B|) of two sorted unique sentinel-padded sets.

    Feeds Jaccard-style similarity; on a mesh these are psum'd per shard
    (SURVEY.md section 3.3 / BASELINE config 3).
    """
    one_a = jnp.where(~((hi_a == SENT32) & (lo_a == SENT32)), 1, 0)
    one_b = jnp.where(~((hi_b == SENT32) & (lo_b == SENT32)), 1, 0)
    na = jnp.sum(one_a)
    nb = jnp.sum(one_b)
    _, _, _, n_int = set_op(hi_a, lo_a, one_a.astype(jnp.uint32),
                            hi_b, lo_b, one_b.astype(jnp.uint32), op="intersect")
    return na, nb, n_int, na + nb - n_int
