"""Sort-merge membership join: packed query k-mers vs a sorted panel.

Reference analog: zotmer's scan binary-searches each k-mer in the panel
(SURVEY.md section 3.5). The device form is a gather-free SORT-MERGE JOIN:

1. transform keys to key* = key*2 + is_probe (51 bits still fit the
   (hi, lo) u32 pair since hi < 2^31): the tie-break rides INSIDE the key,
   so a 2-key sort lands the panel row FIRST in its equal-key segment --
   no bidirectional segment scans needed;
2. concatenate panel and queries (queries carry their ROW id as payload)
   and sort by key*;
3. hit bits via one cummax scan (segment start is a panel row);
4. per-row counts: ONE keys-only sort of ``row*2 + hit`` groups each
   row's m_per_row entries contiguously in row order (panel rows carry
   row = n_rows and sink to the tail), then a reshape row-sum; u16 keys
   when n_rows allows.

Everything is sorts and scans.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from zotpu.kernels.pack import SENT32


def _transform_keys(hi, lo, is_probe: bool):
    """key -> key* = key*2 + is_probe, still two u32 words (51 bits max:
    valid canonical keys have hi < 2^31). Monotone in (key, is_probe), so a
    2-channel sort/merge of key* is a 3-key (hi, lo, side) sort with panel
    rows (side 0) FIRST in every equal-key segment. Probe-side sentinel
    rows (0xFFFF.., 0xFFFF..) map to themselves; panel-side pads map to
    (0xFFFF.., 0xFFFF..FE) -- both have hi* >= 2^31 and are masked as
    invalid downstream."""
    b = jnp.uint32(1) if is_probe else jnp.uint32(0)
    return (hi << 1) | (lo >> 31), (lo << 1) | b


def _hits_from_merged_star(hi_s, lo_s, tag, tag_pad: int):
    """Per-element hit bits from a key*-merged stream (XLA path).

    A panel row is the FIRST element of its segment by construction (panel
    keys are unique and key* makes the side bit the lowest key bit), so
    hit(probe) = "my segment's first element is a panel row" -- ONE cummax
    propagating (pos*2 + is_panel) from segment firsts. tag is the probe's
    ROW id (panel/pad rows carry tag_pad = n_rows); returns (hit, bkey)
    where bkey = min(tag, tag_pad)*2 + hit is the backward-sort key."""
    n = hi_s.shape[0]
    is_probe = (lo_s & 1) == 1
    klo = lo_s >> 1                      # key equality = (hi_s, lo_s >> 1)
    neq = (hi_s[1:] != hi_s[:-1]) | (klo[1:] != klo[:-1])
    first = jnp.concatenate([jnp.ones((1,), bool), neq])
    pos = jnp.arange(n, dtype=jnp.int32)
    lead = jnp.where(first, pos * 2 + (~is_probe).astype(jnp.int32), -1)
    lead = jax.lax.cummax(lead, axis=0)
    valid = hi_s < jnp.uint32(0x80000000)   # real keys only (see transform)
    hit = is_probe & ((lead & 1) == 1) & valid
    bkey = (jnp.minimum(tag, jnp.uint32(tag_pad)) << 1) | hit.astype(
        jnp.uint32)
    return hit, bkey


@functools.partial(jax.jit, static_argnames=("n_rows", "m_per_row"))
def _rowsum_by_idx(bkey, n_rows: int, m_per_row: int):
    """One keys-only sort of row*2+hit: each probe row id appears exactly
    m_per_row times (once per window), so after the sort row r's entries
    occupy [r*m_per_row, (r+1)*m_per_row) with the hit bit in the LSB;
    panel/pad rows (tag == n_rows) sink to the tail. Then a reshape
    row-sum. Row-granularity tags fit u16 for n_rows <= 32766, which
    halves the bytes the sort moves."""
    m = n_rows * m_per_row
    if 2 * n_rows + 1 < (1 << 16):
        bkey = bkey.astype(jnp.uint16)
    (bkey,) = jax.lax.sort((bkey,), num_keys=1)
    hits = (bkey[:m] & bkey.dtype.type(1)).astype(jnp.int32)
    return hits.reshape(n_rows, m_per_row).sum(axis=1, dtype=jnp.int32)


def _hits_from_merged(hi, lo, tag):
    """Post-merge: per-row hit bits (TAG-contract path, used by the sharded
    pulldown in dist/shuffle.py). Rows sorted by (hi, lo); tag==0 marks
    panel rows, tag>0 query rows. A query hits iff its equal-key segment
    CONTAINS a panel row -- checked in both directions, so the rule holds
    for any tie order within a segment. All scans, no gather/scatter."""
    n = hi.shape[0]
    neq = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    first = jnp.concatenate([jnp.ones((1,), bool), neq])
    last = jnp.concatenate([neq, jnp.ones((1,), bool)])
    pos = jnp.arange(n, dtype=jnp.int32)
    is_panel = tag == 0
    seg_start = jax.lax.cummax(jnp.where(first, pos, -1), axis=0)
    prev_panel = jax.lax.cummax(jnp.where(is_panel, pos, -1), axis=0)
    seg_end = jax.lax.cummin(jnp.where(last, pos, n), axis=0, reverse=True)
    next_panel = jax.lax.cummin(jnp.where(is_panel, pos, n), axis=0,
                                reverse=True)
    in_segment = (prev_panel >= seg_start) | (next_panel <= seg_end)
    valid = ~((hi == SENT32) & (lo == SENT32))
    return (tag > 0) & in_segment & valid


@functools.partial(jax.jit, static_argnames=("n_tag",))
def _join_xla_star(phi_s, plo_s, qhi_s, qlo_s, tag, n_tag: int):
    """Concat + 2-key lax.sort of the key*-transformed rows (the side bit
    lives in the key, so no third sort channel is needed)."""
    hi = jnp.concatenate([phi_s, qhi_s])
    lo = jnp.concatenate([plo_s, qlo_s])
    tags = jnp.concatenate([jnp.full(phi_s.shape[0], n_tag, jnp.uint32),
                            tag])
    hi, lo, tags = jax.lax.sort((hi, lo, tags), num_keys=2)
    _, bkey = _hits_from_merged_star(hi, lo, tags, n_tag)
    return bkey


@jax.jit
def _join_xla(phi, plo, qhi, qlo, qtag):
    """Concat + lax.sort with panel-first tie order (panel tag 0 < query
    tags; 3-key sort makes ties deterministic)."""
    hi = jnp.concatenate([phi, qhi])
    lo = jnp.concatenate([plo, qlo])
    tag = jnp.concatenate([jnp.zeros(phi.shape[0], jnp.uint32),
                           qtag.astype(jnp.uint32)])
    hi, lo, tag = jax.lax.sort((hi, lo, tag), num_keys=3)
    return _hits_from_merged(hi, lo, tag), tag


def row_hits_sorted_join(phi, plo, qhi, qlo, n_rows: int, m_per_row: int):
    """Per-row panel-hit counts for a packed (row-major) query batch.

    phi/plo: DENSE sorted unique sentinel-padded panel. qhi/qlo: pack output
    in window order (n_rows * m_per_row,). Returns (n_rows,) int32.
    """
    m = qhi.shape[0]
    if n_rows * m_per_row != m:
        raise ValueError(f"query length {m} != {n_rows} x {m_per_row}")
    if n_rows >= 1 << 30:
        raise ValueError(f"batch of {n_rows} rows exceeds the 2^30 "
                         f"row*2+hit key budget; split the batch")
    phi_s, plo_s = _transform_keys(phi, plo, is_probe=False)
    qhi_s, qlo_s = _transform_keys(qhi, qlo, is_probe=True)
    # tags are ROW ids (probe position granularity is never consumed --
    # the output is per-row counts -- and row-granularity bkeys fit u16
    # for typical batch sizes, a cheaper backward sort)
    tag = jnp.repeat(jnp.arange(n_rows, dtype=jnp.uint32), m_per_row)
    bkey = _join_xla_star(phi_s, plo_s, qhi_s, qlo_s, tag, n_rows)
    return _rowsum_by_idx(bkey, n_rows, m_per_row)
