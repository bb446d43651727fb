"""Device->host wire format for sorted (key, count) result sets.

The final transfer of a kmerize run moves n x 12 B (u32 key hi, u32 key lo,
u32 count); where the D2H link is slow, that transfer is the single largest
item in the end-to-end tail. Keys are SORTED, so consecutive deltas of a k<=31
canonical set (<= 62-bit keys) almost always fit u32 (mean gap at 33M keys
over 2^50 is ~2^25), and counts almost always fit u16 (u8 would be 1 B
cheaper but real WGS sets carry >8k distinct repeat k-mers with coverage
>255, overflowing any reasonable exception table; >65535 is genuinely
rare). This module transfers n x 6 B instead -- u32 key deltas + u16
clamped counts -- plus a small fixed-capacity EXCEPTION table (position,
true key, true count) covering the rare big-gap / big-count rows, and
reconstructs exactly on the host. Encode is elementwise ops + one keys-only u32 sort (exception
collection) on device; decode is one numpy cumsum + patches.

Reference analog: none (zotmer is single-process; this is transport for the
device runtime, like io/wire.py on the H2D side). No output byte depends on the
wire layout -- decode is exact -- so it lives outside semantics.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

EXC_CAP = 1 << 13     # exception-table capacity (8192 rows, 128 KB)
MIN_KEYS = 1 << 20    # below ~1M keys the plain 12 B/key transfer is fine


@functools.partial(jax.jit, static_argnames=("exc_cap",))
def encode_device(hi, lo, cnt, exc_cap: int = EXC_CAP):
    """Sorted (hi, lo, cnt) u32 arrays -> (delta32, cnt16, exc_pos, exc_hi,
    exc_lo, exc_cnt, n_exc).

    delta32[i] = key[i] - key[i-1] (key[-1] := 0) where that fits u32;
    rows where it does not -- or where cnt > 65535 -- are exceptions, listed
    by position with their true key and count. n_exc > exc_cap means the
    encoding is unusable (caller falls back to the plain transfer).
    Capacity padding (sentinel keys) contributes at most one exception at
    the valid/pad boundary; callers slice [:n] before transfer.
    """
    n = hi.shape[0]
    phi = jnp.concatenate([jnp.zeros(1, jnp.uint32), hi[:-1]])
    plo = jnp.concatenate([jnp.zeros(1, jnp.uint32), lo[:-1]])
    borrow = (lo < plo).astype(jnp.uint32)
    dlo = lo - plo                      # wrapping u32
    dhi = hi - phi - borrow
    is_exc = (dhi != 0) | (cnt > 65535)
    pos = jnp.arange(n, dtype=jnp.uint32)
    skey = jnp.where(is_exc, pos, jnp.uint32(0xFFFFFFFF))
    (skey,) = jax.lax.sort((skey,), num_keys=1)
    exc_pos = skey[:exc_cap]
    safe = jnp.minimum(exc_pos, jnp.uint32(n - 1)).astype(jnp.int32)
    exc_hi = hi[safe]
    exc_lo = lo[safe]
    exc_cnt = cnt[safe]
    n_exc = jnp.sum(is_exc.astype(jnp.int32))
    cnt16 = jnp.minimum(cnt, 65535).astype(jnp.uint16)
    return dlo, cnt16, exc_pos, exc_hi, exc_lo, exc_cnt, n_exc


def decode_host(delta32, cnt16, exc_pos, exc_hi, exc_lo, exc_cnt,
                n_exc: int, n: int):
    """Exact inverse of encode_device for the first n rows (numpy).

    The telescoping-correction math lives in io/delta.py (shared with the
    container "delta" codec); this wrapper just joins the (hi, lo) exception
    key halves and trims the fixed-capacity tables to n_exc.
    """
    from zotpu.io import delta as D

    if n == 0:
        return np.empty(0, np.uint64), np.empty(0, np.uint32)
    exc_key = (np.asarray(exc_hi[:n_exc]).astype(np.uint64) << np.uint64(32)
               ) | np.asarray(exc_lo[:n_exc])
    keys, counts = D.decode(np.asarray(delta32), np.asarray(cnt16),
                            np.asarray(exc_pos[:n_exc]), exc_key,
                            np.asarray(exc_cnt[:n_exc]), n)
    return keys, counts


def transfer_sorted_set(hi, lo, cnt, n: int):
    """D2H of the first n rows of a dense sorted (hi, lo, cnt) device run.

    Uses the delta+u16 codec when n >= MIN_KEYS and the exception table
    holds, else the plain 12 B/key transfer. Either way slices to a 1M-row
    grid: each distinct slice length is its own tiny XLA program, and a
    compile per run length would cost more than the transfer. Returns numpy (u64 keys, u32
    counts). Shared by the accumulator finalization and the per-batch spill
    transfers."""
    from zotpu import semantics as S

    if n == 0:
        return np.empty(0, np.uint64), np.empty(0, S.COUNT_DTYPE)
    np_ = min(hi.shape[0], -(-n // (1 << 20)) * (1 << 20))
    if n >= MIN_KEYS:
        d32, c16, ep, ehi, elo, ecnt, n_exc = encode_device(hi, lo, cnt)
        if int(n_exc) <= EXC_CAP:
            keys, counts = decode_host(
                np.asarray(d32[:np_]), np.asarray(c16[:np_]),
                np.asarray(ep), np.asarray(ehi), np.asarray(elo),
                np.asarray(ecnt), int(n_exc), n)
            return keys, counts.astype(S.COUNT_DTYPE)
    keys = S.join_hi_lo(np.asarray(hi[:np_])[:n], np.asarray(lo[:np_])[:n])
    return keys, np.asarray(cnt[:np_])[:n].astype(S.COUNT_DTYPE)
