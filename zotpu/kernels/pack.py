"""Fused tokenize -> 2-bit pack -> canonicalize kernel (device side).

Reference analog: the per-base Python loop in zotmer/library/basics.py
``kmers``/``rc``/``can`` (SURVEY.md section 3.1 hot loop) -- here it becomes one
fused elementwise XLA program over an (R, L) batch of base codes: every k-mer
window of every read is packed, reverse-complemented, canonicalized and
validity-masked in parallel on the device.

Keys are (hi, lo) u32 pairs (u64 emulation; x64 stays off).
Invalid windows (non-ACGT base inside, or window past the read end) become the
sentinel key so they sort to the end and carry weight 0.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from zotpu import semantics as S

# numpy scalar, NOT jnp: a jnp constant here would initialize the XLA
# backend at IMPORT time, so even --host (golden-path) commands would touch
# the device. np.uint32 is strong-typed u32 under JAX's promotion rules, so
# in-kernel arithmetic is unchanged.
SENT32 = np.uint32(0xFFFFFFFF)


@functools.partial(jax.jit, static_argnames=("k",))
def pack_canonical(codes: jax.Array, lengths: jax.Array, k: int):
    """(R, L) u8 codes + (R,) lengths -> flat (hi, lo, weight) of R*(L-k+1).

    weight is u32 1 for valid windows, 0 otherwise; invalid keys are sentinel.
    """
    R, L = codes.shape
    m = L - k + 1
    c32 = codes.astype(jnp.uint32)

    # Forward pack: first base ends up in the most significant 2 bits.
    fhi = jnp.zeros((R, m), jnp.uint32)
    flo = jnp.zeros((R, m), jnp.uint32)
    for j in range(k):
        c = jax.lax.dynamic_slice_in_dim(c32, j, m, axis=1) & jnp.uint32(3)
        fhi = (fhi << jnp.uint32(2)) | (flo >> jnp.uint32(30))
        flo = (flo << jnp.uint32(2)) | c

    # Reverse complement: comp(base[k-1]) ends up most significant.
    rhi = jnp.zeros((R, m), jnp.uint32)
    rlo = jnp.zeros((R, m), jnp.uint32)
    for j in range(k - 1, -1, -1):
        c = (jax.lax.dynamic_slice_in_dim(c32, j, m, axis=1) & jnp.uint32(3)) ^ jnp.uint32(3)
        rhi = (rhi << jnp.uint32(2)) | (rlo >> jnp.uint32(30))
        rlo = (rlo << jnp.uint32(2)) | c

    # canonical = min(fwd, rc) as a two-word unsigned compare
    fwd_le = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
    chi = jnp.where(fwd_le, fhi, rhi)
    clo = jnp.where(fwd_le, flo, rlo)

    # Validity: window inside the read and free of non-ACGT codes.
    # last_bad[i] = largest j <= i with codes[j] invalid (else -1), via cummax.
    bad = codes >= jnp.uint8(S.INVALID_CODE)
    pos = jax.lax.broadcasted_iota(jnp.int32, (R, L), 1)
    last_bad = jax.lax.cummax(jnp.where(bad, pos, -1), axis=1)
    start = jax.lax.broadcasted_iota(jnp.int32, (R, m), 1)
    window_clean = last_bad[:, k - 1:] < start
    in_read = start + k <= lengths[:, None].astype(jnp.int32)
    valid = window_clean & in_read

    hi = jnp.where(valid, chi, SENT32).reshape(-1)
    lo = jnp.where(valid, clo, SENT32).reshape(-1)
    w = valid.astype(jnp.uint32).reshape(-1)
    return hi, lo, w
