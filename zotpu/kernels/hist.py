"""k-mer frequency spectrum on device.

Reference analog: zotmer/commands/hist.py count-of-counts loop
(SURVEY.md section 3.4). The tail accumulates in the last bin; on a mesh
the per-shard histograms are psum'd.

Count-of-counts over a BOUNDED bin range sorts instead of scattering: clamp counts to max_count (u16 when it
fits -- narrow keys sort ~1.2x faster), ONE keys-only lax.sort, then the
histogram is the difference of bin boundaries found by searchsorted
(max_count+1 needles, ~log2(n) steps each -- thousands of gathers, not
tens of millions of scattered adds).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("max_count",))
def spectrum(counts: jax.Array, max_count: int = 1024) -> jax.Array:
    """u32 counts (0 = padding) -> int32 histogram of length max_count+1.

    hist[v] = number of k-mers with count v (v in 1..max_count-1);
    hist[max_count] accumulates every count >= max_count; hist[0] is 0
    (padding rows are excluded, matching golden.spectrum)."""
    dt = jnp.uint16 if max_count < (1 << 16) else jnp.int32
    c = jnp.minimum(counts, jnp.uint32(max_count)).astype(dt)
    (c,) = jax.lax.sort((c,), num_keys=1)
    bins = jnp.arange(max_count + 1, dtype=dt)
    # edges[v] = # elements <= v in the sorted array
    edges = jnp.searchsorted(c, bins, side="right").astype(jnp.int32)
    hist = jnp.diff(edges, prepend=jnp.zeros(1, jnp.int32))
    return hist.at[0].set(0)
