"""Micro-benchmarks dissecting the kmerize step: pack vs sort vs dedup.

Run on the target device to decide where kernel effort goes:
    python -m zotpu.bench.micro [n_log2]
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def timeit(fn, *args, repeats=3):
    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts), out


def main():
    from zotpu import runtime
    runtime.setup()
    from zotpu.kernels import pack, sortdedup

    n_log2 = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    n = 1 << n_log2
    rng = np.random.default_rng(0)
    hi = jnp.asarray(rng.integers(0, 1 << 18, n).astype(np.uint32))
    lo = jnp.asarray(rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32))

    k, read_len = 25, 256
    reads = n // (read_len - k + 1)
    codes = jnp.asarray(rng.integers(0, 4, size=(reads, read_len)).astype(np.uint8))
    lengths = jnp.full(reads, read_len, jnp.int32)

    m = reads * (read_len - k + 1)
    print(f"n = 2^{n_log2} = {n}  pack over {reads}x{read_len} ({m} kmers)",
          flush=True)

    def report(name, dt, per):
        print(f"  {name:28s} {dt*1e3:9.2f} ms   {per/dt/1e9:8.3f} Gelem/s",
              flush=True)

    pack_fn = jax.jit(lambda c, l: pack.pack_canonical(c, l, k))
    dt, packed = timeit(pack_fn, codes, lengths)
    report("pack", dt, m)

    sort1 = jax.jit(lambda a: jax.lax.sort((a,), num_keys=1))
    dt, _ = timeit(sort1, lo)
    report("sort_1xu32", dt, n)

    sort2 = jax.jit(lambda a, b: jax.lax.sort((a, b), num_keys=2))
    dt, (shi, slo) = timeit(sort2, hi, lo)
    report("sort_2xu32", dt, n)

    dt, _ = timeit(sortdedup.dedup_count_sorted, shi, slo)
    report("dedup_scatter", dt, n)

    dt, _ = timeit(sortdedup.kmer_sort_dedup, *packed)
    report("sort+dedup", dt, m)

    seg = jnp.cumsum(jnp.ones(n, jnp.int32)) - 1
    scat = jax.jit(lambda s, x: jnp.zeros(n, jnp.uint32).at[s].set(x, mode="drop"))
    dt, _ = timeit(scat, seg, lo)
    report("scatter_set_unique_sorted", dt, n)

    gat = jax.jit(lambda s, x: x[s])
    dt, _ = timeit(gat, seg, lo)
    report("gather", dt, n)

    cs = jax.jit(lambda x: jnp.cumsum(x.astype(jnp.int32)))
    dt, _ = timeit(cs, lo & 1)
    report("cumsum_i32", dt, n)


if __name__ == "__main__":
    main()
