"""Set-algebra workload wrappers (BASELINE config 3).

Reference analog: zotmer's set-algebra commands (SURVEY.md section 3.3).
Device path pads both sorted sets to power-of-two capacity (bounded compile
count) and runs the neighbour-combine kernel; counts follow semantics.py.
"""

from __future__ import annotations

import numpy as np

from zotpu import semantics as S
from zotpu.kernels import setops as K


def _pad_pow2(keys, counts):
    n = len(keys)
    cap = max(1 << (max(n, 1) - 1).bit_length(), 8)
    hi = np.full(cap, 0xFFFFFFFF, np.uint32)
    lo = np.full(cap, 0xFFFFFFFF, np.uint32)
    c = np.zeros(cap, np.uint32)
    hi[:n], lo[:n] = S.split_hi_lo(np.asarray(keys, np.uint64))
    c[:n] = counts
    return hi, lo, c


def set_op(a: tuple[np.ndarray, np.ndarray], b: tuple[np.ndarray, np.ndarray],
           op: str) -> tuple[np.ndarray, np.ndarray]:
    """Device set op between two sorted unique (keys u64, counts u32) pairs."""
    ahi, alo, ac = _pad_pow2(*a)
    bhi, blo, bc = _pad_pow2(*b)
    hi, lo, c, n = K.set_op(ahi, alo, ac, bhi, blo, bc, op=op)
    n = int(n)
    keys = S.join_hi_lo(np.asarray(hi[:n]), np.asarray(lo[:n]))
    return keys, np.asarray(c[:n])


def merge_tree_device(runs: list[tuple[np.ndarray, np.ndarray]]
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Pairwise device merge tree over sorted runs (counts saturate)."""
    if not runs:
        return np.empty(0, np.uint64), np.empty(0, S.COUNT_DTYPE)
    runs = list(runs)
    while len(runs) > 1:
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            nxt.append(set_op(runs[i], runs[i + 1], op="merge"))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]


def jaccard(a_keys: np.ndarray, b_keys: np.ndarray) -> dict:
    """Similarity statistics from device cardinalities."""
    ahi, alo, _ = _pad_pow2(a_keys, np.ones(len(a_keys), np.uint32))
    bhi, blo, _ = _pad_pow2(b_keys, np.ones(len(b_keys), np.uint32))
    na, nb, ni, nu = (int(x) for x in K.cardinalities(ahi, alo, bhi, blo))
    return {"a": na, "b": nb, "intersect": ni, "union": nu,
            "jaccard": ni / nu if nu else 0.0}


# ---------------------------------------------------------------------------
# sharded set ops (BASELINE multi-host blueprint: "pairwise set-op
# cardinalities are psum'd"; VERDICT round 3 item 5). Both inputs are sorted,
# so key-prefix sharding is a contiguous SLICE per shard: shard d combines
# the two slices independently (keys meet only inside their own shard), the
# per-shard outputs concatenate already globally sorted, and |A|, |B|, n_out
# are psum'd on the mesh -- the set data never has to fit one chip's HBM.


def _prefix_edges(k: int, n_shards: int) -> np.ndarray:
    """The D-1 key values where shard ownership changes (key-prefix
    sharding: shard d owns keys in [edges[d-1], edges[d]))."""
    from zotpu.dist.mesh import shard_bits

    p = shard_bits(n_shards)
    return ((np.arange(1, n_shards, dtype=np.uint64)
             << np.uint64(2 * k - p)) if p else np.empty(0, np.uint64))


def _pow2_cap(max_size: int) -> int:
    """Shared cap rule for (D, cap) shard rows: next power of two, min 8.
    One definition so the in-RAM and streamed partitions compile the SAME
    kernel shapes (and stay byte-equal by construction)."""
    return max(1 << (max(int(max_size), 1) - 1).bit_length(), 8)


def _partition_sorted_prefix(keys, counts, k: int, n_shards: int):
    """Split one sorted set into (D, cap) sentinel-padded shard rows by key
    prefix (searchsorted on the D prefix boundaries -- contiguous slices)."""
    keys = np.asarray(keys, np.uint64)
    edges = _prefix_edges(k, n_shards)
    bounds = np.concatenate([[0], np.searchsorted(keys, edges), [len(keys)]]
                            ).astype(np.int64)
    sizes = np.diff(bounds)
    cap = _pow2_cap(sizes.max() if len(sizes) else 1)
    hi = np.full((n_shards, cap), 0xFFFFFFFF, np.uint32)
    lo = np.full((n_shards, cap), 0xFFFFFFFF, np.uint32)
    c = np.zeros((n_shards, cap), np.uint32)
    for d in range(n_shards):
        seg = slice(bounds[d], bounds[d + 1])
        m = bounds[d + 1] - bounds[d]
        hi[d, :m], lo[d, :m] = S.split_hi_lo(keys[seg])
        c[d, :m] = counts[seg]
    return hi, lo, c


def _partition_cached(keys, counts, k: int, n_shards: int, cache):
    """Device-resident (D, cap) partition of one sorted set, memoized across
    pairwise calls (VERDICT round 4 item 7: an N-way jaccard matrix used to
    repartition every set O(N) times -- O(N^2 * n) host copies on big
    panels). Keyed by array identity; the cache entry holds a reference to
    the arrays so their ids cannot be recycled while cached. The DEVICE
    arrays are what's cached, so repeated pairs skip the H2D upload too.
    Each shard row is uploaded straight to its owner device.
    ``counts=None`` means all-ones (the jaccard form)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from zotpu.dist import mesh as M
    from zotpu.dist.mesh import AXIS

    def part():
        c = np.ones(len(keys), np.uint32) if counts is None else counts
        sharding = NamedSharding(M.make_mesh(n_shards), P(AXIS, None))
        return tuple(jax.device_put(x, sharding) for x in
                     _partition_sorted_prefix(keys, c, k, n_shards))

    if cache is None:
        return part()
    ck = (id(keys), None if counts is None else id(counts), k, n_shards)
    hit = cache.get(ck)
    if hit is None:
        cache[ck] = hit = (keys, counts, part())
    return hit[2]


_SETOP_FN_CACHE: dict = {}


def _sharded_setop_fn(op: str, n_shards: int):
    """Jitted shard_map program: per-shard set_op + psum'd counts.

    Cached by (op, n_shards) -- a fresh jax.jit object per call would
    RETRACE and recompile on every pair of an N-way jaccard matrix even at
    identical shapes; one cached callable lets jit's own shape cache do its
    job."""
    key = (op, n_shards)
    hit = _SETOP_FN_CACHE.get(key)
    if hit is not None:
        return hit

    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from zotpu.dist import mesh as M
    from zotpu.dist.mesh import AXIS

    mesh = M.make_mesh(n_shards)
    SENT = np.uint32(0xFFFFFFFF)

    def local(ahi, alo, ac, bhi, blo, bc):
        ahi, alo, ac = ahi[0], alo[0], ac[0]
        bhi, blo, bc = bhi[0], blo[0], bc[0]
        # valid counts feed the psum'd cardinalities
        na = jnp.sum((~((ahi == SENT) & (alo == SENT))).astype(jnp.int32))
        nb = jnp.sum((~((bhi == SENT) & (blo == SENT))).astype(jnp.int32))
        hi, lo, c, n = K.set_op(ahi, alo, ac, bhi, blo, bc, op=op)
        tot = jax.lax.psum(jnp.stack([na, nb, n.astype(jnp.int32)]), AXIS)
        return hi[None], lo[None], c[None], n[None].astype(jnp.int32), tot

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(AXIS, None),) * 6,
                   out_specs=(P(AXIS, None), P(AXIS, None), P(AXIS, None),
                              P(AXIS), P()),
                   check_vma=False)  # see dist/shuffle.make_kmerize_step
    fn = jax.jit(fn)
    _SETOP_FN_CACHE[key] = fn
    return fn


def set_op_sharded(a: tuple[np.ndarray, np.ndarray],
                   b: tuple[np.ndarray, np.ndarray], op: str, k: int,
                   n_shards: int, gather: bool = True, cache: dict | None = None
                   ) -> tuple[np.ndarray, np.ndarray, dict]:
    """Key-prefix-sharded set op across ``n_shards`` devices.

    Each shard runs the sort-based set_op on its slice of both sets; outputs concatenate already globally sorted (disjoint prefix
    ranges) and are byte-identical to the single-chip ``set_op`` (tested).
    Returns (keys, counts, cards) with cards = the psum'd {a, b, intersect,
    union} cardinalities, derived from the op's own output size (no second
    kernel): n_out = |A|+|B|-|A^B| for union/merge, |A^B| for intersect,
    |A|-|A^B| for diff.

    ``gather=False`` skips the full (D, cap) result transfer and the host
    reconstruction entirely and returns (None, None, cards) -- the right
    form for cardinality-only queries (jaccard), where the D2H of a
    multi-GB result set would be pure waste.

    ``cache`` (a plain dict the caller owns) memoizes each set's device
    partition across calls, so an N-way matrix partitions + uploads each
    set once instead of once per pair. A side's counts may be None
    (all-ones -- the jaccard form)."""
    ahi, alo, ac = _partition_cached(a[0], a[1], k, n_shards, cache)
    bhi, blo, bc = _partition_cached(b[0], b[1], k, n_shards, cache)
    fn = _sharded_setop_fn(op, n_shards)
    hi, lo, c, n, tot = fn(ahi, alo, ac, bhi, blo, bc)
    na, nb, n_out = (int(x) for x in np.asarray(tot))
    n_int = {"merge": na + nb - n_out, "union": na + nb - n_out,
             "intersect": n_out, "diff": na - n_out}[op]
    cards = {"a": na, "b": nb, "intersect": n_int,
             "union": na + nb - n_int,
             "jaccard": n_int / (na + nb - n_int) if na + nb - n_int else 0.0}
    if not gather:
        return None, None, cards
    hi, lo = np.asarray(hi), np.asarray(lo)
    c, n = np.asarray(c), np.asarray(n)
    keys_out, cnt_out = [], []
    for d in range(n_shards):
        m = int(n[d])
        keys_out.append(S.join_hi_lo(hi[d, :m], lo[d, :m]))
        cnt_out.append(c[d, :m].astype(S.COUNT_DTYPE))
    keys = (np.concatenate(keys_out) if keys_out
            else np.empty(0, np.uint64))
    counts = (np.concatenate(cnt_out) if cnt_out
              else np.empty(0, S.COUNT_DTYPE))
    return keys, counts, cards


def jaccard_sharded(a_keys: np.ndarray, b_keys: np.ndarray, k: int,
                    n_shards: int, cache: dict | None = None) -> dict:
    """Similarity from psum'd per-shard cardinalities: gather=False means
    only the three psum'd totals leave the mesh (no result-set D2H).
    ``cache`` makes an N-way matrix partition/upload each set once."""
    _, _, cards = set_op_sharded((a_keys, None), (b_keys, None),
                                 "intersect", k, n_shards, gather=False,
                                 cache=cache)
    return cards


# ---------------------------------------------------------------------------
# streamed + multi-controller sharded set ops (VERDICT round 4 item 4): the
# in-RAM path above materializes both full key arrays on the calling host;
# this path partitions each input straight from container.ChunkReader so no
# host ever holds a whole set, and runs the SAME jitted shard_map program.


def set_op_sharded_stream(path_a: str, path_b: str, op: str, n_shards: int,
                          chunk: int = 1 << 22):
    """Sharded set op streamed straight from two container files.

    Two streaming passes per input (O(chunk) host RSS each): pass 1 counts
    per-shard rows by searchsorted on the key-prefix edges; pass 2 fills
    ONE shard's sentinel-padded row at a time and device_puts it to its
    owner device before moving on -- the inputs are sorted, so shards
    complete in order and at most one partial row buffer is ever live.
    Peak host RSS is O(cap + chunk) per input, not O(set).

    Under multi-controller (jax.distributed across hosts, every host
    running this same call on a shared filesystem) each host builds ONLY
    its addressable shards' rows; the (D, cap) global arrays assemble via
    jax.make_array_from_single_device_arrays and feed the SAME jitted
    shard_map program as set_op_sharded -- byte-equal outputs by
    construction (same partition rule, same cap rule, same kernel).

    Returns (k, keys, counts, cards): keys/counts are THIS host's shard
    rows in shard order (= the full sorted result under a single
    controller; multi-controller callers allgather -- see cli._binary_setop),
    cards the psum'd cardinalities (valid on every host).
    """
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from zotpu.dist import mesh as M
    from zotpu.dist.mesh import AXIS
    from zotpu.dist.shuffle import gather_local_rows
    from zotpu.io import container

    mesh = M.make_mesh(n_shards)
    devs = list(mesh.devices.flat)
    sharding = NamedSharding(mesh, P(AXIS, None))
    proc = jax.process_index()
    local = {d for d in range(n_shards) if devs[d].process_index == proc}

    def sizes_of(path):
        r = container.ChunkReader(path)
        edges = _prefix_edges(r.k, n_shards)
        sizes = np.zeros(n_shards, np.int64)
        for keys, _ in r.chunks(chunk):
            b = np.concatenate([[0], np.searchsorted(keys, edges),
                                [len(keys)]])
            sizes += np.diff(b)
        return r.k, sizes

    def build(path, k, sizes, cap):
        """(D, cap) global sharded (hi, lo, c); one local shard in host RAM
        at a time."""
        r = container.ChunkReader(path)
        edges = _prefix_edges(k, n_shards)
        bufs: dict[int, list] = {}   # shard -> [hi, lo, c, fill cursor]
        done: dict[int, tuple] = {}  # shard -> per-device (1, cap) arrays

        def finalize(d):
            hi, lo, c, _ = bufs.pop(d)
            done[d] = (jax.device_put(hi[None], devs[d]),
                       jax.device_put(lo[None], devs[d]),
                       jax.device_put(c[None], devs[d]))

        for keys, counts in r.chunks(chunk):
            if counts is None:
                counts = np.ones(len(keys), np.uint32)
            b = np.concatenate([[0], np.searchsorted(keys, edges),
                                [len(keys)]])
            for d in range(n_shards):
                m = int(b[d + 1] - b[d])
                if m == 0 or d not in local:
                    continue
                st = bufs.setdefault(d, [
                    np.full(cap, 0xFFFFFFFF, np.uint32),
                    np.full(cap, 0xFFFFFFFF, np.uint32),
                    np.zeros(cap, np.uint32), 0])
                cur = st[3]
                st[0][cur:cur + m], st[1][cur:cur + m] = S.split_hi_lo(
                    np.ascontiguousarray(keys[b[d]:b[d + 1]]))
                st[2][cur:cur + m] = counts[b[d]:b[d + 1]]
                st[3] = cur + m
                if st[3] == sizes[d]:
                    finalize(d)
        for d in local:              # shards that saw zero rows
            if d not in done:
                bufs.setdefault(d, [
                    np.full(cap, 0xFFFFFFFF, np.uint32),
                    np.full(cap, 0xFFFFFFFF, np.uint32),
                    np.zeros(cap, np.uint32), 0])
                finalize(d)

        def glob(i):
            return jax.make_array_from_single_device_arrays(
                (n_shards, cap), sharding, [done[d][i] for d in sorted(done)])
        return glob(0), glob(1), glob(2)

    ka, sa = sizes_of(path_a)
    kb, sb = sizes_of(path_b)
    if ka != kb:
        raise ValueError(f"K mismatch: {path_a} has k={ka}, {path_b} k={kb}")
    ahi, alo, ac = build(path_a, ka, sa, _pow2_cap(sa.max()))
    bhi, blo, bc = build(path_b, kb, sb, _pow2_cap(sb.max()))
    fn = _sharded_setop_fn(op, n_shards)
    hi, lo, c, n, tot = fn(ahi, alo, ac, bhi, blo, bc)
    na, nb, n_out = (int(x) for x in np.asarray(tot))
    n_int = {"merge": na + nb - n_out, "union": na + nb - n_out,
             "intersect": n_out, "diff": na - n_out}[op]
    cards = {"a": na, "b": nb, "intersect": n_int,
             "union": na + nb - n_int,
             "jaccard": n_int / (na + nb - n_int) if na + nb - n_int else 0.0}
    keys, counts = gather_local_rows(hi, lo, c, n)
    return ka, keys, counts, cards
