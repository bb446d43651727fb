"""Hash-space-sharded distributed kmerize / pulldown (shard_map + all_to_all).

Reference analog: none -- this is the scale-out layer BASELINE requires
(SURVEY.md section 2b). Design (SURVEY.md section 7 step 5):

- One mesh axis ``shards`` over all chips. Each chip owns a contiguous range
  of the 2k-bit key space selected by the top ``p = log2(D)`` key bits
  (key-prefix sharding, NOT mixed-hash: concatenated per-shard sorted runs are
  then already globally sorted, and single-chip output is shard-count
  invariant).
- Every chip packs its local read slice (kernels/pack), sorts it --
  because the owner is a key prefix, sorting by key also groups by owner --
  and places entries into fixed-capacity per-destination buckets.
- ``lax.all_to_all`` routes the buckets (on GPUs XLA hands the collective to
  NCCL); receivers sort + dedup their shard into a sorted (key, count) run.
- Variable per-destination volume is handled with static capacity + overflow
  counters (psum'd for monitoring); capacity_factor sizes the slack
  (SURVEY.md section 7 "hard parts": GC-content skew can exceed 2x -- monitor
  the overflow stat and raise the factor or switch to mixed-hash sharding).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map

from zotpu import semantics as S
from zotpu.dist.mesh import AXIS, shard_bits
from zotpu.kernels.pack import SENT32, pack_canonical
from zotpu.kernels.sortdedup import dedup_count_sorted, dedup_mark_sorted


def _embed_bits(k: int, p: int) -> int | None:
    """Bit position for embedding the p-bit mixed-routing owner in ``hi``.

    The owner id must sort ABOVE the key bits, so it lives at bit
    ``bits_hi = max(2k-32, 0)`` of the hi word (hi uses exactly bits_hi real
    bits). Requires ``bits_hi + p <= 31`` so an embedded real key can never
    collide with the 0xFFFFFFFF sentinel word; returns None when it cannot
    (fall back to a separate mix sort channel)."""
    bits_hi = max(2 * k - 32, 0)
    if p > 0 and bits_hi + p <= 31:
        return bits_hi
    return None


def _mixed_owner_sort(hi, lo, k: int, p_bits: int, n_shards: int, payload=()):
    """Sort rows into owner-contiguous, key-sorted order for MIXED sharding.

    Embeds the owner id (top p bits of the 32-bit routing mix) into spare
    high bits of ``hi`` so ONE two-word lexicographic sort both groups rows
    by owner and key-sorts them within each owner -- the same operand count
    as prefix sharding (the naive form pays a third full-width sort channel
    for the mix), and every bucket is a key-sorted run. Returns (khi, lo,
    owner, payload, embedded) with the owner still embedded in khi; strip
    with ``_strip_owner`` after routing.

    Falls back to the separate-mix-channel sort when the owner bits do not
    fit (large k x many shards); its buckets are ordered by mix, not key,
    and it returns embedded=False.
    """
    sent = (hi == SENT32) & (lo == SENT32)
    mix = S.routing_mix32(hi, lo)
    eb = _embed_bits(k, p_bits)
    if eb is not None:
        owner_u = jnp.minimum(mix >> jnp.uint32(32 - p_bits),
                              jnp.uint32(n_shards - 1))
        khi = jnp.where(sent, jnp.uint32(SENT32),
                        hi | (owner_u << jnp.uint32(eb)))
        out = jax.lax.sort((khi, lo) + tuple(payload), num_keys=2)
        khi, lo = out[0], out[1]
        # clamp BEFORE the signed cast: a sentinel's khi >> eb is a huge
        # u32 that must land on the last shard, not wrap to -1
        owner = jnp.minimum(khi >> jnp.uint32(eb),
                            jnp.uint32(n_shards - 1)).astype(jnp.int32)
        return khi, lo, owner, out[2:], True
    mix = jnp.where(sent, jnp.uint32(0xFFFFFFFF), mix)
    out = jax.lax.sort((mix, hi, lo) + tuple(payload), num_keys=3)
    mix, hi, lo = out[0], out[1], out[2]
    owner = (jnp.minimum(mix >> jnp.uint32(32 - p_bits),
                         jnp.uint32(n_shards - 1)).astype(jnp.int32)
             if p_bits else jnp.zeros(mix.shape, jnp.int32))
    return hi, lo, owner, out[3:], False


def _strip_owner(rhi, rlo, k: int, p_bits: int):
    """Clear embedded owner bits from routed keys (sentinels preserved)."""
    eb = _embed_bits(k, p_bits)
    if eb is None or p_bits == 0:
        return rhi
    sent = (rhi == SENT32) & (rlo == SENT32)
    mask = jnp.uint32(~(((1 << p_bits) - 1) << eb) & 0xFFFFFFFF)
    return jnp.where(sent, jnp.uint32(SENT32), rhi & mask)


def _owner_of(hi, lo, k: int, p: int, n_shards: int):
    """Top p bits of the 2k-bit key -> owner shard id (int32).

    Sentinel keys clamp to the last shard (they carry no weight).
    """
    shift = 2 * k - p
    if p == 0:
        return jnp.zeros(hi.shape, jnp.int32)
    if shift >= 32:
        own = (hi >> jnp.uint32(shift - 32)).astype(jnp.int32)
    else:
        own = (((hi << jnp.uint32(32 - shift)) | (lo >> jnp.uint32(shift)))
               & jnp.uint32((1 << p) - 1)).astype(jnp.int32)
    return jnp.minimum(own, n_shards - 1)


def _route(hi, lo, k: int, n_shards: int, capacity: int, payload=(),
           capacity2: int = 0, owner=None):
    """Owner-route sorted-by-key entries into (D, C) buckets + all_to_all.

    Returns received (hi, lo, *payload) flattened to (D*(C+C2),) plus the
    local overflow count. Inputs MUST be sorted so that ``owner`` is
    non-decreasing: by (hi, lo) for the default key-prefix owner, or by the
    routing mix when a precomputed ``owner`` vector is passed (mixed-hash
    sharding); sentinel = invalid.

    ``capacity2 > 0`` enables the overflow SECOND ROUND (SURVEY.md section 7
    "hard parts"): entries beyond a destination's first-round capacity go into
    a second, smaller bucket array routed by a second all_to_all, so transient
    skew (GC-content hot prefixes) degrades gracefully instead of failing the
    run; only entries beyond capacity+capacity2 count as overflow (still
    detected and raised by callers).

    The second round is GATED on a replicated "any sender has leftovers"
    flag (``psum`` of local leftover counts), so in the steady state -- no
    bucket anywhere exceeded first-round capacity -- its fill and
    all_to_all cost nothing but the psum: ``lax.cond`` with a replicated
    predicate takes the same branch on every device, which keeps the
    collective inside the taken branch coherent. The skipped branch emits
    the sentinel-filled buffers the downstream static shapes expect.
    Returns (recv, overflow, need2, landed) where ``need2`` is the
    replicated bool flag (False when capacity2 == 0) and ``landed`` is the
    (n_shards,) count of THIS sender's valid entries that landed in each
    destination's buckets -- psum it to get per-shard received volumes
    without scanning the received buffer (the routing-skew stat).

    """
    p = shard_bits(n_shards)
    m = hi.shape[0]
    if owner is None:
        owner = _owner_of(hi, lo, k, p, n_shards)
    valid = ~((hi == SENT32) & (lo == SENT32))
    # owner is non-decreasing (key prefix on sorted keys; sentinels clamp to
    # the last shard), so bucket d's rows are the CONTIGUOUS input slice
    # [starts[d], starts[d+1]). Bucket fill is therefore D static-size
    # dynamic slices + a live mask instead of a scatter: segment placement.
    # PRACTICAL D BOUND: the fill unrolls n_shards dynamic slices per
    # channel, so program size grows O(D) -- fine through D <= 256, a
    # compile-size trap toward the D = 8192 the owner embedding could
    # address. Past ~256 shards, batch the fill as one lax.map over a
    # stacked starts vector.
    starts = jnp.searchsorted(owner, jnp.arange(n_shards, dtype=jnp.int32)
                              ).astype(jnp.int32)
    sizes = jnp.diff(jnp.concatenate([starts,
                                      jnp.array([m], jnp.int32)]))
    pos = jnp.arange(m, dtype=jnp.int32) - starts[owner]

    def round_bufs(offset: int, cap_r: int):
        pos_r = pos - offset
        ok = valid & (pos_r >= 0) & (pos_r < cap_r)
        live = (jnp.arange(cap_r, dtype=jnp.int32)[None, :]
                < (sizes[:, None] - offset))

        def fill(x, fillv):
            xp = jnp.concatenate([x, jnp.full(cap_r, fillv, x.dtype)])
            buf = jnp.stack([
                jax.lax.dynamic_slice(xp, (starts[d] + offset,), (cap_r,))
                for d in range(n_shards)])
            # mask rows past the bucket's segment (they belong to the next
            # owner); in-bucket sentinel rows are already SENT32 for hi/lo,
            # and payload channels of sentinel rows are ignored downstream
            # (the join requires a valid key).
            return jnp.where(live, buf, fillv)

        send = [fill(hi, SENT32), fill(lo, SENT32)]
        send += [fill(x, jnp.zeros((), x.dtype)) for x in payload]
        recv = [jax.lax.all_to_all(b, AXIS, split_axis=0, concat_axis=0,
                                   tiled=True).reshape(-1) for b in send]
        return recv, jnp.sum(ok.astype(jnp.int32))

    recv, n_ok = round_bufs(0, capacity)
    n_valid = jnp.sum(valid.astype(jnp.int32))
    # Valid rows form a prefix of the owner-sorted input (sentinels carry the
    # max key / max mix, so they sort last -- exact for prefix and embedded-
    # owner sharding; the separate-mix-channel fallback could interleave a
    # real key whose 32-bit mix is 0xFFFFFFFF, a 2^-32 stat-only corner), so
    # this sender's valid count per destination is a clamped range length --
    # O(D) work replacing the old full scan of the received buffer.
    ends = jnp.concatenate([starts[1:], jnp.array([m], jnp.int32)])
    v_dest = jnp.minimum(ends, n_valid) - jnp.minimum(starts, n_valid)
    landed = jnp.minimum(v_dest, capacity + capacity2)
    if capacity2 > 0:
        need2 = jax.lax.psum(n_valid - n_ok, AXIS) > 0

        def run2(_):
            return round_bufs(capacity, capacity2)

        def skip2(_):
            fills = [SENT32, SENT32] + [jnp.zeros((), x.dtype) for x in payload]
            bufs = [jnp.full((n_shards * capacity2,), f, dtype=b.dtype)
                    for f, b in zip(fills, recv)]
            return bufs, jnp.zeros((), jnp.int32)

        recv2, n_ok2 = jax.lax.cond(need2, run2, skip2, operand=None)
        recv = [jnp.concatenate([a, b]) for a, b in zip(recv, recv2)]
        overflow = n_valid - n_ok - n_ok2
    else:
        need2 = jnp.zeros((), bool)
        overflow = n_valid - n_ok
    return recv, overflow, need2, landed


def make_kmerize_step(mesh, k: int, reads_per_chip: int, read_len: int,
                      capacity_factor: float = 2.0, compact: bool = True,
                      second_round: bool = True, wire: bool = False,
                      shard_hash: str = "prefix",
                      force_second_round: bool = False,
                      _bench_no_dedup: bool = False):
    """Build the jitted multi-chip kmerize step.

    Input (global): codes (D*reads_per_chip, read_len) u8, lengths (D*R,).
    With ``wire=True`` the step instead takes the 0.375 B/base wire form
    (io/wire.py) -- packed (D*R, read_len/16) u32 + mask (D*R, read_len/32) u32 +
    lengths -- and each shard unpacks its local slice on device (elementwise,
    fused); read_len must be a multiple of 8.
    Output (global, sharded by shard): per-shard unique keys hi/lo (D, cap_out),
    counts (D, cap_out), n_unique (D,), overflow (D,), routed (D,) --
    concatenating the valid prefixes of the shard rows yields the globally
    sorted set (with compact=True).

    compact=False leaves each shard's run sentinel-MARKED (duplicates blanked
    in place, no compaction sort) for the sharded device accumulator, which
    re-sorts during its merge (kernels/sortdedup.dedup_mark_sorted).
    ``routed`` is the number of k-mers each shard received this batch -- the
    per-shard routing volume/skew metric (SURVEY.md section 5).

    ``shard_hash="mixed"`` routes by the top bits of a 32-bit avalanche of
    the key (semantics.routing_mix32) instead of the key prefix: balanced
    shards regardless of GC-content skew. The owner id is EMBEDDED in the
    key's spare high bits whenever it fits (max(2k-32,0) + log2(D) <= 31,
    e.g. k=25 up to 8192 shards), so the sender pays the SAME two-operand
    sort as prefix sharding; otherwise it falls back to a third full-width
    mix sort channel. Either way the only remaining mixed-mode cost is a
    final host-side reorder after gathering (per-shard runs are each
    key-sorted, but shard key ranges interleave). A key still maps to
    exactly ONE shard, so duplicates always meet and output bytes are
    identical (SURVEY.md section 7 "hard parts": measure both).

    ``force_second_round=True`` enables the overflow round even at D=1, so
    one device can exercise and measure the skew path: pick a
    capacity_factor < 1 and entries spill into the second round.
    ``_bench_no_dedup=True`` is bench-only: it skips the dedup stage so the
    D=1 step isolates pack+sort+fill+route; its outputs are NOT a valid
    k-mer set.
    """
    S.check_k(k)
    D = mesh.devices.size
    m_local = reads_per_chip * (read_len - k + 1)
    cap = int(np.ceil(m_local * capacity_factor / D))
    cap2 = ((cap + 3) // 4
            if (second_round and D > 1) or force_second_round else 0)
    cap_out = D * (cap + cap2)

    if wire and read_len % 32:
        raise ValueError(f"wire form needs 32 | read_len, got {read_len}")

    if shard_hash not in ("prefix", "mixed"):
        raise ValueError(f"unknown shard_hash {shard_hash!r}")
    p_bits = shard_bits(D)

    def body(codes, lengths):
        hi, lo, w = pack_canonical(codes, lengths, k)
        if shard_hash == "mixed" and p_bits > 0:
            # sentinels route to the last shard, weightless (as in prefix)
            hi, lo, owner, _, _ = _mixed_owner_sort(hi, lo, k, p_bits, D)
            (rhi, rlo), overflow, _, landed = _route(
                hi, lo, k, D, cap, capacity2=cap2, owner=owner)
            rhi = _strip_owner(rhi, rlo, k, p_bits)
        else:
            hi, lo = jax.lax.sort((hi, lo), num_keys=2)
            (rhi, rlo), overflow, _, landed = _route(
                hi, lo, k, D, cap, capacity2=cap2)
        # per-shard received volume from the senders' O(D) landed counts --
        # the old full compare+sum over the received buffer is off the step
        routed = jax.lax.psum(landed, AXIS)[jax.lax.axis_index(AXIS)]
        if D > 1 or cap2:
            # the received buffer is several bucket runs; at D=1 with no
            # second round it is the sender's sorted array, as-is
            rhi, rlo = jax.lax.sort((rhi, rlo), num_keys=2)
        if _bench_no_dedup:
            valid_r = ~((rhi == SENT32) & (rlo == SENT32))
            uhi, ulo = rhi, rlo
            counts = valid_r.astype(jnp.uint32)
            n = jnp.sum(valid_r.astype(jnp.int32))
        elif compact:
            uhi, ulo, counts, n = dedup_count_sorted(rhi, rlo)
        else:
            uhi, ulo, counts, n = dedup_mark_sorted(rhi, rlo)
        return (uhi[None], ulo[None], counts[None],
                n[None].astype(jnp.int32), overflow[None], routed[None])

    if wire:
        from zotpu.io import wire as W

        def local_step(packed, mask, lengths):
            return body(W.unpack_codes(packed, mask), lengths)
        in_specs = (P(AXIS, None), P(AXIS, None), P(AXIS))
    else:
        local_step = body
        in_specs = (P(AXIS, None), P(AXIS))

    # check_vma=False: the collectives here are explicit and covered by the
    # byte-equality tests.
    fn = shard_map(
        local_step, mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(AXIS, None), P(AXIS, None), P(AXIS, None), P(AXIS),
                   P(AXIS), P(AXIS)),
        check_vma=False,
        )
    return jax.jit(fn), cap_out


def hosts_prefix_ordered(mesh) -> bool:
    """True when every host's devices are contiguous in the mesh AND host
    ranges ascend with process index -- the layout gather_local_rows /
    allgather_host_sets rely on to concatenate prefix-sharded results
    already sorted (on an interleaved mesh the concatenation is silently
    unsorted; callers must pass reorder=True instead)."""
    flat = list(mesh.devices.flat)
    seen: dict[int, list[int]] = {}
    for i, d in enumerate(flat):
        seen.setdefault(d.process_index, []).append(i)
    prev_end = -1
    for p in sorted(seen):
        idxs = seen[p]
        if idxs != list(range(idxs[0], idxs[0] + len(idxs))):
            return False
        if idxs[0] <= prev_end:
            return False
        prev_end = idxs[-1]
    return True


def gather_local_rows(uhi, ulo, counts, n_unique, reorder: bool = False):
    """Multi-controller: THIS host's addressable shard rows -> (keys, counts).

    The step outputs are global (D, cap) arrays sharded P(AXIS, None); a
    host may only read its own devices' shards. Rows concatenate in shard
    order, so for prefix sharding the host-local result is itself sorted
    (a host's devices own contiguous key-prefix ranges); mixed sharding
    passes reorder=True (its shard key ranges interleave, and per-batch
    spill runs must be sorted for the final merge)."""
    def by_shard(arr):
        return {s.index[0].start or 0: np.asarray(s.data)
                for s in arr.addressable_shards}

    hs, ls = by_shard(uhi), by_shard(ulo)
    cs, ns = by_shard(counts), by_shard(n_unique)
    keys_out, cnt_out = [], []
    for d in sorted(hs):
        n = int(ns[d][0])
        keys_out.append(S.join_hi_lo(hs[d][0, :n], ls[d][0, :n]))
        cnt_out.append(cs[d][0, :n].astype(S.COUNT_DTYPE))
    keys = np.concatenate(keys_out) if keys_out else np.empty(0, np.uint64)
    cnts = np.concatenate(cnt_out) if cnt_out else np.empty(0, S.COUNT_DTYPE)
    if reorder and len(keys):
        order = np.argsort(keys, kind="stable")
        keys, cnts = keys[order], cnts[order]
    return keys, cnts


def allgather_host_sets(keys, cnts, reorder: bool = False):
    """Combine per-host (keys, counts) into the global set on EVERY host.

    Shard key ranges are disjoint, so no count combining happens; prefix
    sharding concatenates sorted (hosts hold ascending shard ranges in
    process order), mixed passes reorder=True for a final stable sort.
    u64 keys ride as (hi, lo) u32 pairs (x64 stays off); lengths pad to the
    max across hosts."""
    from jax.experimental import multihost_utils as mh

    hi, lo = S.split_hi_lo(keys)
    n = len(keys)
    ns = mh.process_allgather(np.asarray([n], np.int32), tiled=True)
    m = max(int(ns.max()), 1)

    def pad(x):
        out = np.zeros(m, x.dtype)
        out[:len(x)] = x
        return out[None]

    gh = mh.process_allgather(pad(hi), tiled=True)
    gl = mh.process_allgather(pad(lo), tiled=True)
    gc = mh.process_allgather(pad(cnts.astype(np.uint32)), tiled=True)
    keys_out, cnt_out = [], []
    for p in range(len(ns)):
        np_ = int(ns[p])
        keys_out.append(S.join_hi_lo(gh[p, :np_], gl[p, :np_]))
        cnt_out.append(gc[p, :np_].astype(S.COUNT_DTYPE))
    keys = np.concatenate(keys_out)
    cnts = np.concatenate(cnt_out)
    if reorder and len(keys):
        order = np.argsort(keys, kind="stable")
        keys, cnts = keys[order], cnts[order]
    return keys, cnts


def gather_global(uhi, ulo, counts, n_unique, reorder: bool = False):
    """Host-side: concatenate per-shard valid prefixes -> sorted u64
    keys+counts. Key-prefix sharding concatenates globally sorted;
    mixed-hash sharding passes reorder=True for a final sort (keys are
    disjoint across shards either way, so no count combining happens)."""
    keys_out, cnt_out = [], []
    uhi, ulo = np.asarray(uhi), np.asarray(ulo)
    counts, n_unique = np.asarray(counts), np.asarray(n_unique)
    for d in range(uhi.shape[0]):
        n = int(n_unique[d])
        keys_out.append(S.join_hi_lo(uhi[d, :n], ulo[d, :n]))
        cnt_out.append(counts[d, :n].astype(S.COUNT_DTYPE))
    keys = np.concatenate(keys_out) if keys_out else np.empty(0, np.uint64)
    cnts = np.concatenate(cnt_out) if cnt_out else np.empty(0, S.COUNT_DTYPE)
    if reorder and len(keys):
        order = np.argsort(keys, kind="stable")
        keys, cnts = keys[order], cnts[order]
    return keys, cnts


def make_pulldown_step(mesh, k: int, reads_per_chip: int, read_len: int,
                       panel_cap: int, capacity_factor: float = 2.0,
                       wire: bool = False, shard_hash: str = "prefix"):
    """Multi-chip panel pulldown (BASELINE config 5).

    ``wire=True``: input reads arrive in the 0.375 B/base wire form
    (io/wire.py) as (packed, mask, lengths, panel_hi, panel_lo); see
    make_kmerize_step.

    The panel is sharded by the same owner function as kmerize -- key
    prefix, or the 32-bit routing mix with ``shard_hash="mixed"`` (balanced
    under GC skew; hits are psum'd, so unlike kmerize there is no gather
    ordering to repair). Shard d holds the panel keys whose owner is d
    (sentinel-padded to panel_cap; partition_panel must be called with the
    SAME shard_hash). Read k-mers are routed to their owner shard carrying
    their global READ-ROW id; each
    shard probes its panel range with a sort-merge join and the
    per-row hit counts are psum'd across shards -- so the sharded scan yields
    the same per-read output surface as the single-chip path (per-sample
    totals, reads_with_hits, per-read rows, pulldown FASTQ all derive from
    it on the host).

    Input (global): codes (D*R, L), lengths (D*R,), panel_hi/lo
    (D, panel_cap). Output: row_hits (D*R,) int32 (replicated across the
    mesh), overflow (D,).
    """
    from zotpu.kernels.join import _join_xla

    S.check_k(k)
    if shard_hash not in ("prefix", "mixed"):
        raise ValueError(f"unknown shard_hash {shard_hash!r}")
    D = mesh.devices.size
    p_bits = shard_bits(D)
    m_per_read = read_len - k + 1
    m_local = reads_per_chip * m_per_read
    cap = int(np.ceil(m_local * capacity_factor / D))
    cap2 = (cap + 3) // 4 if D > 1 else 0
    R_total = D * reads_per_chip
    if R_total >= 1 << 30:
        raise ValueError(f"{R_total} rows exceed the 2^30 row*2+hit key "
                         f"budget; split the batch")

    def body(codes, lengths, phi, plo):
        phi, plo = phi[0], plo[0]
        hi, lo, w = pack_canonical(codes, lengths, k)
        my = jax.lax.axis_index(AXIS).astype(jnp.uint32)
        rid = (my * reads_per_chip
               + jax.lax.broadcasted_iota(jnp.uint32, (reads_per_chip, 1), 0)
               ).reshape(-1)
        rid = jnp.repeat(rid, m_per_read)
        if shard_hash == "mixed" and p_bits > 0:
            hi, lo, owner, (rid,), _ = _mixed_owner_sort(
                hi, lo, k, p_bits, D, payload=(rid,))
            (rhi, rlo, rrid), overflow, _need2, _landed = _route(
                hi, lo, k, D, cap, payload=(rid,), capacity2=cap2,
                owner=owner)
            rhi = _strip_owner(rhi, rlo, k, p_bits)
        else:
            hi, lo, rid = jax.lax.sort((hi, lo, rid), num_keys=2)
            (rhi, rlo, rrid), overflow, _need2, _landed = _route(
                hi, lo, k, D, cap, payload=(rid,), capacity2=cap2)
        # concat + 3-key sort against the shard's panel, tags are rid+1
        # (0 = panel row)
        hit, tag = _join_xla(phi, plo, rhi, rlo, rrid + jnp.uint32(1))
        cond = hit & (tag > 0)
        # Per-read aggregation without scatter: sort the hit row ids
        # (misses sink to the R_total bin) and take per-row occupancy from
        # searchsorted bin edges; u16 keys when they fit.
        dt = jnp.uint16 if R_total + 1 < (1 << 16) else jnp.int32
        t = jnp.where(cond, tag - jnp.uint32(1),
                      jnp.uint32(R_total)).astype(dt)
        (t,) = jax.lax.sort((t,), num_keys=1)
        bins = jnp.arange(R_total + 1, dtype=dt)
        edges = jnp.searchsorted(t, bins, side="left").astype(jnp.int32)
        hits = jnp.diff(edges)
        hits = jax.lax.psum(hits, AXIS)
        return hits[None], overflow[None]

    if wire:
        if read_len % 32:
            raise ValueError(f"wire form needs 32 | read_len, got {read_len}")
        from zotpu.io import wire as W

        def local_step(packed, mask, lengths, phi, plo):
            return body(W.unpack_codes(packed, mask), lengths, phi, plo)
        in_specs = (P(AXIS, None), P(AXIS, None), P(AXIS),
                    P(AXIS, None), P(AXIS, None))
    else:
        local_step = body
        in_specs = (P(AXIS, None), P(AXIS), P(AXIS, None), P(AXIS, None))

    fn = shard_map(
        local_step, mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(AXIS, None), P(AXIS)),
        check_vma=False,  # see make_kmerize_step note
        )
    return jax.jit(fn)


def partition_panel(panel_keys: np.ndarray, k: int, n_shards: int,
                    panel_cap: int | None = None,
                    shard_hash: str = "prefix"):
    """Host-side: split a sorted panel into per-shard sentinel-padded rows.

    Must use the SAME shard_hash as the pulldown step routing. Each shard's
    row stays sorted by key (the stable owner sort preserves key order
    within an owner), as the per-shard join requires."""
    if shard_hash == "mixed":
        hi, lo = S.split_hi_lo(panel_keys)
        p = shard_bits(n_shards)
        mix = S.routing_mix32(hi, lo)
        owners = (np.minimum(mix >> np.uint32(32 - p),
                             np.uint32(n_shards - 1)).astype(np.int64)
                  if p else np.zeros(len(panel_keys), np.int64))
        order = np.argsort(owners, kind="stable")
        panel_keys, owners = panel_keys[order], owners[order]
    else:
        owners = S.shard_of_u64(k, shard_bits(n_shards), panel_keys)
    bounds = np.searchsorted(owners, np.arange(n_shards + 1))
    sizes = np.diff(bounds)
    cap = panel_cap or max(int(sizes.max()) if len(sizes) else 1, 8)
    phi = np.full((n_shards, cap), 0xFFFFFFFF, np.uint32)
    plo = np.full((n_shards, cap), 0xFFFFFFFF, np.uint32)
    for d in range(n_shards):
        seg = panel_keys[bounds[d]:bounds[d + 1]]
        if len(seg) > cap:
            raise ValueError(f"panel shard {d} ({len(seg)}) exceeds capacity {cap}")
        phi[d, :len(seg)], plo[d, :len(seg)] = S.split_hi_lo(seg)
    return phi, plo, cap
