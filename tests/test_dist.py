"""Multi-chip shard_map tests on the 8-fake-CPU-device mesh (SURVEY.md §4 item 4).

Exercises the all-to-all key-prefix routing, shard ownership, overflow
accounting, and the sharded pulldown — all byte-equal to the golden reference.
"""

import numpy as np
import pytest

from zotpu import semantics as S
from zotpu.dist import mesh as M
from zotpu.dist import shuffle
from zotpu.reference_impl import golden as G
from tests.test_kernels import make_batch


@pytest.fixture(scope="module")
def mesh8():
    return M.make_mesh(8)


def test_distributed_kmerize_matches_golden(mesh8):
    k = 25
    D = 8
    reads_per_chip, read_len = 16, 100
    rng = np.random.default_rng(77)
    seqs, codes, lengths = make_batch(rng, D * reads_per_chip, read_len,
                                      min_len=read_len)
    step, cap_out = shuffle.make_kmerize_step(mesh8, k, reads_per_chip, read_len,
                                              capacity_factor=4.0)
    uhi, ulo, counts, n_unique, overflow, routed = step(codes, lengths)
    uhi = np.asarray(uhi).reshape(D, -1)
    ulo = np.asarray(ulo).reshape(D, -1)
    counts = np.asarray(counts).reshape(D, -1)
    assert np.all(np.asarray(overflow) == 0)
    keys, cnts = shuffle.gather_global(uhi, ulo, counts, np.asarray(n_unique))
    want_k, want_c = G.kmerize(k, seqs)
    assert np.array_equal(keys, want_k)
    assert np.array_equal(cnts, want_c)
    # shard ownership: every key in shard d has owner d
    p = M.shard_bits(D)
    off = 0
    for d in range(D):
        n = int(np.asarray(n_unique)[d])
        owners = S.shard_of_u64(k, p, keys[off:off + n])
        assert np.all(owners == d)
        off += n


def test_distributed_kmerize_with_invalid_bases(mesh8):
    """Ns and short reads: weight-0 entries must not pollute any shard."""
    k = 15
    D = 8
    reads_per_chip, read_len = 8, 60
    rng = np.random.default_rng(3)
    seqs, codes, lengths = make_batch(rng, D * reads_per_chip, read_len,
                                      alphabet="ACGTN")
    step, _ = shuffle.make_kmerize_step(mesh8, k, reads_per_chip, read_len,
                                        capacity_factor=8.0)
    uhi, ulo, counts, n_unique, overflow, routed = step(codes, lengths)
    assert np.all(np.asarray(overflow) == 0)
    keys, cnts = shuffle.gather_global(
        np.asarray(uhi).reshape(D, -1), np.asarray(ulo).reshape(D, -1),
        np.asarray(counts).reshape(D, -1), np.asarray(n_unique))
    want_k, want_c = G.kmerize(k, seqs)
    assert np.array_equal(keys, want_k)
    assert np.array_equal(cnts, want_c)


def test_overflow_counter_reports_drops(mesh8):
    """Tiny capacity must overflow and report it rather than crash."""
    k = 11
    D = 8
    reads_per_chip, read_len = 16, 80
    rng = np.random.default_rng(5)
    _, codes, lengths = make_batch(rng, D * reads_per_chip, read_len,
                                   alphabet="ACGT", min_len=read_len)
    step, _ = shuffle.make_kmerize_step(mesh8, k, reads_per_chip, read_len,
                                        capacity_factor=0.05)
    out = step(codes, lengths)
    overflow = out[4]
    assert int(np.asarray(overflow).sum()) > 0


def test_overflow_second_round_rescues_skew(mesh8):
    """Maximally skewed routing (every k-mer owned by shard 0: poly-A reads)
    that exceeds the first-round bucket capacity must be carried by the
    overflow second round, byte-equal to golden, with zero reported drops."""
    k = 11
    D = 8
    reads_per_chip, read_len = 8, 60
    R = D * reads_per_chip
    seqs = ["A" * read_len] * R
    codes = np.stack([G.encode(s) for s in seqs])
    lengths = np.full(R, read_len, np.int32)
    # each sender routes all m_local k-mers to shard 0; capacity_factor=0.9*D
    # makes the first round 10% short, well within cap2 = cap/4
    step, _ = shuffle.make_kmerize_step(mesh8, k, reads_per_chip, read_len,
                                        capacity_factor=0.9 * D)
    uhi, ulo, counts, n_unique, overflow, routed = step(codes, lengths)
    assert np.all(np.asarray(overflow) == 0)
    keys, cnts = shuffle.gather_global(
        np.asarray(uhi).reshape(D, -1), np.asarray(ulo).reshape(D, -1),
        np.asarray(counts).reshape(D, -1), np.asarray(n_unique))
    want_k, want_c = G.kmerize(k, seqs)
    assert np.array_equal(keys, want_k)
    assert np.array_equal(cnts, want_c)
    # everything landed on shard 0 and the routed metric says so
    r = np.asarray(routed)
    assert r[0] == R * (read_len - k + 1) and np.all(r[1:] == 0)


def test_sharded_marked_mode_matches(mesh8):
    """compact=False (the accumulator hot path) carries the same unique
    keys/counts per shard as the compacted step."""
    from zotpu.kernels.sortdedup import compact_sorted
    import jax

    k = 17
    D = 8
    reads_per_chip, read_len = 8, 70
    rng = np.random.default_rng(13)
    seqs, codes, lengths = make_batch(rng, D * reads_per_chip, read_len,
                                      min_len=read_len)
    outs = []
    for compact in (True, False):
        step, _ = shuffle.make_kmerize_step(mesh8, k, reads_per_chip, read_len,
                                            capacity_factor=6.0,
                                            compact=compact)
        uhi, ulo, counts, n_unique, overflow, _ = step(codes, lengths)
        assert np.all(np.asarray(overflow) == 0)
        uhi = np.asarray(uhi).reshape(D, -1)
        ulo = np.asarray(ulo).reshape(D, -1)
        counts = np.asarray(counts).reshape(D, -1)
        if not compact:
            uhi, ulo, counts = (np.asarray(x) for x in jax.vmap(
                compact_sorted)(uhi, ulo, counts))
        outs.append(shuffle.gather_global(uhi, ulo, counts,
                                          np.asarray(n_unique)))
    assert np.array_equal(outs[0][0], outs[1][0])
    assert np.array_equal(outs[0][1], outs[1][1])
    want_k, want_c = G.kmerize(k, seqs)
    assert np.array_equal(outs[0][0], want_k)


def test_distributed_pulldown_matches_golden(mesh8):
    k = 21
    D = 8
    reads_per_chip, read_len = 8, 90
    n_samples = 4
    rng = np.random.default_rng(11)
    panel_src = ["".join(rng.choice(list("ACGT"), size=400))]
    panel_keys, _ = G.kmerize(k, panel_src)

    R = D * reads_per_chip
    seqs = []
    for i in range(R):
        if i % 3 == 0:
            off = rng.integers(0, 400 - read_len)
            seqs.append(panel_src[0][off:off + read_len])
        else:
            seqs.append("".join(rng.choice(list("ACGT"), size=read_len)))
    codes = np.stack([G.encode(s) for s in seqs])
    lengths = np.full(R, read_len, np.int32)
    sample_ids = (np.arange(R) % n_samples).astype(np.int32)

    phi, plo, cap = shuffle.partition_panel(panel_keys, k, D)
    step = shuffle.make_pulldown_step(mesh8, k, reads_per_chip, read_len,
                                      cap, capacity_factor=8.0)
    row_hits, overflow = step(codes, lengths, phi, plo)
    assert np.all(np.asarray(overflow) == 0)
    row_hits = np.asarray(row_hits).reshape(D, R)[0]

    # per-read hits must match golden exactly; per-sample totals derive
    want_rows = G.scan_panel(k, panel_keys, seqs)
    assert np.array_equal(row_hits, want_rows)
    hits = np.zeros(n_samples, np.int64)
    np.add.at(hits, sample_ids, row_hits)
    want = np.zeros(n_samples, np.int64)
    for i in range(R):
        want[sample_ids[i]] += want_rows[i]
    assert np.array_equal(hits, want)


def test_shard_count_invariance(mesh8):
    """Output must be identical across 1, 2, 4, 8 shards (key-prefix policy)."""
    k = 17
    read_len = 64
    rng = np.random.default_rng(21)
    R = 32
    seqs, codes, lengths = make_batch(rng, R, read_len, alphabet="ACGT",
                                      min_len=read_len)
    want_k, want_c = G.kmerize(k, seqs)
    for D in (1, 2, 4, 8):
        mesh = M.make_mesh(D)
        step, _ = shuffle.make_kmerize_step(mesh, k, R // D, read_len,
                                            capacity_factor=6.0)
        uhi, ulo, counts, n_unique, overflow, routed = step(codes, lengths)
        keys, cnts = shuffle.gather_global(
            np.asarray(uhi).reshape(D, -1), np.asarray(ulo).reshape(D, -1),
            np.asarray(counts).reshape(D, -1), np.asarray(n_unique))
        assert np.array_equal(keys, want_k), f"D={D}"
        assert np.array_equal(cnts, want_c), f"D={D}"


def test_pulldown_sixteen_samples(mesh8):
    """BASELINE config 5 at stated scale: 16 read sets vs a sharded panel."""
    k = 25
    D = 8
    reads_per_chip, read_len = 16, 120
    n_samples = 16
    rng = np.random.default_rng(99)
    genome = "".join(rng.choice(list("ACGT"), size=3000))
    panel_keys, _ = G.kmerize(k, [genome[:1000]])

    R = D * reads_per_chip
    seqs = []
    for i in range(R):
        off = rng.integers(0, len(genome) - read_len)
        seqs.append(genome[off:off + read_len])
    codes = np.stack([G.encode(s) for s in seqs])
    lengths = np.full(R, read_len, np.int32)
    sample_ids = rng.integers(0, n_samples, R).astype(np.int32)

    phi, plo, cap = shuffle.partition_panel(panel_keys, k, D)
    step = shuffle.make_pulldown_step(mesh8, k, reads_per_chip, read_len,
                                      cap, capacity_factor=8.0)
    row_hits, overflow = step(codes, lengths, phi, plo)
    assert np.all(np.asarray(overflow) == 0)
    row_hits = np.asarray(row_hits).reshape(D, R)[0]

    per_read = G.scan_panel(k, panel_keys, seqs)
    assert np.array_equal(row_hits, per_read)
    hits = np.zeros(n_samples, np.int64)
    np.add.at(hits, sample_ids, row_hits)
    want = np.zeros(n_samples, np.int64)
    for i in range(R):
        want[sample_ids[i]] += per_read[i]
    assert np.array_equal(hits, want)
    assert want.sum() > 0  # reads overlapping the panel region must hit


def test_sharded_kmerize_unaligned_max_len(tmp_path):
    """max_len divisible by 8 but not 32 must fall back to the codes path
    (the striped u32 wire form needs 32 | L); regression for the gate left
    at % 8 after the wire v2 layout change."""
    import numpy as np

    from zotpu.reference_impl import golden as G
    from zotpu.workloads import kmerize as W

    rng = np.random.default_rng(5)
    seqs = ["".join(rng.choice(list("ACGT"), size=int(n)))
            for n in rng.integers(20, 40, size=24)]
    p = tmp_path / "r.fasta"
    p.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
    keys, counts = W.kmerize_paths_sharded([str(p)], 13, n_shards=4,
                                           batch_reads=16, max_len=40)
    gk, gc = G.kmerize(13, seqs)
    np.testing.assert_array_equal(keys, gk)
    np.testing.assert_array_equal(counts, gc)


def test_mixed_hash_sharding_byte_equal_and_balanced(tmp_path):
    """--shard-hash mixed: byte-equal output, and balanced routing on
    GC-skewed input where key-prefix sharding is pathological (SURVEY
    section 7 "hard parts": measure both)."""
    import numpy as np

    from zotpu.reference_impl import golden as G
    from zotpu.workloads import kmerize as W

    rng = np.random.default_rng(9)
    # AT-rich reads: canonical keys start with A (code 0) almost always ->
    # key-prefix owners collapse onto shard 0
    seqs = ["".join(rng.choice(list("ATATATATAC"), size=64)) for _ in range(64)]
    p = tmp_path / "r.fasta"
    p.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
    k = 13

    smix = W.Stats()
    km, cm = W.kmerize_paths_sharded([str(p)], k, n_shards=8, batch_reads=64,
                                     max_len=64, stats=smix,
                                     capacity_factor=8.0, shard_hash="mixed")
    spre = W.Stats()
    kp, cp = W.kmerize_paths_sharded([str(p)], k, n_shards=8, batch_reads=64,
                                     max_len=64, stats=spre,
                                     capacity_factor=8.0, shard_hash="prefix")
    gk, gc = G.kmerize(k, seqs)
    np.testing.assert_array_equal(km, gk)
    np.testing.assert_array_equal(cm, gc)
    np.testing.assert_array_equal(kp, gk)
    np.testing.assert_array_equal(cp, gc)

    def skew(routed):
        routed = np.asarray(routed, np.float64)
        return routed.max() / routed.mean()

    assert skew(spre.routed_per_shard) > 2.5   # prefix piles onto low shards
    assert skew(smix.routed_per_shard) < 1.5   # mixed stays balanced
    assert skew(smix.routed_per_shard) < skew(spre.routed_per_shard)


def test_mixed_hash_sharded_scan_matches_golden(tmp_path):
    """scan --shards N --shard-hash mixed: per-read hit counts identical to
    golden (hits are psum'd, so mixed routing needs no gather reordering)."""
    import numpy as np

    from zotpu.reference_impl import golden as G
    from zotpu.workloads import pulldown as PD

    rng = np.random.default_rng(4)
    src = "".join(rng.choice(list("ATATATATGC"), size=400))  # AT-rich panel
    panel_keys, _ = G.kmerize(11, [src])
    seqs = []
    for i in range(32):
        if i % 2:
            off = rng.integers(0, 400 - 50)
            seqs.append(src[off:off + 50])
        else:
            seqs.append("".join(rng.choice(list("ACGTN"), size=50)))
    p = tmp_path / "s.fasta"
    p.write_text("".join(f">r{i}\n{q}\n" for i, q in enumerate(seqs)))
    want = G.scan_panel(11, panel_keys, seqs)
    for mode in ("prefix", "mixed"):
        (tot, rwh, per) = PD.pulldown_paths_sharded(
            panel_keys, [str(p)], 11, 4, batch_reads=16, max_len=64,
            capacity_factor=8.0, shard_hash=mode)[0]
        assert np.array_equal(np.asarray(per, np.int64), want), mode
        assert tot == int(want.sum()) and rwh == int((want > 0).sum())


@pytest.mark.parametrize("D,cf", [(2, 1.35), (4, 1.6)])
def test_sharded_step_second_round_taken_submesh(D, cf):
    """A sub-mesh step whose first-round buckets are too small for the
    busiest owner (canonical keys skew toward low prefixes: ~3/4 of them
    land on shard 0 of 2, ~7/16 on shard 0 of 4): the overflow round
    carries the rest, and the receive side's sort of all bucket runs +
    dedup equals golden."""
    k = 19
    reads_per_chip, read_len = 64, 100
    rng = np.random.default_rng(40 + D)
    seqs, codes, lengths = make_batch(rng, D * reads_per_chip, read_len,
                                      alphabet="ACGT", min_len=read_len)
    step, _ = shuffle.make_kmerize_step(M.make_mesh(D), k, reads_per_chip,
                                        read_len, capacity_factor=cf)
    uhi, ulo, counts, n_unique, overflow, routed = step(codes, lengths)
    assert np.all(np.asarray(overflow) == 0)
    cap = int(np.ceil(reads_per_chip * (read_len - k + 1) * cf / D))
    assert int(np.asarray(routed).max()) > D * cap   # second round taken
    keys, cnts = shuffle.gather_global(
        np.asarray(uhi).reshape(D, -1), np.asarray(ulo).reshape(D, -1),
        np.asarray(counts).reshape(D, -1), np.asarray(n_unique))
    want_k, want_c = G.kmerize(k, seqs)
    assert np.array_equal(keys, want_k)
    assert np.array_equal(cnts, want_c)
    assert int(np.asarray(routed).sum()) == int(want_c.sum())


def test_mixed_owner_embedding_properties(rng):
    """_mixed_owner_sort embedded form: owner non-decreasing (sentinels
    clamp to the LAST shard, not -1 -- regression for a signed-cast bug),
    buckets key-sorted within each owner, and _strip_owner restores the
    original keys exactly."""
    import jax.numpy as jnp

    from zotpu import semantics as S
    from zotpu.dist import shuffle as SH
    from zotpu.kernels.pack import SENT32

    for k, D in ((25, 8), (11, 4), (16, 2)):
        p = int(np.log2(D))
        assert SH._embed_bits(k, p) is not None
        keys = rng.integers(0, 1 << min(2 * k, 63), size=500).astype(np.uint64)
        hi0, lo0 = S.split_hi_lo(keys)
        hi = jnp.concatenate([jnp.asarray(hi0),
                              jnp.full(12, SENT32, jnp.uint32)])
        lo = jnp.concatenate([jnp.asarray(lo0),
                              jnp.full(12, SENT32, jnp.uint32)])
        khi, klo, owner, _, emb = SH._mixed_owner_sort(hi, lo, k, p, D)
        assert emb
        o = np.asarray(owner)
        assert o.min() >= 0 and o.max() <= D - 1
        assert np.all(np.diff(o) >= 0)                      # monotone
        assert np.all(o[-12:] == D - 1)                     # sentinels last
        shi = np.asarray(SH._strip_owner(khi, klo, k, p))
        slo = np.asarray(klo)
        got = S.join_hi_lo(shi, slo)
        # stripped keys = the original multiset; key-sorted within owners
        valid = got != np.uint64(0xFFFFFFFFFFFFFFFF)
        assert sorted(got[valid]) == sorted(keys.tolist())
        for d in range(D):
            seg = got[(o == d) & valid]
            assert np.all(np.diff(seg.astype(np.int64)) >= 0), (k, D, d)
        # owner matches the canonical mixed-routing function
        mix = S.routing_mix32(hi0, lo0)
        expect = np.minimum(mix >> np.uint32(32 - p), np.uint32(D - 1))
        assert np.array_equal(np.sort(o[:500]), np.sort(expect.astype(o.dtype)))


def test_mixed_owner_embedding_fallback():
    """k=31 x 4 shards cannot embed (30 key bits + 2 owner bits > 31):
    _mixed_owner_sort falls back to the separate-mix-channel sort and
    reports tree_ok=False; the sharded kmerize still byte-matches golden."""
    import jax.numpy as jnp

    from zotpu import semantics as S
    from zotpu.dist import shuffle as SH

    assert SH._embed_bits(31, 2) is None
    hi = jnp.asarray(np.array([1, 2, 3], np.uint32))
    lo = jnp.asarray(np.array([7, 8, 9], np.uint32))
    *_, emb = SH._mixed_owner_sort(hi, lo, 31, 2, 4)
    assert not emb


def test_mixed_embedded_receive_path(rng):
    """Full mixed-EMBEDDED receive path: owner sort -> bucket layout ->
    strip -> sort of the received runs == plain sorted set of the input
    keys."""
    import jax
    import jax.numpy as jnp

    from zotpu import semantics as S
    from zotpu.dist import shuffle as SH
    from zotpu.kernels.pack import SENT32

    k, D = 25, 2
    p = 1
    cap = 1 << 14
    n_in = D * cap - 2048                    # >8 sigma bucket slack: no overflow
    keys = rng.integers(0, 1 << 50, size=n_in).astype(np.uint64)
    hi0, lo0 = S.split_hi_lo(keys)
    khi, klo, owner, _, emb = SH._mixed_owner_sort(
        jnp.asarray(hi0), jnp.asarray(lo0), k, p, D)
    assert emb
    # bucket layout exactly as _route builds it (single sender, D buckets)
    o = np.asarray(owner)
    starts = np.searchsorted(o, np.arange(D))
    ends = np.append(starts[1:], n_in)
    rhi = np.full((D, cap), SENT32, np.uint32)
    rlo = np.full((D, cap), SENT32, np.uint32)
    for d in range(D):
        seg = slice(starts[d], ends[d])
        m = ends[d] - starts[d]
        assert m <= cap
        rhi[d, :m] = np.asarray(khi)[seg]
        rlo[d, :m] = np.asarray(klo)[seg]
    rhi = jnp.asarray(rhi.reshape(-1))
    rlo = jnp.asarray(rlo.reshape(-1))
    shi = SH._strip_owner(rhi, rlo, k, p)
    got_h, got_l = jax.lax.sort((shi, rlo), num_keys=2)
    want = np.sort(keys)
    got = S.join_hi_lo(np.asarray(got_h), np.asarray(got_l))
    assert np.array_equal(got[:n_in], want)
    assert np.all(got[n_in:] == np.uint64(0xFFFFFFFFFFFFFFFF))


def test_sharded_step_forced_second_round_one_device():
    """D=1 with the overflow round forced on (what selftest runs on a
    one-device host): gated off (everything fits round one) and taken
    (capacity below the load), marked and compacted output, all golden."""
    from zotpu.kernels.sortdedup import compact_sorted

    k = 21
    rng = np.random.default_rng(5)
    seqs, codes, lengths = make_batch(rng, 24, 90, min_len=60)
    want_k, want_c = G.kmerize(k, seqs)
    mesh = M.make_mesh(1)
    for cf in (1.05, 0.8):
        for compact in (True, False):
            step, _ = shuffle.make_kmerize_step(
                mesh, k, 24, 90, capacity_factor=cf, compact=compact,
                force_second_round=True)
            uhi, ulo, counts, n, ovf, _ = step(codes, lengths)
            assert int(np.asarray(ovf).sum()) == 0, (cf, compact)
            uhi, ulo, counts = (np.asarray(x).reshape(-1)
                                for x in (uhi, ulo, counts))
            if not compact:
                uhi, ulo, counts = (np.asarray(x) for x in
                                    compact_sorted(uhi, ulo, counts))
            nn = int(np.asarray(n)[0])
            assert np.array_equal(S.join_hi_lo(uhi[:nn], ulo[:nn]), want_k)
            assert np.array_equal(counts[:nn], want_c), (cf, compact)


@pytest.mark.slow
def test_sharded_step_marked_output(mesh8):
    """The FULL sharded step with marked (uncompacted) output: compacting
    each shard row yields the golden global set, and routed (from the
    senders' landed counts) sums to the total valid k-mers."""
    k = 17
    D = 8
    reads_per_chip, read_len = 8, 70
    rng = np.random.default_rng(29)
    seqs, codes, lengths = make_batch(rng, D * reads_per_chip, read_len,
                                      min_len=read_len)
    from zotpu.kernels.sortdedup import compact_sorted

    step, cap_out = shuffle.make_kmerize_step(mesh8, k, reads_per_chip,
                                              read_len, capacity_factor=6.0,
                                              compact=False)
    uhi, ulo, counts, n_unique, overflow, routed = step(codes, lengths)
    assert np.all(np.asarray(overflow) == 0)
    uhi = np.asarray(uhi).reshape(D, -1)
    ulo = np.asarray(ulo).reshape(D, -1)
    counts = np.asarray(counts).reshape(D, -1)
    # marked rows: n_unique counts the nonzero-count rows
    assert np.array_equal(np.asarray(n_unique),
                          (counts != 0).sum(axis=1).astype(np.int32))
    uhi, ulo, counts = (np.stack(x) for x in zip(*(
        [np.asarray(a) for a in compact_sorted(uhi[d], ulo[d], counts[d])]
        for d in range(D))))
    keys, cnts = shuffle.gather_global(uhi, ulo, counts, np.asarray(n_unique))
    want_k, want_c = G.kmerize(k, seqs)
    assert np.array_equal(keys, want_k)
    assert np.array_equal(cnts, want_c)
    # routed (landed-count psum) sums to the total valid k-mers
    total_kmers = int(want_c.sum())
    assert int(np.asarray(routed).sum()) == total_kmers


def test_hosts_prefix_ordered():
    """Gather helpers assume contiguous ascending host shard ranges; the
    guard must detect interleaved meshes (ADVICE round 3)."""
    from types import SimpleNamespace

    from zotpu.dist.shuffle import hosts_prefix_ordered

    def mesh_of(pidx):
        devs = np.empty(len(pidx), dtype=object)
        for i, p in enumerate(pidx):
            devs[i] = SimpleNamespace(process_index=p)
        return SimpleNamespace(devices=devs)

    assert hosts_prefix_ordered(mesh_of([0]))
    assert hosts_prefix_ordered(mesh_of([0, 0, 1, 1]))
    assert hosts_prefix_ordered(mesh_of([0, 1, 2, 3]))
    assert not hosts_prefix_ordered(mesh_of([0, 1, 0, 1]))   # interleaved
    assert not hosts_prefix_ordered(mesh_of([1, 1, 0, 0]))   # descending
    assert not hosts_prefix_ordered(mesh_of([0, 0, 2, 2, 1, 1]))


def test_set_op_sharded_byte_equal_and_cardinalities(rng):
    """VERDICT round 3 item 5: key-prefix-sharded set ops must be
    byte-equal to the single-chip kernel at every shard count, and the
    psum'd cardinalities must match the golden sets."""
    from zotpu.workloads import setops as WS

    k = 25
    a_keys = np.unique(rng.integers(0, 1 << (2 * k), 5000, dtype=np.uint64))
    b_keys = np.unique(np.concatenate([
        a_keys[rng.random(len(a_keys)) < 0.3],        # real overlap
        rng.integers(0, 1 << (2 * k), 4000, dtype=np.uint64)]))
    a_c = rng.integers(1, 50, len(a_keys)).astype(np.uint32)
    b_c = rng.integers(1, 50, len(b_keys)).astype(np.uint32)
    n_int = len(np.intersect1d(a_keys, b_keys))
    for op in ("union", "intersect", "diff"):
        want_k, want_c = WS.set_op((a_keys, a_c), (b_keys, b_c), op=op)
        for D in (2, 8):
            got_k, got_c, cards = WS.set_op_sharded(
                (a_keys, a_c), (b_keys, b_c), op, k, D)
            assert np.array_equal(got_k, want_k), (op, D)
            assert np.array_equal(got_c, want_c), (op, D)
            assert cards["a"] == len(a_keys) and cards["b"] == len(b_keys)
            assert cards["intersect"] == n_int, (op, D)
            assert cards["union"] == len(np.union1d(a_keys, b_keys))


def test_set_op_sharded_skewed_prefix(rng):
    """All keys in ONE prefix range (worst skew): other shards see empty
    slices; output must still be byte-equal."""
    from zotpu.workloads import setops as WS

    k = 25
    lim = 1 << (2 * k - 3)                     # everything lands on shard 0
    a_keys = np.unique(rng.integers(0, lim, 3000, dtype=np.uint64))
    b_keys = np.unique(rng.integers(0, lim, 3000, dtype=np.uint64))
    a_c = np.ones(len(a_keys), np.uint32)
    b_c = np.ones(len(b_keys), np.uint32)
    want_k, want_c = WS.set_op((a_keys, a_c), (b_keys, b_c), op="union")
    got_k, got_c, _ = WS.set_op_sharded((a_keys, a_c), (b_keys, b_c),
                                        "union", k, 8)
    assert np.array_equal(got_k, want_k)
    assert np.array_equal(got_c, want_c)


def test_jaccard_sharded_matches_host(rng):
    from zotpu.workloads import setops as WS

    k = 19
    a_keys = np.unique(rng.integers(0, 1 << (2 * k), 2000, dtype=np.uint64))
    b_keys = np.unique(np.concatenate([
        a_keys[::3], rng.integers(0, 1 << (2 * k), 1500, dtype=np.uint64)]))
    r = WS.jaccard_sharded(a_keys, b_keys, k, 8)
    ni = len(np.intersect1d(a_keys, b_keys))
    nu = len(np.union1d(a_keys, b_keys))
    assert (r["a"], r["b"], r["intersect"], r["union"]) == (
        len(a_keys), len(b_keys), ni, nu)
    assert r["jaccard"] == pytest.approx(ni / nu)


def test_set_op_sharded_stream_byte_equal(rng, tmp_path):
    """VERDICT round 4 item 4: the ChunkReader-streamed sharded set op must
    be byte-equal to the in-RAM sharded path (and so to single-chip) at a
    chunk size small enough to force many chunks per shard."""
    from zotpu.io import container
    from zotpu.workloads import setops as WS

    k = 25
    a_keys = np.unique(rng.integers(0, 1 << (2 * k), 6000, dtype=np.uint64))
    b_keys = np.unique(np.concatenate([
        a_keys[rng.random(len(a_keys)) < 0.4],
        rng.integers(0, 1 << (2 * k), 5000, dtype=np.uint64)]))
    a_c = rng.integers(1, 90, len(a_keys)).astype(np.uint32)
    b_c = rng.integers(1, 90, len(b_keys)).astype(np.uint32)
    pa, pb = str(tmp_path / "a.zkf"), str(tmp_path / "b.zkf")
    container.write(pa, container.KmerSet(k=k, keys=a_keys, counts=a_c))
    container.write(pb, container.KmerSet(k=k, keys=b_keys, counts=b_c),
                    codec="zlib")   # streamed decode must work per codec
    n_int = len(np.intersect1d(a_keys, b_keys))
    for op in ("union", "intersect", "diff"):
        want_k, want_c = WS.set_op((a_keys, a_c), (b_keys, b_c), op=op)
        kk, got_k, got_c, cards = WS.set_op_sharded_stream(
            pa, pb, op, 8, chunk=512)
        assert kk == k
        assert np.array_equal(got_k, want_k), op
        assert np.array_equal(got_c, want_c), op
        assert cards["intersect"] == n_int
        assert cards["a"] == len(a_keys) and cards["b"] == len(b_keys)


def test_set_op_sharded_stream_k_mismatch(rng, tmp_path):
    from zotpu.io import container
    from zotpu.workloads import setops as WS

    ka = np.unique(rng.integers(0, 1 << 30, 100, dtype=np.uint64))
    container.write(str(tmp_path / "a.zkf"),
                    container.KmerSet(k=17, keys=ka,
                                      counts=np.ones(len(ka), np.uint32)))
    container.write(str(tmp_path / "b.zkf"),
                    container.KmerSet(k=19, keys=ka,
                                      counts=np.ones(len(ka), np.uint32)))
    with pytest.raises(ValueError, match="K mismatch"):
        WS.set_op_sharded_stream(str(tmp_path / "a.zkf"),
                                 str(tmp_path / "b.zkf"), "union", 8)


def test_partition_cache_reused_across_pairs(rng):
    """VERDICT round 4 item 7: an N-way matrix partitions each set ONCE.
    The cache must hold one entry per (set, shard-count) and return
    identical results on reuse."""
    from zotpu.workloads import setops as WS

    k = 19
    sets = [np.unique(rng.integers(0, 1 << (2 * k), 1200, dtype=np.uint64))
            for _ in range(3)]
    cache: dict = {}
    got = {}
    for i in range(3):
        for j in range(i + 1, 3):
            got[(i, j)] = WS.jaccard_sharded(sets[i], sets[j], k, 8,
                                             cache=cache)
    assert len(cache) == 3          # one partition per set, not per pair
    for (i, j), r in got.items():
        ni = len(np.intersect1d(sets[i], sets[j]))
        nu = len(np.union1d(sets[i], sets[j]))
        assert (r["intersect"], r["union"]) == (ni, nu), (i, j)


def test_pulldown_sentinel_heavy_matches_golden(mesh8):
    """Short, N-laden reads (most windows invalid: sentinel probes that
    route as bucket padding) through the sharded pulldown: per-read hits
    equal golden."""
    k = 15
    D = 8
    reads_per_chip, read_len = 6, 64
    rng = np.random.default_rng(19)
    panel_src = "".join(rng.choice(list("ACGT"), size=300))
    panel_keys, _ = G.kmerize(k, [panel_src])
    R = D * reads_per_chip
    seqs = []
    for i in range(R):
        n = int(rng.integers(5, read_len + 1))
        if i % 2 == 0:
            off = int(rng.integers(0, 300 - n))
            s = list(panel_src[off:off + n])
            for j in rng.integers(0, n, size=max(n // 10, 1)):
                s[j] = "N"
            seqs.append("".join(s))
        else:
            seqs.append("".join(rng.choice(list("ACGTN"), size=n)))
    codes = np.full((R, read_len), 4, np.uint8)
    lengths = np.zeros(R, np.int32)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = G.encode(s)
        lengths[i] = len(s)
    phi, plo, cap = shuffle.partition_panel(panel_keys, k, D)
    step = shuffle.make_pulldown_step(mesh8, k, reads_per_chip, read_len,
                                      cap, capacity_factor=8.0)
    row_hits, overflow = step(codes, lengths, phi, plo)
    assert np.all(np.asarray(overflow) == 0)
    got = np.asarray(row_hits).reshape(D, R)[0]
    want = G.scan_panel(k, panel_keys, seqs)
    assert want.sum() > 0
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shard_hash", ["prefix", "mixed"])
def test_pulldown_sharded_matches_golden(mesh8, shard_hash):
    """The sharded pulldown step (route with read-row ids, per-shard 3-key
    join, psum'd hits) matches golden per-read hits exactly, for both
    owner functions."""
    k = 21
    D = 8
    reads_per_chip, read_len = 8, 90
    rng = np.random.default_rng(11)
    panel_src = ["".join(rng.choice(list("ACGT"), size=400))]
    panel_keys, _ = G.kmerize(k, panel_src)

    R = D * reads_per_chip
    seqs = []
    for i in range(R):
        if i % 3 == 0:
            off = rng.integers(0, 400 - read_len)
            seqs.append(panel_src[0][off:off + read_len])
        else:
            seqs.append("".join(rng.choice(list("ACGT"), size=read_len)))
    codes = np.stack([G.encode(s) for s in seqs])
    lengths = np.full(R, read_len, np.int32)

    phi, plo, cap = shuffle.partition_panel(panel_keys, k, D,
                                            shard_hash=shard_hash)
    step = shuffle.make_pulldown_step(mesh8, k, reads_per_chip, read_len,
                                      cap, capacity_factor=8.0,
                                      shard_hash=shard_hash)
    row_hits, overflow = step(codes, lengths, phi, plo)
    assert np.all(np.asarray(overflow) == 0)
    row_hits = np.asarray(row_hits).reshape(D, R)[0]
    want_rows = G.scan_panel(k, panel_keys, seqs)
    assert np.array_equal(row_hits, want_rows)
