"""Performance harness (SURVEY.md section 7 step 7).

Measures the BASELINE metrics on whatever platform jax selected (the GPU in
driver runs, CPU in tests): kmerize bases/s and k-mers/s/chip, sorted-set-op
GB/s. Timers end with a host transfer of a result that depends on the whole
step, after a warmup/compile step.
"""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from zotpu.io import wire
from zotpu.kernels import pack, setops, sortdedup


def _synth_codes(rng, reads, length):
    return rng.integers(0, 4, size=(reads, length), endpoint=False).astype(np.uint8)


class _Fixture:
    """Read-batch generator for the device benches.

    kind="uniform": i.i.d. random bases -- dedup ratio ~1, the unique set
    grows without bound (the round-1..4 fixture; cheapest operating point
    for dedup/count-combine, worst-case growth for the accumulator).

    kind="coverage": the E. coli-shaped workload BASELINE config 1 names --
    reads drawn from ONE deterministic synthetic genome (default sized so
    the whole run is ~30x coverage) with a 0.5% per-base substitution error
    rate. Real duplicate segments exercise the count-combine paths at a
    realistic dedup ratio, and the accumulator's unique set saturates near
    genome size plus the error tail instead of growing linearly.
    """

    def __init__(self, kind: str, seed: int = 0,
                 genome_bases: int | None = None,
                 total_bases: int | None = None,
                 error_rate: float = 0.005):
        if kind not in ("uniform", "coverage"):
            raise ValueError(f"unknown fixture {kind!r}")
        self.kind = kind
        self.rng = np.random.default_rng(seed)
        self.error_rate = error_rate
        self.genome = None
        if kind == "coverage":
            if genome_bases is None:
                # size the genome for ~30x over the run's total bases
                genome_bases = max((total_bases or (1 << 25)) // 30, 1 << 20)
            self.genome = self.rng.integers(0, 4, size=genome_bases,
                                            dtype=np.int64)

    def codes(self, reads: int, length: int) -> np.ndarray:
        if self.kind == "uniform":
            return _synth_codes(self.rng, reads, length)
        offs = self.rng.integers(0, len(self.genome) - length, reads)
        codes = self.genome[offs[:, None]
                            + np.arange(length)[None, :]].astype(np.uint8)
        n_err = int(reads * length * self.error_rate)
        if n_err:
            er = self.rng.integers(0, reads, n_err)
            ec = self.rng.integers(0, length, n_err)
            codes[er, ec] = self.rng.integers(0, 4, n_err).astype(np.uint8)
        return codes


def _amortized_time(dispatch, fence, repeats: int = 3, n: int = 4):
    """Per-dispatch seconds with the host-sync latency amortized away:
    min-of-repeats time(N dispatches + 1 fence) vs (1 dispatch + 1 fence);
    the slope is the per-batch device cost. The production pipeline never
    pays a host sync per batch (dispatch is async; the accumulator's
    result() is the ONE sync of a whole run), so charging one per batch
    understates steady-state throughput. Returns (slope_s, single_sync_s).

    When the first single-dispatch rep takes seconds, extra repeats buy
    noise reduction at minutes of wall cost -- fall back to one rep per
    point."""
    def t_of(m, reps):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            r = None
            for _ in range(m):
                r = dispatch()
            fence(r)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t1 = t_of(1, 1)
    reps = 1 if t1 > 2.0 else repeats
    if reps > 1:
        t1 = min(t1, t_of(1, reps - 1))
    tn = t_of(n, reps)
    slope = (tn - t1) / (n - 1)
    if slope <= 0:
        # A transfer stall during the 1-dispatch point (single-rep mode)
        # can make tn < t1; clamping to ~0 would turn the HEADLINE into an
        # absurd ~1e16 bases/s. Fall back to the full single-sync time:
        # degraded (charges the sync per batch) but sane.
        return t1, t1
    return slope, t1


def bench_kmerize(total_bases: int, k: int = 25, read_len: int = 256,
                  repeats: int = 3, fixture: str = "uniform",
                  fx: "_Fixture | None" = None) -> dict:
    fx = fx or _Fixture(fixture, total_bases=8 * total_bases)
    reads = max(total_bases // read_len, 1)
    pw, mw = wire.pack_codes(fx.codes(reads, read_len))
    pw, mw = jnp.asarray(pw), jnp.asarray(mw)
    lengths = jnp.full(reads, read_len, jnp.int32)

    @jax.jit
    def step(pw, mw, l):
        # The returned scalar depends on the whole pipeline and is synced via
        # host transfer, which is the timer fence. compact=False is the
        # production per-batch path (the accumulator consumes marked runs;
        # compaction happens once at the end of a run). Input is the 2-bit
        # wire form exactly as production ships it.
        hi, lo, w = pack.pack_canonical(wire.unpack_codes(pw, mw), l, k)
        uhi, ulo, counts, n = sortdedup.kmer_sort_dedup(hi, lo, w,
                                                        compact=False)
        return n + jnp.sum(counts, dtype=jnp.uint32).astype(jnp.int32)

    int(np.asarray(step(pw, mw, lengths)))  # compile + warmup
    dt, dt_sync = _amortized_time(lambda: step(pw, mw, lengths),
                                  lambda r: int(np.asarray(r)),
                                  repeats=repeats)
    bases = reads * read_len
    kmers = reads * (read_len - k + 1)
    return {
        "workload": "kmerize", "k": k, "bases": bases,
        "fixture": fx.kind,
        "seconds": dt,
        "seconds_single_sync": dt_sync,
        "bases_per_s": bases / dt,
        "kmers_per_s": kmers / dt,
    }


def bench_setops(n: int = 1 << 24, repeats: int = 3) -> dict:
    """Sorted-set merge GB/s (BASELINE metric 2). n = 16M keys/side (a
    small genome's unique-kmer set): large enough that dispatch latency
    doesn't swamp the kernel."""
    rng = np.random.default_rng(1)
    def mk(seed):
        keys = np.sort(rng.integers(0, 1 << 50, size=n).astype(np.uint64))
        keys = np.unique(keys)
        hi = np.full(n, 0xFFFFFFFF, np.uint32)
        lo = np.full(n, 0xFFFFFFFF, np.uint32)
        c = np.zeros(n, np.uint32)
        hi[:len(keys)] = (keys >> np.uint64(32)).astype(np.uint32)
        lo[:len(keys)] = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        c[:len(keys)] = 1
        return jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(c)

    ahi, alo, ac = mk(0)
    bhi, blo, bc = mk(1)

    def step():
        hi, lo, c, n_out = setops.set_op(ahi, alo, ac, bhi, blo, bc,
                                         op="merge")
        # host-transfer fence (see bench_kmerize)
        return int(np.asarray(n_out + jnp.sum(c, dtype=jnp.uint32)
                              .astype(jnp.int32)))

    step()  # compile + warmup
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    dt = min(times)
    bytes_moved = 2 * n * 12  # two inputs of (hi,lo,count) u32 triples
    return {
        "workload": "setops_merge", "n": 2 * n, "seconds": dt,
        "gb_per_s": bytes_moved / dt / 1e9,
        "keys_per_s": 2 * n / dt,
    }


def bench_scan(n_reads: int = 1 << 17, read_len: int = 256, k: int = 25,
               panel_size: int = 1 << 20, repeats: int = 3) -> dict:
    """Panel pulldown probe rate (BASELINE config 5 single-chip): packed
    k-mers probed against a device-resident sorted panel, k-mers/s."""
    from zotpu.reference_impl import golden as G
    from zotpu.workloads import pulldown

    rng = np.random.default_rng(2)
    # Realistic pulldown mix: most reads are background, ~5% come from a
    # source genome whose k-mers seed part of the panel -- so the measured
    # step includes live hits flowing through the per-read aggregation (a
    # zero-hit synthetic would make the sparse fast path trivially cheap).
    genome = rng.integers(0, 4, size=100_000, endpoint=False).astype(np.uint8)
    gkeys, _ = G.kmerize(k, [genome])    # golden accepts 2-bit code arrays
    panel = np.unique(np.concatenate([
        gkeys, rng.integers(0, 1 << (2 * k), panel_size,
                            dtype=np.uint64).astype(np.uint64)]))
    phi, plo = pulldown.panel_to_device(panel)
    codes = _synth_codes(rng, n_reads, read_len)
    src = n_reads // 20
    offs = rng.integers(0, len(genome) - read_len, src)
    for i, off in enumerate(offs):        # every 20th read is genomic
        codes[i * 20] = genome[off:off + read_len]
    # the production scan ships the 2-bit wire form; measure that step
    pw, mw = wire.pack_codes(codes)
    pw, mw = jnp.asarray(pw), jnp.asarray(mw)
    lengths = jnp.full(n_reads, read_len, jnp.int32)

    def step():
        hits = pulldown.scan_batch_wire(pw, mw, lengths, phi, plo, k)
        return int(np.asarray(jnp.sum(hits)))  # host-transfer fence

    total_hits = step()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    dt = min(times)
    kmers = n_reads * (read_len - k + 1)
    return {
        "workload": "scan", "k": k, "panel": len(panel),
        "kmers_probed": kmers, "total_hits": total_hits, "seconds": dt,
        "kmers_per_s": kmers / dt,
        "bases_per_s": n_reads * read_len / dt,
    }


def bench_scan_shard_model(n_reads: int = 1 << 17, read_len: int = 256,
                           k: int = 25, panel_size: int = 1 << 20,
                           repeats: int = 3) -> dict:
    """Host-scale composition for BASELINE config 5: the FULL sharded
    pulldown program at D=1 on one device -- panel partition, k-mer routing
    with global read-row ids, per-shard sort-merge join, psum'd per-row
    hits -- timed dispatch-amortized; the 8-device host line composes as
    8 x the per-device probe rate at the same 0.8 efficiency floor as the
    kmerize headline (the psum'd (R,) i32 hit vector is the only
    cross-device traffic beyond the k-mer all-to-all, whose per-device
    volume is reported for the link budget)."""
    from zotpu.dist import mesh as M
    from zotpu.dist import shuffle
    from zotpu.reference_impl import golden as G

    rng = np.random.default_rng(2)
    # same realistic mix as bench_scan: ~5% genomic reads seeding part of
    # the panel, so live hits flow through the aggregation
    genome = rng.integers(0, 4, size=100_000, endpoint=False).astype(np.uint8)
    gkeys, _ = G.kmerize(k, [genome])
    panel = np.unique(np.concatenate([
        gkeys, rng.integers(0, 1 << (2 * k), panel_size,
                            dtype=np.uint64).astype(np.uint64)]))
    codes = _synth_codes(rng, n_reads, read_len)
    src = n_reads // 20
    offs = rng.integers(0, len(genome) - read_len, src)
    for i, off in enumerate(offs):
        codes[i * 20] = genome[off:off + read_len]
    pw, mw = wire.pack_codes(codes)
    pw, mw = jnp.asarray(pw), jnp.asarray(mw)
    lengths = jnp.full(n_reads, read_len, jnp.int32)

    mesh = M.make_mesh(1)
    phi, plo, cap = shuffle.partition_panel(panel, k, 1)
    step = shuffle.make_pulldown_step(mesh, k, n_reads, read_len, cap,
                                      capacity_factor=1.05, wire=True)

    @jax.jit
    def prog(pw, mw, l, phi, plo):
        row_hits, overflow = step(pw, mw, l, phi, plo)
        return jnp.sum(row_hits) + jnp.sum(overflow)

    def fence(r):
        return int(np.asarray(r))

    total_hits = fence(prog(pw, mw, lengths, phi, plo))  # compile + warmup
    dt, dt_sync = _amortized_time(lambda: prog(pw, mw, lengths, phi, plo),
                                  fence, repeats=repeats)
    kmers = n_reads * (read_len - k + 1)
    out = {
        "workload": "scan_shard_model", "k": k, "panel": len(panel),
        "kmers_probed": kmers, "total_hits": total_hits,
        "t_sharded_step_s": dt, "t_single_sync_s": dt_sync,
        "kmers_per_s_chip": kmers / dt,
        "alltoall_bytes_per_chip": kmers * 12,   # (hi, lo, tag) u32 triple
    }
    out["t_chip_model8_s"] = dt
    out["host8_kmers_per_s_at_0.8_eff"] = kmers / dt * 8 * 0.8
    out["link_gbps_needed_for_0.8_eff"] = kmers * 12 / (dt / 4) / 1e9
    return out


def bench_setops_shard_model(n: int = 1 << 24, k: int = 25,
                             repeats: int = 3) -> dict:
    """Host-scale composition for BASELINE config 3: the sharded set-op
    program -- shard_map over the mesh, per-shard set_op, psum'd
    cardinalities -- measured at D=1 on one device with 2 x 16M keys PER
    SHARD (what each of 8 shards runs concurrently on an 8-device host over
    a 2 x 128M-key pair),
    timed dispatch-amortized. Host line = 8 x the per-shard byte rate at
    the kmerize headline's 0.8 efficiency floor; the only cross-chip
    traffic is the 3-scalar psum (key-prefix partition means shard slices
    never talk), so the floor is extremely conservative here."""
    from zotpu.workloads.setops import (_partition_sorted_prefix,
                                        _sharded_setop_fn)

    rng = np.random.default_rng(1)

    def mk():
        keys = np.unique(rng.integers(0, 1 << (2 * k), size=n)
                         .astype(np.uint64))
        return keys, np.ones(len(keys), np.uint32)

    a_keys, a_c = mk()
    b_keys, b_c = mk()
    ahi, alo, ac = (jnp.asarray(x) for x in
                    _partition_sorted_prefix(a_keys, a_c, k, 1))
    bhi, blo, bc = (jnp.asarray(x) for x in
                    _partition_sorted_prefix(b_keys, b_c, k, 1))
    fn = _sharded_setop_fn("merge", 1)

    def dispatch():
        return fn(ahi, alo, ac, bhi, blo, bc)

    def fence(out):
        return int(np.asarray(out[4]).sum())

    fence(dispatch())  # compile + warmup
    dt, dt_sync = _amortized_time(dispatch, fence, repeats=repeats)
    bytes_shard = (len(a_keys) + len(b_keys)) * 12
    return {
        "workload": "setops_shard_model", "n_per_shard": 2 * n,
        "t_shard_step_s": dt, "t_single_sync_s": dt_sync,
        "gb_per_s_shard": bytes_shard / dt / 1e9,
        "host8_gb_per_s_at_0.8_eff": bytes_shard / dt / 1e9 * 8 * 0.8,
    }


def run(args) -> int:
    # optional size overrides (tests shrink these; CLI uses full defaults)
    setops_n = getattr(args, "setops_n", None) or (1 << 24)
    scan_reads = getattr(args, "scan_reads", None) or (1 << 17)
    scan_panel = getattr(args, "scan_panel", None) or (1 << 20)
    results = []
    if args.workload in ("kmerize", "all"):
        results.append(bench_kmerize(args.bases, k=args.k, repeats=args.repeats))
    if args.workload in ("setops", "all"):
        results.append(bench_setops(n=setops_n, repeats=args.repeats))
    if args.workload in ("scan", "all"):
        results.append(bench_scan(n_reads=scan_reads, panel_size=scan_panel,
                                  repeats=args.repeats, k=args.k))
    if args.workload in ("scan-shard-model", "all"):
        results.append(bench_scan_shard_model(
            n_reads=scan_reads, panel_size=scan_panel,
            repeats=args.repeats, k=args.k))
    if args.workload in ("setops-shard-model", "all"):
        results.append(bench_setops_shard_model(n=setops_n,
                                                repeats=args.repeats))
    if args.workload in ("scaling", "all"):
        results.extend(bench_scaling(repeats=args.repeats))
    if args.workload in ("shard-model", "all"):
        results.append(bench_shard_model(total_bases=args.bases, k=args.k,
                                         repeats=args.repeats))
    if args.workload in ("shard-sensitivity", "all"):
        results.append(bench_shard_sensitivity(total_bases=args.bases,
                                               k=args.k,
                                               repeats=args.repeats))
    if args.workload in ("sustained", "all"):
        results.append(bench_sustained(total_bases=args.bases, k=args.k))
    if args.workload in ("parse", "all"):
        results.append(bench_parse(total_bases=args.bases * 2, k=args.k))
    if args.workload in ("e2e", "all"):
        results.append(bench_e2e(total_bases=args.bases, k=args.k,
                                 repeats=args.repeats))
    for r in results:
        r["device"] = str(jax.devices()[0])
        print(json.dumps(r))
    return 0


def bench_scaling(reads_per_chip: int = 512, read_len: int = 256, k: int = 25,
                  repeats: int = 3) -> list[dict]:
    """Weak-scaling efficiency of the sharded kmerize step (BASELINE metric 3).

    Runs the full distributed step (pack -> key-prefix all_to_all -> per-shard
    sort/dedup) at D = 1, 2, 4, ... over the available devices with constant
    per-chip load; efficiency_D = t(1) / t(D) (ideal weak scaling keeps t
    flat). On a single-device host this only yields the D=1 row; on a
    multi-device host (or the 8-fake-device CPU mesh) it exercises the
    collective path.
    """
    import numpy as np

    from zotpu.dist import mesh as M
    from zotpu.dist import shuffle

    rng = np.random.default_rng(0)
    results = []
    t1 = None
    D = 1
    ndev = len(jax.devices())
    while D <= ndev:
        mesh = M.make_mesh(D)
        R = D * reads_per_chip
        codes = rng.integers(0, 4, size=(R, read_len)).astype(np.uint8)
        lengths = np.full(R, read_len, np.int32)
        step, _ = shuffle.make_kmerize_step(mesh, k, reads_per_chip, read_len,
                                            capacity_factor=4.0)
        out = step(codes, lengths)
        int(np.asarray(out[3]).sum())  # compile + fence
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = step(codes, lengths)
            int(np.asarray(out[3]).sum())
            times.append(time.perf_counter() - t0)
        dt = min(times)
        if t1 is None:
            t1 = dt
        results.append({
            "workload": "kmerize_scaling", "devices": D,
            "bases": R * read_len, "seconds": dt,
            "bases_per_s": R * read_len / dt,
            "weak_scaling_efficiency": t1 / dt,
        })
        D *= 2
    return results


def bench_shard_model(total_bases: int = 1 << 25, k: int = 25,
                      read_len: int = 256, repeats: int = 3,
                      progress=None, fixture: str = "uniform",
                      acc_batches: int = 8) -> dict:
    """Measured grounding for the multi-device projection (BASELINE metric 3).

    What can be measured on ONE device (an 8-fake-device CPU mesh measures
    host parallelism artifacts, not device scaling):

    - t_plain: the single-device kmerize step (the headline).
    - t_step_nodedup: the FULL sharded program at D=1 -- pack, owner sort,
      bucket fill, (no-op) all_to_all -- with dedup skipped.
      t_step_nodedup/t_plain is the per-device price of the routing
      machinery; it multiplies directly into host-level throughput.
    - t_receive_sort8_dedup: the receive side each of 8 shards runs per
      batch at D=8 shapes -- one sort of the 8 received runs + dedup.
    - the per-device all-to-all volume (8 B per packed k-mer each way), from
      which the link bandwidth needed for >= 0.8 weak-scaling efficiency
      follows: t_comm <= t_chip/4 (efficiency = t/(t+t_comm)).

    Reported as a model with measured inputs, NOT as a measured efficiency.
    A stage that fails records its error under ``errors`` and the model
    keeps the terms measured so far.

    ``progress``, if given, is called with a COPY of the result dict after
    each measured stage, so a parent timeout still harvests every stage
    that finished.
    """
    from zotpu.dist import mesh as M
    from zotpu.dist import shuffle

    # ONE fixture generator feeds the step codes AND (via bench_kmerize
    # below) the plain term, so every model term reflects the same workload
    # shape. fixture="coverage" is the E. coli-shaped 30x regime; the genome
    # here is sized for a 30x run of acc_batches host batches.
    fx = _Fixture(fixture, total_bases=acc_batches * total_bases)
    reads = max(total_bases // read_len, 1)
    codes = fx.codes(reads, read_len)
    lengths = jnp.asarray(np.full(reads, read_len, np.int32))
    mesh = M.make_mesh(1)
    kmers = reads * (read_len - k + 1)
    bytes_each_way = kmers * 8           # (hi, lo) u32 pair per k-mer
    out = {"workload": "kmerize_shard_model", "k": k,
           "bases": reads * read_len, "kmers": kmers, "fixture": fx.kind,
           "acc_batches": acc_batches,
           "alltoall_bytes_per_chip": bytes_each_way}

    def emit():
        if progress is not None:
            progress(dict(out))

    def record_error(stage, e):
        out.setdefault("errors", {})[stage] = f"{type(e).__name__}: {e}"[:300]

    def compose():
        """(Re)compute the composed 8-device model from whichever terms are
        measured so far; every partial carries the best model available."""
        t8 = (out["t_step_nodedup_s"] + out.get("t_receive_sort8_dedup_s", 0.0)
              + out.get("t_acc_amortized8_s", 0.0))
        out["t_chip_model8_s"] = t8
        out["host8_bases_per_s_at_0.8_eff"] = reads * read_len / t8 * 8 * 0.8
        out["link_gbps_needed_for_0.8_eff"] = bytes_each_way / (t8 / 4) / 1e9

    # stage 1: the plain single-device step (feeds the fallback headline)
    plain = bench_kmerize(total_bases, k=k, read_len=read_len,
                          repeats=repeats, fx=fx)
    out["t_plain_s"] = plain["seconds"]
    out["plain_bases_per_s"] = plain["bases_per_s"]
    out["plain_seconds_single_sync"] = plain["seconds_single_sync"]
    emit()

    # stage 2: the FULL sharded program at D=1, dedup skipped (at D >= 2
    # the receive sort + dedup is the stage-3 term)
    step, _ = shuffle.make_kmerize_step(mesh, k, reads, read_len,
                                        capacity_factor=1.03, compact=False,
                                        wire=True, _bench_no_dedup=True)
    pw, mw = wire.pack_codes(codes)
    pw, mw = jnp.asarray(pw), jnp.asarray(mw)

    def fence(o):
        return int(np.asarray(o[3]).sum()) + int(np.asarray(o[4]).sum())

    def timeit(fn, *args):
        fn(*args)  # compile + warmup
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
            if times[-1] > 2.0:
                break      # slow point: see _amortized_time
        return min(times)

    fence(step(pw, mw, lengths))  # compile + warmup
    t_step, t_step_sync = _amortized_time(
        lambda: step(pw, mw, lengths), fence, repeats=repeats)
    out["t_step_nodedup_s"] = t_step
    out["sharded_step_overhead"] = t_step / plain["seconds"]
    out["sharded_bases_per_s"] = reads * read_len / t_step
    compose()
    emit()

    # stage 3: the receive side at D=8 shapes, on this device (it is
    # per-device code): 8 interleaved-range key-sorted runs -> one sort of
    # the whole received buffer + dedup, minus the front that builds them.
    try:
        D = 8
        cap8 = -(-kmers // D)

        def sorted_runs(pw, mw, l):
            hi, lo, _ = pack.pack_canonical(wire.unpack_codes(pw, mw), l, k)
            pad = D * cap8 - hi.shape[0]
            hi = jnp.pad(hi, (0, pad), constant_values=np.uint32(0xFFFFFFFF))
            lo = jnp.pad(lo, (0, pad), constant_values=np.uint32(0xFFFFFFFF))
            # 8 independently sorted chunks of the unsorted k-mer stream:
            # interleaved key ranges, like real received runs
            return jax.lax.sort((hi.reshape(D, cap8), lo.reshape(D, cap8)),
                                num_keys=2, dimension=1)

        @jax.jit
        def receive(pw, mw, l):
            hi, lo = sorted_runs(pw, mw, l)
            hi, lo = jax.lax.sort((hi.reshape(-1), lo.reshape(-1)),
                                  num_keys=2)
            uh, ul, cnt, nn = sortdedup.dedup_mark_sorted(hi, lo)
            return uh[0] + cnt[0] + nn.astype(jnp.uint32)

        @jax.jit
        def front(pw, mw, l):
            hi, lo = sorted_runs(pw, mw, l)
            return hi[0, 0] + lo[-1, -1]

        tt = timeit(lambda *a: int(np.asarray(receive(*a))), pw, mw, lengths)
        tf = timeit(lambda *a: int(np.asarray(front(*a))), pw, mw, lengths)
        out["t_receive_sort8_dedup_s"] = max(tt - tf, 0.0)
        compose()
        emit()
    except Exception as e:
        record_error("receive_sort8", e)

    # stage 4: amortized per-batch LSM accumulator cost at the model's
    # shapes: each shard accumulates one run of ~kmers entries per host
    # batch (its 1/8 share of the 8-device batch) -- exactly
    # bench_sustained's per-batch load. The amortized merge term is
    # sustained per-batch MINUS the bare step both runs share.
    try:
        su = bench_sustained(total_bases=total_bases, k=k,
                             read_len=read_len, batches=acc_batches,
                             fixture=fixture)
        out["sustained_per_batch_s"] = su["per_batch_s"]
        out["sustained_bases_per_s"] = su["bases_per_s"]
        out["t_acc_amortized8_s"] = max(
            su["per_batch_s"] - plain["seconds"], 0.0)
        compose()
    except Exception as e:
        record_error("sustained", e)
    return out


def bench_shard_sensitivity(total_bases: int = 1 << 25, k: int = 25,
                            read_len: int = 256, repeats: int = 3,
                            progress=None) -> dict:
    """Ground the scaling model beyond the steady-state point -- what one
    device can still yield:

    - the D=1 sharded step with the overflow second round FORCE-TAKEN
      (capacity_factor < 1, dist/shuffle.make_kmerize_step
      force_second_round=True): upper-bounds the skew-path cost vs the same
      program with the round gated off (need2=False);
    - a per-chip-load sweep of the sharded step: how sensitive the modeled
      per-chip rate is to batch size (the model's t_chip term).

    ``progress`` (bench.py's partial streamer) is called after the gated/
    taken pair and after every sweep point: each point at a NEW shape is a
    fresh compile, and partials keep every measured point if a parent
    timeout ends the child.
    """
    from zotpu.dist import mesh as M
    from zotpu.dist import shuffle
    from zotpu.io import wire

    rng = np.random.default_rng(0)
    mesh = M.make_mesh(1)

    def fence(out):
        return int(np.asarray(out[3]).sum()) + int(np.asarray(out[4]).sum())

    def measure(reads, capacity_factor, force_second_round):
        codes = _synth_codes(rng, reads, read_len)
        pw, mw = wire.pack_codes(codes)
        pw, mw = jnp.asarray(pw), jnp.asarray(mw)
        lengths = jnp.asarray(np.full(reads, read_len, np.int32))
        step, _ = shuffle.make_kmerize_step(
            mesh, k, reads, read_len, capacity_factor=capacity_factor,
            compact=False, wire=True,
            force_second_round=force_second_round)
        fence(step(pw, mw, lengths))  # compile + warmup
        # dispatch-amortized slope, same timing discipline as the headline
        # model's step term, so the load sweep directly predicts how the
        # headline moves with batch size (round 5)
        dt, _ = _amortized_time(lambda: step(pw, mw, lengths), fence,
                                repeats=repeats)
        return dt

    reads = max(total_bases // read_len, 1)
    out = {"workload": "kmerize_shard_sensitivity", "k": k,
           "bases": reads * read_len, "load_sweep": []}

    def emit():
        if progress is not None:
            progress(dict(out, load_sweep=list(out["load_sweep"])))

    # force_second_round=True for BOTH sides so the program structure is
    # identical and the delta is exactly the taken round's cost: at 1.03
    # every entry fits round 1 (need2 False, fill+all_to_all gated off); at
    # 0.85 ~15% of entries take the second round.
    t_gated = measure(reads, 1.03, True)
    t_taken = measure(reads, 0.85, True)
    out["t_second_round_gated_s"] = t_gated
    out["t_second_round_taken_s"] = t_taken
    out["second_round_overhead"] = t_taken / t_gated
    emit()
    # per-device-load sweep, up as well as down: fixed per-batch overheads
    # amortize further at larger batches, device memory permitting. Point
    # order is decision-value-first: the 2x up-point (the headline's
    # batch-size lever) before the down-points, the 4x point LAST (newest
    # shape = the most expensive cold compile and the one that can OOM) --
    # with per-point partials a budget kill keeps everything measured.
    for num, den in ((1, 1), (2, 1), (1, 2), (1, 4), (4, 1)):
        r = reads * num // den
        try:
            t = t_gated if (num, den) == (1, 1) else measure(r, 1.03, True)
        except Exception as e:          # OOM at the top sizes: record why
            out["load_sweep"].append({"bases": r * read_len,
                                      "error": str(e)[:200]})
            emit()
            continue
        out["load_sweep"].append({"bases": r * read_len, "seconds": t,
                                  "bases_per_s": r * read_len / t})
        emit()
    out["load_sweep"].sort(key=lambda row: -row["bases"])
    return out


def bench_sustained(total_bases: int = 1 << 25, k: int = 25,
                    read_len: int = 256, batches: int = 8,
                    fixture: str = "uniform",
                    max_cap: int | None = None) -> dict:
    """SUSTAINED single-device rate: per-batch step + the LSM accumulator
    merges it amortizes over. The headline step excludes the accumulator;
    at B batches each element is merged O(log B) more times. Reported:
    bases/s over ``batches`` distinct device-resident batches, all LSM
    merges included, final result transfer excluded.

    ``batches`` declares the run length the amortized term reflects (the
    amortized merge cost grows ~log B for all-unique input);
    ``fixture="coverage"`` draws every batch from ONE ~30x genome (sized
    batches*total_bases/30) so the unique set saturates the way a real WGS
    run's does. ``max_cap`` overrides the accumulator's capacity."""
    from zotpu.workloads.accumulator import DeviceAccumulator

    fx = _Fixture(fixture, total_bases=batches * total_bases)
    reads = max(total_bases // read_len, 1)
    # distinct batches (varied content) so merges do real combining work;
    # keep them device-resident (H2D excluded -- this is the device rate)
    devb = []
    for _ in range(batches):
        pw, mw = wire.pack_codes(fx.codes(reads, read_len))
        devb.append((jnp.asarray(pw), jnp.asarray(mw)))
    lengths = jnp.full(reads, read_len, jnp.int32)
    acc_kw = {} if max_cap is None else {"max_cap": max_cap}

    @jax.jit
    def step(pw, mw, l):
        hi, lo, w = pack.pack_canonical(wire.unpack_codes(pw, mw), l, k)
        return sortdedup.kmer_sort_dedup(hi, lo, w, compact=False)

    def run_once():
        acc = DeviceAccumulator(step(*devb[0], lengths)[0].shape[0],
                                **acc_kw)
        for pw, mw in devb:
            acc.add(*step(pw, mw, lengths))
        # fence on a scalar depending on every level (NOT result(): the
        # final transfer is a one-off excluded from the sustained rate)
        tot = jnp.zeros((), jnp.uint32)
        for lvl in acc.levels:
            if lvl is not None:
                tot = tot + lvl[2][0] + lvl[2][-1]
        return int(np.asarray(tot))

    run_once()  # compile + warmup
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        run_once()
        times.append(time.perf_counter() - t0)
        if times[-1] > batches * 0.5:
            break      # slow point: one rep (see _amortized_time)
    dt = min(times)
    bases = batches * reads * read_len
    return {
        "workload": "kmerize_sustained", "k": k, "batches": batches,
        "fixture": fx.kind,
        "genome_bases": len(fx.genome) if fx.genome is not None else None,
        "bases": bases, "seconds": dt,
        "bases_per_s": bases / dt,
        "per_batch_s": dt / batches,
    }


def bench_parse(total_bases: int = 1 << 27, k: int = 25, read_len: int = 256,
                n_files: int = 4) -> dict:
    """HOST-ONLY input-pipeline throughput on .gz fixtures: gzip inflate per-file in a worker pool + chunk-pipelined
    inflate + parse/encode + wire pack, measured as uncompressed-equivalent
    bases/s by draining the production batch stream (no device work).
    Also times the single-worker sequential path for the speedup ratio.
    A single gzip STREAM is serial to inflate, so the per-box ceiling is
    ~n_cores x one-core inflate rate."""
    import gzip
    import os
    import tempfile

    from zotpu.workloads.kmerize import Stats, _iter_batches

    rng = np.random.default_rng(0)
    per_file_reads = max(total_bases // n_files // read_len, 1)
    lut = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.integers(0, 4, size=max(total_bases // 64, read_len + 1),
                          dtype=np.int64)
    qual = b"I" * read_len
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i in range(n_files):
            offs = rng.integers(0, len(genome) - read_len, per_file_reads)
            p = os.path.join(d, f"r{i}.fastq.gz")
            with gzip.open(p, "wb", compresslevel=1) as f:
                for j in range(0, per_file_reads, 65536):
                    seqs = lut[genome[offs[j:j + 65536, None]
                                      + np.arange(read_len)[None, :]]]
                    f.write(b"".join(b"@r\n%s\n+\n%s\n" % (s.tobytes(), qual)
                                     for s in seqs))
            paths.append(p)
        gz_bytes = sum(os.path.getsize(p) for p in paths)

        def drain(parallel, ps=None):
            stats = Stats()
            t0 = time.perf_counter()
            for _ in _iter_batches(ps or paths, 131072, read_len, k, stats,
                                   wire_pack=True, parallel=parallel):
                pass
            return stats.bases, time.perf_counter() - t0

        drain(True)                      # warm the page cache (fresh .gz
        #                                  fixtures are otherwise read from
        #                                  disk, which measures the disk)
        bases_seq, t_seq = drain(False)
        bases_par, t_par = min((drain(True) for _ in range(2)),
                               key=lambda r: r[1])
        assert bases_par == bases_seq

        # ONE BGZF file: a single plain-gzip
        # stream is serial to inflate, but bgzip blocks inflate in the
        # worker pool -- the common single-file .fastq.gz delivery no
        # longer caps at one core. Fixture: same reads, bgzip-blocked.
        from zotpu.io import bgzf as BG
        import gzip as _gz
        raw = []
        for p in paths:
            with _gz.open(p, "rb") as f:
                raw.append(f.read())
        bz = os.path.join(d, "one.fastq.gz")
        BG.write_bgzf(bz, b"".join(raw))
        del raw
        drain(False, [bz])               # warm page cache
        os.environ["ZOTPU_BGZF_WORKERS"] = "1"
        try:
            bases_bz1, t_bz1 = drain(False, [bz])
        finally:
            os.environ.pop("ZOTPU_BGZF_WORKERS", None)
        bases_bzp, t_bzp = min((drain(False, [bz]) for _ in range(2)),
                               key=lambda r: r[1])
        assert bases_bzp == bases_bz1 == bases_seq
    return {
        "workload": "host_parse_gz", "bases": bases_par,
        "gz_bytes": gz_bytes, "files": n_files,
        "workers": int(os.environ.get("ZOTPU_PARSE_WORKERS",
                                      min(4, os.cpu_count() or 1))),
        "cores": os.cpu_count(),
        "seconds": t_par, "bases_per_s": bases_par / t_par,
        "sequential_bases_per_s": bases_seq / t_seq,
        "parallel_speedup": t_seq / t_par,
        "bgzf_workers": BG.default_workers(),
        "bgzf_single_file_bases_per_s": bases_bzp / t_bzp,
        "bgzf_serial_bases_per_s": bases_bz1 / t_bz1,
        "bgzf_speedup": t_bz1 / t_bzp,
    }


def bench_e2e(total_bases: int = 1 << 25, k: int = 25, read_len: int = 128,
              repeats: int = 2) -> dict:
    """Whole-pipeline throughput: FASTQ on disk -> parse -> device batches ->
    device-resident merge -> final set (the CLI path, minus container write)."""
    import os
    import tempfile

    import numpy as np

    from zotpu.workloads import kmerize as W

    rng = np.random.default_rng(0)
    n = max(total_bases // read_len, 1)
    lut = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.integers(0, 4, size=max(total_bases // 16, read_len + 1),
                          dtype=np.int64)
    offs = rng.integers(0, len(genome) - read_len, n)
    seqs = lut[genome[offs[:, None] + np.arange(read_len)[None, :]]]
    qual = b"I" * read_len
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "bench.fastq")
        with open(path, "wb") as f:
            for i in range(0, n, 65536):
                f.write(b"".join(b"@r\n%s\n+\n%s\n" % (s.tobytes(), qual)
                                 for s in seqs[i:i + 65536]))
        half = os.path.join(d, "bench_half.fastq")
        with open(half, "wb") as f:
            for i in range(0, n // 2, 65536):
                f.write(b"".join(b"@r\n%s\n+\n%s\n" % (s.tobytes(), qual)
                                 for s in seqs[i:i + 65536]))
        times = []
        out = None
        for _ in range(max(repeats, 1)):
            stats = W.Stats()
            t0 = time.perf_counter()
            out = W.kmerize_paths([path], k, batch_reads=131072,
                                  max_len=read_len, stats=stats)
            times.append(time.perf_counter() - t0)
        dt = min(times)
        # marginal (steady-state) rate: a half-size run shares the fixed
        # finalization tail (final D2H + sync), so (N - N/2) / (tN - tN/2)
        # differences it out. Reported only when run-to-run noise keeps the
        # denominator positive.
        t_half = []
        for _ in range(max(repeats, 1)):
            st2 = W.Stats()
            t0 = time.perf_counter()
            W.kmerize_paths([half], k, batch_reads=131072,
                            max_len=read_len, stats=st2)
            t_half.append(time.perf_counter() - t0)
        dt_half = min(t_half)
        marginal = ((stats.bases - st2.bases) / (dt - dt_half)
                    if dt > dt_half else None)
    # Raw host->device link bandwidth, measured with the same transfer the
    # pipeline issues (a wire-packed batch): the link caps e2e at
    # link_bw / 0.375 B-per-base, and reporting that ceiling separates the
    # link from pipeline loss.
    import jax
    import jax.numpy as jnp
    buf = np.frombuffer(rng.bytes(32 << 20), np.uint8)
    jax.device_put(buf[:1024]).block_until_ready()
    t0 = time.perf_counter()
    jax.device_put(buf).block_until_ready()
    up = time.perf_counter() - t0
    link = len(buf) / up
    ceiling = link / 0.375          # 2-bit wire form ships 0.375 B/base
    r = {
        "workload": "kmerize_e2e", "bases": stats.bases, "seconds": dt,
        "bases_per_s": stats.bases / dt, "unique": len(out[0]),
        "h2d_link_bytes_per_s": link,
        "link_bases_per_s_ceiling": ceiling,
        "fraction_of_link_ceiling": (stats.bases / dt) / ceiling,
    }
    if marginal is not None and marginal > 0:
        r["marginal_bases_per_s"] = marginal
    return r
