"""kmerize workload: FASTQ/FASTA -> sorted canonical k-mer set + counts.

Reference analog: zotmer/commands/kmerize.py (SURVEY.md section 3.1): stream
reads, emit canonical k-mers, sort+dedup+count with memory-bounded batching and
a final merge of per-batch sorted runs (external-sort structure).

Device shape (BASELINE config 1): the host parses fixed-shape code batches
(numpy-vectorized) and double-buffers them to the device; the device runs the
fused pack->sort->dedup program per batch; per-batch sorted runs are merged in
a tree. Per-batch runs can be spilled as ZKF files (the checkpoint/resume
story, SURVEY.md section 5: a crashed run resumes from completed runs + merge).
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax

import numpy as np

from zotpu import semantics as S
from zotpu.io import container, fastq, wire
from zotpu.kernels import pack, sortdedup
from zotpu.reference_impl import golden as G


@dataclasses.dataclass
class Stats:
    reads: int = 0
    bases: int = 0
    kmers: int = 0
    batches: int = 0
    unique: int = 0
    n_chips: int = 1
    # per-shard routed k-mer volumes over the whole run (sharded mode only;
    # the SURVEY section-5 routing-skew observability metric)
    routed_per_shard: list | None = None

    def as_dict(self):
        return dataclasses.asdict(self)


@functools.partial(jax.jit, static_argnames=("k", "compact"))
def _device_batch(codes, lengths, k, compact: bool = True):
    """One per-batch device step. compact=False leaves duplicates sentinel-
    marked in place (no compaction sort) -- the accumulator re-sorts during
    its merge anyway, so the hot path skips the second full-width sort.
    One jitted program per batch: one dispatch, no eager round trips."""
    hi, lo, w = pack.pack_canonical(codes, lengths, k)
    return sortdedup.kmer_sort_dedup(hi, lo, w, compact=compact)


@functools.partial(jax.jit, static_argnames=("k", "compact"))
def _device_batch_wire(packed, mask, lengths, k, compact=True):
    """Per-batch step over the 0.375 B/base wire form (io/wire.py):
    shipping packed batches cuts H2D bytes 2.67x; the unpack is elementwise
    and fuses into the pack."""
    hi, lo, w = pack.pack_canonical(wire.unpack_codes(packed, mask),
                                    lengths, k)
    return sortdedup.kmer_sort_dedup(hi, lo, w, compact=compact)


DEVICE_MERGE_THRESHOLD = 1 << 20  # total keys above which the device tree wins


def merge_runs(runs: list[tuple[np.ndarray, np.ndarray]],
               force_host: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Tree-merge sorted (keys, counts) runs, summing counts (saturating).

    Small totals merge on the host (numpy oracle, no compile cost); large
    totals use the pairwise device merge tree (~10x faster at scale).
    ``force_host=True`` pins the golden numpy path regardless of size (the
    --host cross-check must never silently use device kernels)."""
    if not runs:
        return np.empty(0, np.uint64), np.empty(0, S.COUNT_DTYPE)
    total = sum(len(r[0]) for r in runs)
    if not force_host and total >= DEVICE_MERGE_THRESHOLD:
        from zotpu.workloads.setops import merge_tree_device
        return merge_tree_device(runs)
    while len(runs) > 1:
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            nxt.append(G.merge([runs[i], runs[i + 1]]))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]


class Interrupted(RuntimeError):
    """Raised by the fault-injection hook to simulate a mid-run crash."""


def _iter_batches(paths, batch_reads, max_len, k, stats, wire_pack=False,
                  parallel=False):
    """Shared prefetched batch stream; updates stats per batch.

    stats.reads counts input RECORDS, not rows: halo-chunked overlong records
    span several rows (and possibly batches), deduplicated via record_ids.
    wire_pack=True attaches the 2-bit H2D wire form (io/wire.py) to each
    batch, computed in the prefetch thread so it overlaps device compute.

    parallel=True (multi-file runs only): files parse in a small worker
    pool (io/prefetch.prefetch_many; ZOTPU_PARSE_WORKERS overrides the
    size), so gzip inflation runs for several files at once (SURVEY.md
    section 7 "host input pipeline"). Batches of different files then
    INTERLEAVE -- valid only for consumers whose output is insertion-order-
    invariant (the device accumulator; callers pass parallel=False in spill
    mode, whose numbered run files must be reproducible for resume)."""
    from zotpu.io.prefetch import prefetch, prefetch_many

    def parse_one(path):
        for batch in fastq.parse_batches(path, batch_reads, max_len,
                                         halo=k - 1):
            if wire_pack:
                batch.wire = wire.pack_codes(batch.codes)
            yield batch

    if parallel and len(paths) > 1:
        import functools as _ft
        import os as _os
        workers = int(_os.environ.get("ZOTPU_PARSE_WORKERS",
                                      min(4, _os.cpu_count() or 1)))
        last_ids: dict[int, int] = {}
        for tag, batch in prefetch_many(
                [_ft.partial(parse_one, p) for p in paths],
                workers=workers, depth=2 * max(workers, 1)):
            rids = batch.record_ids[:batch.n_reads]
            n_rec = len(np.unique(rids))
            last = last_ids.get(tag)
            if n_rec and last is not None and rids[0] == last:
                n_rec -= 1  # first record continues from previous batch
            if len(rids):
                last_ids[tag] = int(rids[-1])
            stats.batches += 1
            stats.reads += n_rec
            stats.bases += batch.bases
            yield batch
        return

    def all_batches():
        for path in paths:
            last_id = None
            for batch in parse_one(path):
                rids = batch.record_ids[:batch.n_reads]
                n_rec = len(np.unique(rids))
                if n_rec and last_id is not None and rids[0] == last_id:
                    n_rec -= 1  # first record continues from previous batch
                if len(rids):
                    last_id = int(rids[-1])
                yield batch, n_rec

    for batch, n_rec in prefetch(all_batches(), depth=2):
        stats.batches += 1
        stats.reads += n_rec
        stats.bases += batch.bases
        yield batch


def kmerize_paths(paths: list[str], k: int, batch_reads: int = 4096,
                  max_len: int = 256, spill_dir: str | None = None,
                  stats: Stats | None = None, resume: bool = False,
                  fail_after_batches: int | None = None,
                  merge_capacity: int = 1 << 26
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Kmerize files into one sorted unique (keys u64, counts u32) pair.

    Default (no spill_dir): per-batch runs stay ON DEVICE and merge through a
    log-structured device accumulator -- only the final set is transferred
    (a per-batch host round trip would serialize the pipeline on the host
    link).
    ``merge_capacity`` bounds the unique-key capacity of the accumulator.

    With ``spill_dir`` each batch's sorted run is written as a ZKF file, which
    is the checkpoint granularity: ``resume=True`` re-reads completed runs
    instead of recomputing them, so a crashed run redoes at most one batch
    (SURVEY.md section 5, failure detection / batch-granular restartability).
    ``fail_after_batches`` is the fault-injection hook used by tests.
    """
    from zotpu.workloads.accumulator import DeviceAccumulator

    S.check_k(k)
    stats = stats if stats is not None else Stats()
    use_acc = spill_dir is None
    acc: DeviceAccumulator | None = None
    runs: list[tuple[np.ndarray, np.ndarray]] = []
    batch_no = 0
    pending = None  # (device outputs, batch_no, run_path) awaiting host sync

    def consume(p):
        nonlocal acc
        (uhi, ulo, counts, n), bno, run_path = p
        if use_acc:
            if acc is None:
                acc = DeviceAccumulator(uhi.shape[0], max_cap=merge_capacity)
            acc.add(uhi, ulo, counts, n)
            return
        # spill mode transfers every batch by design (checkpoint
        # granularity); ride the same delta+u16 D2H codec as the final
        # accumulator transfer (io/wire_result.py)
        from zotpu.io.wire_result import transfer_sorted_set
        keys, cnts = transfer_sorted_set(uhi, ulo, counts, int(n))
        if run_path is not None:
            container.write(run_path, container.KmerSet(
                k=k, keys=keys, counts=cnts, meta={"run": bno, **stamp}))
        stats.kmers += int(cnts.sum(dtype=np.uint64))
        runs.append((keys, cnts))

    # Run-file contents depend on the batching layout AND k; stamp both and
    # reject stale files on resume (ADVICE round 3 -- resuming with
    # different --batch-reads silently reused runs covering the wrong read
    # subsets; round 4 adds k, without which resuming a crashed k=25 run
    # as k=31 silently merged mixed-k key spaces).
    stamp = {"k": k, "batch_reads": batch_reads, "max_len": max_len}

    # The prefetch thread overlaps parsing (gzip/encode, GIL-released) with
    # device compute and host merging of the previous batch.
    wire_pack = max_len % 32 == 0  # wire form needs 32|L (striped u32 words)
    for batch in _iter_batches(paths, batch_reads, max_len, k, stats,
                               wire_pack=wire_pack, parallel=use_acc):
        batch_no += 1
        run_path = (os.path.join(spill_dir, f"run{batch_no:06d}.zkf")
                    if spill_dir is not None else None)
        if resume and run_path:
            ks = _load_run_if_valid(run_path, stamp)
            if ks is not None:
                if pending is not None:
                    consume(pending)
                    pending = None
                stats.kmers += int(ks.counts.sum(dtype=np.uint64))
                runs.append((ks.keys, ks.counts))
                continue
        if fail_after_batches is not None and batch_no > fail_after_batches:
            if pending is not None:
                consume(pending)
            raise Interrupted(f"injected failure before batch {batch_no}")
        # Software pipelining (SURVEY.md section 2b "PP analog"): start the
        # async H2D upload first, do the previous batch's host/merge work
        # while it flies, then dispatch compute on device-resident inputs.

        if wire_pack:
            packed_d = jax.device_put(batch.wire[0])
            mask_d = jax.device_put(batch.wire[1])
        else:
            codes_d = jax.device_put(batch.codes)
        lengths_d = jax.device_put(batch.lengths)
        if pending is not None:
            consume(pending)
        # Spill runs are sliced [:n] on the host, so they need the compacted
        # form; the accumulator path takes the cheaper marked form.
        if wire_pack:
            out = _device_batch_wire(packed_d, mask_d, lengths_d, k,
                                     compact=not use_acc)
        else:
            out = _device_batch(codes_d, lengths_d, k, compact=not use_acc)
        pending = (out, batch_no, run_path)
    if pending is not None:
        consume(pending)
    if use_acc:
        keys, counts = (acc.result() if acc is not None
                        else (np.empty(0, np.uint64),
                              np.empty(0, S.COUNT_DTYPE)))
        # total instances = sum of merged counts (saturation is astronomically
        # far at these scales); avoids a per-batch device sync
        stats.kmers = int(counts.sum(dtype=np.uint64))
    else:
        keys, counts = merge_runs(runs)
    stats.unique = len(keys)
    return keys, counts


_STAMP_KEYS = ("k", "batch_reads", "max_len", "process_count",
               "process_index", "n_shards", "shard_hash")


def _load_run_if_valid(path, stamp):
    """Read a spill run iff its layout stamp matches; None = recompute.

    The match is exact over _STAMP_KEYS, not a subset check: a file whose
    meta carries a layout key ABSENT from the caller's stamp (e.g. a
    single-controller sharded run's ``n_shards`` found by a later plain
    resume with a same-k/batch_reads/max_len stamp) covers a different
    batch layout and must be recomputed (ADVICE round 4)."""
    if not os.path.exists(path):
        return None
    ks = container.read(path)
    if any(ks.meta.get(key) != val for key, val in stamp.items()):
        return None                           # stale layout: recompute
    if any(key in ks.meta and key not in stamp for key in _STAMP_KEYS):
        return None                           # different-MODE spill: recompute
    return ks


def resume_from_spills(spill_dir: str) -> tuple[np.ndarray, np.ndarray]:
    """Rebuild the merged set from previously written per-batch runs.

    Every run file must carry an IDENTICAL layout stamp (k, batching, and
    -- for sharded runs -- the process layout): run contents depend on all
    of them, so a directory mixing leftovers from a run with a different
    layout (e.g. a crashed --batch-reads 1024 run partially overwritten by
    a --batch-reads 4096 rerun) would silently double-count the reads the
    stale files cover. Mixed stamps raise instead."""
    runs = []
    ref = None
    for name in sorted(os.listdir(spill_dir)):
        if not name.endswith(".zkf"):
            continue
        ks = container.read(os.path.join(spill_dir, name))
        sig = (ks.k,) + tuple(ks.meta.get(key) for key in _STAMP_KEYS)
        if ref is None:
            ref = (name, sig)
        elif sig != ref[1]:
            raise ValueError(
                f"spill dir mixes runs from different layouts: {ref[0]} has "
                f"{ref[1]} but {name} has {sig}; delete the stale files or "
                f"rerun kmerize with --spill-dir to recompute")
        runs.append((ks.keys, ks.counts))
    return merge_runs(runs)


@dataclasses.dataclass
class _GlobalBatch:
    """A multi-controller batch: globally-sharded device arrays."""
    codes: object
    lengths: object
    wire: tuple | None = None


def _iter_global_batches(paths, mesh, reads_per_chip, rtot, max_len, k, stats,
                         wire_pack=False, parallel=False):
    """Batch stream for the sharded step.

    Single controller: plain numpy batches (XLA shards them on dispatch).
    Multi-controller (jax.distributed): each host parses ONLY its own input
    files into the rows of its addressable shards and the global batch is
    assembled with jax.make_array_from_process_local_data -- data-parallel
    reading with no cross-host byte shipping (SURVEY.md section 2b DP row).
    Hosts whose files run out feed empty rows until every host is drained
    (steps are collective, so all hosts must iterate in lockstep).
    wire_pack ships batches in the 0.375 B/base wire form (io/wire.py)."""
    if jax.process_count() == 1:
        yield from _iter_batches(paths, rtot, max_len, k, stats,
                                 wire_pack=wire_pack, parallel=parallel)
        return
    from jax.experimental import multihost_utils as mh
    from jax.sharding import NamedSharding, PartitionSpec as P

    from zotpu.dist.mesh import AXIS
    n_local = sum(1 for d in mesh.devices.flat
                  if d.process_index == jax.process_index())
    local_rows = reads_per_chip * n_local
    sh2 = NamedSharding(mesh, P(AXIS, None))
    sh1 = NamedSharding(mesh, P(AXIS))
    it = iter(_iter_batches(paths, local_rows, max_len, k, stats,
                            wire_pack=wire_pack, parallel=parallel))
    while True:
        batch = next(it, None)
        has_more = mh.process_allgather(np.asarray([batch is not None]))
        if not bool(np.any(has_more)):
            return
        if batch is None:  # this host is drained; feed all-padding rows
            codes_l = np.full((local_rows, max_len), S.INVALID_CODE, np.uint8)
            lengths_l = np.zeros(local_rows, np.int32)
            wire_l = wire.pack_codes(codes_l) if wire_pack else None
        else:
            codes_l, lengths_l = batch.codes, batch.lengths
            wire_l = batch.wire
        lengths_g = jax.make_array_from_process_local_data(sh1, lengths_l)
        if wire_pack:
            yield _GlobalBatch(None, lengths_g, wire=(
                jax.make_array_from_process_local_data(sh2, wire_l[0]),
                jax.make_array_from_process_local_data(sh2, wire_l[1])))
        else:
            yield _GlobalBatch(
                jax.make_array_from_process_local_data(sh2, codes_l),
                lengths_g)


def kmerize_paths_sharded(paths: list[str], k: int, n_shards: int,
                          batch_reads: int = 4096, max_len: int = 256,
                          stats: Stats | None = None,
                          capacity_factor: float = 4.0,
                          spill_dir: str | None = None,
                          resume: bool = False,
                          fail_after_batches: int | None = None,
                          merge_capacity: int = 1 << 26,
                          shard_hash: str = "prefix"
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Multi-chip kmerize through the shard_map pipeline (BASELINE config 1
    at scale): each batch is split across the mesh, k-mers are all-to-all
    routed to their key-prefix owner shard (with an overflow second round),
    and per-shard runs accumulate DEVICE-RESIDENT through a per-shard LSM
    merge (ShardedAccumulator) -- zero per-batch host gathers; one transfer
    at the end. n_shards must be a power of two <= len(jax.devices()).

    With ``spill_dir`` each batch's globally-merged run is written as a ZKF
    checkpoint instead (per-batch transfers by design, same contract as the
    single-chip spill path); ``resume=True`` re-reads completed runs.
    Under multi-controller each host spills ITS addressable shards' rows to
    ``run{batch}.p{process_id}.zkf`` (no cross-host bytes; VERDICT round 2
    item 5) and a batch resumes from spills only when EVERY host still has
    its file (steps are collective, so the skip/recompute decision must be
    unanimous -- a host that lost its spill forces the batch to recompute
    everywhere, which simply overwrites the surviving hosts' files).
    Routing-bucket overflow detection is DEFERRED to the end in accumulator
    mode (a device-side counter; no per-batch sync) and immediate in spill
    mode. Correctness is identical to the single-chip path by the
    shard-count invariance tests.
    """
    from zotpu.dist import mesh as M
    from zotpu.dist import shuffle
    from zotpu.workloads.accumulator import ShardedAccumulator

    S.check_k(k)
    stats = stats if stats is not None else Stats()
    stats.n_chips = n_shards
    n_dev = len(jax.devices())
    multi = jax.process_count() > 1
    if n_shards > n_dev:
        raise ValueError(
            f"--shards {n_shards} exceeds the {n_dev} available device(s)")
    if multi and n_shards != n_dev:
        raise ValueError(
            f"multi-host runs must shard over every device: --shards "
            f"{n_shards} != {n_dev} global devices")
    mesh = M.make_mesh(n_shards)
    reads_per_chip = max(batch_reads // n_shards, 1)
    rtot = reads_per_chip * n_shards
    use_acc = spill_dir is None
    wire_pack = max_len % 32 == 0
    step, cap_out = shuffle.make_kmerize_step(
        mesh, k, reads_per_chip, max_len, capacity_factor=capacity_factor,
        compact=not use_acc, wire=wire_pack, shard_hash=shard_hash)
    acc: ShardedAccumulator | None = None
    route_overflow = None  # device-side deferred counter (accumulator mode)
    routed_tot = None      # per-shard routed k-mer volumes (device)
    runs: list[tuple[np.ndarray, np.ndarray]] = []
    batch_no = 0
    # Prefix-sharded gathers may concatenate host results unsorted when the
    # mesh interleaves process indices (ADVICE round 3); detect once and
    # fall back to an explicit reorder instead of corrupting sort order.
    hosts_ordered = (not multi) or shuffle.hosts_prefix_ordered(mesh)
    reorder = shard_hash == "mixed" or not hosts_ordered
    # Spill-run contents depend on the process layout and batching (a
    # run{N}.p{pid}.zkf covers THIS host's shard subset of batch N); stamp
    # the layout into the run meta and reject stale files on resume
    # (ADVICE round 3: resuming under a different --num-processes silently
    # reused files covering the wrong shard subsets).
    stamp = {"k": k, "process_count": jax.process_count(),
             "process_index": jax.process_index(), "n_shards": n_shards,
             "batch_reads": batch_reads, "max_len": max_len,
             "shard_hash": shard_hash}

    for batch in _iter_global_batches(paths, mesh, reads_per_chip, rtot,
                                      max_len, k, stats,
                                      wire_pack=wire_pack, parallel=use_acc):
        batch_no += 1
        run_name = (f"run{batch_no:06d}.p{jax.process_index()}.zkf" if multi
                    else f"run{batch_no:06d}.zkf")
        run_path = (os.path.join(spill_dir, run_name)
                    if spill_dir is not None else None)
        if resume and run_path:
            ks = _load_run_if_valid(run_path, stamp)
            have = ks is not None
            if multi:
                # unanimous skip only: steps are collective, so one host
                # missing its spill forces the batch everywhere
                from jax.experimental import multihost_utils as mh
                have = bool(mh.process_allgather(
                    np.asarray([have])).all())
            if have:
                stats.kmers += int(ks.counts.sum(dtype=np.uint64))
                runs.append((ks.keys, ks.counts))
                continue
        if fail_after_batches is not None and batch_no > fail_after_batches:
            raise Interrupted(f"injected failure before batch {batch_no}")
        if wire_pack:
            uhi, ulo, counts, n_unique, overflow, routed = step(
                batch.wire[0], batch.wire[1], batch.lengths)
        else:
            uhi, ulo, counts, n_unique, overflow, routed = step(
                batch.codes, batch.lengths)
        if use_acc:
            if acc is None:
                # each shard can receive up to cap_out entries per batch
                acc = ShardedAccumulator(n_shards, cap_out,
                                         max_cap=merge_capacity, mesh=mesh)
            acc.add(uhi.reshape(n_shards, -1), ulo.reshape(n_shards, -1),
                    counts.reshape(n_shards, -1), n_unique)
            route_overflow = (overflow if route_overflow is None
                              else route_overflow + overflow)
            routed_tot = routed if routed_tot is None else routed_tot + routed
            continue
        if multi:
            from jax.experimental import multihost_utils as mh
            ovl = sum(int(np.asarray(s.data).sum())
                      for s in overflow.addressable_shards)
            ovf_now = int(mh.process_allgather(np.asarray([ovl])).sum())
        else:
            ovf_now = int(np.asarray(overflow).sum())
        if ovf_now > 0:
            raise ValueError(
                "all-to-all bucket overflow: raise capacity_factor")
        # routing-skew observability in spill mode too (round 4: it was
        # accumulated only on the accumulator path, leaving skewed spill
        # runs with no signal to justify --shard-hash mixed)
        routed_tot = routed if routed_tot is None else routed_tot + routed
        if multi:
            # spill THIS host's shard rows only (sorted: a host's devices
            # own ascending key-prefix ranges; mixed reorders at the end)
            keys, cnts = shuffle.gather_local_rows(
                uhi, ulo, counts, n_unique, reorder=shard_hash == "mixed")
        else:
            keys, cnts = shuffle.gather_global(
                np.asarray(uhi).reshape(n_shards, -1),
                np.asarray(ulo).reshape(n_shards, -1),
                np.asarray(counts).reshape(n_shards, -1),
                np.asarray(n_unique), reorder=shard_hash == "mixed")
            stats.kmers += int(cnts.sum(dtype=np.uint64))
        if run_path is not None:
            container.write(run_path, container.KmerSet(
                k=k, keys=keys, counts=cnts,
                meta={"run": batch_no, **stamp}))
        runs.append((keys, cnts))
    if use_acc:
        if acc is None:
            keys = np.empty(0, np.uint64)
            counts = np.empty(0, S.COUNT_DTYPE)
        else:
            if multi:
                from jax.experimental import multihost_utils as mh
                ovf = int(mh.process_allgather(route_overflow,
                                               tiled=True).sum())
            else:
                ovf = int(np.asarray(route_overflow).sum())
            if ovf > 0:
                raise ValueError(
                    "all-to-all bucket overflow (deferred): raise "
                    "capacity_factor")
            keys, counts = shuffle.gather_global(
                *acc.result(), reorder=shard_hash == "mixed")
            stats.kmers = int(counts.sum(dtype=np.uint64))
    else:
        # multi: merge THIS host's runs on the host (local data, zero
        # collective risk), then allgather the disjoint host sets
        keys, counts = merge_runs(runs, force_host=multi)
        if multi:
            keys, counts = shuffle.allgather_host_sets(
                keys, counts, reorder=reorder)
            stats.kmers = int(counts.sum(dtype=np.uint64))
    if routed_tot is not None:
        if multi:
            from jax.experimental import multihost_utils as mh
            routed = mh.process_allgather(routed_tot, tiled=True)
        else:
            routed = np.asarray(routed_tot)
        stats.routed_per_shard = [int(x) for x in routed]
    if multi:
        # reads/bases were counted per host; sum across hosts
        from jax.experimental import multihost_utils as mh
        agg = mh.process_allgather(
            np.asarray([[stats.reads, stats.bases]], np.int64))
        stats.reads, stats.bases = (int(x) for x in agg.reshape(-1, 2).sum(0))
    stats.unique = len(keys)
    return keys, counts
