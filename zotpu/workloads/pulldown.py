"""Panel pulldown / scan workload (BASELINE config 5).

Reference analog: zotmer/commands/scan.py (SURVEY.md section 3.5): screen reads
against a sorted reference k-mer panel via binary search per k-mer.

Device shape: the panel lives on-device as a sorted sentinel-padded (hi, lo)
pair; each read batch is packed (kernels/pack) and every window probes the
panel through a sort-merge join (kernels/join); hits reduce per read on the
device. On a mesh the panel is sharded by the same key prefix as
kmerize and k-mers are routed to their owner shard (dist/shuffle.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from zotpu import semantics as S
from zotpu.io import fastq, wire
from zotpu.kernels import pack


@functools.partial(jax.jit, static_argnames=("k",))
def scan_batch(codes, lengths, panel_hi, panel_lo, k: int):
    """(R, L) codes vs sorted panel -> (R,) per-read hit counts (int32).

    Membership is a gather-free SORT-MERGE JOIN (kernels/join.py)."""
    from zotpu.kernels.join import row_hits_sorted_join

    R, L = codes.shape
    m = L - k + 1
    hi, lo, w = pack.pack_canonical(codes, lengths, k)
    return row_hits_sorted_join(panel_hi, panel_lo, hi, lo, R, m)


@functools.partial(jax.jit, static_argnames=("k",))
def scan_batch_wire(packed, mask, lengths, panel_hi, panel_lo, k: int):
    """scan_batch over the 0.375 B/base wire form (io/wire.py): H2D bytes
    drop 2.67x; the unpack is elementwise and fuses into the pack."""
    from zotpu.kernels.join import row_hits_sorted_join

    R, W = packed.shape
    m = W * 16 - k + 1
    hi, lo, w = pack.pack_canonical(wire.unpack_codes(packed, mask),
                                    lengths, k)
    return row_hits_sorted_join(panel_hi, panel_lo, hi, lo, R, m)


def _iter_scan_batches(path, batch_reads, max_len, k, wire_pack):
    """Prefetched batch stream for scans; packs the wire form (and ships
    arrays to the device) in the prefetch thread to overlap device compute."""
    from zotpu.io.prefetch import prefetch

    def gen():
        for batch in fastq.parse_batches(path, batch_reads, max_len,
                                         halo=k - 1):
            if wire_pack:
                batch.wire = wire.pack_codes(batch.codes)
            yield batch

    yield from prefetch(gen(), depth=2)


def panel_to_device(keys: np.ndarray, capacity: int | None = None):
    """Sorted u64 panel -> sentinel-padded (hi, lo) device arrays."""
    n = len(keys)
    if capacity is not None:
        cap = capacity
    else:
        cap = max(1 << (n - 1).bit_length(), 8) if n else 8
    hi = np.full(cap, 0xFFFFFFFF, np.uint32)
    lo = np.full(cap, 0xFFFFFFFF, np.uint32)
    hi[:n], lo[:n] = S.split_hi_lo(keys)
    return jnp.asarray(hi), jnp.asarray(lo)


class RecordAggregator:
    """Re-aggregate per-ROW hit counts into per-RECORD counts.

    Overlong records are halo-chunked into several rows (possibly spanning
    batch boundaries), and counting rows would overstate reads_with_hits /
    misalign per-read output (ADVICE round 1). Chunk halos never duplicate a
    k-mer start position, so summing row hits per record is exact."""

    def __init__(self):
        self.per_read: list[int] = []
        self._last_id = -1

    def add(self, row_hits: np.ndarray, record_ids: np.ndarray) -> None:
        # record_ids are non-decreasing; reduce rows -> records in the batch
        uniq, inv = np.unique(record_ids, return_inverse=True)
        sums = np.bincount(inv, weights=row_hits).astype(np.int64)
        for rid, hsum in zip(uniq, sums):
            if self.per_read and rid == self._last_id:
                self.per_read[-1] += int(hsum)  # record spans batches
            else:
                self.per_read.append(int(hsum))
                self._last_id = int(rid)

    def result(self) -> tuple[int, int, list[int]]:
        total = sum(self.per_read)
        reads_hit = sum(1 for h in self.per_read if h > 0)
        return total, reads_hit, self.per_read


def pulldown_paths(panel_keys: np.ndarray, sample_paths: list[str], k: int,
                   batch_reads: int = 4096, max_len: int = 256):
    """Per-sample (total_hits, reads_with_hits, per_read_hits list)."""
    phi, plo = panel_to_device(panel_keys)
    wire_pack = max_len % 32 == 0
    results = []
    for path in sample_paths:
        agg = RecordAggregator()
        for batch in _iter_scan_batches(path, batch_reads, max_len, k,
                                        wire_pack):
            if wire_pack:
                hits = np.asarray(scan_batch_wire(
                    batch.wire[0], batch.wire[1], batch.lengths, phi, plo, k))
            else:
                hits = np.asarray(scan_batch(batch.codes, batch.lengths,
                                             phi, plo, k))
            n = batch.n_reads
            agg.add(hits[:n], batch.record_ids[:n])
        results.append(agg.result())
    return results


def pulldown_paths_sharded(panel_keys: np.ndarray, sample_paths: list[str],
                           k: int, n_shards: int, batch_reads: int = 4096,
                           max_len: int = 256, capacity_factor: float = 4.0,
                           shard_hash: str = "prefix"):
    """Hash-sharded pulldown (BASELINE config 5): the panel is partitioned by
    key prefix across the mesh, read k-mers are all-to-all routed to their
    owner shard carrying read-row ids, and per-row hits are psum'd back --
    same per-record output surface as the single-chip path.

    Under multi-controller (jax.distributed initialized, BASELINE config 5
    "hash-sharded across hosts") samples are assigned round-robin to hosts;
    every collective step mixes the hosts' current batches (each host fills
    its own devices' rows), so hosts stream data-parallel while the panel
    stays sharded over the full mesh. Per-sample results return for ALL
    samples on every host, but per-read vectors only for samples THIS host
    read (others carry None) -- summary stats are allgathered.
    """
    import jax

    from zotpu.dist import mesh as M
    from zotpu.dist import shuffle

    n_dev = len(jax.devices())
    if n_shards > n_dev:
        raise ValueError(
            f"--shards {n_shards} exceeds the {n_dev} available device(s)")
    if jax.process_count() > 1:
        if n_shards != n_dev:
            raise ValueError(
                f"multi-host runs must shard over every device: --shards "
                f"{n_shards} != {n_dev} global devices")
        return _pulldown_sharded_multihost(
            panel_keys, sample_paths, k, n_shards, batch_reads, max_len,
            capacity_factor, shard_hash)
    mesh = M.make_mesh(n_shards)
    reads_per_chip = max(batch_reads // n_shards, 1)
    rtot = reads_per_chip * n_shards
    wire_pack = max_len % 32 == 0
    phi, plo, cap = shuffle.partition_panel(panel_keys, k, n_shards,
                                            shard_hash=shard_hash)
    step = shuffle.make_pulldown_step(mesh, k, reads_per_chip, max_len, cap,
                                      capacity_factor=capacity_factor,
                                      wire=wire_pack, shard_hash=shard_hash)
    results = []
    for path in sample_paths:
        agg = RecordAggregator()
        for batch in _iter_scan_batches(path, rtot, max_len, k, wire_pack):
            if wire_pack:
                row_hits, overflow = step(batch.wire[0], batch.wire[1],
                                          batch.lengths, phi, plo)
            else:
                row_hits, overflow = step(batch.codes, batch.lengths,
                                          phi, plo)
            if int(np.asarray(overflow).sum()) > 0:
                raise ValueError(
                    "all-to-all bucket overflow in scan: raise "
                    "capacity_factor")
            hits = np.asarray(row_hits).reshape(n_shards, -1)[0]
            n = batch.n_reads
            agg.add(hits[:n], batch.record_ids[:n])
        results.append(agg.result())
    return results


def _pulldown_sharded_multihost(panel_keys, sample_paths, k, n_shards,
                                batch_reads, max_len, capacity_factor,
                                shard_hash):
    """Multi-controller sharded scan (VERDICT round 2 item 3).

    Mirrors kmerize's _iter_global_batches data parallelism: host h reads
    samples[h::P] (no cross-host byte shipping) and fills the rows of its
    own addressable devices in every collective step via
    jax.make_array_from_process_local_data; drained hosts feed all-padding
    rows until every host's stream is empty (steps are collective, so all
    hosts iterate in lockstep). One step can therefore mix batches of
    DIFFERENT samples: correctness holds because row ids are global, the
    per-row hit vector is psum-replicated, and each host aggregates only
    its own rows against its own record ids.
    """
    import jax
    from jax.experimental import multihost_utils as mh
    from jax.sharding import NamedSharding, PartitionSpec as P

    from zotpu.dist import mesh as M
    from zotpu.dist import shuffle
    from zotpu.dist.mesh import AXIS

    mesh = M.make_mesh(n_shards)
    pid, nproc = jax.process_index(), jax.process_count()
    flat = list(mesh.devices.flat)
    mine = [i for i, d in enumerate(flat) if d.process_index == pid]
    if mine != list(range(mine[0], mine[0] + len(mine))):
        raise ValueError("this host's devices are not contiguous in the "
                         "mesh; row-slice assembly needs contiguity")
    n_local = len(mine)
    reads_per_chip = max(batch_reads // n_shards, 1)
    local_rows = reads_per_chip * n_local
    row0 = mine[0] * reads_per_chip
    wire_pack = max_len % 32 == 0
    phi_np, plo_np, cap = shuffle.partition_panel(panel_keys, k, n_shards,
                                                  shard_hash=shard_hash)
    sh2 = NamedSharding(mesh, P(AXIS, None))
    sh1 = NamedSharding(mesh, P(AXIS))
    mk2 = lambda x: jax.make_array_from_process_local_data(sh2, x)
    phi = mk2(phi_np[mine[0]:mine[0] + n_local])
    plo = mk2(plo_np[mine[0]:mine[0] + n_local])
    step = shuffle.make_pulldown_step(mesh, k, reads_per_chip, max_len, cap,
                                      capacity_factor=capacity_factor,
                                      wire=wire_pack, shard_hash=shard_hash)

    def local_stream():
        """(global sample idx, batch) over THIS host's samples."""
        for idx in range(pid, len(sample_paths), nproc):
            for batch in _iter_scan_batches(sample_paths[idx], local_rows,
                                            max_len, k, wire_pack):
                yield idx, batch

    aggs = {idx: RecordAggregator()
            for idx in range(pid, len(sample_paths), nproc)}
    it = iter(local_stream())
    while True:
        item = next(it, None)
        has_more = mh.process_allgather(np.asarray([item is not None]))
        if not bool(np.any(has_more)):
            break
        if item is None:   # drained: feed all-padding rows
            idx, batch = None, None
            codes_l = np.full((local_rows, max_len), S.INVALID_CODE, np.uint8)
            lengths_l = np.zeros(local_rows, np.int32)
            wire_l = wire.pack_codes(codes_l) if wire_pack else None
        else:
            idx, batch = item
            codes_l, lengths_l, wire_l = batch.codes, batch.lengths, batch.wire
        lengths_g = jax.make_array_from_process_local_data(sh1, lengths_l)
        if wire_pack:
            row_hits, overflow = step(mk2(wire_l[0]), mk2(wire_l[1]),
                                      lengths_g, phi, plo)
        else:
            row_hits, overflow = step(mk2(codes_l), lengths_g, phi, plo)
        ovl = sum(int(np.asarray(s.data).sum())
                  for s in overflow.addressable_shards)
        if int(mh.process_allgather(np.asarray([ovl])).sum()) > 0:
            raise ValueError(
                "all-to-all bucket overflow in scan: raise capacity_factor")
        # psum makes every device's row a full copy of the global hit vector
        hits_full = np.asarray(row_hits.addressable_shards[0].data).reshape(-1)
        if batch is not None:
            n = batch.n_reads
            aggs[idx].add(hits_full[row0:row0 + local_rows][:n],
                          batch.record_ids[:n])

    # summary stats for ALL samples on every host (allgather; per-read
    # vectors stay host-local -- they can be large and only the owning host
    # needs them for --per-read / --out-reads output)
    stat = np.full((len(sample_paths), 2), -1, np.int64)
    for idx, agg in aggs.items():
        tot, rwh, _ = agg.result()
        stat[idx] = (tot, rwh)
    allstat = mh.process_allgather(stat[None], tiled=True)
    combined = allstat.max(axis=0)
    results = []
    for idx in range(len(sample_paths)):
        per = aggs[idx].result()[2] if idx in aggs else None
        results.append((int(combined[idx, 0]), int(combined[idx, 1]), per))
    return results
