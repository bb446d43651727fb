"""Device-resident merge accumulator for streaming kmerize.

Why: a per-batch host round trip of each batch's variable-length result
serializes the pipeline on the host link (and each distinct valid-length
slice triggers its own tiny compile). This keeps per-batch sorted runs in
device memory and merges them there, log-structured-merge style:

level i holds at most one run of capacity ``base_cap * 2**i`` (clamped to
``max_cap``). A new batch enters level 0; while a level is occupied, the two
runs merge (device set_op, counts saturate) and carry to the next level.
Each element is merged O(log B) times over B batches, every merge is ONE
jitted program per level shape (pad + merge + truncate + overflow check
fused -- one dispatch per merge), and
NOTHING synchronizes with the host until ``result()``: capacity overflow is
accumulated as a device flag and raised at the end (the run must then be
redone with a larger --merge-capacity; detection is deferred by design to
keep the pipeline asynchronous).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from zotpu import semantics as S
from zotpu.io import wire_result
from zotpu.kernels import setops


class CapacityError(ValueError):
    pass


@functools.partial(jax.jit, static_argnames=("cap",))
def _pad_to(hi, lo, cnt, cap: int):
    n = hi.shape[0]
    if n >= cap:
        return hi[:cap], lo[:cap], cnt[:cap]
    padk = jnp.full(cap - n, 0xFFFFFFFF, jnp.uint32)
    padc = jnp.zeros(cap - n, jnp.uint32)
    return (jnp.concatenate([hi, padk]), jnp.concatenate([lo, padk]),
            jnp.concatenate([cnt, padc]))


@functools.partial(jax.jit, static_argnames=("out_cap",))
def _merge_fused(ahi, alo, ac, bhi, blo, bc, ov, out_cap: int):
    """One fused dispatch: merge two sorted runs, truncate to out_cap,
    accumulate the overflow flag (max excess valid count seen so far)."""
    hi, lo, cnt, n = setops.set_op(ahi, alo, ac, bhi, blo, bc, op="merge")
    ov = jnp.maximum(ov, n - out_cap)
    return hi[:out_cap], lo[:out_cap], cnt[:out_cap], n, ov


@functools.partial(jax.jit, static_argnames=("out_cap",))
def _merge_fused_batched(ahi, alo, ac, bhi, blo, bc, ov, out_cap: int):
    """vmapped _merge_fused over a leading shard axis (D, cap).

    With the leading axis sharded over the mesh (the kmerize step's output
    layout), XLA runs each shard's sort/merge locally -- a per-shard device-
    resident merge with NO collectives and NO host round trips."""
    def one(ahi, alo, ac, bhi, blo, bc, ov):
        hi, lo, cnt, n = setops.set_op(ahi, alo, ac, bhi, blo, bc, op="merge")
        return (hi[:out_cap], lo[:out_cap], cnt[:out_cap], n,
                jnp.maximum(ov, n - out_cap))
    return jax.vmap(one)(ahi, alo, ac, bhi, blo, bc, ov)


def _pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


class DeviceAccumulator:
    def __init__(self, batch_capacity: int, max_cap: int = 1 << 26):
        self.base_cap = _pow2(batch_capacity)
        self.max_cap = max(max_cap, self.base_cap)
        self.overflow = jnp.zeros((), jnp.int32)
        # levels[i] = (hi, lo, cnt, n_device, merged) at cap(i), or None;
        # merged runs come out of set_op compacted, inserted ones may be
        # sentinel-marked
        self.levels: list = []

    def _cap(self, i: int) -> int:
        return min(self.base_cap << i, self.max_cap)

    def add(self, hi, lo, cnt, n) -> None:
        """Insert one run of unique keys (device arrays). No host
        synchronization happens here. Runs may be sentinel-MARKED rather than
        compacted (kernels/sortdedup.dedup_mark_sorted): the merge's set_op
        re-sorts its concatenated input, so interspersed sentinel rows are
        equivalent to trailing padding."""
        if hi.shape[0] > self._cap(0):
            raise ValueError(
                f"run capacity {hi.shape[0]} exceeds the accumulator's level-0 "
                f"capacity {self._cap(0)}; construct DeviceAccumulator with "
                f"batch_capacity >= the largest run (silent truncation would "
                f"lose k-mers)")
        entry = (*_pad_to(hi, lo, cnt, cap=self._cap(0)), n, False)
        i = 0
        while True:
            if len(self.levels) <= i:
                self.levels.append(None)
            if self.levels[i] is None:
                self.levels[i] = entry
                return
            other = self.levels[i]
            self.levels[i] = None
            entry = self._merge(entry, other, self._cap(i + 1))
            i += 1

    def _merge(self, a, b, out_cap: int):
        """Merge two entries (hi, lo, cnt, n, merged) through the sort-based
        set_op, truncating to out_cap; out_cap is also the deferred-overflow
        threshold."""
        hi, lo, cnt, n, self.overflow = _merge_fused(
            a[0], a[1], a[2], b[0], b[1], b[2], self.overflow,
            out_cap=out_cap)
        return hi, lo, cnt, n, True

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        """Merge remaining levels, check deferred overflow, transfer ONLY the
        valid prefix (the single host sync of the whole accumulation)."""
        entry = None
        cap_final = self._cap(len(self.levels))
        for lvl in self.levels:
            if lvl is None:
                continue
            entry = lvl if entry is None else self._merge(entry, lvl, cap_final)
        if entry is None:
            return np.empty(0, np.uint64), np.empty(0, S.COUNT_DTYPE)
        if int(self.overflow) > 0:
            raise CapacityError(
                f"accumulator overflowed its unique-key capacity by "
                f"{int(self.overflow)}; rerun with a larger --merge-capacity "
                f"or use --spill-dir (host merging)")
        hi, lo, cnt, n = entry[:4]
        if not entry[4]:
            # A single-batch run may never pass through set_op, leaving the
            # entry sentinel-marked rather than compacted; one final
            # compaction (a one-off dispatch) makes [:n] dense.
            from zotpu.kernels.sortdedup import compact_sorted
            hi, lo, cnt = compact_sorted(hi, lo, cnt)
        # delta+u16 wire transfer, 6 B/key instead of 12 (D2H of the final
        # set is the largest single tail item on slow links), with the plain
        # fallback and 1M-grid slicing handled inside.
        return wire_result.transfer_sorted_set(hi, lo, cnt, int(n))


class ShardedAccumulator:
    """Per-shard LSM accumulator for the multi-chip kmerize path.

    Same log-structured-merge design as DeviceAccumulator, but every level is
    a (D, cap) array whose leading axis is sharded over the mesh (the layout
    ``dist.shuffle.make_kmerize_step`` emits). Merging is the vmapped fused
    set_op, which XLA partitions along the sharded axis -- each shard merges
    its own key range locally, runs never leave device memory, and nothing
    synchronizes with the host until ``result()``."""

    def __init__(self, n_shards: int, batch_capacity: int,
                 max_cap: int = 1 << 26, mesh=None):
        self.n_shards = n_shards
        self.base_cap = _pow2(batch_capacity)
        # max_cap is the GLOBAL unique-key capacity; each shard gets its slice
        self.max_cap = max(max_cap // n_shards, self.base_cap)
        # With a mesh, state arrays carry explicit shard-axis shardings so the
        # same SPMD program runs under multi-controller (each process owns its
        # shards' rows); without one, XLA's propagation handles it.
        self.mesh = mesh
        self.overflow = self._shard1(np.zeros(n_shards, np.int32))
        self.levels: list = []

    def _shard1(self, x):
        if self.mesh is None:
            return jnp.asarray(x)
        from jax.sharding import NamedSharding, PartitionSpec as P
        from zotpu.dist.mesh import AXIS
        return jax.device_put(x, NamedSharding(self.mesh, P(AXIS)))

    def _shard2(self, x):
        if self.mesh is None:
            return jnp.asarray(x)
        from jax.sharding import NamedSharding, PartitionSpec as P
        from zotpu.dist.mesh import AXIS
        return jax.device_put(x, NamedSharding(self.mesh, P(AXIS, None)))

    def _cap(self, i: int) -> int:
        return min(self.base_cap << i, self.max_cap)

    def add(self, uhi, ulo, counts, n) -> None:
        """Insert per-shard runs: (D, cap) arrays + (D,) valid counts.
        Runs may be sentinel-marked (uncompacted). No host sync."""
        if uhi.shape[1] > self._cap(0):
            raise ValueError(
                f"per-shard run capacity {uhi.shape[1]} exceeds level-0 "
                f"capacity {self._cap(0)}")
        pad = self._cap(0) - uhi.shape[1]
        if pad:
            padk = self._shard2(np.full((self.n_shards, pad), 0xFFFFFFFF,
                                        np.uint32))
            padc = self._shard2(np.zeros((self.n_shards, pad), np.uint32))
            uhi = jnp.concatenate([uhi, padk], axis=1)
            ulo = jnp.concatenate([ulo, padk], axis=1)
            counts = jnp.concatenate([counts, padc], axis=1)
        entry = (uhi, ulo, counts, n, False)
        i = 0
        while True:
            if len(self.levels) <= i:
                self.levels.append(None)
            if self.levels[i] is None:
                self.levels[i] = entry
                return
            other = self.levels[i]
            self.levels[i] = None
            entry = self._merge(entry, other, self._cap(i + 1))
            i += 1

    def _merge(self, a, b, out_cap: int):
        hi, lo, cnt, n, self.overflow = _merge_fused_batched(
            a[0], a[1], a[2], b[0], b[1], b[2], self.overflow, out_cap=out_cap)
        return hi, lo, cnt, n, True

    def result(self):
        """Merge remaining levels, check deferred overflow, compact each
        shard, and transfer the per-shard arrays (the single host sync).
        Returns numpy (uhi, ulo, counts, n_unique) in the gather_global
        layout: (D, cap) + (D,). Under multi-controller the transfer is a
        process_allgather, so every host returns the full global result."""
        from zotpu.kernels.sortdedup import compact_sorted
        entry = None
        cap_final = self._cap(len(self.levels))
        for lvl in self.levels:
            if lvl is None:
                continue
            entry = lvl if entry is None else self._merge(entry, lvl, cap_final)
        if entry is None:
            z = np.zeros((self.n_shards, 0), np.uint32)
            return z, z, z, np.zeros(self.n_shards, np.int32)
        hi, lo, cnt, n = entry[:4]
        if not entry[4]:
            hi, lo, cnt = jax.vmap(compact_sorted)(hi, lo, cnt)
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils as mh
            hi, lo, cnt, n, ov = (
                mh.process_allgather(x, tiled=True)
                for x in (hi, lo, cnt, n, self.overflow))
        else:
            hi, lo, cnt, n, ov = (np.asarray(x)
                                  for x in (hi, lo, cnt, n, self.overflow))
        if int(ov.max(initial=0)) > 0:
            raise CapacityError(
                f"sharded accumulator overflowed its per-shard unique-key "
                f"capacity by {int(ov.max())} (shard {int(ov.argmax())}); "
                f"rerun with a larger --merge-capacity")
        return hi, lo, cnt, np.asarray(n).astype(np.int32)
