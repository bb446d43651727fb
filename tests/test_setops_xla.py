"""Sort-based set algebra (kernels/setops.set_op) vs golden -- byte equality
across ops, sizes, capacities, overlap patterns, marked (uncompacted) inputs
and padding-heavy rows, plus a brute-force check of the compaction
primitive."""

import jax.numpy as jnp
import numpy as np
import pytest

from zotpu import semantics as S
from zotpu.kernels import setops as K
from zotpu.reference_impl import golden as G

GOLD = {"merge": lambda a, b: G.merge([a, b]), "union": G.union,
        "intersect": G.intersect, "diff": G.difference}
SIZES = [
    (500, 300, 1024, 512),          # uneven sizes and capacities
    (0, 700, 8, 1024),              # one side empty
    (1, 1, 8, 8),                   # tiny
    (40000, 50000, 65536, 65536),   # large, heavy overlap
]


def _dense(keys, counts, cap):
    hi = np.full(cap, 0xFFFFFFFF, np.uint32)
    lo = np.full(cap, 0xFFFFFFFF, np.uint32)
    c = np.zeros(cap, np.uint32)
    hi[:len(keys)], lo[:len(keys)] = S.split_hi_lo(np.asarray(keys, np.uint64))
    c[:len(keys)] = counts
    return hi, lo, c


def _marked(keys, counts, cap, rng):
    """The same set with its rows scattered among sentinel rows (the
    sentinel-MARKED form dedup_mark_sorted emits): key order kept, padding
    interspersed instead of trailing."""
    n = len(keys)
    slots = np.sort(rng.choice(cap, size=n, replace=False))
    hi = np.full(cap, 0xFFFFFFFF, np.uint32)
    lo = np.full(cap, 0xFFFFFFFF, np.uint32)
    c = np.zeros(cap, np.uint32)
    hi[slots], lo[slots] = S.split_hi_lo(np.asarray(keys, np.uint64))
    c[slots] = counts
    return hi, lo, c


def _rand_set(rng, n, key_space=1 << 50):
    if n == 0:
        return np.empty(0, np.uint64), np.empty(0, np.uint32)
    keys = np.unique(rng.integers(0, key_space, n).astype(np.uint64))
    counts = rng.integers(1, 1000, len(keys)).astype(np.uint32)
    return keys, counts


def _overlapping_pair(rng, na, nb):
    ka, ca = _rand_set(rng, na)
    kb, cb = _rand_set(rng, nb)
    # force key overlap so intersect/diff are non-trivial
    if na and nb:
        kb = np.unique(np.concatenate([kb[: nb // 2], ka[: na // 3]]))
        cb = rng.integers(1, 1000, len(kb)).astype(np.uint32)
    return (ka, ca), (kb, cb)


def _check(out, want):
    hi, lo, c, n = (np.asarray(x) for x in out)
    n = int(n)
    keys = S.join_hi_lo(hi[:n], lo[:n])
    assert np.array_equal(keys, want[0])
    assert np.array_equal(c[:n], want[1])
    # the sentinel tail holds through the FULL output capacity
    assert np.all(hi[n:] == 0xFFFFFFFF) and np.all(lo[n:] == 0xFFFFFFFF)
    assert np.all(c[n:] == 0)


def test_compact_kept_brute_force():
    """The stable flag-sort compaction keeps exactly the flagged rows, in
    order, for every keep density."""
    rng = np.random.default_rng(0)
    n = 512
    for frac in (0.0, 0.1, 0.5, 0.9, 1.0):
        for trial in range(8):
            keep = rng.random(n) < frac
            hi = np.sort(rng.integers(0, 1 << 20, n).astype(np.uint32))
            lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
            c = rng.integers(1, 99, n).astype(np.uint32)
            oh, ol, oc, m = (np.asarray(x) for x in K._compact_kept(
                jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(c),
                jnp.asarray(keep)))
            m = int(m)
            assert m == int(keep.sum()), (frac, trial)
            assert np.array_equal(oh[:m], hi[keep])
            assert np.array_equal(ol[:m], lo[keep])
            assert np.array_equal(oc[:m], c[keep])
            assert np.all(oh[m:] == 0xFFFFFFFF) and np.all(oc[m:] == 0)


@pytest.mark.parametrize("op", ["merge", "union", "intersect", "diff"])
@pytest.mark.parametrize("na,nb,cap_a,cap_b", SIZES)
def test_set_op_matches_golden(op, na, nb, cap_a, cap_b):
    rng = np.random.default_rng(na * 7 + nb + len(op))
    a, b = _overlapping_pair(rng, na, nb)
    out = K.set_op(*_dense(*a, cap_a), *_dense(*b, cap_b), op=op)
    _check(out, GOLD[op](a, b))


@pytest.mark.parametrize("op", ["merge", "intersect", "diff"])
@pytest.mark.parametrize("na,nb,cap_a,cap_b", [
    (500, 300, 1024, 512),
    (2000, 2000, 2048, 2048),
    (0, 700, 8, 1024),
    (1, 1, 8, 8),
])
def test_set_op_marked_inputs_match_dense(op, na, nb, cap_a, cap_b):
    """Sentinel-MARKED inputs (rows interspersed with sentinels, as the
    accumulator's level-0 runs arrive) give the same bytes as dense ones."""
    rng = np.random.default_rng(na * 5 + nb + len(op))
    a, b = _overlapping_pair(rng, na, nb)
    want = K.set_op(*_dense(*a, cap_a), *_dense(*b, cap_b), op=op)
    got = K.set_op(*_marked(*a, cap_a, rng), *_marked(*b, cap_b, rng), op=op)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), np.asarray(g))
    _check(got, GOLD[op](a, b))


def test_set_op_workload_merge_matches_golden():
    """The CLI's set-op wrapper (pow2 padding of container sets)."""
    from zotpu.workloads import setops as WS
    rng = np.random.default_rng(0)
    a = _rand_set(rng, 3000)
    b = _rand_set(rng, 1500)
    keys, counts = WS.set_op(a, b, op="merge")
    want_k, want_c = G.merge([a, b])
    assert np.array_equal(keys, want_k)
    assert np.array_equal(counts, want_c)


def test_set_op_intersect_count_saturation():
    k = np.array([5, 9], np.uint64)
    A = _dense(k, np.array([0xFFFFFFF0, 3], np.uint32), 8)
    B = _dense(k, np.array([0x20, 4], np.uint32), 8)
    _, _, c, n = K.set_op(*A, *B, op="intersect")
    assert int(n) == 2
    assert np.array_equal(np.asarray(c)[:2], [0xFFFFFFFF, 7])


def test_set_op_identical_sides():
    """A == B: every key is a 2-member segment (maximal combine load)."""
    rng = np.random.default_rng(7)
    a = _rand_set(rng, 5000)
    A = _dense(*a, 8192)
    for op in ("merge", "intersect", "diff"):
        _check(K.set_op(*A, *A, op=op), GOLD[op](a, a))


@pytest.mark.parametrize("na,nb,cap_a,cap_b", [
    (100, 200, 2 << 14, 4 << 14),   # both sides mostly padding
    (0, 50, 1 << 14, 1 << 14),      # one side empty
    (0, 0, 1 << 14, 1 << 14),       # both empty: n_out == 0
])
def test_set_op_padding_heavy(na, nb, cap_a, cap_b):
    """Rows that are mostly sentinel padding (pow2-padded sets, skewed
    shard rows) keep every op exact, tails included."""
    rng = np.random.default_rng(11)
    a, b = _rand_set(rng, na), _rand_set(rng, nb)
    for op in ("merge", "intersect", "diff"):
        _check(K.set_op(*_dense(*a, cap_a), *_dense(*b, cap_b), op=op),
               GOLD[op](a, b))


def test_merge_tree_device_matches_golden():
    """The pairwise device merge tree over an odd number of runs."""
    from zotpu.workloads import setops as WS
    rng = np.random.default_rng(4)
    runs = [_rand_set(rng, n, key_space=1 << 16) for n in (900, 1500, 40)]
    keys, counts = WS.merge_tree_device(runs)
    want_k, want_c = G.merge(runs)
    assert np.array_equal(keys, want_k)
    assert np.array_equal(counts, want_c)


def test_accumulator_merge_count_saturation():
    """Counts saturate at 0xFFFFFFFF through the accumulator's level
    merges, not only in a single set_op."""
    from zotpu.workloads.accumulator import DeviceAccumulator
    keys = np.array([5, 6], np.uint64)
    acc = DeviceAccumulator(8)
    for c in ([0xFFFFFFF0, 1], [0x20, 2], [0x20, 3]):
        acc.add(*(jnp.asarray(x) for x in _dense(keys,
                                                 np.array(c, np.uint32), 8)),
                2)
    got_k, got_c = acc.result()
    assert np.array_equal(got_k, keys)
    assert np.array_equal(got_c, [0xFFFFFFFF, 6])
