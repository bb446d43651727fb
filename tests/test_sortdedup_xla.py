"""Sort + dedup on device (kernels/sortdedup) vs golden and numpy: segment
counting across duplicate densities and sentinel tails, the sort of several
sorted runs into one (the sharded receive side), and the 2-key sort with a
payload."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zotpu import semantics as S
from zotpu.kernels import sortdedup as SD
from zotpu.reference_impl import golden as G

N = 1 << 14
SENT64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _sorted_with_dups(rng, n, n_valid, key_space):
    key = rng.integers(0, key_space, size=n).astype(np.uint64)
    key.sort()
    key[n_valid:] = SENT64
    return key


def _split(keys):
    return (jnp.asarray((keys >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray(keys.astype(np.uint32)))


def _dense(hi, lo, cnt, n):
    hi, lo, cnt = (np.asarray(x) for x in (hi, lo, cnt))
    n = int(np.asarray(n))
    return S.join_hi_lo(hi[:n], lo[:n]), cnt[:n]


def _golden(keys):
    return G.sort_dedup(keys[keys != SENT64])


@pytest.mark.parametrize("blocks,valid_frac,key_space", [
    (1, 1.0, 300),         # heavy duplication
    (2, 0.6, 1 << 20),     # sparse dups, sentinel tail
    (3, 0.0, 300),         # all-sentinel input -> n == 0
    (4, 1.0, 1 << 45),     # mostly unique
])
def test_dedup_count_matches_golden(rng, blocks, valid_frac, key_space):
    n = blocks * N
    keys = _sorted_with_dups(rng, n, int(n * valid_frac), key_space)
    out = SD.dedup_count_sorted(*_split(keys))
    gk, gc = _dense(*out)
    wk, wc = _golden(keys)
    assert np.array_equal(gk, wk)
    assert np.array_equal(gc, wc)
    n_out = int(np.asarray(out[3]))
    assert np.all(np.asarray(out[0])[n_out:] == np.uint32(0xFFFFFFFF))
    assert np.all(np.asarray(out[2])[n_out:] == 0)


def test_dedup_single_segment(rng):
    # one giant segment: count = n - pad
    n = 2 * N
    n_valid = n - 100
    keys = np.full(n, 7, np.uint64)
    keys[n_valid:] = SENT64
    gk, gc = _dense(*SD.dedup_count_sorted(*_split(keys)))
    assert len(gk) == 1 and gk[0] == np.uint64(7) and gc[0] == n_valid


@pytest.mark.parametrize("na_blocks,nb_blocks", [(1, 1), (2, 2), (3, 1),
                                                 (2, 0)])
def test_sort_dedup_of_two_runs(rng, na_blocks, nb_blocks):
    """Two sorted runs, each with its own sentinel tail, concatenated: the
    full sort + dedup equals golden (the sharded receive side at D=2)."""
    nA, nB = na_blocks * N, nb_blocks * N
    parts = [_sorted_with_dups(rng, nA, int(nA * 0.9), 500)]
    if nB:
        parts.append(_sorted_with_dups(rng, nB, int(nB * 0.7), 500))
    keys = np.concatenate(parts)
    hi, lo = _split(keys)
    out = SD.kmer_sort_dedup(hi, lo, None, compact=True)
    gk, gc = _dense(*out)
    wk, wc = _golden(keys)
    assert np.array_equal(gk, wk), (na_blocks, nb_blocks)
    assert np.array_equal(gc, wc)


def test_sort_dedup_of_many_runs_marked(rng):
    """Eight sorted runs -> one sort + the MARKED dedup (the accumulator's
    input form): valid rows carry exactly golden's (key, count) pairs and
    duplicate rows are sentinel with count 0."""
    runs = [_sorted_with_dups(rng, N, int(rng.integers(N // 2, N + 1)), 400)
            for _ in range(8)]
    keys = np.concatenate(runs)
    hi, lo = jax.lax.sort(_split(keys), num_keys=2)
    mh, ml, mc, mn = (np.asarray(x) for x in SD.dedup_mark_sorted(hi, lo))
    mk = S.join_hi_lo(mh, ml)
    valid = mk != SENT64
    wk, wc = _golden(keys)
    assert int(mn) == len(wk)
    assert np.array_equal(mk[valid], wk)
    assert np.array_equal(mc[valid], wc)
    assert np.all(mc[~valid] == 0)


def test_accumulator_of_four_runs_matches_golden(rng):
    """Four marked runs through the device accumulator's LSM levels give
    golden's merged set."""
    from zotpu.workloads.accumulator import DeviceAccumulator

    runs = [_sorted_with_dups(rng, N, int(rng.integers(N // 2, N + 1)),
                              1 << 30) for _ in range(4)]
    acc = DeviceAccumulator(N)
    for keys in runs:
        acc.add(*SD.kmer_sort_dedup(*_split(keys), None, compact=False))
    got_k, got_c = acc.result()
    want_k, want_c = _golden(np.concatenate(runs))
    assert np.array_equal(got_k, want_k)
    assert np.array_equal(got_c, want_c)


def test_merge_of_unequal_runs(rng):
    """An unequal pair (2 blocks + 1 block of keys, different sentinel
    tails) merges through set_op into one ascending run, counts summed."""
    from zotpu.kernels import setops

    a = _golden(_sorted_with_dups(rng, 2 * N, 2 * N - 77, 1 << 30))
    b = _golden(_sorted_with_dups(rng, N, N // 2, 1 << 30))

    def dev(keys, counts, cap):
        k = np.full(cap, SENT64, np.uint64)
        k[:len(keys)] = keys
        c = np.zeros(cap, np.uint32)
        c[:len(keys)] = counts
        return (*_split(k), jnp.asarray(c))

    out = setops.set_op(*dev(*a, 2 * N), *dev(*b, N), op="merge")
    gk, gc = _dense(*out)
    wk, wc = G.merge([a, b])
    assert np.array_equal(gk, wk)
    assert np.array_equal(gc, wc)


def _rand(n, seed, hi_bits=18):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 1 << hi_bits, n).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    pay = np.arange(n, dtype=np.uint32)
    return hi, lo, pay


def _key(hi, lo):
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def test_sort_by_key_with_payload():
    """sort_by_key: keys in numpy order, payload permuted with its key."""
    hi, lo, pay = _rand(8192, 17)
    shi, slo, spay = (np.asarray(x) for x in SD.sort_by_key(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(pay)))
    got = _key(shi, slo)
    assert np.array_equal(got, np.sort(_key(hi, lo)))
    assert np.array_equal(_key(hi, lo)[spay], got)


def test_sort_by_key_duplicates_keep_payload_multiset():
    """Heavy duplication: the (key, payload) multiset is exactly preserved."""
    rng = np.random.default_rng(23)
    n = 4096
    hi = np.zeros(n, np.uint32)
    lo = rng.integers(0, 50, n).astype(np.uint32)
    pay = np.arange(n, dtype=np.uint32)
    _, slo, spay = (np.asarray(x) for x in SD.sort_by_key(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(pay)))
    assert np.array_equal(slo, np.sort(lo))
    assert sorted(zip(slo.tolist(), spay.tolist())) == \
        sorted(zip(lo.tolist(), pay.tolist()))


def test_sort_by_key_sentinel_padded_runs():
    """A short sentinel-padded run beside a full one: sentinels sort last
    and every real key keeps its payload."""
    rng = np.random.default_rng(11)
    NA, NB = N, 2 * N
    A = np.sort(rng.integers(0, 1 << 40, NA // 4).astype(np.uint64))
    A = np.concatenate([A, np.full(NA - len(A), SENT64, np.uint64)])
    B = np.sort(rng.integers(0, 1 << 40, NB).astype(np.uint64))
    keys = np.concatenate([A, B])
    hi, lo = _split(keys)
    pay = jnp.arange(NA + NB, dtype=jnp.uint32)
    ohi, olo, opay = (np.asarray(x) for x in SD.sort_by_key(hi, lo, pay))
    got = _key(ohi, olo)
    assert np.array_equal(got, np.sort(keys))
    assert np.array_equal(keys[opay], got)
