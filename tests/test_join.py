"""Sort-merge membership join vs a numpy membership oracle and golden."""

import numpy as np
import pytest

from zotpu import semantics as S
from zotpu.kernels import join as J
from zotpu.kernels import pack
from zotpu.reference_impl import golden as G
from tests.test_kernels import make_batch


def _panel(keys, cap):
    hi = np.full(cap, 0xFFFFFFFF, np.uint32)
    lo = np.full(cap, 0xFFFFFFFF, np.uint32)
    hi[:len(keys)], lo[:len(keys)] = S.split_hi_lo(np.asarray(keys, np.uint64))
    return hi, lo


@pytest.mark.parametrize("k,n_reads,read_len", [(21, 37, 120), (11, 8, 50)])
def test_row_hits_join_matches_golden(k, n_reads, read_len):
    rng = np.random.default_rng(k + n_reads)
    src = "".join(rng.choice(list("ACGT"), size=500))
    panel_keys, _ = G.kmerize(k, [src])
    phi, plo = _panel(panel_keys, 1 << (len(panel_keys) - 1).bit_length())
    # mix of panel substrings, random reads, and N-containing reads
    seqs = []
    for i in range(n_reads):
        if i % 3 == 0:
            off = rng.integers(0, 500 - read_len)
            seqs.append(src[off:off + read_len])
        else:
            seqs.append("".join(rng.choice(list("ACGTN"), size=read_len)))
    codes = np.stack([np.pad(G.encode(s), (0, read_len - len(s)),
                             constant_values=S.INVALID_CODE) for s in seqs])
    lengths = np.full(n_reads, read_len, np.int32)
    hi, lo, w = pack.pack_canonical(codes, lengths, k)
    got = np.asarray(J.row_hits_sorted_join(phi, plo, hi, lo, n_reads,
                                            read_len - k + 1))
    want = G.scan_panel(k, panel_keys, seqs)
    assert np.array_equal(got, want)
    # and a plain numpy membership oracle over the packed windows agrees
    m = read_len - k + 1
    qk = S.join_hi_lo(np.asarray(hi), np.asarray(lo))
    sent = np.uint64(0xFFFFFFFFFFFFFFFF)
    oracle = (np.isin(qk, panel_keys) & (qk != sent)).reshape(n_reads, m)
    assert np.array_equal(got, oracle.sum(axis=1).astype(np.int32))


def _star_rows(phi, plo, qhi, qlo, n_rows, m_per_row):
    """Per-row hits through the key*-transformed XLA join + backward sort,
    plus the bkey stream itself."""
    import jax.numpy as jnp
    phi_s, plo_s = J._transform_keys(jnp.asarray(phi), jnp.asarray(plo),
                                     is_probe=False)
    qhi_s, qlo_s = J._transform_keys(jnp.asarray(qhi), jnp.asarray(qlo),
                                     is_probe=True)
    tag = jnp.repeat(jnp.arange(n_rows, dtype=jnp.uint32), m_per_row)
    bkey = J._join_xla_star(phi_s, plo_s, qhi_s, qlo_s, tag, n_rows)
    rows = np.asarray(J._rowsum_by_idx(bkey, n_rows, m_per_row))
    return rows, np.asarray(bkey)


def test_join_xla_matches_membership_oracle():
    rng = np.random.default_rng(3)
    n_rows, m_per_row = 64, 512
    panel_keys = np.unique(rng.integers(0, 1 << 40, 5000).astype(np.uint64))
    phi, plo = _panel(panel_keys, 8192)
    m = n_rows * m_per_row
    qk = rng.integers(0, 1 << 40, m).astype(np.uint64)
    # force overlap
    qk[::7] = panel_keys[rng.integers(0, len(panel_keys), len(qk[::7]))]
    qhi, qlo = S.split_hi_lo(qk)
    rows_x, _ = _star_rows(phi, plo, qhi, qlo, n_rows, m_per_row)
    want = np.isin(qk, panel_keys)
    want_rows = want.reshape(n_rows, m_per_row).sum(axis=1).astype(np.int32)
    assert np.array_equal(rows_x, want_rows)
    # the public entry point agrees
    rows = np.asarray(J.row_hits_sorted_join(phi, plo, qhi, qlo, n_rows,
                                             m_per_row))
    assert np.array_equal(rows, want_rows)


def test_join_sentinel_probes():
    """Sentinel-KEY probes (invalid pack windows) carry real row tags: every
    probe ROW must still appear exactly m_per_row times in the backward-sort
    stream, and sentinel probes never count as hits."""
    rng = np.random.default_rng(11)
    n_rows, m_per_row = 128, 512
    m = n_rows * m_per_row
    panel_keys = np.unique(rng.integers(0, 1 << 40, 9000).astype(np.uint64))
    phi, plo = _panel(panel_keys, 16384)
    qk = rng.integers(0, 1 << 40, m).astype(np.uint64)
    qk[::5] = panel_keys[rng.integers(0, len(panel_keys), len(qk[::5]))]
    sent = rng.random(m) < 0.4            # 40% invalid windows, scattered
    qhi, qlo = S.split_hi_lo(qk)
    qhi[sent] = 0xFFFFFFFF
    qlo[sent] = 0xFFFFFFFF
    rows, bkey = _star_rows(phi, plo, qhi, qlo, n_rows, m_per_row)
    bk = bkey >> 1
    counts = np.bincount(bk[bk < n_rows], minlength=n_rows)
    assert np.array_equal(counts, np.full(n_rows, m_per_row))
    want = ((np.isin(qk, panel_keys) & ~sent)
            .reshape(n_rows, m_per_row).sum(axis=1).astype(np.int32))
    assert np.array_equal(rows, want)


@pytest.mark.parametrize("n_rows", [1000, 40_000])  # u16 path / u32 path
def test_rowsum_by_idx_dtype_paths(n_rows):
    """row*2+hit backward sort: u16 keys when 2*n_rows+1 < 2^16, u32 above;
    both must aggregate identically."""
    import jax.numpy as jnp
    rng = np.random.default_rng(n_rows)
    m_per_row = 4
    m = n_rows * m_per_row
    rows = np.repeat(np.arange(n_rows, dtype=np.uint32), m_per_row)
    hits = (rng.random(m) < 0.3).astype(np.uint32)
    bkey = (rows << 1) | hits
    # shuffle + append panel/pad entries (tag = n_rows), as the merge emits
    perm = rng.permutation(m)
    padded = np.concatenate([bkey[perm],
                             np.full(513, 2 * n_rows, np.uint32)])
    got = np.asarray(J._rowsum_by_idx(jnp.asarray(padded), n_rows,
                                      m_per_row))
    want = hits.reshape(n_rows, m_per_row).sum(axis=1).astype(np.int32)
    assert np.array_equal(got, want)


def test_join_duplicate_queries_same_key():
    """Many queries equal to one panel key all count as hits."""
    import jax.numpy as jnp
    panel_keys = np.array([100, 200, 300], np.uint64)
    phi, plo = _panel(panel_keys, 8)
    qk = np.array([200] * 5 + [150] * 3, np.uint64)
    qhi, qlo = S.split_hi_lo(qk)
    rows = np.asarray(J.row_hits_sorted_join(
        jnp.asarray(phi), jnp.asarray(plo),
        jnp.asarray(qhi), jnp.asarray(qlo), 1, 8))
    assert rows[0] == 5


def test_join_every_probe_hits():
    """DENSE hits (every query in the panel): each row counts all of its
    windows."""
    rng = np.random.default_rng(17)
    n_rows, m_per_row = 64, 512
    m = n_rows * m_per_row
    panel_keys = np.unique(rng.integers(0, 1 << 40, 60000).astype(np.uint64))
    phi, plo = _panel(panel_keys, 65536)
    qk = panel_keys[rng.integers(0, len(panel_keys), m)]  # 100% hit rate
    qhi, qlo = S.split_hi_lo(qk)
    rows, _ = _star_rows(phi, plo, qhi, qlo, n_rows, m_per_row)
    assert np.array_equal(rows, np.full(n_rows, m_per_row, np.int32))


def test_hits_from_merged_tag_contract():
    """The sharded pulldown's 3-key join (_join_xla + _hits_from_merged):
    panel rows carry tag 0, queries tag row+1; a query hits iff its key is
    in the panel -- for small and large row-id ranges alike."""
    import jax.numpy as jnp

    for n_rows in (100, 70_000):
        rng = np.random.default_rng(n_rows)
        panel_keys = np.unique(rng.integers(0, 1 << 40, 3000)
                               .astype(np.uint64))
        phi, plo = _panel(panel_keys, 4096)
        qk = rng.integers(0, 1 << 40, 5000).astype(np.uint64)
        qk[::3] = panel_keys[rng.integers(0, len(panel_keys), len(qk[::3]))]
        qk[::11] = np.uint64(0xFFFFFFFFFFFFFFFF)      # sentinel probes
        qtag = rng.integers(1, n_rows + 1, len(qk)).astype(np.uint32)
        qhi, qlo = S.split_hi_lo(qk)
        hit, tag = J._join_xla(jnp.asarray(phi), jnp.asarray(plo),
                               jnp.asarray(qhi), jnp.asarray(qlo),
                               jnp.asarray(qtag))
        hit, tag = np.asarray(hit), np.asarray(tag)
        got = np.bincount(tag[hit], minlength=n_rows + 1)
        is_hit = np.isin(qk, panel_keys)
        want = np.bincount(qtag[is_hit], minlength=n_rows + 1)
        assert np.array_equal(got, want), n_rows
        assert not np.any(hit & (tag == 0))            # panel rows never hit


def test_join_non_pow2_panel():
    """A panel padded to a non-power-of-two capacity (49152) against 96
    rows x 1024 windows stays exact."""
    rng = np.random.default_rng(23)
    n_rows, m_per_row = 96, 1024
    m = n_rows * m_per_row
    panel_keys = np.unique(rng.integers(0, 1 << 44, 40000).astype(np.uint64))
    phi, plo = _panel(panel_keys, 49152)
    qk = rng.integers(0, 1 << 44, m).astype(np.uint64)
    qk[::9] = panel_keys[rng.integers(0, len(panel_keys), len(qk[::9]))]
    qhi, qlo = S.split_hi_lo(qk)
    want = np.isin(qk, panel_keys).reshape(n_rows, m_per_row).sum(
        axis=1).astype(np.int32)
    rows, _ = _star_rows(phi, plo, qhi, qlo, n_rows, m_per_row)
    assert np.array_equal(rows, want)
