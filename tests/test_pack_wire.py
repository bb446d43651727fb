"""kernels/pack.pack_canonical in exact window order vs golden, row padding,
and the wire form (io/wire) feeding the same pack."""

import jax.numpy as jnp
import numpy as np
import pytest

from zotpu import semantics as S
from zotpu.io import wire
from zotpu.kernels import pack
from zotpu.reference_impl import golden as G
from tests.test_kernels import make_batch


def _valid_keys_in_order(hi, lo, w):
    keys = S.join_hi_lo(np.asarray(hi), np.asarray(lo))
    return keys[np.asarray(w) == 1]


@pytest.mark.parametrize("k", [1, 15, 16, 25, 31])
def test_pack_window_order_matches_golden(k):
    """Valid windows come out row-major, in read order -- exactly golden's
    per-read k-mer sequence concatenated -- and invalid ones are sentinel."""
    rng = np.random.default_rng(k * 7 + 1)
    seqs, codes, lengths = make_batch(rng, 37, 128, alphabet="ACGTN")
    hi, lo, w = pack.pack_canonical(codes, lengths, k)
    want = np.concatenate([G.kmerize_seq(k, s) for s in seqs])
    assert np.array_equal(_valid_keys_in_order(hi, lo, w), want), k
    keys = S.join_hi_lo(np.asarray(hi), np.asarray(lo))
    assert np.all(keys[np.asarray(w) == 0] == S.SENTINEL_KEY)


def test_pack_row_padding():
    """Few rows, reads shorter than the row: the padded tail of each row
    yields no windows."""
    rng = np.random.default_rng(5)
    seqs, codes, lengths = make_batch(rng, 7, 64, alphabet="ACGT")
    hi, lo, w = pack.pack_canonical(codes, lengths, 21)
    want = np.concatenate([G.kmerize_seq(21, s) for s in seqs])
    assert np.array_equal(_valid_keys_in_order(hi, lo, w), want)
    assert int(np.asarray(w).sum()) == sum(max(len(s) - 20, 0) for s in seqs)


def test_pack_from_wire_matches_codes():
    """Unpacking the 2-bit wire form on device and packing gives the same
    (hi, lo, w) as packing the u8 codes."""
    rng = np.random.default_rng(21)
    R, L, k = 37, 96, 25
    codes = rng.integers(0, 6, size=(R, L)).astype(np.uint8)
    lengths = rng.integers(k, L + 1, size=R).astype(np.int32)
    packed, mask = wire.pack_codes(codes)
    got = pack.pack_canonical(
        wire.unpack_codes(jnp.asarray(packed), jnp.asarray(mask)),
        jnp.asarray(lengths), k)
    want = pack.pack_canonical(np.minimum(codes, S.INVALID_CODE), lengths, k)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w_))
