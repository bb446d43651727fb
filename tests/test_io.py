"""I/O tests: FASTA/FASTQ batch parsing and the ZKF container."""

import gzip
import zlib

import numpy as np
import pytest

from zotpu import semantics as S
from zotpu.io import container, fastq
from zotpu.reference_impl import golden as G


def _write_fastq(path, reads, gz=False):
    op = gzip.open if gz else open
    with op(path, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


def test_fastq_generator(tmp_path):
    reads = ["ACGT", "GGGTTTNAC", "A"]
    p = str(tmp_path / "x.fastq")
    _write_fastq(p, reads)
    with fastq.open_file(p) as f:
        got = [s for _, s, _ in fastq.read_fastq(f)]
    assert got == reads


def test_fastq_batches_match_generator(tmp_path):
    rng = np.random.default_rng(7)
    reads = ["".join(rng.choice(list("ACGTN"), size=rng.integers(1, 60)))
             for _ in range(23)]
    p = str(tmp_path / "x.fastq.gz")
    _write_fastq(p, reads, gz=True)
    batches = list(fastq.parse_batches(p, max_reads=10, max_len=64))
    assert sum(b.n_reads for b in batches) == len(reads)
    i = 0
    for b in batches:
        for r in range(b.n_reads):
            want = S.ENCODE_LUT[np.frombuffer(reads[i].encode(), np.uint8)]
            got = b.codes[r, :b.lengths[r]]
            assert np.array_equal(got, want)
            assert np.all(b.codes[r, b.lengths[r]:] == S.INVALID_CODE)
            i += 1


def test_fasta_batches(tmp_path):
    p = str(tmp_path / "x.fa")
    with open(p, "w") as f:
        f.write(">chr1 desc\nACGTACGT\nGGGG\n>chr2\nTTTT\n")
    batches = list(fastq.parse_batches(p, max_reads=4, max_len=32))
    seqs = []
    for b in batches:
        for r in range(b.n_reads):
            row = b.codes[r]
            seqs.append(bytes(S.DECODE_LUT[row[row < 4]]).decode())
    assert seqs == ["ACGTACGTGGGG", "TTTT"]


def test_chunk_with_halo_loses_no_kmers():
    rng = np.random.default_rng(3)
    k = 7
    seq = "".join(rng.choice(list("ACGT"), size=300))
    codes = G.encode(seq)
    rows = fastq.chunk_with_halo(codes, k=k, chunk_len=50)
    chunked = np.concatenate([G.kmerize_seq(k, row) for row in rows])
    want, wc = G.sort_dedup(G.kmerize_seq(k, seq))
    got, gc = G.sort_dedup(chunked)
    assert np.array_equal(want, got)
    assert np.array_equal(wc, gc)


def test_container_roundtrip(tmp_path):
    keys, counts = G.kmerize(11, ["ACGTACGTACGTAAACCCGGTT", "TTGGAACC"])
    ks = container.KmerSet(k=11, keys=keys, counts=counts, meta={"source": "test"})
    p = str(tmp_path / "a.zkf")
    container.write(p, ks)
    back = container.read(p)
    assert back.k == 11 and back.meta["source"] == "test"
    assert np.array_equal(back.keys, keys)
    assert np.array_equal(back.counts, counts)
    hdr = container.read_header(p)
    assert hdr["n"] == len(keys)


def test_container_kset_no_counts(tmp_path):
    keys = np.array([1, 5, 9], dtype=np.uint64)
    p = str(tmp_path / "b.zkf")
    container.write(p, container.KmerSet(k=5, keys=keys))
    back = container.read(p)
    assert back.counts is None and np.array_equal(back.keys, keys)


def test_container_zlib_codec(tmp_path):
    keys, counts = G.kmerize(13, ["ACGTACGTACGTACGTTTTGGGCCAA" * 4])
    p = str(tmp_path / "c.zkf")
    container.write(p, container.KmerSet(k=13, keys=keys, counts=counts),
                    codec="zlib")
    back = container.read(p)
    assert np.array_equal(back.keys, keys)
    assert np.array_equal(back.counts, counts)
    hdr = container.read_header(p)
    assert hdr["codec"] == "zlib"


def test_container_delta_codec(tmp_path):
    keys, counts = G.kmerize(13, ["ACGTACGTACGTACGTTTTGGGCCAA" * 4])
    p = str(tmp_path / "d.zkf")
    container.write(p, container.KmerSet(k=13, keys=keys, counts=counts),
                    codec="delta")
    back = container.read(p)
    assert np.array_equal(back.keys, keys)
    assert np.array_equal(back.counts, counts)
    assert container.read_header(p)["codec"] == "delta"


def test_container_delta_codec_exceptions(tmp_path, rng):
    """Gaps > u32 and counts > u16 must survive via the exception table."""
    n = 5000
    # keys spread over the full 62-bit k=31 space: most deltas overflow? no --
    # force a mix: small dense runs plus huge jumps
    base = np.sort(rng.integers(0, 1 << 62, size=50, dtype=np.uint64))
    keys = np.unique((base[:, None]
                      + np.arange(100, dtype=np.uint64)[None, :]).ravel())
    counts = rng.integers(1, 100, size=len(keys), dtype=np.uint32)
    counts[rng.integers(0, len(keys), 37)] = np.uint32(1 << 20)  # u16 overflow
    p = str(tmp_path / "e.zkf")
    container.write(p, container.KmerSet(k=31, keys=keys, counts=counts),
                    codec="delta")
    back = container.read(p)
    assert np.array_equal(back.keys, keys)
    assert np.array_equal(back.counts, counts)
    assert len(keys) >= n - 100  # the fixture really exercised scale


def test_container_delta_codec_kset_and_empty(tmp_path):
    p = str(tmp_path / "f.zkf")
    keys = np.array([3, 4, 1 << 61], dtype=np.uint64)
    container.write(p, container.KmerSet(k=31, keys=keys), codec="delta")
    back = container.read(p)
    assert back.counts is None and np.array_equal(back.keys, keys)
    container.write(p, container.KmerSet(
        k=31, keys=np.empty(0, np.uint64), counts=np.empty(0, np.uint32)),
        codec="delta")
    back = container.read(p)
    assert back.n == 0 and len(back.counts) == 0


def test_container_delta_smaller_than_zlib(tmp_path, rng):
    """The delta codec should beat zlib-on-raw on a realistic sorted set."""
    import os as _os
    # density matters: a real 33M-key k=25 set has mean gap ~2^25; mimic
    # that ratio (200k keys over 2^43) so deltas fit u32 as in production
    keys = np.unique(rng.integers(0, 1 << 43, size=200_000, dtype=np.uint64))
    counts = rng.poisson(30, size=len(keys)).astype(np.uint32) + 1
    ks = container.KmerSet(k=25, keys=keys, counts=counts)
    pz, pd = str(tmp_path / "z.zkf"), str(tmp_path / "d.zkf")
    container.write(pz, ks, codec="zlib")
    container.write(pd, ks, codec="delta")
    assert _os.path.getsize(pd) < _os.path.getsize(pz)
    back = container.read(pd)
    assert np.array_equal(back.keys, keys)
    assert np.array_equal(back.counts, counts)


def test_chunk_reader_all_codecs(tmp_path, rng):
    """ChunkReader must reproduce container.read byte-for-byte for every
    codec, chunk size, and counts-presence combination (VERDICT round 3
    item 7: cmd_merge streams inputs through it)."""
    base = np.sort(rng.integers(0, 1 << 62, size=40, dtype=np.uint64))
    keys = np.unique((base[:, None]
                      + np.arange(64, dtype=np.uint64)[None, :]).ravel())
    counts = rng.integers(1, 100, size=len(keys), dtype=np.uint32)
    counts[rng.integers(0, len(keys), 17)] = np.uint32(1 << 20)
    for codec in ("raw", "zlib", "delta"):
        for with_counts in (True, False):
            pth = str(tmp_path / f"{codec}{with_counts}.zkf")
            container.write(pth, container.KmerSet(
                k=31, keys=keys, counts=counts if with_counts else None),
                codec=codec)
            for chunk in (1, 7, 1000, len(keys), len(keys) + 999):
                r = container.ChunkReader(pth)
                assert (r.k, r.n, r.codec) == (31, len(keys), codec)
                got_k, got_c = [], []
                for kc, cc in r.chunks(chunk):
                    got_k.append(kc)
                    if with_counts:
                        got_c.append(cc)
                    else:
                        assert cc is None
                assert np.array_equal(np.concatenate(got_k), keys), (
                    codec, chunk)
                if with_counts:
                    assert np.array_equal(
                        np.concatenate(got_c).astype(np.uint32), counts), (
                        codec, chunk)


def test_chunk_reader_casket_member_and_empty(tmp_path):
    keys, counts = G.kmerize(11, ["ACGTACGTACGTAAACCCGGTT"])
    p = str(tmp_path / "c.zkc")
    container.casket_write(p, [
        ("a", container.KmerSet(k=11, keys=keys, counts=counts)),
        ("b", container.KmerSet(k=11, keys=np.empty(0, np.uint64))),
    ], codec="zlib")
    r = container.ChunkReader(p + "#a")
    chunks = list(r.chunks(2))
    assert np.array_equal(np.concatenate([c[0] for c in chunks]), keys)
    assert list(container.ChunkReader(p + "#b").chunks(4)) == []
    with pytest.raises(ValueError, match="casket"):
        container.ChunkReader(p)


def test_prefetch_many_fails_fast():
    """A worker error must surface before other workers drain (ADVICE
    round 3): the good generator below would take ~60 s to finish."""
    import time

    from zotpu.io.prefetch import prefetch_many

    def bad():
        yield 1
        raise RuntimeError("boom")

    def slow_good():
        for i in range(600):
            time.sleep(0.1)
            yield i

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="boom"):
        for _ in prefetch_many([bad, slow_good], workers=2, depth=4):
            pass
    assert time.perf_counter() - t0 < 20


def test_fastq_no_trailing_newline(tmp_path):
    """Native and numpy paths must both parse a final unterminated record."""
    p = str(tmp_path / "nt.fastq")
    with open(p, "w") as f:
        f.write("@r0\nACGT\n+\nIIII\n@r1\nGGGG\n+\nIIII")  # no trailing \n
    batches = list(fastq.parse_batches(p, 8, 16))
    assert sum(b.n_reads for b in batches) == 2
    seqs = []
    for b in batches:
        for r in range(b.n_reads):
            row = b.codes[r]
            seqs.append(bytes(S.DECODE_LUT[row[row < 4]]).decode())
    assert seqs == ["ACGT", "GGGG"]


def test_crlf_fasta_matches_golden(tmp_path):
    """CRLF FASTA: no k-mer spanning a line joint may be lost."""
    rng = np.random.default_rng(44)
    seq = "".join(rng.choice(list("ACGT"), size=100))
    p = str(tmp_path / "c.fa")
    with open(p, "wb") as f:
        f.write(b">chr1 desc\r\n")
        for i in range(0, 100, 20):
            f.write(seq[i:i + 20].encode() + b"\r\n")
    k = 9
    batches = list(fastq.parse_batches(p, 8, 256, halo=k - 1))
    got = np.concatenate([G.kmerize_seq(k, b.codes[r])
                          for b in batches for r in range(b.n_reads)])
    want = G.kmerize_seq(k, seq)
    assert np.array_equal(np.sort(got), np.sort(want))
    assert len(want) == 100 - k + 1


def test_crlf_fastq_matches(tmp_path):
    p = str(tmp_path / "c.fastq")
    with open(p, "wb") as f:
        f.write(b"@r0\r\nACGTACGT\r\n+\r\nIIIIIIII\r\n")
    batches = list(fastq.parse_batches(p, 4, 16))
    row = batches[0].codes[0]
    assert bytes(S.DECODE_LUT[row[row < 4]]).decode() == "ACGTACGT"
    with fastq.open_file(p) as f:
        recs = list(fastq.read_fastq(f))
    assert recs[0][1] == "ACGTACGT"


def test_overlong_read_after_first_batch_falls_back(tmp_path):
    """An overlong read appearing late must not crash mid-stream."""
    reads = ["ACGT" * 4] * 5 + ["A" * 200] + ["GGGG" * 4]
    p = str(tmp_path / "late.fastq")
    with open(p, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    batches = list(fastq.parse_batches(p, 2, 32, halo=8))
    total_valid = sum(int((b.codes[r] < 4).sum())
                     for b in batches for r in range(b.n_reads))
    # every input base appears at least once (halo rows repeat k-1 bases)
    assert total_valid >= sum(len(r) for r in reads)


def test_fasta_blank_header():
    import io as _io
    recs = list(fastq.read_fasta(_io.StringIO("> \nACGT\n")))
    assert recs == [("", "ACGT")]


def test_sample_rate_bounds():
    keys = np.arange(100, dtype=np.uint64)
    counts = np.ones(100, np.uint32)
    k_all, _ = G.sample(keys, counts, 1.0)
    assert len(k_all) == 100
    k_none, _ = G.sample(keys, counts, 0.0)
    assert len(k_none) <= 1  # only an exact-zero hash could survive


def test_prefetch_order_and_errors():
    from zotpu.io.prefetch import prefetch
    assert list(prefetch(iter(range(100)), depth=3)) == list(range(100))

    def boom():
        yield 1
        raise RuntimeError("parse failed")

    import pytest as _pytest
    gen = prefetch(boom(), depth=2)
    assert next(gen) == 1
    with _pytest.raises(RuntimeError, match="parse failed"):
        list(gen)


def test_chunked_parse_equivalence(tmp_path, monkeypatch, rng):
    """Tiny read chunks (every carry path) must yield byte-identical batches
    to one-shot parsing, for FASTQ and multi-line FASTA with overlong
    records (the bounded-memory streaming contract)."""
    from zotpu.io import fastq as FQ

    seqs = ["".join(rng.choice(list("ACGTN"), size=int(n)))
            for n in rng.integers(5, 400, 60)]
    fq = tmp_path / "c.fastq"
    with open(fq, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
    fa = tmp_path / "c.fasta"
    with open(fa, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">rec{i}\n")
            for j in range(0, len(s), 37):   # multi-line records
                f.write(s[j:j + 37] + "\n")

    def collect(path):
        out = []
        for b in FQ.parse_batches(str(path), 16, 128, halo=20):
            out.append((b.codes.copy(), b.lengths.copy(), b.n_reads,
                        b.bases, b.record_ids.copy()))
        return out

    for path in (fq, fa):
        want = collect(path)
        for chunk in (17, 256, 4096):
            monkeypatch.setenv("ZOTPU_CHUNK_BYTES", str(chunk))
            got = collect(path)
            monkeypatch.delenv("ZOTPU_CHUNK_BYTES")
            assert len(got) == len(want), (path, chunk)
            for g, w in zip(got, want):
                for gg, ww in zip(g, w):
                    assert np.array_equal(gg, ww), (path, chunk)


def test_chunked_kmerize_byte_equal(tmp_path, monkeypatch, rng):
    """kmerize over a tiny-chunk stream == golden (end-to-end, gzip too)."""
    import gzip as _gzip

    from zotpu.reference_impl import golden as G2
    from zotpu.workloads import kmerize as W

    seqs = ["".join(rng.choice(list("ACGT"), size=90)) for _ in range(50)]
    raw = "".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n"
                  for i, s in enumerate(seqs))
    fqgz = tmp_path / "c.fastq.gz"
    with _gzip.open(fqgz, "wb") as f:
        f.write(raw.encode())
    monkeypatch.setenv("ZOTPU_CHUNK_BYTES", "103")
    keys, counts = W.kmerize_paths([str(fqgz)], 15, batch_reads=8,
                                   max_len=128)
    want_k, want_c = G2.kmerize(15, seqs)
    assert np.array_equal(keys, want_k)
    assert np.array_equal(counts, want_c)


def test_prefetch_many_interleaves_and_tags():
    from zotpu.io.prefetch import prefetch_many

    def gen(base):
        def g():
            for i in range(5):
                yield base * 100 + i
        return g

    got = list(prefetch_many([gen(1), gen(2), gen(3)], workers=2, depth=4))
    # every item arrives exactly once, tagged with its source index
    by_src = {}
    for tag, item in got:
        by_src.setdefault(tag, []).append(item)
    assert sorted(by_src) == [0, 1, 2]
    for tag, items in by_src.items():
        assert items == [(tag + 1) * 100 + i for i in range(5)]  # in order


def test_prefetch_many_propagates_errors():
    from zotpu.io.prefetch import prefetch_many

    def bad():
        yield 1
        raise RuntimeError("boom")

    def good():
        yield from range(3)

    with pytest.raises(RuntimeError, match="boom"):
        list(prefetch_many([bad, good], workers=2))


def test_parallel_multifile_kmerize_matches_golden(tmp_path, rng,
                                                   monkeypatch):
    """Accumulator-mode kmerize parses multiple .gz files in a worker pool
    (batches interleave across files); the sorted set is interleaving-
    invariant and must byte-match golden, with exact reads/bases stats."""
    import gzip

    from zotpu.reference_impl import golden as G
    from zotpu.workloads import kmerize as W

    monkeypatch.setenv("ZOTPU_PARSE_WORKERS", "3")
    monkeypatch.setenv("ZOTPU_CHUNK_BYTES", "256")  # many chunks per file
    paths, all_seqs = [], []
    for i in range(4):
        seqs = ["".join(rng.choice(list("ACGTN"), size=70))
                for _ in range(25)]
        p = tmp_path / f"in{i}.fastq.gz"
        with gzip.open(p, "wt") as f:
            for j, s in enumerate(seqs):
                f.write(f"@r{i}_{j}\n{s}\n+\n{'I' * len(s)}\n")
        paths.append(str(p))
        all_seqs.extend(seqs)
    stats = W.Stats()
    keys, counts = W.kmerize_paths(paths, 13, batch_reads=8, max_len=96,
                                   stats=stats)
    want_k, want_c = G.kmerize(13, all_seqs)
    assert np.array_equal(keys, want_k)
    assert np.array_equal(counts, want_c)
    assert stats.reads == len(all_seqs)
    assert stats.bases == sum(len(s) for s in all_seqs)


class TestBgzf:
    """VERDICT round 4 item 6: BGZF detection + block-parallel inflate."""

    def _fastq_bytes(self, n=400, L=64, seed=3):
        rng = np.random.default_rng(seed)
        lut = np.frombuffer(b"ACGT", np.uint8)
        out = []
        for i in range(n):
            s = lut[rng.integers(0, 4, L)].tobytes()
            out.append(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * L))
        return b"".join(out)

    def test_roundtrip_and_detection(self, tmp_path):
        import gzip

        from zotpu.io import bgzf
        data = self._fastq_bytes()
        p = str(tmp_path / "r.fastq.gz")
        bgzf.write_bgzf(p, data, block_bytes=1024)   # many blocks
        assert bgzf.is_bgzf(p)
        # gzip-transparent readers see the same bytes (BGZF IS gzip)
        with gzip.open(p, "rb") as f:
            assert f.read() == data
        # the parallel pipe re-emits the same bytes in order
        with bgzf.BgzfPipe(p, workers=3, group_bytes=4096) as pipe:
            got = b""
            while True:
                c = pipe.read()
                if not c:
                    break
                got += c
        assert got == data
        # plain gzip is NOT detected as BGZF
        q = str(tmp_path / "plain.fastq.gz")
        with gzip.open(q, "wb") as f:
            f.write(data)
        assert not bgzf.is_bgzf(q)

    def test_parse_batches_bgzf_equals_plain(self, tmp_path):
        from zotpu.io import bgzf, fastq
        data = self._fastq_bytes(n=300, L=96)
        plain = str(tmp_path / "r.fastq")
        with open(plain, "wb") as f:
            f.write(data)
        bz = str(tmp_path / "r2.fastq.gz")
        bgzf.write_bgzf(bz, data, block_bytes=2048)

        def collect(path):
            rows = []
            for b in fastq.parse_batches(path, 64, 96):
                rows.append(b.codes[:b.n_reads].copy())
            return np.concatenate(rows)

        assert np.array_equal(collect(plain), collect(bz))

    def test_corrupt_block_raises(self, tmp_path):
        from zotpu.io import bgzf
        p = str(tmp_path / "bad.gz")
        bgzf.write_bgzf(p, b"@r\nACGT\n+\nIIII\n" * 50, block_bytes=128)
        raw = bytearray(open(p, "rb").read())
        raw[40] ^= 0xFF                 # clobber inside the first block
        open(p, "wb").write(bytes(raw))
        with pytest.raises((ValueError, zlib.error)):
            with bgzf.BgzfPipe(p, workers=2) as pipe:
                while pipe.read():
                    pass
