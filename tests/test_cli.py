"""End-to-end CLI workload tests on small synthetic FASTQ (SURVEY.md §4 item 5).

Covers all five BASELINE configs single-chip: kmerize, merge, set ops,
spectrum+cutoff, pulldown — each against the golden reference.
"""

import gzip
import json

import numpy as np
import pytest

from zotpu import cli
from zotpu import semantics as S
from zotpu.io import container
from zotpu.reference_impl import golden as G


def write_fastq(path, reads):
    op = gzip.open if str(path).endswith(".gz") else open
    with op(path, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


@pytest.fixture
def reads(rng):
    return ["".join(rng.choice(list("ACGTACGTN"), size=rng.integers(30, 120)))
            for _ in range(150)]


def run_cli(*argv):
    return cli.main([str(a) for a in argv])


def test_kmerize_matches_golden(tmp_path, reads, capsys):
    fq = tmp_path / "in.fastq.gz"
    write_fastq(str(fq), reads)
    out = tmp_path / "out.zkf"
    assert run_cli("kmerize", "-k", 25, "--batch-reads", 32, "--max-len", 128,
                   out, fq) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ks = container.read(str(out))
    want_k, want_c = G.kmerize(25, reads)
    assert np.array_equal(ks.keys, want_k)
    assert np.array_equal(ks.counts, want_c)
    assert stats["unique"] == len(want_k)
    assert stats["reads"] == len(reads)


def test_kmerize_spill_resume(tmp_path, reads):
    from zotpu.workloads import kmerize as W
    fq = tmp_path / "in.fastq"
    write_fastq(str(fq), reads)
    spill = tmp_path / "spill"
    spill.mkdir()
    keys, counts = W.kmerize_paths([str(fq)], 21, batch_reads=32, max_len=128,
                                   spill_dir=str(spill))
    rk, rc = W.resume_from_spills(str(spill))
    assert np.array_equal(keys, rk)
    assert np.array_equal(counts, rc)


def test_kmerize_resume_rejects_different_k(tmp_path, reads):
    """Round 4: the layout stamp includes k -- resuming a crashed k=21 run
    as k=25 must RECOMPUTE every batch (stale-k run files silently merged
    mixed-k key spaces before; KmerSet.validate cannot catch it because
    smaller-k keys are valid under a larger k's mask)."""
    from zotpu.workloads import kmerize as W
    fq = tmp_path / "in.fastq"
    write_fastq(str(fq), reads)
    spill = tmp_path / "spill"
    spill.mkdir()
    with pytest.raises(W.Interrupted):
        W.kmerize_paths([str(fq)], 21, batch_reads=32, max_len=128,
                        spill_dir=str(spill), fail_after_batches=2)
    keys, counts = W.kmerize_paths([str(fq)], 25, batch_reads=32, max_len=128,
                                   spill_dir=str(spill), resume=True)
    want_k, want_c = G.kmerize(25, reads)
    assert np.array_equal(keys, want_k)
    assert np.array_equal(counts, want_c)


def test_resume_from_spills_rejects_mixed_layouts(tmp_path, reads):
    """Round 4: resume_from_spills refuses a directory whose run files
    carry different layout stamps (leftovers of a crashed finer-batched
    run beside a coarser rerun would double-count their reads)."""
    from zotpu.workloads import kmerize as W
    fq = tmp_path / "in.fastq"
    write_fastq(str(fq), reads)
    spill = tmp_path / "spill"
    spill.mkdir()
    with pytest.raises(W.Interrupted):
        W.kmerize_paths([str(fq)], 21, batch_reads=8, max_len=128,
                        spill_dir=str(spill), fail_after_batches=5)
    # a coarser rerun overwrites only the batch numbers it reaches (150
    # reads / 64 = 3 batches), leaving run000004-5 of the finer run stale
    W.kmerize_paths([str(fq)], 21, batch_reads=64, max_len=128,
                    spill_dir=str(spill))
    assert len(list(spill.glob("*.zkf"))) == 5
    with pytest.raises(ValueError, match="different layouts"):
        W.resume_from_spills(str(spill))


def test_kmerize_crash_and_resume(tmp_path, reads):
    """Fault injection: crash mid-run, resume, output identical (SURVEY §5)."""
    from zotpu.workloads import kmerize as W
    fq = tmp_path / "in.fastq"
    write_fastq(str(fq), reads)
    clean_keys, clean_counts = W.kmerize_paths([str(fq)], 21, batch_reads=32,
                                               max_len=128)
    spill = tmp_path / "spill"
    spill.mkdir()
    with pytest.raises(W.Interrupted):
        W.kmerize_paths([str(fq)], 21, batch_reads=32, max_len=128,
                        spill_dir=str(spill), fail_after_batches=2)
    assert len(list(spill.glob("*.zkf"))) == 2
    # resume recomputes only the missing batches
    keys, counts = W.kmerize_paths([str(fq)], 21, batch_reads=32, max_len=128,
                                   spill_dir=str(spill), resume=True)
    assert np.array_equal(keys, clean_keys)
    assert np.array_equal(counts, clean_counts)


def test_merge_cli(tmp_path, rng, capsys):
    paths = []
    sets = []
    for i in range(3):
        reads = ["".join(rng.choice(list("ACGT"), size=80)) for _ in range(40)]
        keys, counts = G.kmerize(17, reads)
        p = tmp_path / f"s{i}.zkf"
        container.write(str(p), container.KmerSet(k=17, keys=keys, counts=counts))
        paths.append(p)
        sets.append((keys, counts))
    out = tmp_path / "merged.zkf"
    assert run_cli("merge", out, *paths) == 0
    ks = container.read(str(out))
    want_k, want_c = G.merge(sets)
    assert np.array_equal(ks.keys, want_k)
    assert np.array_equal(ks.counts, want_c)

    # tiny chunks exercise the streaming accumulator path (each input is
    # fed in many pieces; host RSS stays O(one input) -- VERDICT r2 item 9)
    import os
    out2 = tmp_path / "merged2.zkf"
    os.environ["ZOTPU_MERGE_CHUNK"] = "64"
    try:
        assert run_cli("merge", out2, *paths) == 0
    finally:
        del os.environ["ZOTPU_MERGE_CHUNK"]
    ks2 = container.read(str(out2))
    assert np.array_equal(ks2.keys, want_k)
    assert np.array_equal(ks2.counts, want_c)


@pytest.mark.parametrize("op,gold", [
    ("union", G.union), ("intersect", G.intersect), ("diff", G.difference)])
def test_setop_cli(tmp_path, rng, op, gold, capsys):
    shared = ["".join(rng.choice(list("ACGT"), size=100)) for _ in range(10)]
    ra = shared + ["".join(rng.choice(list("ACGT"), size=100)) for _ in range(20)]
    rb = shared + ["".join(rng.choice(list("ACGT"), size=100)) for _ in range(15)]
    a = G.kmerize(19, ra)
    b = G.kmerize(19, rb)
    pa, pb = tmp_path / "a.zkf", tmp_path / "b.zkf"
    container.write(str(pa), container.KmerSet(k=19, keys=a[0], counts=a[1]))
    container.write(str(pb), container.KmerSet(k=19, keys=b[0], counts=b[1]))
    out = tmp_path / "o.zkf"
    assert run_cli(op, out, pa, pb) == 0
    ks = container.read(str(out))
    want_k, want_c = gold(a, b)
    assert np.array_equal(ks.keys, want_k)
    assert np.array_equal(ks.counts, want_c)


def test_jaccard_cli(tmp_path, rng, capsys):
    a_keys = np.unique(rng.integers(0, 4**10, 200).astype(np.uint64))
    b_keys = np.unique(np.concatenate([a_keys[:50],
                                       rng.integers(0, 4**10, 100).astype(np.uint64)]))
    pa, pb = tmp_path / "a.zkf", tmp_path / "b.zkf"
    container.write(str(pa), container.KmerSet(k=10, keys=a_keys))
    container.write(str(pb), container.KmerSet(k=10, keys=b_keys))
    assert run_cli("jaccard", pa, pb) == 0
    out = json.loads(capsys.readouterr().out)
    ni = len(np.intersect1d(a_keys, b_keys))
    nu = len(np.union1d(a_keys, b_keys))
    assert out["intersect"] == ni and out["union"] == nu
    assert abs(out["jaccard"] - ni / nu) < 1e-12


@pytest.mark.parametrize("op,gold", [
    ("union", G.union), ("intersect", G.intersect), ("diff", G.difference)])
def test_setop_cli_sharded(tmp_path, rng, op, gold, capsys):
    """--shards N: key-prefix-sharded set op, byte-equal to single-chip
    (VERDICT round 3 item 5)."""
    shared = ["".join(rng.choice(list("ACGT"), size=100)) for _ in range(10)]
    ra = shared + ["".join(rng.choice(list("ACGT"), size=100))
                   for _ in range(20)]
    rb = shared + ["".join(rng.choice(list("ACGT"), size=100))
                   for _ in range(15)]
    a = G.kmerize(19, ra)
    b = G.kmerize(19, rb)
    pa, pb = tmp_path / "a.zkf", tmp_path / "b.zkf"
    container.write(str(pa), container.KmerSet(k=19, keys=a[0], counts=a[1]))
    container.write(str(pb), container.KmerSet(k=19, keys=b[0], counts=b[1]))
    out = tmp_path / "o.zkf"
    assert run_cli(op, out, pa, pb, "--shards", 8) == 0
    ks = container.read(str(out))
    want_k, want_c = gold(a, b)
    assert np.array_equal(ks.keys, want_k)
    assert np.array_equal(ks.counts, want_c)


def test_jaccard_cli_sharded(tmp_path, rng, capsys):
    a_keys = np.unique(rng.integers(0, 4 ** 10, 200).astype(np.uint64))
    b_keys = np.unique(np.concatenate([
        a_keys[:50], rng.integers(0, 4 ** 10, 100).astype(np.uint64)]))
    pa, pb = tmp_path / "a.zkf", tmp_path / "b.zkf"
    container.write(str(pa), container.KmerSet(k=10, keys=a_keys))
    container.write(str(pb), container.KmerSet(k=10, keys=b_keys))
    assert run_cli("jaccard", pa, pb, "--shards", 4) == 0
    out = json.loads(capsys.readouterr().out)
    ni = len(np.intersect1d(a_keys, b_keys))
    nu = len(np.union1d(a_keys, b_keys))
    assert out["intersect"] == ni and out["union"] == nu
    assert abs(out["jaccard"] - ni / nu) < 1e-12


def test_hist_cli_and_cutoff(tmp_path, rng, capsys):
    reads = ["".join(rng.choice(list("ACGT"), size=60)) for _ in range(30)]
    reads = reads * 5 + ["".join(rng.choice(list("ACGT"), size=60)) for _ in range(40)]
    keys, counts = G.kmerize(15, reads)
    p = tmp_path / "x.zkf"
    container.write(str(p), container.KmerSet(k=15, keys=keys, counts=counts))
    assert run_cli("hist", p, "--cutoff") == 0
    lines = capsys.readouterr().out.strip().splitlines()
    hist_lines = [l for l in lines if "\t" in l]
    got = {int(f): int(c) for f, c in (l.split("\t") for l in hist_lines)}
    want = G.spectrum(counts)
    for f, c in got.items():
        assert want[f] == c
    assert sum(got.values()) == len(keys)
    cutoff = json.loads(lines[-1])
    assert cutoff["cutoff"] == G.error_peak_cutoff(want)


def test_scan_cli(tmp_path, rng, capsys):
    panel_reads = ["".join(rng.choice(list("ACGT"), size=200)) for _ in range(5)]
    panel_k, _ = G.kmerize(21, panel_reads)
    pp = tmp_path / "panel.zkf"
    container.write(str(pp), container.KmerSet(k=21, keys=panel_k))
    # sample contains panel substrings and random reads
    sample = [panel_reads[0][10:90], "".join(rng.choice(list("ACGT"), size=80))]
    fq = tmp_path / "s.fastq"
    write_fastq(str(fq), sample)
    assert run_cli("scan", pp, fq, "--per-read", "--batch-reads", 8,
                   "--max-len", 128) == 0
    out_lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out_lines[0])
    want = G.scan_panel(21, panel_k, sample)
    assert summary["total_hits"] == int(want.sum())
    per_read = [int(l.split("\t")[2]) for l in out_lines[1:]]
    assert per_read == [int(h) for h in want]


def test_sample_dump_info_verify(tmp_path, rng, capsys):
    reads = ["".join(rng.choice(list("ACGT"), size=90)) for _ in range(20)]
    keys, counts = G.kmerize(11, reads)
    p = tmp_path / "x.zkf"
    container.write(str(p), container.KmerSet(k=11, keys=keys, counts=counts))

    out = tmp_path / "s.zkf"
    assert run_cli("sample", "--rate", 0.5, out, p) == 0
    ks = container.read(str(out))
    want_k, want_c = G.sample(keys, counts, 0.5)
    assert np.array_equal(ks.keys, want_k)
    capsys.readouterr()

    assert run_cli("dump", p) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    # every line must match the reference per-key renderer exactly (the CLI
    # uses a vectorized block renderer)
    assert lines == [f"{G.decode_kmer(11, int(x))}\t{int(c)}"
                     for x, c in zip(keys, counts)]

    assert run_cli("info", p) == 0
    hdr = json.loads(capsys.readouterr().out)
    assert hdr["k"] == 11 and hdr["n"] == len(keys)

    assert run_cli("verify", p, p) == 0
    assert json.loads(capsys.readouterr().out)["equal"] is True
    p2 = tmp_path / "y.zkf"
    container.write(str(p2), container.KmerSet(k=11, keys=keys[:-1],
                                               counts=counts[:-1]))
    assert run_cli("verify", p, p2) == 1


def test_kmerize_fasta_long_record(tmp_path, capsys):
    rng = np.random.default_rng(8)
    genome = "".join(rng.choice(list("ACGT"), size=5000))
    fa = tmp_path / "g.fa"
    with open(fa, "w") as f:
        f.write(">genome\n")
        for i in range(0, len(genome), 70):
            f.write(genome[i:i + 70] + "\n")
    out = tmp_path / "g.zkf"
    assert run_cli("kmerize", "-k", 25, "--batch-reads", 16, "--max-len", 256,
                   out, fa) == 0
    ks = container.read(str(out))
    want_k, want_c = G.kmerize(25, [genome])
    assert np.array_equal(ks.keys, want_k)
    assert np.array_equal(ks.counts, want_c)


def test_filter_cli(tmp_path, rng, capsys):
    reads = ["".join(rng.choice(list("ACGT"), size=80)) for _ in range(20)]
    reads = reads * 6 + ["".join(rng.choice(list("ACGT"), size=80))
                         for _ in range(30)]
    keys, counts = G.kmerize(15, reads)
    p = tmp_path / "f.zkf"
    container.write(str(p), container.KmerSet(k=15, keys=keys, counts=counts))
    out = tmp_path / "solid.zkf"
    assert run_cli("filter", out, p, "--min-count", 3) == 0
    ks = container.read(str(out))
    mask = counts >= 3
    assert np.array_equal(ks.keys, keys[mask])
    assert np.array_equal(ks.counts, counts[mask])
    capsys.readouterr()
    out2 = tmp_path / "auto.zkf"
    assert run_cli("filter", out2, p, "--auto") == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["kept"] <= len(keys) and info["min_count"] >= 1
    assert run_cli("filter", tmp_path / "x.zkf", p) == 1  # needs a threshold


def test_scan_out_reads(tmp_path, rng, capsys):
    panel_src = "".join(rng.choice(list("ACGT"), size=300))
    panel_k, _ = G.kmerize(21, [panel_src])
    pp = tmp_path / "p.zkf"
    container.write(str(pp), container.KmerSet(k=21, keys=panel_k))
    sample = [panel_src[50:150],
              "".join(rng.choice(list("ACGT"), size=100)),
              panel_src[100:200]]
    fq = tmp_path / "s.fastq"
    write_fastq(str(fq), sample)
    out = tmp_path / "hits.fastq"
    assert run_cli("scan", pp, fq, "--out-reads", out, "--batch-reads", 8,
                   "--max-len", 128) == 0
    from zotpu.io import fastq as FQ
    with FQ.open_file(str(out)) as f:
        pulled = [s for _, s, _ in FQ.read_fastq(f)]
    want = G.scan_panel(21, panel_k, sample)
    assert pulled == [s for s, h in zip(sample, want) if h >= 1]
    assert sample[0] in pulled and sample[2] in pulled


def test_device_accumulator_matches_golden(rng):
    import jax.numpy as jnp

    from zotpu.workloads.accumulator import CapacityError, DeviceAccumulator
    sets = []
    for i in range(5):
        reads = ["".join(rng.choice(list("ACGT"), size=70)) for _ in range(30)]
        sets.append(G.kmerize(17, reads))
    acc = DeviceAccumulator(batch_capacity=2048, max_cap=1 << 14)
    for keys, counts in sets:
        hi = np.full(2048, 0xFFFFFFFF, np.uint32)
        lo = np.full(2048, 0xFFFFFFFF, np.uint32)
        c = np.zeros(2048, np.uint32)
        hi[:len(keys)], lo[:len(keys)] = S.split_hi_lo(keys)
        c[:len(keys)] = counts
        acc.add(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(c),
                jnp.int32(len(keys)))
    keys, counts = acc.result()
    want_k, want_c = G.merge(sets)
    assert np.array_equal(keys, want_k)
    assert np.array_equal(counts, want_c)

    tiny = DeviceAccumulator(batch_capacity=256, max_cap=256)
    hi = np.full(256, 0xFFFFFFFF, np.uint32)
    lo = np.full(256, 0xFFFFFFFF, np.uint32)
    c = np.zeros(256, np.uint32)
    ka = np.arange(200, dtype=np.uint64)
    hi[:200], lo[:200] = S.split_hi_lo(ka)
    c[:200] = 1
    kb = np.arange(200, 400, dtype=np.uint64)
    hi2 = np.full(256, 0xFFFFFFFF, np.uint32)
    lo2 = np.full(256, 0xFFFFFFFF, np.uint32)
    c2 = np.zeros(256, np.uint32)
    hi2[:200], lo2[:200] = S.split_hi_lo(kb)
    c2[:200] = 1
    tiny.add(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(c), jnp.int32(200))
    tiny.add(jnp.asarray(hi2), jnp.asarray(lo2), jnp.asarray(c2),
             jnp.int32(200))
    # overflow detection is deferred to result() (no per-merge host sync)
    with pytest.raises(CapacityError):
        tiny.result()


def test_kmerize_sharded_cli_matches(tmp_path, reads, capsys):
    """--shards 4 through the CLI must be byte-equal to single-chip."""
    fq = tmp_path / "in.fastq"
    write_fastq(str(fq), reads)
    out1 = tmp_path / "s1.zkf"
    out4 = tmp_path / "s4.zkf"
    assert run_cli("kmerize", "-k", 21, "--batch-reads", 64, "--max-len", 128,
                   out1, fq) == 0
    assert run_cli("kmerize", "-k", 21, "--batch-reads", 64, "--max-len", 128,
                   "--shards", 4, out4, fq) == 0
    a = container.read(str(out1))
    b = container.read(str(out4))
    assert np.array_equal(a.keys, b.keys)
    assert np.array_equal(a.counts, b.counts)


def test_scan_per_read_overlong_records(tmp_path, rng, capsys):
    """Overlong reads are halo-chunked into several device rows; per-read and
    reads_with_hits output must still be per input RECORD (rows re-aggregated
    via record_ids), byte-equal to the golden per-record scan."""
    src = "".join(rng.choice(list("ACGT"), size=400))
    panel_k, _ = G.kmerize(21, [src])
    pp = tmp_path / "p2.zkf"
    container.write(str(pp), container.KmerSet(k=21, keys=panel_k))
    # record 0: 500-base read with panel hits spanning chunk boundaries;
    # record 1: short no-hit read; record 2: another overlong hit read
    seqs = [src + "TTTTAAAACCCCGGGGTTTTAAAA" * 5, "ACGT" * 10, src[50:350]]
    fq = tmp_path / "long.fastq"
    write_fastq(str(fq), seqs)
    assert run_cli("scan", pp, fq, "--per-read", "--max-len", 128,
                   "--batch-reads", 2) == 0
    out_lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out_lines[0])
    want = G.scan_panel(21, panel_k, seqs)
    assert summary["total_hits"] == int(want.sum())
    assert summary["reads_with_hits"] == int((want > 0).sum())
    per_read = [int(l.split("\t")[2]) for l in out_lines[1:]]
    assert per_read == [int(h) for h in want]


def test_scan_sharded_cli_matches(tmp_path, rng, capsys):
    """scan --shards 4 must produce identical per-read output to single-chip
    (BASELINE config 5 hash-sharded), including a halo-chunked long record."""
    src = "".join(rng.choice(list("ACGT"), size=300))
    panel_k, _ = G.kmerize(21, [src])
    pp = tmp_path / "panel.zkf"
    container.write(str(pp), container.KmerSet(k=21, keys=panel_k))
    seqs = [src[20:120], "".join(rng.choice(list("ACGT"), size=80)),
            src + "T" * 200]  # last one exceeds --max-len -> chunked rows
    fq = tmp_path / "s.fastq"
    write_fastq(str(fq), seqs)
    outs = []
    for extra in ([], ["--shards", 4]):
        assert run_cli("scan", pp, fq, "--per-read", "--batch-reads", 8,
                       "--max-len", 128, *extra) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    want = G.scan_panel(21, panel_k, seqs)
    summary = json.loads(outs[1].strip().splitlines()[0])
    assert summary["total_hits"] == int(want.sum())
    assert summary["reads_with_hits"] == int((want > 0).sum())


def test_shards_validation(tmp_path, reads, capsys):
    fq = tmp_path / "v.fastq"
    write_fastq(str(fq), reads)
    # more shards than devices -> clean error
    assert run_cli("kmerize", "-k", 15, "--shards", 64,
                   tmp_path / "x.zkf", fq) == 1
    assert "exceeds" in capsys.readouterr().err


def test_kmerize_sharded_spill_resume(tmp_path, reads, capsys):
    """--shards with --spill-dir checkpoints per-batch runs; a crashed run
    resumes from completed runs, byte-equal to the uninterrupted output."""
    from zotpu.workloads import kmerize as W

    fq = tmp_path / "in.fastq"
    write_fastq(str(fq), reads)
    # uninterrupted sharded spill run
    sd2 = tmp_path / "sd2"
    sd2.mkdir()
    stats = W.Stats()
    keys_full, counts_full = W.kmerize_paths_sharded(
        [str(fq)], 15, 4, batch_reads=64, max_len=128,
        spill_dir=str(sd2), stats=stats)
    # interrupted run: fail after 1 batch, then resume
    sd3 = tmp_path / "sd3"
    sd3.mkdir()
    with pytest.raises(W.Interrupted):
        W.kmerize_paths_sharded([str(fq)], 15, 4, batch_reads=64,
                                max_len=128, spill_dir=str(sd3),
                                fail_after_batches=1)
    assert len(list(sd3.glob("*.zkf"))) == 1  # one completed checkpoint
    keys_res, counts_res = W.kmerize_paths_sharded(
        [str(fq)], 15, 4, batch_reads=64, max_len=128,
        spill_dir=str(sd3), resume=True)
    assert np.array_equal(keys_res, keys_full)
    assert np.array_equal(counts_res, counts_full)
    # and both equal the device-accumulator (no-spill) sharded path
    keys_acc, counts_acc = W.kmerize_paths_sharded(
        [str(fq)], 15, 4, batch_reads=64, max_len=128)
    assert np.array_equal(keys_acc, keys_full)
    assert np.array_equal(counts_acc, counts_full)


def test_kmerize_resume_rejects_stale_layout(tmp_path, reads):
    """Resuming with a different batching layout must recompute rather than
    reuse run files covering the wrong read subsets (ADVICE round 3: run
    contents depend on the layout, which is now stamped into run meta)."""
    from zotpu.workloads import kmerize as W

    fq = tmp_path / "in.fastq"
    write_fastq(str(fq), reads)
    fresh_k, fresh_c = W.kmerize_paths([str(fq)], 21, batch_reads=16,
                                       max_len=128)
    spill = tmp_path / "spill"
    spill.mkdir()
    W.kmerize_paths([str(fq)], 21, batch_reads=32, max_len=128,
                    spill_dir=str(spill))
    # same run file names, DIFFERENT batch_reads: stale runs must be
    # rejected (before the stamp, run000001 of 32 reads was reused as
    # batch 1 of 16 reads -- silently double-counting half the file)
    keys, counts = W.kmerize_paths([str(fq)], 21, batch_reads=16,
                                   max_len=128, spill_dir=str(spill),
                                   resume=True)
    assert np.array_equal(keys, fresh_k)
    assert np.array_equal(counts, fresh_c)


def test_kmerize_sharded_resume_rejects_stale_layout(tmp_path, reads):
    """Sharded spill runs stamp the process/shard layout too."""
    from zotpu.workloads import kmerize as W

    fq = tmp_path / "in.fastq"
    write_fastq(str(fq), reads)
    fresh_k, fresh_c = W.kmerize_paths_sharded(
        [str(fq)], 15, 4, batch_reads=32, max_len=128)
    spill = tmp_path / "spill"
    spill.mkdir()
    W.kmerize_paths_sharded([str(fq)], 15, 4, batch_reads=64, max_len=128,
                            spill_dir=str(spill))
    keys, counts = W.kmerize_paths_sharded(
        [str(fq)], 15, 4, batch_reads=32, max_len=128,
        spill_dir=str(spill), resume=True)
    assert np.array_equal(keys, fresh_k)
    assert np.array_equal(counts, fresh_c)


def test_prefetch_abandoned_consumer_shuts_down():
    import threading

    from zotpu.io.prefetch import prefetch
    before = threading.active_count()
    gen = prefetch(iter(range(1000)), depth=2)
    assert next(gen) == 0
    gen.close()  # consumer abandons early
    import time
    for _ in range(50):
        if threading.active_count() <= before:
            break
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_query(tmp_path, rng, capsys):
    reads = ["".join(rng.choice(list("ACGT"), size=90)) for _ in range(20)]
    keys, counts = G.kmerize(11, reads)
    p = tmp_path / "x.zkf"
    container.write(str(p), container.KmerSet(k=11, keys=keys, counts=counts))

    present = reads[0][:11]
    # either strand of a present k-mer finds the same count
    rc = present.translate(str.maketrans("ACGT", "TGCA"))[::-1]
    assert run_cli("query", p, present, rc) == 0
    rows = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert rows[0]["count"] == rows[1]["count"] > 0

    # absent k-mer: count 0, grep-style exit 1
    assert run_cli("query", p, "A" * 11) in (0, 1)
    row = json.loads(capsys.readouterr().out.strip())
    got = G.kmerize_seq(11, "A" * 11)[0]
    want = counts[np.searchsorted(keys, got)] if got in keys else 0
    assert row["count"] == int(want)

    # wrong length is a clean error
    assert run_cli("query", p, "ACGT") == 1
    assert "k=11" in capsys.readouterr().err

    # --seq mode: every k-mer of the read is present
    assert run_cli("query", p, reads[0], "--seq") == 0
    row = json.loads(capsys.readouterr().out.strip())
    assert row["kmers"] == 80 and row["present"] == row["distinct"]
    assert row["total_count"] >= row["distinct"]

    # @FILE expansion
    qf = tmp_path / "q.txt"
    qf.write_text(f"# queries\n{present}\n{rc}\n")
    assert run_cli("query", p, f"@{qf}") == 0
    assert len(capsys.readouterr().out.splitlines()) == 2


def test_query_empty_set(tmp_path, capsys):
    # empty set: every query has count 0, no IndexError (ADVICE round 2)
    p = tmp_path / "empty.zkf"
    container.write(str(p), container.KmerSet(
        k=11, keys=np.empty(0, np.uint64),
        counts=np.empty(0, S.COUNT_DTYPE)))
    assert run_cli("query", p, "A" * 11) == 1
    row = json.loads(capsys.readouterr().out.strip())
    assert row["count"] == 0
    assert run_cli("query", p, "ACGTACGTACGTACGT", "--seq") == 1
    row = json.loads(capsys.readouterr().out.strip())
    assert row["present"] == 0 and row["total_count"] == 0


def test_verify_kset_vs_kfset(tmp_path, rng, capsys):
    # a counts-less kset is NOT an all-ones kfset (VERDICT round 2 weak 9);
    # --as-sets opts into the membership-only comparison
    keys = np.unique(rng.integers(0, 1 << 40, 64).astype(np.uint64))
    kf = tmp_path / "a.zkf"
    ks = tmp_path / "b.zkf"
    container.write(str(kf), container.KmerSet(
        k=21, keys=keys, counts=np.full(len(keys), 2, S.COUNT_DTYPE)))
    container.write(str(ks), container.KmerSet(k=21, keys=keys, counts=None))
    assert run_cli("verify", kf, ks) == 1
    assert "kset vs kfset" in json.loads(capsys.readouterr().out)["reason"]
    assert run_cli("verify", "--as-sets", kf, ks) == 0
    assert json.loads(capsys.readouterr().out)["equal"] is True


def test_kmerize_from_stdin(tmp_path, rng):
    # `cat reads.fastq | zotpu kmerize ... -` : the format sniff must not eat
    # the first record's '@' (VERDICT round 2 weak 5)
    import os
    import subprocess
    import sys
    reads = ["".join(rng.choice(list("ACGT"), size=80)) for _ in range(30)]
    fq = tmp_path / "in.fastq"
    write_fastq(str(fq), reads)
    out = tmp_path / "out.zkf"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    extra = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = (extra + os.pathsep if extra else "") + repo
    with open(fq, "rb") as fin:
        r = subprocess.run(
            [sys.executable, "-m", "zotpu", "kmerize", "-k", "15",
             "--batch-reads", "8", "--max-len", "96", str(out), "-"],
            stdin=fin, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    got = container.read(str(out))
    want_k, want_c = G.kmerize(15, reads)
    assert np.array_equal(got.keys, want_k)
    assert np.array_equal(got.counts, want_c)


def test_selftest_cli(capsys):
    # on CPU the sharded fused-dedup check is skipped (suite covers it in
    # interpret mode); the five configs still run device-vs-golden
    assert run_cli("selftest", "-k", 15) == 0
    rows = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    summary = rows[-1]
    assert summary["ok"] is True and summary["failed"] == 0
    assert "partial" not in summary
    names = {r.get("check") for r in rows if "check" in r}
    assert {"config1_kmerize", "config2_merge", "config3_setops",
            "config4_hist", "config5_scan"} <= names


def test_selftest_budget_partial(capsys):
    # an exhausted in-process budget (bench.py's gate sets
    # ZOTPU_SELFTEST_BUDGET) skips remaining checks CLEANLY between device
    # ops: the summary says partial, every check that ran is reported, and
    # a zero-failure partial still returns 0 (gate pass)
    from zotpu.selftest import run_selftest
    assert run_selftest(k=15, budget_s=1e-9) == 0
    rows = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    summary = rows[-1]
    assert summary["partial"] is True and summary["ok"] is True
    assert summary["checks"] >= 1          # config1 always completes
    assert any("selftest_budget_exceeded" in r for r in rows)


def test_plain_resume_rejects_sharded_spills(tmp_path):
    """ADVICE round 4: a spill whose meta carries layout keys ABSENT from
    the caller's stamp (e.g. a single-controller sharded run's n_shards)
    covers a different batch layout and must be recomputed even when every
    shared key matches."""
    from zotpu.workloads import kmerize as W
    p = str(tmp_path / "run000001.zkf")
    plain_stamp = {"k": 21, "batch_reads": 32, "max_len": 128}
    container.write(p, container.KmerSet(
        k=21, keys=np.array([5], np.uint64),
        counts=np.array([1], np.uint32),
        meta={"run": 1, **plain_stamp, "n_shards": 8, "process_count": 1,
              "process_index": 0, "shard_hash": "prefix"}))
    assert W._load_run_if_valid(p, plain_stamp) is None
    container.write(p, container.KmerSet(
        k=21, keys=np.array([5], np.uint64),
        counts=np.array([1], np.uint32),
        meta={"run": 1, **plain_stamp}))
    assert W._load_run_if_valid(p, plain_stamp) is not None


def test_union_stream_cli_single_process(tmp_path, capsys):
    """`union --stream`: ChunkReader-partitioned sharded union, byte-equal
    to the in-RAM device path (single controller; multi-controller covered
    by test_multiprocess.test_two_process_stream_union_cli)."""
    rng = np.random.default_rng(13)
    k = 21
    a_keys = np.unique(rng.integers(0, 1 << (2 * k), 3000, dtype=np.uint64))
    b_keys = np.unique(np.concatenate([
        a_keys[::2], rng.integers(0, 1 << (2 * k), 2500, dtype=np.uint64)]))
    a_c = rng.integers(1, 40, len(a_keys)).astype(np.uint32)
    b_c = rng.integers(1, 40, len(b_keys)).astype(np.uint32)
    pa, pb = str(tmp_path / "a.zkf"), str(tmp_path / "b.zkf")
    container.write(pa, container.KmerSet(k=k, keys=a_keys, counts=a_c))
    container.write(pb, container.KmerSet(k=k, keys=b_keys, counts=b_c))
    out = str(tmp_path / "u.zkf")
    assert run_cli("union", "--stream", "--shards", 8, out, pa, pb) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ks = container.read(out)
    want_k, want_c = G.union((a_keys, a_c), (b_keys, b_c))
    assert np.array_equal(ks.keys, want_k)
    assert np.array_equal(ks.counts, want_c)
    assert row["cards"]["union"] == len(want_k)
