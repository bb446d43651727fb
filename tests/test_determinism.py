"""Determinism tests — the device analog of race detection (SURVEY.md §5):
same input must produce bit-identical output across runs, batch sizes, and
shard counts (shard-count invariance is covered in test_dist.py)."""

import numpy as np

from zotpu.workloads import kmerize as W
from tests.test_cli import write_fastq


def test_kmerize_bit_identical_across_runs(tmp_path, rng):
    reads = ["".join(rng.choice(list("ACGTN"), size=rng.integers(40, 100)))
             for _ in range(120)]
    fq = tmp_path / "r.fastq"
    write_fastq(str(fq), reads)
    k1, c1 = W.kmerize_paths([str(fq)], 23, batch_reads=64, max_len=128)
    k2, c2 = W.kmerize_paths([str(fq)], 23, batch_reads=64, max_len=128)
    assert np.array_equal(k1, k2)
    assert np.array_equal(c1, c2)


def test_kmerize_invariant_to_batching(tmp_path, rng):
    reads = ["".join(rng.choice(list("ACGT"), size=90)) for _ in range(100)]
    fq = tmp_path / "r.fastq"
    write_fastq(str(fq), reads)
    outs = [W.kmerize_paths([str(fq)], 19, batch_reads=b, max_len=128)
            for b in (16, 100, 1024)]
    for keys, counts in outs[1:]:
        assert np.array_equal(keys, outs[0][0])
        assert np.array_equal(counts, outs[0][1])
