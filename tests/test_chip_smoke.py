"""chip_smoke.py rehearsed on the CPU at a tiny size: its data generator and
golden check, every one-card and four-card phase, and its refusal to run
without a GPU."""

import os
import shutil
import subprocess
import sys

from pathlib import Path

import numpy as np
import pytest

from zotpu.reference_impl import golden as G

REPO = str(Path(__file__).resolve().parent.parent)
sys.path.insert(0, REPO)

import chip_smoke as CS  # noqa: E402  (repo-root script)


def _decode(row):
    return CS.ACGTN[row].tobytes().decode()


def test_generator_and_golden_check_tiny():
    rng = np.random.default_rng(3)
    genome = CS.make_genome(rng, 3000)
    reads = CS.make_reads(rng, genome, 60, 150, sub_rate=0.01, n_rate=0.01)
    assert reads.shape == (60, 150) and reads.max() <= 4
    assert (reads == 4).any()                       # N calls present
    snp = CS.with_snps(rng, genome, 0.01)
    assert int((snp != genome).sum()) == 30
    # separator-joined golden == golden over the reads one by one
    want_k, want_c = G.kmerize(25, [_decode(r) for r in reads])
    got_k, got_c = CS.golden_kmerize(25, reads)
    assert np.array_equal(got_k, want_k) and np.array_equal(got_c, want_c)


def test_fastq_writer_round_trips(tmp_path):
    from zotpu.io import fastq
    rng = np.random.default_rng(4)
    reads = CS.make_reads(rng, CS.make_genome(rng, 500), 9, 40)
    p = str(tmp_path / "r.fastq")
    CS.write_fastq(p, reads)
    (batch,) = list(fastq.parse_batches(p, 16, 64))
    assert batch.n_reads == 9
    assert np.array_equal(batch.codes[:9, :40], reads)


def _run(fn, tmp_path, **kw):
    smoke = CS.Smoke("cpu rehearsal")
    work = tmp_path / "work"
    work.mkdir()
    fn(smoke, str(work), **kw)
    return smoke


def test_one_card_phases_tiny_on_cpu(tmp_path, capsys):
    out = tmp_path / "out"
    out.mkdir()
    smoke = _run(CS.run_one_card, tmp_path, out=str(out), seed=1,
                 genome_bases=6000, scan_reads=64, batch_reads_big=256,
                 panel_bases=800)
    lines = capsys.readouterr().out.splitlines()
    assert smoke.failed == [], "\n".join(lines)
    phases = [l for l in lines if l.startswith('{"phase"')]
    assert len(phases) == 9
    assert (out / "trace_summary.json").exists()


def test_four_card_phases_tiny_on_cpu(tmp_path, capsys):
    smoke = _run(CS.run_four_cards, tmp_path, seed=2, genome_bases=6000,
                 scan_reads=64, panel_bases=800)
    lines = capsys.readouterr().out.splitlines()
    assert smoke.failed == [], "\n".join(lines)


def test_failed_phase_is_reported_and_counted(capsys):
    smoke = CS.Smoke("cpu rehearsal")
    smoke.phase("boom", lambda: 1 / 0)
    assert smoke.failed == ["boom"]
    assert '"ok": false' in capsys.readouterr().out


@pytest.mark.parametrize("alone", [False, True])
def test_script_fails_without_gpu(tmp_path, alone):
    """No GPU here: the script exits non-zero and prints no result line --
    from the checkout, and alone in a directory without the package."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "PYTHONPATH")}
    r = subprocess.run([sys.executable, script, "--out",
                        str(tmp_path / "o")], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.gpu
def test_selftest_on_gpu(gpu):
    """On a card: zotpu selftest passes on the GPU backend with no check
    skipped (run with `python -m pytest -m gpu tests/test_chip_smoke.py`)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "ZOTPU_JAX_CACHE")}
    env["JAX_PLATFORMS"] = "cuda"
    r = subprocess.run([sys.executable, "-m", "zotpu", "selftest"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    assert '"skipped"' not in r.stdout
    assert "cuda" in r.stdout.lower()      # the summary names the device
