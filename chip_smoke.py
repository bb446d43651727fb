"""Smoke test of zotpu on an NVIDIA GPU, through the CLI, checked against golden.

    python chip_smoke.py [--seed N] [--out DIR]      # one card
    python chip_smoke.py --four-cards                # the --shards 4 paths

Data is made from --seed: one synthetic genome the length of E. coli K-12
MG1655, 150 bp reads at 30x with 0.5% substitutions and 0.1% N, a second
sample from a copy of the genome with 1% SNPs, and a panel of the canonical
25-mers of a 50 kbase slice. Every phase calls ``zotpu.cli.main`` in this one
process (a second JAX process could not get the card's memory) and compares
its output exactly with the golden numpy reference. Each phase prints one
JSON line; any failure exits non-zero. On success the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

JAX_PLATFORMS is pinned to cuda before JAX is imported, so a host without a
GPU fails instead of falling back to the CPU. The kmerize trace at the
2^25-base batch is written under --out and summarized there.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

GENOME_BASES = 4_641_652          # E. coli K-12 MG1655 (NC_000913.3)
READ_LEN = 150
COVERAGE = 30
SUB_RATE = 0.005
N_RATE = 0.001
SNP_RATE = 0.01
PANEL_BASES = 50_000
SCAN_READS = 1 << 17
K = 25
ACGTN = np.frombuffer(b"ACGTN", np.uint8)


# --------------------------------------------------------------- data


def make_genome(rng, n: int) -> np.ndarray:
    return rng.integers(0, 4, size=n, dtype=np.uint8)


def with_snps(rng, genome: np.ndarray, rate: float) -> np.ndarray:
    """A copy of ``genome`` with a fraction ``rate`` of positions changed to
    a different base."""
    out = genome.copy()
    pos = rng.choice(len(genome), size=int(len(genome) * rate), replace=False)
    out[pos] = (out[pos] + rng.integers(1, 4, size=len(pos),
                                        dtype=np.uint8)) % 4
    return out


def make_reads(rng, genome: np.ndarray, n_reads: int, read_len: int,
               sub_rate: float = SUB_RATE, n_rate: float = N_RATE
               ) -> np.ndarray:
    """(n_reads, read_len) u8 codes (0..3 bases, 4 = N) sampled uniformly
    from ``genome``, half of them reverse-complemented, with substitution
    errors and N calls."""
    offs = rng.integers(0, len(genome) - read_len + 1, size=n_reads)
    codes = genome[offs[:, None] + np.arange(read_len)[None, :]]
    rc = rng.random(n_reads) < 0.5
    codes[rc] = 3 - codes[rc, ::-1]
    flat = codes.reshape(-1)
    subs = rng.random(flat.size) < sub_rate
    flat[subs] = (flat[subs] + rng.integers(1, 4, size=int(subs.sum()),
                                            dtype=np.uint8)) % 4
    flat[rng.random(flat.size) < n_rate] = 4
    return codes


def write_fastq(path: str, codes: np.ndarray) -> None:
    """Fixed-width records "@r\\n<seq>\\n+\\n<qual>\\n", written in bulk."""
    n, length = codes.shape
    rec = np.empty((n, 2 * length + 7), np.uint8)
    rec[:, 0:3] = np.frombuffer(b"@r\n", np.uint8)
    rec[:, 3:3 + length] = ACGTN[codes]
    rec[:, 3 + length:6 + length] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 6 + length:6 + 2 * length] = ord("I")
    rec[:, -1] = ord("\n")
    with open(path, "wb") as f:
        f.write(rec.tobytes())


def write_fasta(path: str, name: str, codes: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n" + ACGTN[codes].tobytes() + b"\n")


def golden_kmerize(k: int, reads: np.ndarray):
    """Golden (keys, counts) of a read matrix: every read's codes joined
    with one code-4 separator between reads, then golden.kmerize_seq +
    golden.sort_dedup. No window spans a separator, so the k-mer multiset
    is exactly that of the reads."""
    from concurrent.futures import ThreadPoolExecutor

    from zotpu.reference_impl import golden as G

    n, length = reads.shape
    flat = np.full((n, length + 1), 4, np.uint8)
    flat[:, :length] = reads
    # row blocks end in a separator, so they kmerize independently; numpy
    # releases the GIL inside its loops, so threads share the host's cores
    blocks = np.array_split(flat, max(1, min(os.cpu_count() or 1, 16)))
    with ThreadPoolExecutor(len(blocks)) as pool:
        parts = list(pool.map(lambda b: G.kmerize_seq(k, b.reshape(-1)),
                              blocks))
    return G.sort_dedup(np.concatenate(parts))


# --------------------------------------------------------------- CLI


def cli(*argv) -> tuple[int, str]:
    """Run ``zotpu.cli.main`` in this process; return (rc, stdout)."""
    from zotpu import cli as C
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = C.main([str(a) for a in argv])
    return rc, buf.getvalue()


def _json_lines(out: str) -> list[dict]:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def _ok(rc: int, out: str) -> list[dict]:
    if rc != 0:
        raise RuntimeError(f"CLI exit code {rc}; output tail: {out[-500:]}")
    return _json_lines(out)


def same_set(path: str, want) -> dict:
    """Exact comparison of a written ZKF set with golden (keys, counts)."""
    from zotpu.io import container
    ks = container.read(path)
    keys_ok = np.array_equal(ks.keys, want[0])
    counts_ok = ks.counts is not None and np.array_equal(ks.counts, want[1])
    if not (keys_ok and counts_ok):
        raise AssertionError(
            f"{os.path.basename(path)} differs from golden: {ks.n} keys vs "
            f"{len(want[0])}, keys equal {keys_ok}, counts equal {counts_ok}")
    return {"unique": int(ks.n), "kmers": int(ks.counts.sum(dtype=np.uint64))}


def scan_rows(out: str) -> tuple[list[dict], list[str]]:
    rows = [ln for ln in out.splitlines() if ln and not ln.startswith("{")]
    return _json_lines(out), rows


# --------------------------------------------------------------- trace


def trace_summary(trace_dir: str, top: int = 20) -> dict:
    """Device time by kernel from the profiler trace: per device plane, the
    busy time (union of kernel intervals on its stream lines), the window
    from its first to its last kernel, and the top kernels by summed
    duration."""
    import glob

    import jax

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True))
    if not paths:
        return {"error": f"no .xplane.pb under {trace_dir}"}
    prof = jax.profiler.ProfileData.from_file(paths[-1])
    planes = []
    for plane in prof.planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = {}
        intervals = []
        for line in plane.lines:
            by_name: dict[str, list] = {}
            for ev in line.events:
                e = by_name.setdefault(ev.name, [0.0, 0])
                e[0] += ev.duration_ns
                e[1] += 1
                if line.name.startswith("Stream"):
                    intervals.append((ev.start_ns, ev.start_ns
                                      + ev.duration_ns))
            ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
            lines[line.name] = [{"name": n[:160], "ms": v[0] / 1e6,
                                 "count": v[1]} for n, v in ranked]
        busy = 0.0
        end = None
        for s, e in sorted(intervals):
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        window = (max(e for _, e in intervals) - min(s for s, _ in intervals)
                  if intervals else 0.0)
        planes.append({"plane": plane.name, "busy_s": busy / 1e9,
                       "window_s": window / 1e9,
                       "idle_share": 1 - busy / window if window else None,
                       "lines": lines})
    return {"file": os.path.relpath(paths[-1], trace_dir), "planes": planes}


# --------------------------------------------------------------- phases


def make_samples(work: str, seed: int, genome_bases: int, scan_reads: int,
                 panel_bases: int) -> dict:
    """Both samples' read matrices, written as a.fastq / b.fastq, the scan
    subset (scan.fastq, the first reads of sample A) and the panel slice
    (panel.fa) under ``work``."""
    rng = np.random.default_rng(seed)
    n_reads = genome_bases * COVERAGE // READ_LEN
    genome = make_genome(rng, genome_bases)
    d = {"a": make_reads(rng, genome, n_reads, READ_LEN),
         "b": make_reads(rng, with_snps(rng, genome, SNP_RATE), n_reads,
                         READ_LEN)}
    for s in ("a", "b"):
        write_fastq(os.path.join(work, f"{s}.fastq"), d[s])
    write_fastq(os.path.join(work, "scan.fastq"), d["a"][:scan_reads])
    off = int(rng.integers(0, genome_bases - panel_bases + 1))
    write_fasta(os.path.join(work, "panel.fa"), "panel",
                genome[off:off + panel_bases])
    d["info"] = {"genome_bases": genome_bases, "reads_per_sample": n_reads,
                 "read_len": READ_LEN, "bases_per_sample": n_reads * READ_LEN,
                 "scan_reads": min(scan_reads, n_reads), "panel_offset": off}
    return d


def check_scan(work: str, *flags) -> dict:
    """Device ``scan --per-read`` (with ``flags``) of scan.fastq against the
    panel's canonical k-mers, compared with ``scan --host --per-read``."""
    zp = os.path.join(work, "panel.zkf")
    fs = os.path.join(work, "scan.fastq")
    _ok(*cli("kmerize", "-k", K, "--host", zp,
             os.path.join(work, "panel.fa")))
    dev, dev_rows = scan_rows(cli("scan", "--per-read", *flags, zp, fs)[1])
    host, host_rows = scan_rows(cli("scan", "--host", "--per-read", zp,
                                    fs)[1])
    if not dev or dev != host or dev_rows != host_rows:
        raise AssertionError(f"scan {dev} != host {host} or per-read rows "
                             f"differ")
    if dev[0]["total_hits"] == 0:
        raise AssertionError("scan found no hits")
    return dev[0]


class Smoke:
    """Runs phases in order; each prints one JSON line."""

    def __init__(self, card: str):
        self.card = card
        self.failed: list[str] = []

    def phase(self, name: str, fn):
        t0 = time.perf_counter()
        rec = {"phase": name}
        try:
            rec["result"] = fn()
            rec["ok"] = True
        except Exception as e:  # report every phase, then fail the run
            rec["ok"] = False
            rec["error"] = f"{type(e).__name__}: {e}"[:2000]
            self.failed.append(name)
        rec["seconds"] = time.perf_counter() - t0
        rec["card"] = self.card
        print(json.dumps(rec), flush=True)
        return rec.get("result")


def run_one_card(smoke: Smoke, work: str, out: str, seed: int,
                 genome_bases: int = GENOME_BASES,
                 scan_reads: int = SCAN_READS,
                 batch_reads_big: int = 131072,
                 panel_bases: int = PANEL_BASES) -> None:
    """The one-card phases: kmerize (default and 2^25-base batches, traced),
    golden check, second sample + merge/set ops/jaccard, spectrum, scan,
    selftest."""
    from zotpu.reference_impl import golden as G

    d = {}

    def data():
        d.update(make_samples(work, seed, genome_bases, scan_reads,
                              panel_bases))
        return d["info"]

    smoke.phase("data", data)
    fa, fb = (os.path.join(work, f"{s}.fastq") for s in ("a", "b"))
    za, za2, zb = (os.path.join(work, f) for f in ("a.zkf", "a2.zkf",
                                                    "b.zkf"))
    trace = os.path.join(out, "trace_kmerize")

    def kmerize_a():
        res = {}
        for label, extra in (("default_batch", ()),
                             ("batch_2e25", ("--batch-reads", batch_reads_big)),
                             ("batch_2e25_traced", ("--batch-reads",
                                                    batch_reads_big,
                                                    "--trace", trace))):
            # the untraced 2^25-base run compiles every shape, so the traced
            # one shows the steady state
            t0 = time.perf_counter()
            stats = _ok(*cli("kmerize", "-k", K, *extra,
                             za if label == "default_batch" else za2, fa))[-1]
            res[label] = {"seconds": time.perf_counter() - t0, **stats}
        return res

    smoke.phase("kmerize_a", kmerize_a)

    def golden_a():
        d["ga"] = golden_kmerize(K, d["a"])
        return {"default_batch": same_set(za, d["ga"]),
                "batch_2e25": same_set(za2, d["ga"])}

    smoke.phase("golden_a", golden_a)

    def summarize():
        summary = trace_summary(trace)
        with open(os.path.join(out, "trace_summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
        return summary

    smoke.phase("trace_summary", summarize)

    def kmerize_b():
        s = _ok(*cli("kmerize", "-k", K, zb, fb))[-1]
        d["gb"] = golden_kmerize(K, d["b"])
        return {"stats": s, "golden": same_set(zb, d["gb"])}

    smoke.phase("kmerize_b", kmerize_b)

    def setops():
        ga, gb = d["ga"], d["gb"]
        res, gold = {}, {}

        def timed(key, fn):
            t0 = time.perf_counter()
            out_ = fn()
            res.setdefault("seconds", {})[key] = time.perf_counter() - t0
            return out_

        zm = os.path.join(work, "m.zkf")
        timed("merge", lambda: _ok(*cli("merge", zm, za, zb)))
        res["merge"] = same_set(zm, timed("golden_merge",
                                          lambda: G.merge([ga, gb])))
        for op, fn in (("union", G.union), ("intersect", G.intersect),
                       ("diff", G.difference)):
            zo = os.path.join(work, f"{op}.zkf")
            timed(op, lambda: _ok(*cli(op, zo, za, zb)))
            gold[op] = timed(f"golden_{op}", lambda: fn(ga, gb))
            res[op] = same_set(zo, gold[op])
        j = timed("jaccard", lambda: _ok(*cli("jaccard", za, zb)))[-1]
        want = {"a": len(ga[0]), "b": len(gb[0]),
                "intersect": len(gold["intersect"][0]),
                "union": len(gold["union"][0])}
        got = {key: j[key] for key in want}
        if got != want:
            raise AssertionError(f"jaccard {got} != golden {want}")
        res["jaccard"] = j
        return res

    smoke.phase("setops", setops)

    def spectrum():
        rc, out_ = cli("hist", za, "--cutoff")
        fit = _ok(rc, out_)[-1]
        rows = {int(f): int(c) for f, c in
                (ln.split("\t") for ln in out_.splitlines()
                 if ln and not ln.startswith("{"))}
        h = G.spectrum(d["ga"][1], max_count=1024)
        want = {f: int(h[f]) for f in range(1, len(h)) if h[f]}
        if rows != want:
            raise AssertionError("hist differs from golden spectrum")
        cut = G.error_peak_cutoff(h)
        if fit["cutoff"] != cut:
            raise AssertionError(f"cutoff {fit['cutoff']} != golden {cut}")
        return {"cutoff": cut, "coverage_peak": fit["coverage_peak"],
                "genome_size_estimate": fit["genome_size_estimate"]}

    smoke.phase("spectrum", spectrum)

    smoke.phase("scan", lambda: check_scan(work))

    def selftest():
        rc, out_ = cli("selftest")
        rows = _json_lines(out_)
        summary = rows[-1] if rows else {}
        skipped = [r for r in rows if "skipped" in r]
        if rc != 0 or not summary.get("ok") or summary.get("partial") \
                or skipped:
            raise AssertionError(f"selftest rc={rc} summary={summary} "
                                 f"skipped={skipped}")
        return {k_: summary[k_] for k_ in ("checks", "failed", "seconds")}

    smoke.phase("selftest", selftest)


def run_four_cards(smoke: Smoke, work: str, seed: int,
                   genome_bases: int = GENOME_BASES,
                   scan_reads: int = SCAN_READS,
                   panel_bases: int = PANEL_BASES) -> None:
    """The --shards 4 paths, each compared with the one-card golden result
    from the same seed."""
    from zotpu.io import container
    from zotpu.reference_impl import golden as G

    d = {}

    def data():
        d.update(make_samples(work, seed, genome_bases, scan_reads,
                              panel_bases))
        d["ga"] = golden_kmerize(K, d["a"])
        d["gb"] = golden_kmerize(K, d["b"])
        for s in ("a", "b"):
            container.write(os.path.join(work, f"g{s}.zkf"), container.KmerSet(
                k=K, keys=d[f"g{s}"][0], counts=d[f"g{s}"][1]))
        return d["info"]

    smoke.phase("data", data)
    fa = os.path.join(work, "a.fastq")

    for mode in ("prefix", "mixed"):
        def kmerize(mode=mode):
            zo = os.path.join(work, f"a_{mode}.zkf")
            s = _ok(*cli("kmerize", "-k", K, "--shards", 4, "--shard-hash",
                         mode, zo, fa))[-1]
            return {"stats": s, "golden": same_set(zo, d["ga"])}
        smoke.phase(f"kmerize_shards4_{mode}", kmerize)

    smoke.phase("scan_shards4", lambda: check_scan(work, "--shards", 4))

    def intersect():
        zo = os.path.join(work, "i.zkf")
        _ok(*cli("intersect", "--shards", 4, zo,
                 os.path.join(work, "ga.zkf"), os.path.join(work, "gb.zkf")))
        return same_set(zo, G.intersect(d["ga"], d["gb"]))

    smoke.phase("intersect_shards4", intersect)


# --------------------------------------------------------------- main


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return "; ".join(ln.strip() for ln in r.stdout.splitlines() if ln.strip())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "chiprun_out", "smoke"))
    p.add_argument("--four-cards", action="store_true",
                   help="run only the --shards 4 paths, on four cards")
    args = p.parse_args(argv)

    # No fallback that hides the device: CUDA or nothing.
    os.environ["JAX_PLATFORMS"] = "cuda"
    import jax

    from zotpu import runtime
    from zotpu.io import native

    runtime.setup()
    devs = jax.devices()
    want = 4 if args.four_cards else 1
    if devs[0].platform != "gpu" or len(devs) < want:
        print(f"error: need {want} GPU(s), JAX found {devs}", file=sys.stderr)
        return 1
    card = card_line()
    smoke = Smoke(card)
    lib = native.get_lib()
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": want}

    def device_phase():
        if lib is None:
            raise RuntimeError(f"native FASTQ parser did not load: "
                               f"{native.load_error()}")
        return {"nvidia_smi": card, "jax": jax.__version__,
                "device_kind": devs[0].device_kind, "devices": len(devs),
                "bytes_limit": devs[0].memory_stats().get("bytes_limit"),
                "native_parser": True}

    smoke.phase("device", device_phase)
    os.makedirs(args.out, exist_ok=True)
    work = tempfile.mkdtemp(prefix="zotpu_smoke_")
    try:
        if args.four_cards:
            run_four_cards(smoke, work, args.seed)
        else:
            run_one_card(smoke, work, args.out, args.seed)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if smoke.failed:
        print(f"error: phases failed: {', '.join(smoke.failed)}",
              file=sys.stderr)
        return 1
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
