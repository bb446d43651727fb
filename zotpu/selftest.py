"""On-device self-test: the five BASELINE configs, device vs golden, in-process.

Motivation (SURVEY.md section 4 item 6): the test suite runs on the CPU, and
a device compiler can differ from it. `zotpu selftest` is the pre-bench gate:
it runs every device path on small deterministic fixtures against the golden
reference ON WHATEVER BACKEND JAX SELECTED (the GPU in production) and
byte-compares.

Checks beyond the five configs:
- sentinel-heavy scan (short/N reads -> many invalid pack windows), where
  ties between sentinel probes and padding are most likely;
- the sharded step's overflow second round on whatever devices exist, via
  dist/shuffle.make_kmerize_step(force_second_round=True) -- both the
  gated-off and the taken overflow round.
"""

from __future__ import annotations

import json
import time

import numpy as np

from zotpu import semantics as S
from zotpu.reference_impl import golden as G


def _mk_reads(rng, genome: str, n: int, length: int, frac_genomic: float,
              with_n: bool = True) -> list[str]:
    reads = []
    for i in range(n):
        if rng.random() < frac_genomic:
            off = rng.integers(0, len(genome) - length)
            reads.append(genome[off:off + length])
        else:
            alpha = "ACGTN" if with_n and i % 4 == 0 else "ACGT"
            reads.append("".join(rng.choice(list(alpha), size=length)))
    return reads


def run_selftest(k: int = 25, verbose_print=print,
                 budget_s: float | None = None) -> int:
    """Returns 0 when every check that RAN is byte-equal, 1 otherwise.

    ``budget_s`` (or env ``ZOTPU_SELFTEST_BUDGET``, seconds) makes the run
    deadline-aware: once elapsed time exceeds the budget, remaining checks
    are skipped and the summary says ``partial: true``. The caller that
    needs this is bench.py's gate: a clean between-checks exit never kills
    the process in the middle of a device operation. A partial run with
    zero failures still gates as a pass (no byte-inequality was observed)."""
    import os

    import jax

    from zotpu.workloads import kmerize as WK
    from zotpu.workloads import pulldown as WP
    from zotpu.workloads import setops as WS
    from zotpu.workloads import spectrum as WSp

    if budget_s is None:
        budget_s = float(os.environ.get("ZOTPU_SELFTEST_BUDGET", 0)) or None

    checks: list[tuple[str, bool, str]] = []
    t_start = time.perf_counter()

    def over_budget() -> bool:
        return (budget_s is not None
                and time.perf_counter() - t_start > budget_s)

    def check(name: str, ok: bool, detail: str = ""):
        checks.append((name, bool(ok), detail))
        verbose_print(json.dumps({"check": name, "ok": bool(ok),
                                  **({"detail": detail} if detail else {})}))

    class _OverBudget(Exception):
        pass

    def guard():
        if over_budget():
            raise _OverBudget

    rng = np.random.default_rng(20260819)
    genome = "".join(rng.choice(list("ACGT"), size=20000))
    reads_a = _mk_reads(rng, genome, 600, 128, 0.7)
    reads_b = _mk_reads(rng, genome, 500, 128, 0.5)

    import tempfile
    partial = False
    try:
      with tempfile.TemporaryDirectory() as d:
        fa = os.path.join(d, "a.fastq")
        fb = os.path.join(d, "b.fastq")
        for path, reads in ((fa, reads_a), (fb, reads_b)):
            with open(path, "w") as f:
                for i, r in enumerate(reads):
                    f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")

        # config 1: kmerize, device accumulator path vs golden
        keys_a, cnt_a = WK.kmerize_paths([fa], k, batch_reads=256,
                                         max_len=128)
        gk_a, gc_a = G.kmerize(k, reads_a)
        check("config1_kmerize",
              np.array_equal(keys_a, gk_a) and np.array_equal(cnt_a, gc_a),
              f"{len(gk_a)} unique")
        guard()

        keys_b, cnt_b = WK.kmerize_paths([fb], k, batch_reads=256,
                                         max_len=128)
        gk_b, gc_b = G.kmerize(k, reads_b)

        # config 2: merge via the device tree
        mk, mc = WS.merge_tree_device([(keys_a, cnt_a), (keys_b, cnt_b)])
        wk, wc = G.merge([(gk_a, gc_a), (gk_b, gc_b)])
        check("config2_merge",
              np.array_equal(mk, wk) and np.array_equal(mc, wc),
              f"{len(wk)} unique")
        guard()

        # config 3: set algebra
        ok3 = True
        for op, gold in (("union", G.union), ("intersect", G.intersect),
                         ("diff", G.difference)):
            dk, dc = WS.set_op((keys_a, cnt_a), (keys_b, cnt_b), op=op)
            wk3, wc3 = gold((gk_a, gc_a), (gk_b, gc_b))
            ok3 &= np.array_equal(dk, wk3) and np.array_equal(dc, wc3)
        check("config3_setops", ok3)
        guard()

        # config 4: spectrum + cutoff
        h_dev = WSp.spectrum(cnt_a, max_count=64)
        h_gold = G.spectrum(gc_a, max_count=64)
        fit = WSp.spectrum_with_cutoff(cnt_a)
        check("config4_hist",
              np.array_equal(np.asarray(h_dev), np.asarray(h_gold))
              and fit["cutoff"] >= 1)
        guard()

        # config 5: panel pulldown, incl. the sentinel-heavy probe regime
        # (short + N-laden reads -> many invalid windows; round 2.2's
        # corruption class) -- per-read hit vectors must match exactly
        panel_src = [genome[:4000]]
        panel_keys, _ = G.kmerize(k, panel_src)
        samples = reads_b + ["".join(rng.choice(list("ACGTN"), size=40))
                             for _ in range(200)]  # short, N-heavy tail
        fs = os.path.join(d, "s.fastq")
        with open(fs, "w") as f:
            for i, r in enumerate(samples):
                f.write(f"@s{i}\n{r}\n+\n{'I' * len(r)}\n")
        (tot, rwh, per) = WP.pulldown_paths(panel_keys, [fs], k,
                                            batch_reads=256,
                                            max_len=128)[0]
        want = G.scan_panel(k, panel_keys, samples)
        check("config5_scan",
              np.array_equal(np.asarray(per, np.int64), want)
              and tot == int(want.sum()) and rwh == int((want > 0).sum()),
              f"{tot} hits / {rwh} reads")

        # --- sharded paths: every device path enters the gate ---

        # largest power-of-two shard count this backend can host (1 on a
        # single-device host; 8 on the CPU gate tests)
        D = 1
        while D * 2 <= min(len(jax.devices()), 8):
            D *= 2

        # sharded set op + jaccard with psum'd cardinalities (the --shards
        # path; at D=1 still the shard_map + psum program on the live
        # backend)
        guard()
        gi_k, _ = G.intersect((gk_a, gc_a), (gk_b, gc_b))
        gu_k, gu_c = G.union((gk_a, gc_a), (gk_b, gc_b))
        sk, sc, cards = WS.set_op_sharded((keys_a, cnt_a), (keys_b, cnt_b),
                                          "union", k, D)
        jac = WS.jaccard_sharded(keys_a, keys_b, k, D)
        check("sharded_setop_psum",
              np.array_equal(sk, gu_k) and np.array_equal(sc, gu_c)
              and cards["intersect"] == len(gi_k)
              and jac["intersect"] == len(gi_k)
              and jac["union"] == len(gu_k), f"D={D}")

        # chunk-streamed sharded set op (ChunkReader partition one shard at
        # a time; tiny chunk forces many chunks per shard)
        guard()
        pa = os.path.join(d, "a.zkf")
        pb = os.path.join(d, "b.zkf")
        from zotpu.io import container as C
        C.write(pa, C.KmerSet(k=k, keys=keys_a, counts=cnt_a))
        C.write(pb, C.KmerSet(k=k, keys=keys_b, counts=cnt_b))
        kk, sk2, sc2, cards2 = WS.set_op_sharded_stream(pa, pb, "union", D,
                                                        chunk=2048)
        check("sharded_setop_stream",
              kk == k and np.array_equal(sk2, gu_k)
              and np.array_equal(sc2, gu_c)
              and cards2["intersect"] == len(gi_k))

        # sharded pulldown (route with read-row-id payload, per-shard
        # sort-merge join, psum'd hits) on the live backend -- per-read
        # hits must match golden exactly, INCLUDING the sentinel-heavy
        # sample tail (invalid windows route as sentinel bucket padding
        # with tag 0)
        guard()
        (stot, srwh, sper) = WP.pulldown_paths_sharded(
            panel_keys, [fs], k, n_shards=D, batch_reads=256,
            max_len=128)[0]
        check("sharded_scan",
              np.array_equal(np.asarray(sper, np.int64), want)
              and stot == int(want.sum()) and srwh == int((want > 0).sum()),
              f"D={D}, {stot} hits")

        # chunk-streamed merge: container chunks -> DeviceAccumulator level
        # merges on the live backend (the cmd_merge path)
        guard()
        import argparse

        from zotpu import cli as CLI
        pm = os.path.join(d, "m.zkf")
        old_chunk = os.environ.get("ZOTPU_MERGE_CHUNK")
        os.environ["ZOTPU_MERGE_CHUNK"] = "4096"
        try:
            CLI.cmd_merge(argparse.Namespace(
                host=False, inputs=[pa, pb], output=pm, codec=None,
                merge_capacity=1 << 22))
        finally:
            if old_chunk is None:
                os.environ.pop("ZOTPU_MERGE_CHUNK", None)
            else:
                os.environ["ZOTPU_MERGE_CHUNK"] = old_chunk
        ms = C.read(pm)
        wmk, wmc = G.merge([(gk_a, gc_a), (gk_b, gc_b)])
        check("merge_chunk_streamed",
              np.array_equal(ms.keys, wmk) and np.array_equal(ms.counts, wmc))

        # spill/resume layout-stamp rejection (host logic, ~free): stale-k
        # and different-mode spills must be recomputed, matching loads kept
        from zotpu.workloads.kmerize import _load_run_if_valid
        ps = os.path.join(d, "run000001.zkf")
        stamp = {"k": k, "batch_reads": 256, "max_len": 128}
        C.write(ps, C.KmerSet(k=k, keys=keys_a[:4], counts=cnt_a[:4],
                              meta={"run": 1, **stamp}))
        ok_st = _load_run_if_valid(ps, stamp) is not None
        ok_st &= _load_run_if_valid(ps, {**stamp, "k": k + 2}) is None
        C.write(ps, C.KmerSet(k=k, keys=keys_a[:4], counts=cnt_a[:4],
                              meta={"run": 1, **stamp, "n_shards": 8}))
        ok_st &= _load_run_if_valid(ps, stamp) is None
        check("spill_stamp_rejection", ok_st)

        from zotpu.dist import mesh as M
        from zotpu.dist import shuffle
        from zotpu.io import wire
        from zotpu.kernels.sortdedup import compact_sorted

        # mixed-hash sharded kmerize step (owner EMBEDDED in spare key bits
        # + strip after routing). The embedding exists only at D >= 2; at
        # D=1 p_bits=0 and the step takes the prefix path, which this
        # check then covers instead.
        guard()
        codes_m = np.stack([G.encode(r) for r in reads_a])
        # pad rows to a multiple of D devices
        rpc = -(-len(reads_a) // D)
        pad_r = D * rpc - len(reads_a)
        codes_m = np.concatenate([codes_m, np.full(
            (pad_r, 128), 4, np.uint8)]) if pad_r else codes_m
        lengths_m = np.concatenate([np.full(len(reads_a), 128, np.int32),
                                    np.zeros(pad_r, np.int32)])
        pw_m, mw_m = wire.pack_codes(codes_m)
        step_m, _ = shuffle.make_kmerize_step(
            M.make_mesh(D), k, rpc, 128, capacity_factor=4.0,
            compact=True, wire=True, shard_hash="mixed")
        uhi, ulo, counts, nn, ovf, _ = step_m(pw_m, mw_m, lengths_m)
        okm = int(np.asarray(ovf).sum()) == 0
        gk2, gc2 = shuffle.gather_global(uhi, ulo, counts, nn, reorder=True)
        okm &= (np.array_equal(gk2, gk_a)
                and np.array_equal(gc2.astype(np.uint32), gc_a))
        check("mixed_hash_sharded_step", okm, f"D={D}")

        # sharded step with the overflow second round forced on:
        # gated-off AND taken rounds. guard() runs BEFORE each chunk of
        # device work, never after the last one -- a run whose final check
        # completes just as the budget expires is complete, not partial.
        codes = np.stack([G.encode(r) for r in reads_a])
        lengths = np.full(len(reads_a), 128, np.int32)
        pw, mw = wire.pack_codes(codes)
        mesh = M.make_mesh(1)
        for label, cf in (("gated", 1.05), ("taken", 0.8)):
            guard()
            step, _ = shuffle.make_kmerize_step(
                mesh, k, len(reads_a), 128, capacity_factor=cf,
                compact=False, wire=True, force_second_round=True)
            uhi, ulo, counts, n, ovf, _ = step(pw, mw, lengths)
            okd = int(np.asarray(ovf).sum()) == 0
            uhi, ulo, counts = (np.asarray(x) for x in compact_sorted(
                np.asarray(uhi).reshape(-1), np.asarray(ulo).reshape(-1),
                np.asarray(counts).reshape(-1)))
            nn = int(np.asarray(n)[0])
            got = S.join_hi_lo(uhi[:nn], ulo[:nn])
            okd &= (np.array_equal(got, gk_a)
                    and np.array_equal(counts[:nn].astype(np.uint32), gc_a))
            check(f"sharded_second_round_{label}", okd)
    except _OverBudget:
        partial = True
        verbose_print(json.dumps({
            "selftest_budget_exceeded": budget_s,
            "note": ("remaining checks skipped CLEANLY between device ops "
                     "(no mid-op kill; every check that ran is reported)")}))

    n_fail = sum(1 for _, ok, _ in checks if not ok)
    verbose_print(json.dumps({
        "command": "selftest", "device": str(jax.devices()[0]),
        "checks": len(checks), "failed": n_fail,
        "seconds": round(time.perf_counter() - t_start, 2),
        **({"partial": True} if partial else {}),
        "ok": n_fail == 0}))
    return 0 if n_fail == 0 else 1
