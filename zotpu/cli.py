"""`zot`-style command-line interface.

Reference analog: zotmer's dispatcher `zot <command> [args...]`
(SURVEY.md section 1 L5) with one function per subcommand (L4). Commands:

    kmerize   FASTA/FASTQ -> ZKF k-mer set + counts        (BASELINE config 1)
    merge     N ZKF files -> one, counts summed            (BASELINE config 2)
    union/intersect/diff  set algebra between two sets     (BASELINE config 3;
              --shards N runs key-prefix-sharded across the mesh)
    jaccard   similarity from cardinalities (--shards N psums them per shard)
    hist      frequency spectrum (+ error-peak cutoff)     (BASELINE config 4)
    scan      panel pulldown over read sets                (BASELINE config 5)
    filter    drop k-mers below a count threshold (--auto = spectrum cutoff)
    sample    deterministic hash-threshold downsampling
    query     point k-mer count lookups / --seq membership screens
    probes/evidence/spikein  clinical variant family (variants.py; g. and
              transcript c./n. HGVS coordinates via --transcripts)
    casket    named-member containers (file.zkc#member addressing)
    dump/info print set contents / container metadata
    verify    compare two sets, report first divergence    (SURVEY.md section 4 item 6)
    bench     performance harness (bench/harness.py)

All compute paths run the device kernels; `--host` falls back to the golden
numpy reference implementation (the equality oracle).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from zotpu import semantics as S
from zotpu.io import container
from zotpu.reference_impl import golden as G


def _load_padded(path: str):
    ks = container.read(path)
    counts = ks.counts if ks.counts is not None else np.ones(ks.n, S.COUNT_DTYPE)
    return ks, counts


def _init_multihost(args, files=None, assign=True):
    """Bring up jax.distributed from the CLI flags (multi-host runs).

    Returns (process_id, files_for_this_host). ``files`` (default
    args.inputs) are assigned round-robin across hosts when ``assign``
    (data-parallel reading, SURVEY.md section 2b); scan passes assign=False
    because pulldown_paths_sharded owns the sample assignment (it must index
    results by GLOBAL sample position). Every host must still be launched
    with the same command line."""
    import jax

    from zotpu.dist import mesh as M
    files = args.inputs if files is None else files
    if not args.num_processes or args.num_processes <= 1:
        return 0, files
    if args.process_id is None or args.coordinator is None:
        raise ValueError(
            "--num-processes needs --coordinator HOST:PORT and --process-id")
    M.init_distributed(args.coordinator, args.num_processes, args.process_id)
    if args.shards <= 1:
        args.shards = len(jax.devices())
    local = (files[args.process_id::args.num_processes] if assign else files)
    logger_host = jax.process_index()
    return logger_host, local


def cmd_kmerize(args):
    import time

    # distributed init MUST precede the first backend use (imports are
    # backend-free since SENT32 became a numpy scalar, but keep the order)
    host_id, inputs = _init_multihost(args)
    from zotpu import metrics
    from zotpu.workloads import kmerize as W
    args = argparse.Namespace(**{**vars(args), "inputs": inputs})
    logger = (metrics.MetricsLogger(args.metrics, host_id=host_id)
              if args.metrics else None)
    stats = W.Stats()
    t0 = time.perf_counter()
    with metrics.profiled(args.trace):
        if args.host:
            seqs = _read_all_seqs(args.inputs)
            keys, counts = G.kmerize(args.k, seqs)
            stats.reads = len(seqs)
            stats.bases = sum(len(s) for s in seqs)
            stats.kmers = int(counts.sum(dtype=np.uint64)) if len(counts) else 0
            stats.unique = len(keys)
        elif args.shards > 1:
            keys, counts = W.kmerize_paths_sharded(
                args.inputs, args.k, args.shards,
                batch_reads=args.batch_reads, max_len=args.max_len,
                stats=stats, spill_dir=args.spill_dir, resume=args.resume,
                merge_capacity=args.merge_capacity,
                shard_hash=args.shard_hash)
        else:
            keys, counts = W.kmerize_paths(
                args.inputs, args.k, batch_reads=args.batch_reads,
                max_len=args.max_len, spill_dir=args.spill_dir, stats=stats,
                resume=args.resume, merge_capacity=args.merge_capacity)
    wall = time.perf_counter() - t0
    if host_id == 0:  # multi-host: every host holds the result; host 0 writes
        container.write(args.output, container.KmerSet(
            k=args.k, keys=keys, counts=counts,
            meta={"tool": "zotpu kmerize", "inputs": args.inputs,
                  "stats": stats.as_dict()}),
            codec=args.codec or ("zlib" if args.compress else "raw"))
    if logger:
        logger.log("kmerize", **metrics.kmerize_stage_metrics(
            stats, wall, n_chips=stats.n_chips))
        logger.close()
    print(json.dumps({"command": "kmerize", **stats.as_dict()}))
    return 0


def _read_all_seqs(paths):
    from zotpu.io import fastq
    seqs = []
    for p in paths:
        fmt = fastq.sniff_format(p)
        with fastq.open_file(p) as f:
            if fmt == "fastq":
                seqs.extend(s for _, s, _ in fastq.read_fastq(f))
            else:
                seqs.extend(s for _, s in fastq.read_fasta(f))
    return seqs


def cmd_merge(args):
    """Merge N sets, counts summed (BASELINE config 2).

    Device path: inputs stream ONE AT A TIME from disk in fixed-size chunks
    (container.ChunkReader decodes every codec incrementally) through the
    log-structured device accumulator (workloads/accumulator.py), so host
    RSS peaks at O(chunk) no matter how many multi-GB runs are merged
    (VERDICT round 3 item 7 -- the previous path still materialized each
    whole input before chunking it). Saturating count addition is
    order-insensitive here (partial sums only grow, so every order reaches
    0xFFFFFFFF on overflow), hence bytes match the old tree.
    --host keeps the golden numpy oracle (loads everything; small data)."""
    if args.host:
        sets = []
        k = None
        for p in args.inputs:
            ks, counts = _load_padded(p)
            if k is None:
                k = ks.k
            elif ks.k != k:
                print(f"error: K mismatch: {p} has k={ks.k}, expected {k}",
                      file=sys.stderr)
                return 1
            sets.append((ks.keys, counts))
        from zotpu.workloads.kmerize import merge_runs
        keys, counts = merge_runs(sets, force_host=True)
        n_in = len(sets)
    else:
        import jax.numpy as jnp

        from zotpu.workloads.accumulator import DeviceAccumulator
        CHUNK = int(os.environ.get("ZOTPU_MERGE_CHUNK", 1 << 22))
        acc = None
        k = None
        n_in = 0
        for p in args.inputs:
            r = container.ChunkReader(p)
            n_in += 1
            if k is None:
                k = r.k
            elif r.k != k:
                print(f"error: K mismatch: {p} has k={r.k}, expected {k}",
                      file=sys.stderr)
                return 1
            if acc is None:
                acc = DeviceAccumulator(CHUNK, max_cap=args.merge_capacity)
            for kc, cc in r.chunks(CHUNK):
                hi32, lo32 = S.split_hi_lo(kc)
                if cc is None:
                    cc = np.ones(len(kc), np.uint32)
                acc.add(jnp.asarray(hi32), jnp.asarray(lo32),
                        jnp.asarray(cc.astype(np.uint32)), len(kc))
        if acc is None:
            keys = np.empty(0, np.uint64)
            counts = np.empty(0, S.COUNT_DTYPE)
        else:
            keys, counts = acc.result()
    container.write(args.output, container.KmerSet(
        k=k, keys=keys, counts=counts, meta={"tool": "zotpu merge"}),
        codec=args.codec or "raw")
    print(json.dumps({"command": "merge", "inputs": n_in,
                      "unique": len(keys)}))
    return 0


def _binary_setop(args, op):
    multi = bool(getattr(args, "num_processes", None)
                 and args.num_processes > 1)
    if getattr(args, "stream", False) or multi:
        # Streamed sharded path (VERDICT round 4 item 4): partitions ride
        # container.ChunkReader (O(chunk) host RSS per input); under
        # multi-controller every host feeds only its addressable shards
        # from the shared filesystem, cardinalities psum, host 0 writes.
        import jax

        from zotpu.dist import shuffle
        from zotpu.workloads import setops as WS
        host_id, _ = _init_multihost(args, files=[], assign=False)
        n_shards = args.shards if args.shards > 1 else len(jax.devices())
        try:
            k, keys, counts, cards = WS.set_op_sharded_stream(
                args.a, args.b, op, n_shards)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        if multi:
            keys, counts = shuffle.allgather_host_sets(keys, counts)
        if host_id == 0:
            container.write(args.output, container.KmerSet(
                k=k, keys=keys, counts=counts, meta={"tool": f"zotpu {op}"}),
                codec=args.codec or "raw")
            print(json.dumps({"command": op, "unique": len(keys),
                              "cards": cards}))
        return 0
    a, ca = _load_padded(args.a)
    b, cb = _load_padded(args.b)
    if a.k != b.k:
        print(f"error: K mismatch ({a.k} vs {b.k})", file=sys.stderr)
        return 1
    if args.host:
        gold = {"union": G.union, "intersect": G.intersect, "diff": G.difference}[op]
        keys, counts = gold((a.keys, ca), (b.keys, cb))
    else:
        from zotpu.workloads import setops as WS
        if getattr(args, "shards", 1) > 1:
            # key-prefix sharded across the mesh, cardinalities psum'd
            # (BASELINE multi-host blueprint; byte-equal to single-chip)
            keys, counts, _ = WS.set_op_sharded(
                (a.keys, ca), (b.keys, cb), op, a.k, args.shards)
        else:
            keys, counts = WS.set_op((a.keys, ca), (b.keys, cb), op=op)
    container.write(args.output, container.KmerSet(
        k=a.k, keys=keys, counts=counts, meta={"tool": f"zotpu {op}"}),
        codec=args.codec or "raw")
    print(json.dumps({"command": op, "unique": len(keys)}))
    return 0


def _pair_jaccard(a, b, host, shards=1, cache=None):
    if host:
        ni = len(np.intersect1d(a.keys, b.keys))
        nu = len(np.union1d(a.keys, b.keys))
        na, nb = a.n, b.n
    else:
        from zotpu.workloads import setops as WS
        r = (WS.jaccard_sharded(a.keys, b.keys, a.k, shards, cache=cache)
             if shards > 1 else WS.jaccard(a.keys, b.keys))
        na, nb, ni, nu = r["a"], r["b"], r["intersect"], r["union"]
    return int(na), int(nb), int(ni), int(nu)


def cmd_jaccard(args):
    """Pairwise similarity; with >2 inputs prints the full matrix."""
    sets = [_load_padded(p)[0] for p in args.inputs]
    if len(sets) == 2:
        na, nb, ni, nu = _pair_jaccard(sets[0], sets[1], args.host,
                                       args.shards)
        print(json.dumps({"command": "jaccard", "a": na, "b": nb,
                          "intersect": ni, "union": nu,
                          "jaccard": ni / nu if nu else 0.0}))
        return 0
    # one partition cache for the whole matrix: each set is partitioned +
    # uploaded ONCE, not once per pair (VERDICT round 4 item 7)
    cache = {}
    for i in range(len(sets)):
        for j in range(i + 1, len(sets)):
            _, _, ni, nu = _pair_jaccard(sets[i], sets[j], args.host,
                                         args.shards, cache=cache)
            print(json.dumps({
                "command": "jaccard", "a": args.inputs[i], "b": args.inputs[j],
                "intersect": ni, "union": nu,
                "jaccard": ni / nu if nu else 0.0}))
    return 0


def cmd_hist(args):
    ks, counts = _load_padded(args.input)
    if args.host:
        h = G.spectrum(counts, max_count=args.max_count)
    else:
        from zotpu.workloads import spectrum as WSp
        h = WSp.spectrum(counts, max_count=args.max_count)
    for freq in range(1, len(h)):
        if h[freq]:
            print(f"{freq}\t{int(h[freq])}")
    if args.cutoff:
        from zotpu import stats as ST
        d = ST.spectrum_mixture_fit_detail(np.asarray(h, np.float64))
        print(json.dumps({"command": "hist", "cutoff": int(d["cutoff"]),
                          "coverage_peak": float(d["lam_g"]),
                          "genome_size_estimate":
                              int(d["genome_size_estimate"]),
                          "error_rate_lambda": round(d["lam_e"], 4),
                          "em_cutoff": int(d["em_cutoff"]),
                          "mixture_weights":
                              [round(x, 4) for x in d["weights"]],
                          "fit_ks": round(d["ks"], 4)}))
    return 0


def cmd_filter(args):
    """Drop k-mers below a count threshold (the config-4 error-trim step).

    --auto derives the threshold from the spectrum's error-peak cutoff."""
    ks, counts = _load_padded(args.input)
    if args.auto:
        from zotpu.workloads import spectrum as WSp
        fit = WSp.spectrum_with_cutoff(counts)
        min_count = fit["cutoff"]
    else:
        min_count = args.min_count
    if min_count is None:
        print("error: pass --min-count N or --auto", file=sys.stderr)
        return 1
    mask = counts >= np.uint32(min_count)
    container.write(args.output, container.KmerSet(
        k=ks.k, keys=ks.keys[mask], counts=counts[mask],
        meta={"tool": "zotpu filter", "min_count": int(min_count)}),
        codec=args.codec or "raw")
    print(json.dumps({"command": "filter", "min_count": int(min_count),
                      "kept": int(mask.sum()), "of": int(ks.n)}))
    return 0


def cmd_scan(args):
    # Overlong reads are halo-chunked into several device rows; pulldown
    # re-aggregates rows per input record via CodeBatch.record_ids, so all
    # outputs (totals, reads_with_hits, --per-read rows) stay record-aligned.
    # Multi-host (--coordinator ...): the panel shards over the full mesh
    # and samples are assigned round-robin to hosts (BASELINE config 5
    # "hash-sharded across hosts"); distributed init MUST precede device use.
    host_id, _ = _init_multihost(args, files=args.samples, assign=False)
    multi = args.num_processes is not None and args.num_processes > 1
    panel, _ = _load_padded(args.panel)
    from zotpu.workloads import pulldown
    if args.host:
        if multi:
            # the host path ignores sample assignment: every host would
            # scan ALL samples and emit duplicate per-read/out-reads output
            print("error: --host is not supported with --num-processes > 1 "
                  "(run the host oracle single-controller)", file=sys.stderr)
            return 1
        results = []
        for p in args.samples:
            seqs = _read_all_seqs([p])
            hits = G.scan_panel(panel.k, panel.keys, seqs)
            results.append((int(hits.sum()), int((hits > 0).sum()),
                            [int(h) for h in hits]))
    elif args.shards > 1:
        results = pulldown.pulldown_paths_sharded(
            panel.keys, args.samples, panel.k, args.shards,
            batch_reads=args.batch_reads, max_len=args.max_len,
            shard_hash=args.shard_hash)
    else:
        results = pulldown.pulldown_paths(
            panel.keys, args.samples, panel.k,
            batch_reads=args.batch_reads, max_len=args.max_len)
    # multi-host: every host holds all summary stats (allgathered); host 0
    # prints them. Per-read vectors exist only on the sample's owning host,
    # which prints/writes them (each host gets its own --out-reads file,
    # suffixed .pN, so hosts on shared storage never clobber one another).
    out_path = args.out_reads
    if out_path and multi:
        out_path = f"{out_path}.p{host_id}"
    out_fh = open(out_path, "w") if out_path else None
    for path, (total, reads_hit, per_read) in zip(args.samples, results):
        if host_id == 0:
            print(json.dumps({"command": "scan", "sample": path,
                              "k": panel.k, "total_hits": total,
                              "reads_with_hits": reads_hit}))
        if per_read is None:
            continue  # multi-host: another host owns this sample's rows
        if args.per_read:
            for i, h in enumerate(per_read):
                print(f"{path}\t{i}\t{h}")
        if out_fh is not None:
            _write_hit_reads(out_fh, path, per_read, args.min_hits)
    if out_fh is not None:
        out_fh.close()
    return 0


def _write_hit_reads(out_fh, path, per_read, min_hits):
    """Pull down reads with >= min_hits panel k-mers as FASTQ records."""
    from zotpu.io import fastq
    fmt = fastq.sniff_format(path)
    with fastq.open_file(path) as f:
        if fmt == "fastq":
            recs = fastq.read_fastq(f)
        else:
            recs = ((name, seq, "I" * len(seq)) for name, seq in fastq.read_fasta(f))
        for i, (rid, seq, qual) in enumerate(recs):
            if i < len(per_read) and per_read[i] >= min_hits:
                out_fh.write(f"@{rid}\n{seq}\n+\n{qual}\n")


def _write_variant_reads(args, meta, k, sample):
    """Per-variant pulldown of supporting reads (clinical workflow tail):
    for each panel variant, the sample reads carrying >= --min-hits of its
    ALT probes go to OUT_DIR/<variant>.<sample>.fastq.

    O(1) passes over the sample, not O(variants) (round 4 -- a 200-variant
    panel on a 10 GB FASTQ used to re-scan AND re-parse the file ~400
    times): ONE scan against the UNION of every variant's alt probes finds
    the candidate reads (any read supporting variant V with >= min_hits
    hits must hit the union at least once), ONE parse pass collects just
    those records, then each variant's per-read hit counts come from the
    golden scan over only the candidates (typically a tiny fraction of the
    sample)."""
    import re

    from zotpu.io import fastq
    from zotpu.workloads import pulldown
    os.makedirs(args.out_reads, exist_ok=True)
    sanitize = lambda s: re.sub(r"[^A-Za-z0-9._-]", "_", s)
    sbase = sanitize(os.path.basename(sample))
    alt_sets = {m["spec"]: np.asarray([int(x, 16) for x in m["alt_probes"]],
                                      np.uint64)
                for m in meta["variants"]}
    if not alt_sets:
        return {}
    union = np.unique(np.concatenate(list(alt_sets.values())))

    if args.min_hits <= 0:
        # Every read satisfies hits >= min_hits for EVERY variant, so each
        # output file is the whole sample: stream one parse pass into all
        # variant files at once instead of materializing the sample in RAM
        # (ADVICE round 4 -- the candidate dict below buffered a multi-GB
        # FASTQ fully when min_hits <= 0 made every read a candidate).
        outs = {m["spec"]: open(os.path.join(
                    args.out_reads, f"{sanitize(m['spec'])}.{sbase}.fastq"),
                    "w") for m in meta["variants"]}
        nw = 0
        fmt = fastq.sniff_format(sample)
        with fastq.open_file(sample) as f:
            it = (fastq.read_fastq(f) if fmt == "fastq"
                  else ((n, s, "I" * len(s)) for n, s in fastq.read_fasta(f)))
            for rid, seq, qual in it:
                rec = f"@{rid}\n{seq}\n+\n{qual}\n"
                for fh in outs.values():
                    fh.write(rec)
                nw += 1
        for fh in outs.values():
            fh.close()
        return {spec: nw for spec in outs}

    # 1. one scan of the whole sample vs the union panel
    if args.host:
        seqs = _read_all_seqs([sample])
        union_hits = [int(h) for h in G.scan_panel(k, union, seqs)]
    else:
        _, _, union_hits = pulldown.pulldown_paths(
            union, [sample], k, batch_reads=args.batch_reads,
            max_len=args.max_len)[0]
    cand = [i for i, h in enumerate(union_hits) if h >= 1]

    # 2. one parse pass collects just the candidate records
    recs = {}
    fmt = fastq.sniff_format(sample)
    cand_set = set(cand)
    with fastq.open_file(sample) as f:
        it = (fastq.read_fastq(f) if fmt == "fastq"
              else ((n, s, "I" * len(s)) for n, s in fastq.read_fasta(f)))
        for i, rec in enumerate(it):
            if i in cand_set:
                recs[i] = rec

    # 3. per-variant hit counts over only the candidates (host golden --
    # byte-equal to the device join by the project invariant)
    cand_seqs = [recs[i][1] for i in cand]
    written = {}
    for m in meta["variants"]:
        hits = (G.scan_panel(k, alt_sets[m["spec"]], cand_seqs)
                if cand else np.zeros(0, np.int64))
        out = os.path.join(args.out_reads,
                           f"{sanitize(m['spec'])}.{sbase}.fastq")
        nw = 0
        with open(out, "w") as fh:
            for idx, h in zip(cand, hits):
                if int(h) >= args.min_hits:
                    rid, seq, qual = recs[idx]
                    fh.write(f"@{rid}\n{seq}\n+\n{qual}\n")
                    nw += 1
        written[m["spec"]] = nw
    return written


def _expand_variant_specs(specs):
    """Expand ``@FILE`` entries into the HGVS specs the file lists.

    Clinical panels run to hundreds of variants, which do not fit argv
    comfortably; ``@vars.txt`` reads one spec per line (blank lines and
    ``#`` comments skipped). Plain specs pass through unchanged."""
    out = []
    for s in specs:
        if s.startswith("@"):
            with open(s[1:]) as f:
                for line in f:
                    line = line.split("#", 1)[0].strip()
                    if line:
                        out.append(line)
        else:
            out.append(s)
    return out


def cmd_probes(args):
    """Variant descriptions -> discriminating k-mer probe panel (ZKF).

    Reference analog: zotmer's HGVS probe generation (SURVEY.md section 2a
    clinical family); per-variant ref/alt probe lists ride in the container
    metadata for host-side attribution by `evidence`."""
    from zotpu import variants as V
    args.variants = _expand_variant_specs(args.variants)
    keys, meta = V.build_panel(args.variants, args.reference, args.k,
                               transcripts_path=args.transcripts)
    container.write(args.output, container.KmerSet(
        k=args.k, keys=keys, counts=None,
        meta={"tool": "zotpu probes", **meta}),
        codec=args.codec or "raw")
    print(json.dumps({"command": "probes", "variants": len(args.variants),
                      "probes": len(keys)}))
    return 0


def cmd_evidence(args):
    """Screen read sets for variant evidence against a probe panel."""
    from zotpu import variants as V
    from zotpu.workloads import kmerize as W
    hdr = container.read(args.panel)
    meta = hdr.meta
    if "variants" not in meta:
        raise ValueError(f"{args.panel}: not a probes panel (run "
                         f"`zotpu probes` first)")
    k = hdr.k
    for sample in args.samples:
        if args.host:
            seqs = _read_all_seqs([sample])
            keys, counts = G.kmerize(k, seqs)
        else:
            keys, counts = W.kmerize_paths(
                [sample], k, batch_reads=args.batch_reads,
                max_len=args.max_len)
        for row in V.evidence_from_counts(meta, keys, counts):
            print(json.dumps({"command": "evidence", "sample": sample,
                              **row}))
        if args.out_reads:
            written = _write_variant_reads(args, meta, k, sample)
            print(json.dumps({"command": "evidence", "sample": sample,
                              "out_reads": args.out_reads,
                              "supporting_reads": written}))
    return 0


def cmd_spikein(args):
    """Simulate reads from a reference with variants at a given VAF."""
    from zotpu import variants as V
    args.variants = _expand_variant_specs(args.variants)
    stats = V.spike_reads(args.reference, args.variants, args.output,
                          coverage=args.coverage, vaf=args.vaf,
                          read_len=args.read_len,
                          error_rate=args.error_rate, seed=args.seed,
                          transcripts_path=args.transcripts)
    print(json.dumps({"command": "spikein", "output": args.output, **stats}))
    return 0


def cmd_sample(args):
    ks, counts = _load_padded(args.input)
    keys, cnts = G.sample(ks.keys, counts, args.rate, seed=args.seed)
    container.write(args.output, container.KmerSet(
        k=ks.k, keys=keys, counts=cnts,
        meta={"tool": "zotpu sample", "rate": args.rate, "seed": args.seed}),
        codec=args.codec or "raw")
    print(json.dumps({"command": "sample", "kept": len(keys), "of": ks.n}))
    return 0


def cmd_query(args):
    """Point lookups: k-mer strings (or every k-mer of longer sequences with
    --seq) -> counts in a set.

    Reference analog: zotmer's sparse rank/select membership surface
    (SURVEY.md section 2a "sparse/succinct set") exposed interactively --
    the CLI front door to zotpu/sparse.py. Queries canonicalize first, so
    either strand of a k-mer finds its count."""
    from zotpu.sparse import SparseSet
    ks, counts = _load_padded(args.input)
    k = ks.k
    sset = SparseSet(ks.keys)
    # same @FILE expansion as the variant commands (shared helper: the old
    # inline copy skipped only whole-line comments, so a trailing
    # '# note' raised a length error instead of being stripped)
    specs = _expand_variant_specs(args.kmers)
    found = 0
    for q in specs:
        qs = q.upper()
        if not args.seq and len(qs) != k:
            raise ValueError(f"query {q!r} is {len(qs)} bases; the set has "
                             f"k={k} (use --seq to query every k-mer of a "
                             f"longer sequence)")
        keys = G.kmerize_seq(k, qs)
        if len(keys) == 0:
            print(json.dumps({"query": q, "count": 0,
                              "note": "no valid ACGT window"}))
            continue
        uniq = np.unique(keys)
        if ks.n == 0:  # empty set: every query misses (ADVICE round 2:
            # counts[0] would IndexError through the eager np.where)
            mask = np.zeros(len(uniq), bool)
            cnt = np.zeros(len(uniq), np.int64)
        else:
            mask = sset.access(uniq)
            cnt = np.where(mask, counts[np.minimum(sset.rank(uniq),
                                                   ks.n - 1)], 0)
        if args.seq:
            print(json.dumps({
                "query": q, "kmers": int(len(keys)),
                "distinct": int(len(uniq)), "present": int(mask.sum()),
                "total_count": int(cnt.sum())}))
        else:
            print(json.dumps({"query": q, "count": int(cnt[0])}))
        found += int(mask.sum())
    return 0 if found or not specs else 1


def cmd_dump(args):
    ks, counts = _load_padded(args.input)
    # vectorized text render: the per-key python loop (G.decode_kmer) takes
    # minutes on a WGS-scale set; this does ~2M rows/s in numpy blocks
    k = ks.k
    shifts = np.array([2 * (k - 1 - i) for i in range(k)], np.uint64)
    out = sys.stdout
    for lo in range(0, ks.n, 1 << 20):
        keys = ks.keys[lo:lo + (1 << 20)]
        codes = (keys[:, None] >> shifts[None, :]) & np.uint64(3)
        chars = S.DECODE_LUT[codes.astype(np.uint8)]
        block = np.empty((len(keys), k + 1), np.uint8)
        block[:, :k] = chars
        block[:, k] = ord("\t")
        text = block.tobytes().decode("ascii").split("\t")[:-1]
        out.write("".join(f"{s}\t{int(c)}\n" for s, c in
                          zip(text, counts[lo:lo + (1 << 20)])))
    return 0


def cmd_info(args):
    for p in args.inputs:
        hdr = container.read_header(p)
        print(json.dumps({"file": p, **hdr}))
    return 0


def cmd_verify(args):
    a, ca = _load_padded(args.a)
    b, cb = _load_padded(args.b)
    if a.k != b.k:
        print(json.dumps({"equal": False, "reason": f"k {a.k} != {b.k}"}))
        return 1
    if (a.counts is None) != (b.counts is None) and not args.as_sets:
        # a counts-less kset is a membership set, not an all-ones kfset;
        # reporting them equal hid a real format difference (VERDICT round 2
        # weak item 9). --as-sets opts into the membership-only comparison.
        which = args.a if a.counts is None else args.b
        print(json.dumps({"equal": False,
                          "reason": f"{which} has no counts (kset vs kfset; "
                                    f"pass --as-sets to compare membership "
                                    f"only)"}))
        return 1
    n = min(a.n, b.n)
    kdiff = np.nonzero(a.keys[:n] != b.keys[:n])[0]
    cdiff = (np.empty(0, np.int64) if args.as_sets
             else np.nonzero(ca[:n] != cb[:n])[0])
    first = min(
        int(kdiff[0]) if len(kdiff) else n if a.n != b.n else -1,
        int(cdiff[0]) if len(cdiff) else n if a.n != b.n else -1,
        key=lambda x: x if x >= 0 else 1 << 62)
    if first == -1:
        print(json.dumps({"equal": True, "n": int(a.n)}))
        return 0
    print(json.dumps({"equal": False, "first_divergence": int(first),
                      "n_a": int(a.n), "n_b": int(b.n)}))
    return 1


def cmd_casket(args):
    """Named-member containers (reference analog: the casket container
    layer, SURVEY.md section 2a). Members are complete ZKF streams; every
    reading command accepts 'casket.zkc#member' addressing."""
    if args.verb == "ls":
        print(json.dumps({"file": args.casket,
                          **container.casket_toc(args.casket)}))
        return 0
    if args.verb == "new":
        members = []
        for spec in args.members:
            name, _, src = spec.partition("=")
            if not name or not src:
                raise ValueError(f"member spec {spec!r} is not NAME=SET.zkf")
            members.append((name, container.read(src)))
        ks = [m[1].k for m in members]
        if len(set(ks)) > 1:
            raise ValueError(f"K mismatch across members: {sorted(set(ks))}")
        container.casket_write(args.casket, members,
                               codec=args.codec or "raw")
        print(json.dumps({"file": args.casket,
                          "members": [m[0] for m in members]}))
        return 0
    if args.verb == "add":
        container.casket_add(args.casket, args.name, container.read(args.source),
                             codec=args.codec or "raw")
        print(json.dumps({"file": args.casket, "added": args.name}))
        return 0
    if args.verb == "extract":
        container.write(args.output, container.casket_read(args.casket, args.name),
                        codec=args.codec or "raw")
        print(json.dumps({"file": args.output, "from": args.casket,
                          "member": args.name}))
        return 0
    raise AssertionError(args.verb)


def cmd_selftest(args):
    """On-device self-test: the five BASELINE configs byte-compared against
    golden on the selected backend (the pre-bench gate; SURVEY.md section 4
    item 6)."""
    from zotpu.selftest import run_selftest
    return run_selftest(k=args.k)


def cmd_bench(args):
    from zotpu.bench import harness
    return harness.run(args)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="zotpu", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    from zotpu import __version__
    p.add_argument("-V", "--version", action="version",
                   version=f"zotpu {__version__}")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp, host=True, batch=False):
        if host:
            sp.add_argument("--host", action="store_true",
                            help="use the golden numpy path instead of device kernels")
        if batch:
            sp.add_argument("--batch-reads", type=int, default=4096)
            sp.add_argument("--max-len", type=int, default=256)

    def multihost(sp):
        sp.add_argument("--coordinator", default=None,
                        help="HOST:PORT of process 0 for multi-host runs "
                             "(jax.distributed)")
        sp.add_argument("--num-processes", type=int, default=None,
                        help="total controller processes in a multi-host run")
        sp.add_argument("--process-id", type=int, default=None,
                        help="this process's id in [0, num-processes)")

    def out_codec(sp):
        sp.add_argument("--codec", choices=("raw", "zlib", "delta"),
                        default=None,
                        help="output container codec; 'delta' stores zlib'd "
                             "key deltas + u16 counts with an exception "
                             "table (smallest and fastest compressed form)")

    sp = sub.add_parser("kmerize", help="FASTA/FASTQ -> k-mer set with counts")
    sp.add_argument("-k", type=int, required=True, dest="k")
    sp.add_argument("--spill-dir", default=None,
                    help="write per-batch sorted runs here (restartable)")
    sp.add_argument("--shards", type=int, default=1,
                    help="shard the k-mer key space across N local devices "
                         "(power of two; all-to-all routing)")
    sp.add_argument("--shard-hash", choices=("prefix", "mixed"),
                    default="prefix", dest="shard_hash",
                    help="shard owner function: key prefix (concatenation "
                         "is globally sorted) or a mixed 32-bit hash "
                         "(balanced under GC-content skew; output re-sorted "
                         "at the end, bytes identical)")
    sp.add_argument("--merge-capacity", type=int, default=1 << 26,
                    help="device accumulator capacity in unique k-mers")
    sp.add_argument("--resume", action="store_true",
                    help="reuse completed runs in --spill-dir after a crash")
    sp.add_argument("--compress", action="store_true",
                    help="zlib-compress the output container blobs "
                         "(legacy alias for --codec zlib)")
    out_codec(sp)
    sp.add_argument("--metrics", default=None,
                    help="append JSONL stage metrics to this file")
    sp.add_argument("--trace", default=None,
                    help="write a jax.profiler trace to this directory")
    multihost(sp)
    sp.add_argument("output")
    sp.add_argument("inputs", nargs="+")
    common(sp, batch=True)
    sp.set_defaults(fn=cmd_kmerize)

    sp = sub.add_parser("merge", help="merge N sets, summing counts")
    sp.add_argument("output")
    sp.add_argument("inputs", nargs="+")
    sp.add_argument("--merge-capacity", type=int, default=1 << 26,
                    help="device accumulator capacity in unique k-mers")
    common(sp)
    out_codec(sp)
    sp.set_defaults(fn=cmd_merge)

    for op in ("union", "intersect", "diff"):
        sp = sub.add_parser(op, help=f"{op} of two sets")
        sp.add_argument("output")
        sp.add_argument("a")
        sp.add_argument("b")
        sp.add_argument("--shards", type=int, default=1,
                        help="key-prefix-shard both sets over N devices "
                             "(psum'd cardinalities; byte-equal output)")
        sp.add_argument("--stream", action="store_true",
                        help="partition the inputs straight from the "
                             "container files in O(chunk) host RSS (sets "
                             "larger than host RAM; implied by multi-host)")
        multihost(sp)
        common(sp)
        out_codec(sp)
        sp.set_defaults(fn=lambda a, _op=op: _binary_setop(a, _op))

    sp = sub.add_parser("jaccard", help="similarity of two or more sets")
    sp.add_argument("inputs", nargs="+")
    sp.add_argument("--shards", type=int, default=1,
                    help="shard the cardinality computation over N devices")
    common(sp)
    sp.set_defaults(fn=cmd_jaccard)

    sp = sub.add_parser("hist", help="k-mer frequency spectrum")
    sp.add_argument("input")
    sp.add_argument("--max-count", type=int, default=1024)
    sp.add_argument("--cutoff", action="store_true",
                    help="also print the error-peak cutoff")
    common(sp)
    sp.set_defaults(fn=cmd_hist)

    sp = sub.add_parser("filter", help="drop k-mers below a count threshold")
    sp.add_argument("output")
    sp.add_argument("input")
    sp.add_argument("--min-count", type=int, default=None)
    sp.add_argument("--auto", action="store_true",
                    help="derive the threshold from the error-peak cutoff")
    out_codec(sp)
    sp.set_defaults(fn=cmd_filter)

    sp = sub.add_parser("scan", help="panel pulldown over read sets")
    sp.add_argument("--shard-hash", choices=("prefix", "mixed"),
                    default="prefix", dest="shard_hash",
                    help="--shards owner function (see kmerize --shard-hash)")
    sp.add_argument("panel")
    sp.add_argument("samples", nargs="+")
    sp.add_argument("--per-read", action="store_true")
    sp.add_argument("--out-reads", default=None,
                    help="write reads with >= --min-hits panel k-mers here (FASTQ)")
    sp.add_argument("--min-hits", type=int, default=1)
    sp.add_argument("--shards", type=int, default=1,
                    help="hash-shard the panel across N local devices "
                         "(power of two; all-to-all k-mer routing)")
    multihost(sp)
    common(sp, batch=True)
    sp.set_defaults(fn=cmd_scan)

    sp = sub.add_parser("probes", help="variant descriptions -> k-mer probe panel")
    sp.add_argument("-k", type=int, required=True, dest="k")
    sp.add_argument("reference", help="reference FASTA")
    sp.add_argument("output")
    sp.add_argument("variants", nargs="+",
                    help="HGVS-style specs, e.g. chr1:g.123A>G, "
                         "chr1:g.10_12del, chr1:g.10_11insTT, "
                         "chr1:g.10_12dup, chr1:g.10_12delinsGG, "
                         "chr1:g.10_12inv; @FILE reads one spec per line "
                         "('#' comments ok); with --transcripts also "
                         "TX:c.76A>T, TX:c.-14G>C, TX:c.*6del, TX:c.88+2T>G, "
                         "TX:n.42del")
    sp.add_argument("--transcripts", metavar="TSV",
                    help="refGene-style gene models enabling c./n. "
                         "coordinates (name chrom strand txStart txEnd "
                         "cdsStart cdsEnd exonCount exonStarts exonEnds)")
    out_codec(sp)
    sp.set_defaults(fn=cmd_probes)

    sp = sub.add_parser("evidence",
                        help="variant evidence in read sets vs a probe panel")
    sp.add_argument("panel", help="output of `zotpu probes`")
    sp.add_argument("samples", nargs="+")
    sp.add_argument("--out-reads", metavar="DIR",
                    help="also write each variant's supporting reads "
                         "(>= --min-hits ALT-probe k-mers) to "
                         "DIR/<variant>.<sample>.fastq")
    sp.add_argument("--min-hits", type=int, default=1)
    common(sp, batch=True)
    sp.set_defaults(fn=cmd_evidence)

    sp = sub.add_parser("spikein",
                        help="simulate reads with variants at a given VAF")
    sp.add_argument("reference")
    sp.add_argument("output", help="FASTQ (.gz ok) to write")
    sp.add_argument("variants", nargs="+",
                    help="HGVS-style specs (@FILE reads one per line)")
    sp.add_argument("--vaf", type=float, default=0.5)
    sp.add_argument("--coverage", type=float, default=30.0)
    sp.add_argument("--read-len", type=int, default=100)
    sp.add_argument("--error-rate", type=float, default=0.0)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--transcripts", metavar="TSV",
                    help="gene models enabling c./n. variant specs")
    sp.set_defaults(fn=cmd_spikein)

    sp = sub.add_parser("query", help="look up k-mer counts in a set")
    sp.add_argument("input", help="ZKF set (casket#member ok)")
    sp.add_argument("kmers", nargs="+",
                    help="k-mer strings (either strand; @FILE reads one "
                         "per line)")
    sp.add_argument("--seq", action="store_true",
                    help="treat queries as longer sequences; report how many "
                         "of their k-mers are present")
    sp.set_defaults(fn=cmd_query)

    sp = sub.add_parser("sample", help="hash-threshold downsample")
    sp.add_argument("--rate", type=float, required=True)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("output")
    sp.add_argument("input")
    out_codec(sp)
    sp.set_defaults(fn=cmd_sample)

    sp = sub.add_parser("dump", help="print k-mers and counts as text")
    sp.add_argument("input")
    sp.set_defaults(fn=cmd_dump)

    sp = sub.add_parser("info", help="print container metadata")
    sp.add_argument("inputs", nargs="+")
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser("verify", help="compare two sets byte-for-byte")
    sp.add_argument("a")
    sp.add_argument("b")
    sp.add_argument("--as-sets", action="store_true",
                    help="compare membership only (a counts-less kset vs a "
                         "kfset is otherwise a format mismatch)")
    sp.set_defaults(fn=cmd_verify)

    sp = sub.add_parser("casket", help="named-member containers; reading "
                        "commands accept CASKET.zkc#member everywhere")
    cs = sp.add_subparsers(dest="verb", required=True)
    c = cs.add_parser("ls", help="print the member table")
    c.add_argument("casket")
    c.set_defaults(fn=cmd_casket)
    c = cs.add_parser("new", help="build a casket from NAME=SET.zkf specs")
    c.add_argument("casket")
    c.add_argument("members", nargs="+", metavar="NAME=SET.zkf")
    out_codec(c)
    c.set_defaults(fn=cmd_casket)
    c = cs.add_parser("add", help="add or replace one member")
    c.add_argument("casket")
    c.add_argument("name")
    c.add_argument("source", help="a ZKF file or CASKET#member")
    out_codec(c)
    c.set_defaults(fn=cmd_casket)
    c = cs.add_parser("extract", help="copy a member out to a ZKF file")
    c.add_argument("casket")
    c.add_argument("name")
    c.add_argument("output")
    out_codec(c)
    c.set_defaults(fn=cmd_casket)

    sp = sub.add_parser("selftest",
                        help="run the five BASELINE configs device-vs-golden "
                             "on the current backend (pre-bench gate)")
    sp.add_argument("-k", type=int, default=25, dest="k")
    sp.set_defaults(fn=cmd_selftest)

    sp = sub.add_parser("bench", help="performance harness")
    sp.add_argument("--workload", default="kmerize",
                    choices=["kmerize", "setops", "scan",
                             "scan-shard-model", "setops-shard-model",
                             "scaling", "shard-model", "shard-sensitivity",
                             "sustained", "parse", "e2e", "all"])
    sp.add_argument("--bases", type=int, default=1 << 26)
    sp.add_argument("--k", type=int, default=25)
    sp.add_argument("--repeats", type=int, default=3)
    sp.add_argument("--setops-n", type=int, default=None,
                    help="keys per side for the setops workload")
    sp.add_argument("--scan-reads", type=int, default=None,
                    help="reads for the scan workload")
    sp.add_argument("--scan-panel", type=int, default=None,
                    help="panel size for the scan workload")
    sp.set_defaults(fn=cmd_bench)
    return p


def main(argv=None) -> int:
    from zotpu import runtime
    runtime.setup()
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # downstream consumer (e.g. `zotpu dump | head`) closed the pipe
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 0
    except (ValueError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
