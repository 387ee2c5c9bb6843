"""masa_tpu command-line interface — the libmasa_entry_point equivalent
(libs/masa-core/src/libmasa/libmasa.cpp:762, getopt table :825-893).

Usage:  python -m masa_tpu [options] seq0.fasta seq1.fasta
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from masa_tpu.types import AlignmentStart, ScoreParams

HEADER = "masa_tpu: long-sequence alignment engine (JAX; CUDA on NVIDIA GPUs)"

_STARTS = {
    "*": AlignmentStart.ANYWHERE,
    "1": AlignmentStart.SEQUENCE_1,
    "2": AlignmentStart.SEQUENCE_2,
    "+": AlignmentStart.SEQUENCE_1_OR_2,
    "!": AlignmentStart.SEQUENCE_1_AND_2,
}


def _size(s: str) -> int:
    mult = 1
    s = s.strip().upper()
    for suffix, m in (("K", 1 << 10), ("M", 1 << 20), ("G", 1 << 30),
                      ("T", 1 << 40)):
        if s.endswith(suffix):
            mult, s = m, s[:-1]
            break
    return int(float(s) * mult)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="masa_tpu", description=HEADER,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("fasta", nargs=2, help="the two FASTA files")
    # general
    p.add_argument("--work-dir", default="work.tmp")
    p.add_argument("--clear", action="store_true",
                   help="wipe the work directory before starting")
    p.add_argument("--verbose", type=int, default=1)
    # input modifiers
    p.add_argument("--trim", default=None,
                   help="i0,i1,j0,j1 (1-based inclusive; 0 = no trim)")
    p.add_argument("--clear-n", action="store_true")
    p.add_argument("--reverse", default=None, choices=["1", "2", "both"])
    p.add_argument("--complement", default=None,
                   choices=["1", "2", "both"])
    p.add_argument("--reverse-complement", default=None,
                   choices=["1", "2", "both"])
    # alignment mode
    p.add_argument("--alignment-end", default=None,
                   choices=["*", "+", "1", "2", "!"],
                   help="where the alignment may end (default mirrors "
                        "--alignment-start)")
    p.add_argument("--alignment-start", default="*",
                   choices=list(_STARTS),
                   help="* local; ! global; +/1/2 semi-global")
    # scores
    p.add_argument("--match", type=int, default=1)
    p.add_argument("--mismatch", type=int, default=-3)
    p.add_argument("--gap-open", type=int, default=3)
    p.add_argument("--gap-ext", type=int, default=2)
    # execution
    p.add_argument("--stage-1", action="store_true",
                   help="run only stage 1 (score + endpoint)")
    p.add_argument("--no-flush", action="store_true",
                   help="do not save special rows (disables traceback)")
    p.add_argument("--ram-size", type=_size, default=1 << 30)
    p.add_argument("--disk-size", type=_size, default=16 << 30)
    p.add_argument("--no-block-pruning", action="store_true")
    p.add_argument("--dump-blocks", action="store_true",
                   help="dump per-block score maxima for the SVG "
                        "pruning plot (common/BlocksFile.cpp)")
    p.add_argument("--sra-compression", default="none",
                   choices=["none", "8bit", "4bit", "vlc"],
                   help="special-rows checkpoint compression")
    p.add_argument("--max-alignments", type=int, default=1)
    p.add_argument("--maximum-partition", type=int, default=16)
    p.add_argument("--stage-4-strategy", default="OPTIMIZED",
                   choices=["ORIGINAL_MM", "ORTHOGONAL", "OPTIMIZED"])
    p.add_argument("--output-format", default="text",
                   choices=["text", "svg", "histogram", "binary"],
                   help="stage-6 renderer (binary = CGFF only, which "
                        "stage 5 always writes)")
    # multi-device
    p.add_argument("--split", default="0",
                   help="column-shard stage 1 over N devices")
    p.add_argument("--fork", default=None,
                   help="N or W1,..,Wn: run one worker PROCESS per "
                        "weighted column slab, wired by localhost "
                        "sockets + the shared-dir pool "
                        "(fork_multi_process, libmasa.cpp:540-642)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "numpy", "kernel"])
    p.add_argument("--traceback", default="pipelined",
                   choices=["pipelined", "speculative"],
                   help="multi-device stage-2 strategy (--split/--fork): "
                        "pipelined right-to-left slab marching vs "
                        "speculative per-slab prediction (the entry-point "
                        "selection of libmasa.cpp:698-757)")
    # multi-host: initialize the JAX distributed runtime before building
    # the mesh (the network control plane; boundary columns ride ppermute)
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 for multi-host runs")
    p.add_argument("--num-hosts", type=int, default=1)
    p.add_argument("--host-id", type=int, default=0)
    p.add_argument("--test", action="store_true",
                   help="run a built-in self-check (kernel vs oracle on "
                        "a random pair) and exit — the reference's "
                        "--test throws Not Implemented")
    p.add_argument("--list-devices", action="store_true",
                   help="list accelerators and exit")
    p.add_argument("--config", default=None,
                   help="INI config file ([global]/[stageN])")
    return p


def _apply_modifiers(args, which: str, idx: int) -> dict:
    out = {}
    for flag, fields in (("reverse", ("reverse",)),
                         ("complement", ("complement",)),
                         ("reverse_complement", ("reverse", "complement"))):
        v = getattr(args, flag)
        if v in (which, "both"):
            for f in fields:
                out[f] = True
    if args.clear_n:
        out["clear_n"] = True
    return out


def main(argv=None) -> int:
    from masa_tpu.utils.devices import enable_persistent_compile_cache

    enable_persistent_compile_cache()
    import sys as _sys

    if argv is None:
        argv = _sys.argv[1:]
    if "--test" in argv:
        return _self_test()
    if "--list-devices" in argv:
        from masa_tpu.utils.devices import format_device_list

        print(format_device_list())
        return 0
    parser = build_parser()
    args = parser.parse_args(argv)
    print(HEADER)

    import dataclasses

    from masa_tpu.biology.sequence import Sequence, SequenceModifiers
    from masa_tpu.core.job import Job, JobConfig
    from masa_tpu.ops import myers_miller as mm
    from masa_tpu.stages import runner

    params = ScoreParams(args.match, args.mismatch, args.gap_open,
                         args.gap_ext)
    seqs = []
    for k, path in enumerate(args.fasta):
        mods = SequenceModifiers(**_apply_modifiers(args, str(k + 1), k))
        s = Sequence.from_file(path, mods)
        seqs.append(s)
    if args.trim:
        t = [int(x) for x in args.trim.split(",")]
        if t[0] or t[1]:
            seqs[0] = seqs[0].trimmed_view(t[0] or 1, t[1] or len(seqs[0]))
        if len(t) >= 4 and (t[2] or t[3]):
            seqs[1] = seqs[1].trimmed_view(t[2] or 1, t[3] or len(seqs[1]))

    seq0 = seqs[0].data()
    seq1 = seqs[1].data()
    print(f"seq0: {seqs[0].info.description} ({len(seq0)} bp)")
    print(f"seq1: {seqs[1].info.description} ({len(seq1)} bp)")

    jcfg = JobConfig(
        work_dir=args.work_dir,
        ram_limit=args.ram_size,
        disk_limit=args.disk_size,
        alignment_start=_STARTS[args.alignment_start],
        alignment_end=(_STARTS[args.alignment_end]
                       if args.alignment_end else None),
        params=params,
        max_alignments=args.max_alignments,
        clear=args.clear,
        stage4_max_partition=args.maximum_partition,
        stage4_strategy=args.stage_4_strategy.upper(),
        backend=args.backend,
        block_pruning=not args.no_block_pruning,
        sra_compression=args.sra_compression,
        dump_blocks=args.dump_blocks,
    )
    if args.config:
        # the INI file overrides execution resources/strategy
        # ([global]/[stageN], configs/default.cfg analogue)
        from masa_tpu.utils.config import apply_to_job_config, load_config

        apply_to_job_config(load_config(args.config), jcfg)
    job = Job(jcfg, seqs[0].info.hash or str(len(seq0)),
              seqs[1].info.hash or str(len(seq1)))

    log = print if args.verbose else (lambda *a, **k: None)

    # --split=N shards over N devices; --split=W1,..,Wn gives weighted
    # column slabs (the reference's fork-weight syntax, libmasa.cpp:497)
    try:
        split_weights = [float(x) for x in str(args.split).split(",")]
    except ValueError:
        parser.error(f"--split: expected N or W1,..,Wn, got {args.split!r}")
    nonlocal_mode = (args.alignment_start != "*"
                     or args.alignment_end is not None)
    if args.fork:
        if nonlocal_mode:
            parser.error(
                "--fork only supports local alignment "
                "(--alignment-start '*' and no --alignment-end)")
        try:
            fw = [float(x) for x in str(args.fork).split(",")]
        except ValueError:
            parser.error(f"--fork: expected N or W1,..,Wn, "
                         f"got {args.fork!r}")
        if len(fw) == 1:
            # --fork N: uniform slabs.  The parent must NOT touch JAX
            # before spawning (each worker owns its own runtime, and a
            # probe here would claim the device the workers need);
            # heterogeneous weights come from --fork W1,..,Wn or the
            # library's Aligner.get_fork_weights probe.
            fw = [1.0] * int(fw[0])
        from masa_tpu.parallel.fork import run_fork

        if args.backend == "numpy":
            print("warning: --backend numpy unsupported for --fork; "
                  "using the platform's strip kernel", file=sys.stderr)
        res = run_fork(seq0, seq1, fw, jcfg.work_dir, params,
                       max_partition=args.maximum_partition,
                       output_format=(args.output_format
                                      if args.output_format != "binary"
                                      else "text"))
        print(f"alignment score: {res['score']}  "
              f"({len(fw)} forked processes; matches={res['matches']} "
              f"mismatches={res['mismatches']} "
              f"gaps={res['gap_opens']}/{res['gap_extensions']})")
        return 0
    if len(split_weights) > 1:
        if nonlocal_mode:
            parser.error(
                "--split with weights only supports local alignment "
                "(--alignment-start '*' and no --alignment-end)")
        import time as _time

        from masa_tpu.parallel.split import (
            auto_urls, pipelined_traceback, run_part_stage1, split_points,
        )
        from masa_tpu.stages import pipeline as _pl
        from masa_tpu.stages.core import adaptive_config, stage1_config

        # 'numpy' has no streamed-border path: the strips run on the
        # platform's kernel route, with a warning
        if args.backend == "numpy":
            print("warning: --backend numpy unsupported for weighted "
                  "--split; using the platform's strip kernel",
                  file=sys.stderr)
        points = split_points(len(seq1), split_weights)
        urls = auto_urls(jcfg.work_dir, len(split_weights))
        score_only = args.stage_1 or args.no_flush
        # a traceback follows unless score-only: the strip comes with the
        # special-row plan
        kcfg = (adaptive_config(len(seq0)) if score_only
                else stage1_config(len(seq0), len(seq1), job.sra_limit()))
        iv = 0
        if not score_only:
            iv = job.calculate_flush_intervals(
                len(seq0), len(seq1), align_to=kcfg.rows)[0]
        t0 = _time.time()
        parts = []
        for k in range(len(split_weights)):
            parts.append(run_part_stage1(
                seq0, seq1, k, points, params, cfg=kcfg,
                load_url=urls[k - 1] if k > 0 else None,
                flush_url=urls[k] if k < len(split_weights) - 1 else None,
                buffered=False,
                special_every=iv,
            ))
        t1 = _time.time()
        b = max(p.best for p in parts)
        if score_only:
            print(f"stage1 (weighted column split "
                  f"{[p.j1 - p.j0 for p in parts]}): best={b}")
            return 0
        # full alignment over the weighted slabs, with the standard
        # work-dir artifact set (libmasa.cpp:659-696 + 1351-1394); the
        # stage-2 strategy follows --traceback (libmasa.cpp:698-757)
        if args.traceback == "speculative":
            from masa_tpu.parallel.split import speculative_traceback

            cps, _reused = speculative_traceback(seq0, seq1, parts,
                                                 params, backend="kernel")
        else:
            cps = pipelined_traceback(seq0, seq1, parts, params,
                                      backend="kernel")
        t2 = _time.time()
        pcfg = _pl.PipelineConfig(params=params,
                                  max_cells_stage5=jcfg.stage5_max_cells)
        cps = _pl.stage3_densify(seq0, seq1, pcfg, cps)
        t3 = _time.time()
        if args.maximum_partition:
            from masa_tpu.ops import myers_miller as _mm

            cps = _mm.stage4_reduce(seq0, seq1, cps, params,
                                    args.maximum_partition,
                                    stage5_max_cells=jcfg.stage5_max_cells)
        t4 = _time.time()
        aln = _pl.stage5_emit(seq0, seq1, pcfg, cps)
        fmt = (args.output_format if args.output_format != "binary"
               else "text")
        runner.finish_alignment(
            job, seq0, seq1, aln, cps=cps, fmt=fmt, log=log,
            elapsed={"stage1": t1 - t0, "stage2": t2 - t1,
                     "stage3": t3 - t2, "stage4": t4 - t3,
                     "stage5": _time.time() - t4})
        print(f"alignment score: {aln.raw_score}  "
              f"(weighted column split {[p.j1 - p.j0 for p in parts]}; "
              f"matches={aln.matches} mismatches={aln.mismatches} "
              f"gaps={aln.gap_opens}/{aln.gap_extensions})")
        return 0
    if int(split_weights[0]):
        if nonlocal_mode:
            parser.error(
                "--split only supports local alignment "
                "(--alignment-start '*' and no --alignment-end)")
        from masa_tpu.parallel.mesh import initialize_distributed, make_mesh
        from masa_tpu.parallel.sharded import sharded_align, sharded_stage1

        initialize_distributed(args.coordinator, args.num_hosts,
                               args.host_id)
        nsh = int(split_weights[0])
        mesh = make_mesh(nsh)
        if args.stage_1 or args.no_flush:
            res = sharded_stage1(seq0, seq1, mesh, params=params,
                                 prune=not args.no_block_pruning)
            print(f"stage1 (sharded over {nsh} devices): "
                  f"best={res.best}")
            return 0
        import time as _time

        t0 = _time.time()
        b, aln = sharded_align(seq0, seq1, mesh, params=params,
                               prune=not args.no_block_pruning,
                               traceback=args.traceback,
                               max_cells_stage5=jcfg.stage5_max_cells,
                               state_dir=job.path("sharded"), log=log)
        fmt = (args.output_format if args.output_format != "binary"
               else "text")
        runner.finish_alignment(job, seq0, seq1, aln, fmt=fmt, log=log,
                                elapsed={"stage1": _time.time() - t0})
        print(f"alignment score: {aln.raw_score}  "
              f"(sharded over {nsh} devices; matches={aln.matches} "
              f"mismatches={aln.mismatches} "
              f"gaps={aln.gap_opens}/{aln.gap_extensions})")
        return 0

    from masa_tpu.core.capabilities import AlignerCapabilities

    caps = AlignerCapabilities()
    if len(seq1) > caps.maximum_seq1_len:
        if nonlocal_mode:
            parser.error(
                "sequences this long require the column-split path, "
                "which only supports local alignment "
                "(--alignment-start '*' and no --alignment-end)")
        # oversize: chained column slabs with file:// border handoff
        # (sw_stage1.cpp:362-375 ni x nj splitting)
        from masa_tpu.parallel.split import align_oversize

        log(f"seq1 exceeds per-run capability "
            f"({caps.maximum_seq1_len} bp): splitting columns")
        b, aln = align_oversize(
            seq0, seq1, caps.maximum_seq1_len, jcfg.work_dir, params,
        )
        fmt = (args.output_format if args.output_format != "binary"
               else "text")
        runner.finish_alignment(job, seq0, seq1, aln, fmt=fmt, log=log)
        print(f"alignment score: {aln.raw_score}  "
              f"(matches={aln.matches} mismatches={aln.mismatches} "
              f"gaps={aln.gap_opens}/{aln.gap_extensions})")
        return 0

    best = runner.stage1(job, seq0, seq1, log=log)
    if args.stage_1 or args.no_flush:
        b = best.best
        print(f"best score: {b.score} at ({b.i},{b.j})")
        return 0

    fmt = args.output_format if args.output_format != "binary" else "text"
    aln = runner.execute_traceback(job, seq0, seq1, seqs, fmt=fmt, log=log)
    print(f"alignment score: {aln.raw_score}  "
          f"(matches={aln.matches} mismatches={aln.mismatches} "
          f"gaps={aln.gap_opens}/{aln.gap_extensions})")
    return 0


if __name__ == "__main__":
    sys.exit(main())


def _self_test() -> int:
    """Built-in self-check (the --test flag; libmasa.cpp:1195-1199 throws
    "Not Implemented" — here it works): align a random homologous pair
    end-to-end in memory and cross-check every layer against the oracle.
    """
    import numpy as np

    from masa_tpu.ops import oracle
    from masa_tpu.stages import pipeline, stage6
    from masa_tpu.types import ScoreParams

    rng = np.random.default_rng(12345)
    bases = np.frombuffer(b"ACGT", np.uint8)
    m = 2000
    s0 = rng.choice(bases, m).astype(np.uint8)
    s1 = s0.copy()
    idx = rng.random(m) < 0.08
    s1[idx] = rng.choice(bases, int(idx.sum())).astype(np.uint8)
    s1 = np.delete(s1, np.arange(900, 930))
    params = ScoreParams()
    ref = oracle.dp_rows(s0, s1, params)
    pcfg = pipeline.PipelineConfig(params=params,
                                   max_cells_stage5=1 << 14)
    res, endpoint = pipeline.stage1_pass(s0, s1, pcfg)
    ok = endpoint.score == ref.best
    print(f"stage1 best: {endpoint.score} (oracle {ref.best})"
          f" {'OK' if ok else 'FAIL'}")
    cps = pipeline.stage2_march(s0, s1, pcfg, endpoint, res.specials)
    cps = pipeline.stage3_densify(s0, s1, pcfg, cps)
    from masa_tpu.ops import myers_miller as mm

    cps = mm.stage4_reduce(s0, s1, cps, params, 16,
                           stage5_max_cells=pcfg.max_cells_stage5)
    aln = pipeline.stage5_emit(s0, s1, pcfg, cps)
    stage6.recheck(aln, s0, s1, params)
    ok2 = aln.raw_score == ref.best
    print(f"traceback score: {aln.raw_score} "
          f"(matches={aln.matches} mismatches={aln.mismatches} "
          f"gaps={aln.gap_opens}/{aln.gap_extensions})"
          f" {'OK' if ok2 else 'FAIL'}")
    print("self-test:", "PASS" if ok and ok2 else "FAIL")
    return 0 if ok and ok2 else 1
