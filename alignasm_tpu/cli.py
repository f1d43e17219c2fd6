"""Command-line interface — same surface as the reference binary.

Parity target: /root/reference/src/alignasm.cpp:28-74 (flags) and
:398-490 (output naming): ``<input>.aln.paf``, ``<input>.aln.alt.paf``,
``<input>.aln.all.paf``.

Engine selection is new: ``--engine native`` (C++ host plane, default),
``--engine tpu`` (batched device kernels with a native host plane and
exact fallback), or ``--engine exact`` (pure-Python oracle-faithful
engine, also behind ``--resume`` and ``-t N`` process pooling).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

from alignasm_tpu.config import DEFAULT_CONFIG
from alignasm_tpu.io.paf import merge_alt_paf, read_paf, write_outputs


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "alignasm_tpu",
        description="Assembly alignment engine with a JAX device path"
    )
    p.add_argument("paf_loc", metavar="PAF_LOC", help="Location of PAF file")
    p.add_argument("-t", "--thread", type=int, default=1, metavar="THREAD",
                   help="Number of worker processes for the host engine")
    p.add_argument("-a", "--alt", metavar="PAF_ALT_LOC",
                   help="Location of alternative PAF file")
    p.add_argument("-b", "--alt_baseline", type=float, default=0.5,
                   metavar="ALT_BASELINE",
                   help="Baseline for coverage of alternative PAF file")
    p.add_argument("--non_skip_linkable", action="store_true",
                   help="Drop a->b edges when a->c->b exists")
    p.add_argument("--upgrade_mode",
                   choices=["alt_path", "single_piece", "no_update"],
                   default="alt_path",
                   help="Path upgrade mode — the reference's compile-time "
                        "UPGRADE_MODE, runtime-selectable in every engine")
    p.add_argument("--engine", choices=["native", "exact", "tpu"], default="native",
                   help="native: C++ host plane (default); exact: Python "
                        "reference engine; tpu: batched device kernels")
    p.add_argument("--progress", action="store_true")
    p.add_argument("--profile", metavar="DIR",
                   help="write a jax.profiler trace of the solve to DIR "
                        "(tpu engine: also its phase stats, stats.json)")
    p.add_argument("--resume", metavar="JOURNAL",
                   help="journal file for per-contig checkpoint/resume "
                        "(works with every --engine)")
    return p


def _progress_bar(width: int = 40):
    """In-place progress bar for the serial path (the analogue of the
    reference's indicators::ProgressBar, alignasm.cpp:362-397)."""
    state = {"last": -1}

    def tick(done: int, total: int) -> None:
        pct = done * 100 // max(total, 1)
        if pct == state["last"] and done != total:
            return
        state["last"] = pct
        filled = width * done // max(total, 1)
        sys.stderr.write(
            f"\r[{'#' * filled}{'-' * (width - filled)}] {pct:3d}% "
            f"({done}/{total} contigs)"
        )
        sys.stderr.flush()

    return tick


def _profiled(trace_dir):
    """jax.profiler trace of the enclosed solve into ``trace_dir``."""
    if not trace_dir:
        return contextlib.nullcontext()
    import jax

    os.makedirs(trace_dir, exist_ok=True)
    return jax.profiler.trace(trace_dir)


def output_paths(paf_loc: str):
    base = os.path.abspath(paf_loc)
    root, _ext = os.path.splitext(base)
    return root + ".aln.paf", root + ".aln.alt.paf", root + ".aln.all.paf"


def run(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if not args.paf_loc.endswith(".paf"):
        print(f"Wrong PAF file : {os.path.abspath(args.paf_loc)}", file=sys.stderr)
        return 1

    cfg = dataclasses.replace(
        DEFAULT_CONFIG,
        alt_baseline=args.alt_baseline,
        non_skip_linkable=args.non_skip_linkable,
        upgrade_mode=args.upgrade_mode,
    )

    if args.alt and not args.alt.endswith(".paf"):
        print(f"Wrong PAF file : {os.path.abspath(args.alt)}", file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    if args.engine == "native" and not args.resume:
        from alignasm_tpu import native

        alt = args.alt
        if alt and os.path.getsize(alt) == 0:
            alt = None  # zero-size alt disables the merge (alignasm.cpp:196-201)
        try:
            stats = native.run(
                args.paf_loc,
                alt_path=alt,
                alt_baseline=cfg.alt_baseline,
                non_skip_linkable=cfg.non_skip_linkable,
                threads=args.thread,
                config=cfg,
            )
        except native.NativeError as exc:
            print(f"alignasm_tpu: {exc}", file=sys.stderr)
            return 1
        elapsed = time.perf_counter() - t0
        cps = stats["contigs"] / elapsed if elapsed else 0.0
        print(
            f"{stats['contigs']} contigs, {stats['records']} records in "
            f"{elapsed:.2f}s ({cps:.0f} contigs/s; read {stats['read_s']:.2f}s "
            f"solve {stats['solve_s']:.2f}s write {stats['write_s']:.2f}s)"
        )
        return 0

    if args.engine == "tpu" and not args.resume:
        # production device engine: the C++ host plane parses the file
        # itself (a Python parse here would only duplicate it); a
        # native-plane failure degrades to the Python plane below,
        # visibly
        from alignasm_tpu import native
        from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

        out_p, alt_p, all_p = output_paths(args.paf_loc)
        try:
            with _profiled(args.profile):
                solve_dataset_tpu(
                    None, cfg, src_paths=(args.paf_loc, args.alt or None),
                    write_prefix=out_p[: -len(".aln.paf")],
                )
            stats = solve_dataset_tpu.last_stats
            if args.profile:
                with open(os.path.join(args.profile, "stats.json"),
                          "w") as fh:
                    json.dump(stats, fh, indent=1, default=str)
            if args.progress:
                print(f"device engine stats: {stats}")
            elapsed = time.perf_counter() - t0
            n_ctg = stats.get("n_contigs", 0)
            print("Write output PAF file")
            print(f"{n_ctg} contigs, {stats.get('n_records', 0)} records "
                  f"in {elapsed:.2f}s ({n_ctg / elapsed:.1f} contigs/s)")
            return 0
        except native.NativeError as exc:
            print(f"native host plane unavailable ({exc}); "
                  f"degrading to the Python plane", file=sys.stderr)

    dataset = read_paf(args.paf_loc)
    if args.alt:
        merge_alt_paf(dataset, args.alt, cfg.alt_baseline)
    print("File read complete")

    profile_ctx = _profiled(args.profile)
    profile_ctx.__enter__()

    if args.resume:
        from alignasm_tpu.runtime.checkpoint import solve_dataset_resumable

        outs, alt_outs, max_outs, stats = solve_dataset_resumable(
            dataset, cfg, args.resume, engine=args.engine,
            src_paths=(args.paf_loc, args.alt or None),
            threads=args.thread,
        )
        print(f"resume: {stats}")
    elif args.engine == "tpu":
        # degraded path: the native plane failed above — run the Python
        # device plane on the parsed dataset
        from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

        outs, alt_outs, max_outs = solve_dataset_tpu(dataset, cfg)
        if args.progress:
            print(f"device engine stats: {solve_dataset_tpu.last_stats}")
    elif args.thread > 1:
        from alignasm_tpu.runtime.scheduler import solve_dataset_parallel

        outs, alt_outs, max_outs = solve_dataset_parallel(dataset, cfg, args.thread)
    else:
        from alignasm_tpu.engine.exact import solve_dataset

        bar = _progress_bar() if args.progress else None
        outs, alt_outs, max_outs = solve_dataset(dataset, cfg, progress=bar)
        if bar is not None:
            print(file=sys.stderr)

    profile_ctx.__exit__(None, None, None)

    print("Write output PAF file")
    out_p, alt_p, all_p = output_paths(args.paf_loc)
    with open(out_p, "w") as fh:
        write_outputs(dataset, outs, fh)
    with open(alt_p, "w") as fh:
        write_outputs(dataset, alt_outs, fh)
    with open(all_p, "w") as fh:
        write_outputs(dataset, max_outs, fh, name_suffix_counts=True)

    elapsed = time.perf_counter() - t0
    n_rec = sum(len(c) for c in dataset.contigs)
    print(f"{len(dataset.contigs)} contigs, {n_rec} records in {elapsed:.2f}s "
          f"({len(dataset.contigs) / elapsed:.1f} contigs/s)")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
