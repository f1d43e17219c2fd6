"""Multi-host scale-out of the native engine.

The reference is single-process (SURVEY.md §2.9/§5.8); here contig
batches are data-parallel across hosts: each process runs the NATIVE
C++ shard engine (native.run_shard) — a contig-group-SHARDED parse
(the cheap line/name index scan covers the whole file, but the
expensive record parse + cs scan + solve + output formatting run only
for the rank's owned groups, a CONTIGUOUS record-balanced range every
rank derives identically from the index scan).  Contiguity makes the
merge pure blob concatenation: rank 0 streams its own slice — the
head of every output stream — straight into tmp-named outputs with no
shard file at all, ranks > 0 publish PRE-FORMATTED text shards
(atomic rename, shared filesystem — standard for pod workloads), and
rank 0 APPENDS each shard's blobs the moment it lands (the merge
overlaps the barrier), finally renaming the three outputs into place.
No Python objects, no duplicated record parse, no rank-0
re-formatting, no per-contig interleave seeks — the round-2/3
efficiency limiters are gone by construction.  Device-side
collectives are not needed for the merge — contigs share nothing —
so scaling is embarrassingly parallel and efficiency is bounded by
the shared index scan, which is memchr-bound.

Run on each host:

    python -m alignasm_tpu.parallel.multihost input.paf \
        --num-processes 8 --process-id <k>

Single-process invocation (no flags) degenerates to the local pipeline.
"""

from __future__ import annotations

import argparse
import os
import sys


def shard_indices(n: int, rank: int, world: int):
    return list(range(rank, n, world))


def _effective_r0w() -> float:
    """The rank-0 split weight io.cc read_paf_range actually uses:
    strict decimal form (digits, at most one dot), clamped to
    (0.1, 1.5], default 0.95.  The job digest hashes THIS effective
    value — hashing the raw env string let a one-host-only setting of
    the default (or an out-of-range value io.cc silently ignores)
    strand the merge on a digest mismatch while every shard was
    byte-correct (round-5 review)."""
    import re

    raw = os.environ.get("ALN_SHARD_R0W")
    if raw is None:
        return 0.95
    if re.fullmatch(r"[0-9]*\.?[0-9]*", raw) and any(
            c.isdigit() for c in raw):
        v = float(raw)
    else:
        v = -1.0
    return v if 0.1 < v <= 1.5 else 0.95


def run_local_procs(paf_path: str, world: int, argv_tail: list[str]) -> None:
    """Single-host convenience launcher: spawn all ``world`` ranks as
    subprocesses and wait.  Multi-HOST deployments launch one
    ``--process-id`` per host themselves."""
    import subprocess

    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "alignasm_tpu.parallel.multihost",
             paf_path, "--num-processes", str(world),
             "--process-id", str(rank), *argv_tail],
        )
        for rank in range(world)
    ]
    rcs = [p.wait() for p in procs]
    bad = [(r, rc) for r, rc in enumerate(rcs) if rc != 0]
    if bad:
        raise SystemExit(f"rank(s) failed: {bad}")


def run_multihost(
    paf_path: str,
    num_processes: int = 1,
    process_id: int = 0,
    threads: int = 0,
    alt_path: str | None = None,
    alt_baseline: float = 0.5,
    non_skip_linkable: bool = False,
    upgrade_mode: str = "alt_path",
) -> None:
    # The rank/world of THIS job come from the launcher's flags; ranks
    # run the native engine only and meet through the shared filesystem
    # (no coordinator, no device).
    if num_processes > 1:
        rank, world = process_id, num_processes
    else:
        rank, world = 0, 1

    import hashlib
    import struct

    from alignasm_tpu import native

    def _input_digest() -> int:
        """Cheap job identity: a partial is valid for THIS job iff it was
        produced from the same inputs, the same solver flags, and the
        same world size (the per-rank solve is deterministic, so a
        matching partial from an earlier crashed run is byte-equal to
        what this run would produce and is safe — even correct — to
        merge).  The digest covers every knob that reaches the solver
        (alt_baseline, non_skip_linkable) and the full file identity
        (size + mtime + head/tail bytes) of BOTH inputs, so a re-run
        with different flags, or against an edited same-size input,
        rejects stale partials instead of silently mixing configs."""
        h = hashlib.sha256()
        h.update(f"v4:{world}:{alt_baseline!r}:{non_skip_linkable}:"
                 f"{upgrade_mode}:".encode())
        # the rank-0 split weight changes group ownership; a cross-rank
        # mismatch must reject shards, not silently mis-split — hash
        # the EFFECTIVE clamped value io.cc uses, not the raw string
        h.update(f"r0w={_effective_r0w():.17g}:".encode())

        def _file_id(path):
            st = os.stat(path)
            h.update(f"{st.st_size}:{st.st_mtime_ns}:".encode())
            with open(path, "rb") as fh:
                h.update(fh.read(1 << 16))
                if st.st_size > (1 << 16):
                    fh.seek(-(1 << 16), os.SEEK_END)
                    h.update(fh.read(1 << 16))

        _file_id(paf_path)
        if alt_path and os.path.getsize(alt_path):
            _file_id(alt_path)
        return int.from_bytes(h.digest()[:8], "big", signed=False) >> 1

    digest = _input_digest()
    stem = os.path.abspath(paf_path)[: -len(".paf")]
    alt = alt_path if alt_path and os.path.getsize(alt_path) else None

    # per-rank native shard engine: contig-group-sharded parse + solve
    # + format fused in C++ over a CONTIGUOUS record-balanced group
    # range.  Ranks > 0 publish pre-formatted text shards (atomic
    # rename, so existence == internal completeness); rank 0 streams
    # its slice — the head of every output stream — straight into
    # tmp-named outputs, then APPENDS each later rank's blobs as its
    # shard lands (merge overlapped with the barrier; pure sequential
    # blob concatenation), and atomically renames the three outputs.
    cfg = None
    if upgrade_mode != "alt_path":
        import dataclasses

        from alignasm_tpu.config import DEFAULT_CONFIG

        cfg = dataclasses.replace(DEFAULT_CONFIG, upgrade_mode=upgrade_mode)
    merging = f"{stem}.merging" if rank == 0 else None
    info = native.run_shard(
        paf_path, None if rank == 0 else f"{stem}.shard{rank}.bin",
        rank, world, digest=digest,
        alt_path=alt, alt_baseline=alt_baseline,
        non_skip_linkable=non_skip_linkable, threads=threads, config=cfg,
        direct_prefix=merging,
    )
    n = info["n_total"]

    if rank == 0:
        # file-based barrier, overlapped with the merge: shards publish
        # via atomic rename; the header check rejects stale shards from
        # a different input / world size; each shard appends the moment
        # it lands (rank order = output order under contiguous ranges)
        import time

        timeout_s = float(os.environ.get("ALIGNASM_MERGE_TIMEOUT_S",
                                         "86400"))
        deadline = time.monotonic() + timeout_s
        last_note = time.monotonic()  # first note after 60s, not at once
        try:
            _merge_shards(stem, merging, world, digest, n, threads,
                          deadline, timeout_s, last_note)
        except BaseException:
            # a failed merge must not leave half-appended {stem}.merging
            # temporaries behind to be mistaken for output; shard files
            # stay — they are digest-keyed and reusable on rerun
            for sfx in (".aln.paf", ".aln.alt.paf", ".aln.all.paf"):
                try:
                    os.unlink(merging + sfx)
                except OSError:
                    pass
            raise


def _merge_shards(stem, merging, world, digest, n, threads,
                  deadline, timeout_s, last_note):
    import struct
    import time

    from alignasm_tpu import native

    for r in range(1, world):
        path_r = f"{stem}.shard{r}.bin"
        seen_stat = None
        while True:
            try:
                st = os.stat(path_r)
                cur = (st.st_mtime_ns, st.st_size, st.st_ino)
            except FileNotFoundError:
                cur = None
            if cur is not None and cur != seen_stat:
                seen_stat = cur
                with open(path_r, "rb") as fh:
                    raw = fh.read(80)
                hdr = struct.unpack("<10q", raw) if len(raw) == 80 else ()
                if (len(hdr) == 10 and hdr[0] == 0x414C4E53484432
                        and hdr[1] == digest and hdr[2] == world
                        and hdr[3] == r and hdr[4] == n):
                    break
            now = time.monotonic()
            if now > deadline:
                raise TimeoutError(
                    f"rank {r} shard never appeared/matched "
                    f"within {timeout_s:.0f}s "
                    "(ALIGNASM_MERGE_TIMEOUT_S to adjust)")
            if now - last_note > 60:
                last_note = now
                print(f"waiting for rank {r} shard...",
                      file=sys.stderr)
            # fine-grained poll: the landing shard sits on the merge's
            # critical path, and a coarse poll adds half its period per
            # shard on average
            time.sleep(0.002)
        native.append_shard(merging, path_r, world, r, digest=digest,
                            n_expected=n, threads=threads)
        os.unlink(path_r)
    for sfx in (".aln.paf", ".aln.alt.paf", ".aln.all.paf"):
        os.replace(merging + sfx, stem + sfx)


def main() -> None:
    p = argparse.ArgumentParser("alignasm-multihost")
    p.add_argument("paf_loc")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("-t", "--thread", type=int, default=0)
    p.add_argument("-a", "--alt")
    p.add_argument("-b", "--alt_baseline", type=float, default=0.5)
    p.add_argument("--non_skip_linkable", action="store_true")
    p.add_argument("--upgrade_mode",
                   choices=["alt_path", "single_piece", "no_update"],
                   default="alt_path")
    p.add_argument("--local-procs", type=int, default=0, metavar="W",
                   help="single-host launcher: spawn W ranks as local "
                        "subprocesses and wait")
    a = p.parse_args()
    if a.local_procs > 1:
        tail = ["-t", str(a.thread), "-b", str(a.alt_baseline),
                "--upgrade_mode", a.upgrade_mode]
        if a.alt:
            tail += ["-a", a.alt]
        if a.non_skip_linkable:
            tail.append("--non_skip_linkable")
        run_local_procs(a.paf_loc, a.local_procs, tail)
        return
    run_multihost(
        a.paf_loc, a.num_processes, a.process_id,
        a.thread, a.alt, a.alt_baseline, a.non_skip_linkable,
        a.upgrade_mode,
    )


if __name__ == "__main__":
    main()
    sys.exit(0)
