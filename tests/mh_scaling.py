"""Multi-host scaling measurement (manual tool).

Emulates a two-host run on one machine: T1 = one rank with -t 2 (one
"host"), T2 = two ranks with -t 2 each (two "hosts"), efficiency =
T1 / (2 * T2), interleaved reps so a CPU-steal window hits both sides.

    python tests/mh_scaling.py [n_contigs ...] [--reps N]

Prints one JSON line per corpus size plus a startup-floor line.
"""

from __future__ import annotations

import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from alignasm_tpu.testing.synth import generate_paf  # noqa: E402


def _spawn(paf, world, rank, env, threads=2):
    return subprocess.Popen(
        [sys.executable, "-m", "alignasm_tpu.parallel.multihost", str(paf),
         "--num-processes", str(world), "--process-id", str(rank),
         "-t", str(threads)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def _wall(paf, world, env):
    t0 = time.perf_counter()
    procs = [_spawn(paf, world, r, env) for r in range(world)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode()[-2000:]
    return time.perf_counter() - t0


def measure(n_contigs: int, reps: int, seed: int = 2024) -> dict:
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    work = pathlib.Path(tempfile.mkdtemp(prefix="alignasm_mh_", dir=shm))
    try:
        paf = work / "mh.paf"
        paf.write_text(generate_paf(n_contigs=n_contigs, seed=seed,
                                    max_records_per_contig=24))
        env = dict(os.environ)
        _wall(paf, 1, env)  # warm: native lib build, page cache
        ref = [pathlib.Path(str(paf)[:-4] + f".aln{s}.paf").read_bytes()
               for s in ("", ".alt", ".all")]
        t1s, t2s, effs = [], [], []
        for _ in range(reps):
            t1 = _wall(paf, 1, env)
            t2 = _wall(paf, 2, env)
            t1s.append(round(t1, 3))
            t2s.append(round(t2, 3))
            effs.append(round(t1 / (2 * t2), 4))
        got = [pathlib.Path(str(paf)[:-4] + f".aln{s}.paf").read_bytes()
               for s in ("", ".alt", ".all")]
        return {
            "n_contigs": n_contigs,
            "n_records": sum(1 for _ in open(paf)),
            "corpus_MB": round(os.path.getsize(paf) / 1e6, 1),
            "t1_reps_s": t1s,
            "t2_reps_s": t2s,
            "efficiency_reps": effs,
            "efficiency_median": round(statistics.median(effs), 4),
            "t1_best_s": min(t1s),
            "t2_best_s": min(t2s),
            "efficiency_best_of": round(min(t1s) / (2 * min(t2s)), 4),
            "output_identical_1p_2p": got == ref,
        }
    finally:
        import shutil

        shutil.rmtree(work, True)


def startup_floor() -> dict:
    """Per-rank interpreter start-up floor."""
    def t(env):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "-c", "pass"], env=env,
                           check=True)
            best = min(best, time.perf_counter() - t0)
        return round(best, 3)

    return {
        "interpreter_s": t(dict(os.environ)),
    }


def main() -> None:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("sizes", nargs="*", type=int,
                   default=[10000, 50000, 100000])
    p.add_argument("--reps", type=int, default=5)
    a = p.parse_args()
    sizes, reps = a.sizes or [10000, 50000, 100000], a.reps
    print(json.dumps({"startup_floor": startup_floor()}), flush=True)
    for n in sizes:
        print(json.dumps(measure(n, reps)), flush=True)


if __name__ == "__main__":
    main()
