"""Randomized differential fuzz campaign for the DEVICE (tpu) engine
(not collected by pytest — run manually on the GPU, or on the CPU with
JAX_PLATFORMS=cpu).

The native/exact campaign (fuzz_campaign.py) spawns one CLI process per
case; the device engine cannot afford that (per-process backend init and
compiles), so this campaign runs IN PROCESS: warm once, then loop
randomized cases — dataset generator x upgrade mode x alt merge x
--non_skip_linkable x -b — through the production entry
(solve_dataset_tpu, native host plane, native writers) and byte-compare
all three output PAFs against the reference: the matching C++ oracle
build where its sources are present, the exact engine (engine/exact.py,
same flags) otherwise.

    python tests/fuzz_campaign_tpu.py [n_cases] [master_seed]
"""
import pathlib
import random
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from alignasm_tpu.testing.synth import (  # noqa: E402
    generate_alt_paf, generate_boundary_paf, generate_hard_paf,
    generate_paf, generate_realistic_paf,
)

from tests.reference import ORACLE_DIR, oracle_available  # noqa: E402

ORACLES = {
    "alt_path": str(ORACLE_DIR / "bin" / "alignasm_ref"),
    "single_piece": str(ORACLE_DIR / "bin" / "alignasm_ref_sp"),
    "no_update": str(ORACLE_DIR / "bin" / "alignasm_ref_nu"),
}


def reference(paf, mode, args) -> None:
    """Golden outputs beside ``paf``: the oracle build for ``mode``, or
    the exact engine through the same CLI flags."""
    if ORACLES_BUILT:
        subprocess.run([ORACLES[mode], str(paf), *args], check=True,
                       capture_output=True, timeout=120)
    else:
        from alignasm_tpu import cli

        if cli.run([str(paf), "--engine", "exact", "--upgrade_mode", mode,
                    *args]) != 0:
            raise RuntimeError("exact engine failed")


def main() -> None:
    global ORACLES_BUILT

    ORACLES_BUILT = oracle_available()
    if ORACLES_BUILT:
        for target in ("all", "single", "noupdate"):
            subprocess.run(["make", "-C", str(ORACLE_DIR), target],
                           check=True, capture_output=True)
    from alignasm_tpu.config import AlignasmConfig
    from alignasm_tpu.io.paf import read_paf
    from alignasm_tpu.runtime import ensure_jax_compile_cache, scheduler

    ensure_jax_compile_cache()
    print(f"reference: {'C++ oracle' if ORACLES_BUILT else 'exact engine'}",
          flush=True)

    root = pathlib.Path(tempfile.mkdtemp(prefix="fuzz_tpu_"))
    n_cases = int(sys.argv[1]) if len(sys.argv) > 1 else 60
    master_seed = int(sys.argv[2]) if len(sys.argv) > 2 else 20260818
    rng = random.Random(master_seed)
    fails = []
    tot = {"device": 0, "fallback": 0, "singleton": 0, "native_direct": 0}
    t0 = time.time()
    for case in range(n_cases):
        kind = rng.choice(["basic", "basic", "hard", "hard", "hard",
                           "boundary", "realistic", "realistic"])
        gen = {"basic": generate_paf, "hard": generate_hard_paf,
               "boundary": generate_boundary_paf,
               "realistic": generate_realistic_paf}[kind]
        seed = rng.randrange(10_000, 1_000_000)
        mode = rng.choice(["alt_path", "alt_path", "alt_path",
                           "single_piece", "no_update"])
        nsl = rng.random() < 0.3
        use_alt = kind == "basic" and rng.random() < 0.3
        b = rng.choice([0.5, 0.5, 0.3, 0.7])

        d = root / f"c{case:04d}"
        d.mkdir()
        main_text = gen(n_contigs=rng.randrange(4, 16), seed=seed)
        paf = d / "t.paf"
        paf.write_text(main_text)
        args = []
        alt_src = None
        if use_alt:
            alt = d / "a.paf"
            alt.write_text(generate_alt_paf(main_text, seed=seed))
            if alt.stat().st_size:
                args += ["-a", str(alt)]
                alt_src = str(alt)
        if nsl:
            args += ["--non_skip_linkable"]
        args += ["-b", str(b)]
        try:
            reference(paf, mode, args)
        except Exception as e:
            fails.append((case, "reference", mode, kind, seed,
                          repr(e)[:100]))
            continue

        eng = d / "e.paf"
        eng.write_bytes(paf.read_bytes())
        # force the bucket device pipeline: the campaign exists to fuzz
        # THAT path (device_routing="auto" would route it all native)
        cfg = AlignasmConfig(alt_baseline=b, non_skip_linkable=nsl,
                             upgrade_mode=mode, device_routing="always")
        try:
            ds = read_paf(eng)
            scheduler.solve_dataset_tpu(
                ds, cfg, src_paths=(str(eng), alt_src),
                write_prefix=str(d / "e"))
            st = scheduler.solve_dataset_tpu.last_stats
            for k in tot:
                tot[k] += st.get(k, 0)
            if st.get("host_plane") != "native":
                fails.append((case, "plane", mode, kind, seed,
                              st.get("host_plane")))
            if st.get("device_error"):
                # the degrade-to-native path keeps bytes correct, so a
                # device regression would otherwise pass silently here
                fails.append((case, "device_error", mode, kind, seed,
                              st["device_error"][:120]))
        except Exception as e:
            fails.append((case, "engine", mode, kind, seed, repr(e)[:200]))
            continue
        for sfx in (".aln.paf", ".aln.alt.paf", ".aln.all.paf"):
            a = (d / ("t" + sfx)).read_bytes()
            bb = (d / ("e" + sfx)).read_bytes()
            if a != bb:
                fails.append((case, "bytes" + sfx, mode, kind, seed, "tpu"))
        if not any(f[0] == case for f in fails):
            import shutil

            shutil.rmtree(d)
        if case % 20 == 19:
            print(f"[{time.time() - t0:.0f}s] {case + 1}/{n_cases}, "
                  f"fails={len(fails)}, stats={tot}", flush=True)

    print(f"DONE: {n_cases} cases, {len(fails)} failures in "
          f"{time.time() - t0:.0f}s; contig totals {tot}")
    for f in fails[:20]:
        print("FAIL:", f)
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
