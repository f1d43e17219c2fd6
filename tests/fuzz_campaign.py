"""Randomized differential fuzz campaign (not collected by pytest).

Datasets x engines (native/exact) x upgrade modes x flags (alt merge,
--non_skip_linkable, -b, -t, --resume), each byte-compared against the
matching oracle build.  Run manually:

    python tests/fuzz_campaign.py [n_cases]
"""
import pathlib, random, subprocess, sys, tempfile, time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from alignasm_tpu.testing.synth import (
    generate_alt_paf, generate_boundary_paf, generate_hard_paf,
    generate_paf, generate_realistic_paf,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
ORACLE_DIR = REPO / "tests" / "oracle"
ORACLES = {
    "alt_path": str(ORACLE_DIR / "bin" / "alignasm_ref"),
    "single_piece": str(ORACLE_DIR / "bin" / "alignasm_ref_sp"),
    "no_update": str(ORACLE_DIR / "bin" / "alignasm_ref_nu"),
}
# build every oracle flavor up front (all, single, noupdate targets)
for target in ("all", "single", "noupdate"):
    subprocess.run(["make", "-C", str(ORACLE_DIR), target],
                   check=True, capture_output=True)
root = pathlib.Path(tempfile.mkdtemp(prefix="fuzz_r2_"))
n_cases = int(sys.argv[1]) if len(sys.argv) > 1 else 300
master_seed = int(sys.argv[2]) if len(sys.argv) > 2 else 20260817
rng = random.Random(master_seed)
fails = []
t0 = time.time()
for case in range(n_cases):
    kind = rng.choice(["basic", "basic", "hard", "hard", "hard", "boundary",
                       "realistic", "realistic"])
    gen = {"basic": generate_paf, "hard": generate_hard_paf,
           "boundary": generate_boundary_paf,
           "realistic": generate_realistic_paf}[kind]
    seed = rng.randrange(10_000, 1_000_000)
    mode = rng.choice(["alt_path", "alt_path", "alt_path", "single_piece", "no_update"])
    engine = rng.choice(["native", "native", "exact"])
    nsl = rng.random() < 0.3
    use_alt = kind == "basic" and rng.random() < 0.3
    threads = rng.choice([1, 1, 4])
    b = rng.choice([0.5, 0.5, 0.3, 0.7])

    d = root / f"c{case:04d}"
    d.mkdir()
    main = gen(n_contigs=rng.randrange(4, 16), seed=seed)
    paf = d / "t.paf"
    paf.write_text(main)
    args = []
    if use_alt:
        alt = d / "a.paf"
        alt.write_text(generate_alt_paf(main, seed=seed))
        if alt.stat().st_size:
            args += ["-a", str(alt)]
    if nsl:
        args += ["--non_skip_linkable"]
    args += ["-b", str(b)]
    try:
        subprocess.run([ORACLES[mode], str(paf), *args], check=True,
                       capture_output=True, timeout=120)
    except Exception as e:
        fails.append((case, "oracle", mode, kind, seed, repr(e)[:100]))
        continue
    eng = d / "e.paf"
    eng.write_bytes(paf.read_bytes())
    cmd = [sys.executable, "-m", "alignasm_tpu.cli", str(eng), *args,
           "--engine", engine, "--upgrade_mode", mode, "-t", str(threads)]
    if rng.random() < 0.15:
        cmd += ["--resume", str(d / "j.bin")]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except Exception as e:
        fails.append((case, "engine", mode, kind, seed, repr(e)[:200]))
        continue
    for sfx in (".aln.paf", ".aln.alt.paf", ".aln.all.paf"):
        a = (d / ("t" + sfx)).read_bytes()
        bb = (d / ("e" + sfx)).read_bytes()
        if a != bb:
            fails.append((case, "bytes" + sfx, mode, kind, seed, engine))
    # cleanup on success to bound disk
    if not any(f[0] == case for f in fails):
        import shutil
        shutil.rmtree(d)
    if case % 50 == 49:
        print(f"[{time.time()-t0:.0f}s] {case+1}/{n_cases}, fails={len(fails)}", flush=True)

print(f"DONE: {n_cases} cases, {len(fails)} failures in {time.time()-t0:.0f}s")
for f in fails[:20]:
    print("FAIL:", f)
sys.exit(1 if fails else 0)
