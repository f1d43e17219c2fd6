"""Input edge cases through the native pipeline vs the reference (the
C++ oracle where its sources exist, else the exact engine)."""

import pathlib

import pytest

from alignasm_tpu import native


def _both(reference_outputs, tmp_path, text, extra=()):
    paf = tmp_path / "t.paf"
    paf.write_text(text)
    gold = reference_outputs(paf, tmp_path, extra=extra)
    nat = tmp_path / "n.paf"
    nat.write_bytes(paf.read_bytes())
    native.run(str(nat))
    for g, suffix in zip(gold, ("", ".alt", ".all")):
        got = pathlib.Path(str(nat)[:-4] + f".aln{suffix}.paf")
        assert g == got.read_bytes(), f"aln{suffix}"


def test_single_base_records(reference_outputs, tmp_path):
    # qry_end - qry_str == 1 (single base, half-open)
    rows = [
        "c1\t100\t5\t6\t+\tchrA\t50\t9\t10\t1\t1\t60\tcs:Z::1",
        "c1\t100\t20\t21\t+\tchrA\t50\t30\t31\t1\t1\t0\tcs:Z::1",
    ]
    _both(reference_outputs, tmp_path, "\n".join(rows) + "\n")


def test_crlf_line_endings(reference_outputs, tmp_path):
    rows = [
        "c1\t200\t0\t50\t+\tchrA\t500\t0\t50\t50\t50\t60\tcs:Z::50",
        "c1\t200\t60\t120\t+\tchrA\t500\t60\t120\t60\t60\t60\tcs:Z::60",
    ]
    _both(reference_outputs, tmp_path, "\r\n".join(rows) + "\r\n")


def test_mapq_255(reference_outputs, tmp_path):
    rows = [
        "c1\t300\t0\t50\t+\tchrA\t500\t0\t50\t50\t50\t255\tcs:Z::50",
        "c1\t300\t60\t120\t-\tchrA\t500\t200\t260\t60\t60\t255\tcs:Z::60",
    ]
    _both(reference_outputs, tmp_path, "\n".join(rows) + "\n")


def test_reappearing_contig_name(reference_outputs, tmp_path):
    # query name appears, another contig intervenes, then it reappears:
    # the reference starts a NEW contig on every name change
    rows = [
        "cA\t200\t0\t50\t+\tchrA\t500\t0\t50\t50\t50\t60\tcs:Z::50",
        "cB\t200\t0\t50\t+\tchrA\t500\t100\t150\t50\t50\t60\tcs:Z::50",
        "cA\t200\t60\t110\t+\tchrA\t500\t200\t250\t50\t50\t60\tcs:Z::50",
    ]
    _both(reference_outputs, tmp_path, "\n".join(rows) + "\n")


def test_rev_strand_only_contig(reference_outputs, tmp_path):
    rows = [
        "c1\t400\t10\t60\t-\tchrA\t900\t700\t750\t50\t50\t60\tcs:Z::50",
        "c1\t400\t80\t140\t-\tchrA\t900\t600\t660\t60\t60\t60\tcs:Z::60",
        "c1\t400\t150\t200\t-\tchrA\t900\t500\t550\t50\t50\t20\tcs:Z::50",
    ]
    _both(reference_outputs, tmp_path, "\n".join(rows) + "\n")


def test_identical_duplicate_records(reference_outputs, tmp_path):
    # exact duplicates: full-distance ties everywhere — deterministic
    # oracle (bump allocator) vs engine must still agree
    row = "c1\t300\t10\t110\t+\tchrA\t500\t10\t110\t100\t100\t60\tcs:Z::100"
    rows = [row, row, "c1\t300\t150\t250\t+\tchrA\t500\t150\t250\t100\t100\t60\tcs:Z::100"]
    _both(reference_outputs, tmp_path, "\n".join(rows) + "\n")


def test_alt_merge_flush_fallback(reference_outputs, tmp_path):
    # an alt group where no record passes the baseline: the single
    # best-ratio record is appended instead (alignasm.cpp:244-252)
    main_rows = [
        "cA\t1000\t0\t200\t+\tchrA\t900\t0\t200\t200\t200\t60\tcs:Z::200",
        "cA\t1000\t300\t500\t+\tchrA\t900\t300\t500\t200\t200\t60\tcs:Z::200",
    ]
    alt_rows = [
        # fragment total 400 -> ratios 50/400 and 80/400, both < 0.5
        "cA:201-600\t400\t0\t50\t+\tchrB\t700\t0\t50\t50\t50\t60\tcs:Z::50",
        "cA:201-600\t400\t100\t180\t+\tchrB\t700\t100\t180\t80\t80\t60\tcs:Z::80",
    ]
    paf = tmp_path / "m.paf"
    paf.write_text("\n".join(main_rows) + "\n")
    alt = tmp_path / "a.paf"
    alt.write_text("\n".join(alt_rows) + "\n")
    gold = reference_outputs(paf, tmp_path, extra=["-a", str(alt)])
    nat = tmp_path / "n.paf"
    nat.write_bytes(paf.read_bytes())
    native.run(str(nat), alt_path=str(alt))
    for g, suffix in zip(gold, ("", ".alt", ".all")):
        got = pathlib.Path(str(nat)[:-4] + f".aln{suffix}.paf")
        assert g == got.read_bytes(), f"aln{suffix}"


def test_mapq_overflow_wraps_uint8(reference_outputs, tmp_path):
    # mapq 256/300 pass through uint8_t in the reference (paf_data.hpp:65)
    # — 256 scores qul_nonzero=0 and prints as "0"; all engines must wrap
    rows = [
        "c1\t300\t0\t50\t+\tchrA\t500\t0\t50\t50\t50\t256\tcs:Z::50",
        "c1\t300\t60\t120\t+\tchrA\t500\t60\t120\t60\t60\t300\tcs:Z::60",
    ]
    text = "\n".join(rows) + "\n"
    _both(reference_outputs, tmp_path, text)
    # Python engines parse through the same wrap
    from alignasm_tpu.io.paf import read_paf

    p = tmp_path / "q.paf"
    p.write_text(text)
    ds = read_paf(p)
    assert [r.map_qul for r in ds.contigs[0]] == [0, 300 & 0xFF]


def test_alt_group_all_zero_ratio_raises(tmp_path):
    # degenerate alt group (every aln_len == 0): the reference would
    # append a garbage default-constructed record; we raise instead
    # (documented deviation, COMPONENTS.md)
    main_rows = [
        "cA\t1000\t0\t200\t+\tchrA\t900\t0\t200\t200\t200\t60\tcs:Z::200",
        "cA\t1000\t300\t500\t+\tchrA\t900\t300\t500\t200\t200\t60\tcs:Z::200",
    ]
    alt_rows = [
        "cA:201-600\t400\t0\t1\t+\tchrB\t700\t0\t1\t1\t0\t60\tcs:Z::1",
    ]
    paf = tmp_path / "m.paf"
    paf.write_text("\n".join(main_rows) + "\n")
    alt = tmp_path / "a.paf"
    alt.write_text("\n".join(alt_rows) + "\n")

    from alignasm_tpu.io.paf import PafParseError, merge_alt_paf, read_paf

    ds = read_paf(paf)
    with pytest.raises(PafParseError):
        merge_alt_paf(ds, alt, 0.5)
    with pytest.raises(native.NativeError):
        native.run(str(paf), alt_path=str(alt))


def test_long_cs_string(reference_outputs, tmp_path):
    import random

    rng = random.Random(0)
    ops = []
    q = r = 0
    for _ in range(2000):
        n = rng.randrange(1, 30)
        ops.append(f":{n}")
        q += n
        r += n
        k = rng.random()
        if k < 0.3:
            ops.append("*ac"); q += 1; r += 1
        elif k < 0.5:
            ops.append("+ggt"); q += 3
        elif k < 0.7:
            ops.append("-tt"); r += 2
    ops.append(":5"); q += 5; r += 5
    cs = "cs:Z:" + "".join(ops)
    mat = sum(int(t[1:]) for t in ops if t.startswith(":"))
    aln = mat + sum(1 for t in ops if t.startswith("*")) \
        + sum(len(t) - 1 for t in ops if t[0] in "+-")
    rows = [
        f"c1\t{q+200}\t0\t{q}\t+\tchrA\t{r+100}\t0\t{r}\t{mat}\t{aln}\t60\t{cs}",
        f"c1\t{q+200}\t{q+10}\t{q+110}\t+\tchrA\t{r+100}\t{r-100}\t{r}\t100\t100\t60\tcs:Z::100",
    ]
    _both(reference_outputs, tmp_path, "\n".join(rows) + "\n")


def test_cli_progress_and_profile_flags(tmp_path, oracle_bin):
    """--progress (serial exact-path bar + device stats line) and
    --profile DIR (jax.profiler trace written) work end to end with
    byte-identical outputs."""
    import pathlib
    import subprocess
    import sys

    from alignasm_tpu.testing.synth import generate_paf
    from tests.conftest import run_oracle

    p = tmp_path / "flags.paf"
    p.write_text(generate_paf(n_contigs=6, seed=9))
    oracle_outs = run_oracle(oracle_bin, p, tmp_path)

    eng = tmp_path / "flg.paf"
    eng.write_bytes(p.read_bytes())
    prof_dir = tmp_path / "trace"
    proc = subprocess.run(
        [sys.executable, "-m", "alignasm_tpu.cli", str(eng),
         "--engine", "exact", "--progress", "--profile", str(prof_dir)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert prof_dir.exists() and any(prof_dir.rglob("*")), \
        "profiler trace dir empty"
    for o, suffix in zip(oracle_outs, ("", ".alt", ".all")):
        got = pathlib.Path(str(eng)[:-4] + f".aln{suffix}.paf")
        assert o.read_bytes() == got.read_bytes(), f"aln{suffix}"
