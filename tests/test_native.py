"""Native (C++) pipeline: byte-identity vs the reference (the C++ oracle
where its sources exist, else the exact engine: ``reference_outputs``)."""

import pathlib
import shutil

import pytest

from alignasm_tpu import native
from alignasm_tpu.testing.synth import generate_alt_paf, generate_hard_paf, generate_paf


def _outs(stem: str):
    return [pathlib.Path(f"{stem}.aln{s}.paf") for s in ("", ".alt", ".all")]


def _assert_match(gold, stem):
    for g, n in zip(gold, _outs(stem)):
        assert g == n.read_bytes(), f"{n.name} differs from the reference"


@pytest.mark.parametrize("kind,seed,lazy", [
    ("basic", 2, True), ("hard", 4, True), ("hard", 4, False), ("hard", 7, True),
])
def test_native_byte_identical(reference_outputs, tmp_path, kind, seed, lazy):
    gen = generate_paf if kind == "basic" else generate_hard_paf
    paf = tmp_path / "t.paf"
    paf.write_text(gen(n_contigs=20, seed=seed))
    oracle_outs = reference_outputs(paf, tmp_path)
    nat = tmp_path / "n.paf"
    nat.write_bytes(paf.read_bytes())
    native.run(str(nat), threads=4, lazy_walks=lazy)
    _assert_match(oracle_outs, str(nat)[:-4])


def test_native_alt_merge(reference_outputs, tmp_path):
    main = generate_paf(n_contigs=15, seed=8)
    paf = tmp_path / "m.paf"
    paf.write_text(main)
    alt = tmp_path / "alt.paf"
    alt.write_text(generate_alt_paf(main, seed=8))
    oracle_outs = reference_outputs(paf, tmp_path, extra=["-a", str(alt)])
    nat = tmp_path / "nm.paf"
    nat.write_bytes(paf.read_bytes())
    native.run(str(nat), alt_path=str(alt), threads=2)
    _assert_match(oracle_outs, str(nat)[:-4])


def test_native_non_skip_linkable(reference_outputs, tmp_path):
    paf = tmp_path / "nsl.paf"
    paf.write_text(generate_hard_paf(n_contigs=12, seed=6))
    oracle_outs = reference_outputs(paf, tmp_path, extra=["--non_skip_linkable"])
    nat = tmp_path / "nn.paf"
    nat.write_bytes(paf.read_bytes())
    native.run(str(nat), non_skip_linkable=True)
    _assert_match(oracle_outs, str(nat)[:-4])


def test_native_error_surface(tmp_path):
    bad = tmp_path / "bad.paf"
    bad.write_text("ctg\t100\t0\t10\t+\tchr1\t100\t0\t10\t10\t10\t60\n")  # no cs
    with pytest.raises(native.NativeError, match="cs:Z"):
        native.run(str(bad))


def test_native_short_row_is_clean_error(tmp_path):
    # a tab-separated row with 6-11 fields must raise, not index OOB
    bad = tmp_path / "short.paf"
    bad.write_text("ctg\t100\t0\t10\t+\tchr1\t100\t0\n")
    with pytest.raises(native.NativeError, match="short PAF row"):
        native.run(str(bad))


def test_native_custom_scoring_matches_exact(tmp_path):
    """Non-default scoring constants must flow through the C ABI and
    produce the same outputs as the Python engine."""
    import dataclasses
    import io

    from alignasm_tpu.config import DEFAULT_CONFIG
    from alignasm_tpu.engine.exact import solve_dataset
    from alignasm_tpu.io.paf import read_paf, write_outputs

    cfg = dataclasses.replace(
        DEFAULT_CONFIG, sv_inv_penalty=9999, sv_trans_penalty=12345,
        ref_negative_penalty=3,
    )
    paf = tmp_path / "c.paf"
    paf.write_text(generate_hard_paf(n_contigs=10, seed=14))
    native.run(str(paf), config=cfg)
    ds = read_paf(paf)
    o, a, m = solve_dataset(ds, cfg)
    for rows, suffix, maxmode in [(o, "", False), (a, ".alt", False), (m, ".all", True)]:
        buf = io.StringIO()
        write_outputs(ds, rows, buf, name_suffix_counts=maxmode)
        got = pathlib.Path(str(paf)[:-4] + f".aln{suffix}.paf").read_text()
        assert buf.getvalue() == got, f"aln{suffix}"


def test_parallel_writer_branches_byte_identical(tmp_path, reference_outputs):
    """The threaded writer paths (write_rows / write_max_rows switch to
    per-contig parallel formatting at >= 64 contigs) must serialize
    byte-identically to the reference — every other byte test in CI
    uses < 64 contigs and only exercises the serial branch.  The hard
    generator populates .aln.all.paf groups, covering the .N-suffix
    parallel path too."""
    paf = tmp_path / "wide.paf"
    paf.write_text(generate_hard_paf(n_contigs=100, seed=17))
    oracle_outs = reference_outputs(paf, tmp_path)

    eng = tmp_path / "eng.paf"
    eng.write_bytes(paf.read_bytes())
    native.run(str(eng), threads=4)
    _assert_match(oracle_outs, str(eng)[:-4])
