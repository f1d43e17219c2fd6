"""SINGLE_PIECE / NO_UPDATE upgrade modes vs a reference build with
UPGRADE_MODE flipped (tests/oracle/Makefile `single` / `noupdate`
targets) — byte-for-byte on all three outputs.  Where the C++ sources
are absent, the native and tpu engines are checked against the exact
engine in the same mode, and the exact engine's own cases skip."""

import pathlib
import subprocess
import sys

import pytest

from alignasm_tpu.testing.synth import generate_hard_paf, generate_paf

ORACLE_DIR = pathlib.Path(__file__).resolve().parent / "oracle"
SP_BIN = ORACLE_DIR / "bin" / "alignasm_ref_sp"


def _build(binary, target):
    from tests.reference import reference_src

    if not binary.exists():
        if not reference_src().is_dir():
            pytest.skip(f"C++ reference sources not present at "
                        f"{reference_src()} (tests/oracle/Makefile REF)")
        subprocess.run(["make", "-C", str(ORACLE_DIR), target],
                       check=True, capture_output=True)
    return binary


@pytest.fixture(scope="module")
def sp_oracle():
    return _build(SP_BIN, "single")


def _gold(request, paf, tmp_path, engine, mode):
    """The golden outputs of ``paf`` in upgrade ``mode``: the flipped
    oracle build, or the exact engine when the engine under test is not
    the exact engine itself."""
    from tests.reference import oracle_available

    if engine == "exact" or oracle_available():
        request.getfixturevalue("sp_oracle" if mode == "single_piece"
                                else "nu_oracle")
        binary = SP_BIN if mode == "single_piece" else NU_BIN
        subprocess.run([str(binary), str(paf)], check=True,
                       capture_output=True)
        stem = str(paf)[: -len(".paf")]
        return [pathlib.Path(stem + f".aln{sfx}.paf").read_bytes()
                for sfx in ("", ".alt", ".all")]
    return request.getfixturevalue("reference_outputs")(
        paf, tmp_path, extra=("--upgrade_mode", mode))


def _run_sp_oracle(paf: pathlib.Path):
    subprocess.run([str(SP_BIN), str(paf)], check=True, capture_output=True)
    stem = str(paf)[: -len(".paf")]
    return [pathlib.Path(stem + f".aln{sfx}.paf")
            for sfx in ("", ".alt", ".all")]


def _run_engine_sp(paf: pathlib.Path, workdir: pathlib.Path, engine="exact"):
    local = workdir / ("eng_" + paf.name)
    local.write_bytes(paf.read_bytes())
    subprocess.run(
        [sys.executable, "-m", "alignasm_tpu.cli", str(local),
         "--engine", engine, "--upgrade_mode", "single_piece"],
        check=True, capture_output=True,
    )
    stem = str(local)[: -len(".paf")]
    return [pathlib.Path(stem + f".aln{sfx}.paf")
            for sfx in ("", ".alt", ".all")]


def _assert_identical(oracle_outs, engine_outs):
    for o, e in zip(oracle_outs, engine_outs):
        ob = o if isinstance(o, bytes) else o.read_bytes()
        eb = e.read_bytes()
        if ob != eb:
            for ln, (lo, le) in enumerate(
                zip(ob.decode().splitlines(), eb.decode().splitlines())
            ):
                assert lo == le, f"{e.name} line {ln}:\n reference: {lo}\n engine: {le}"
            assert len(ob) == len(eb), f"{e.name}: length differs"


@pytest.mark.parametrize("engine,kind,seed", [
    ("exact", "basic", 7), ("exact", "basic", 11), ("exact", "basic", 23),
    ("exact", "hard", 11), ("exact", "hard", 42), ("exact", "hard", 3),
    ("native", "basic", 7), ("native", "hard", 11), ("native", "hard", 42),
    ("tpu", "basic", 7), ("tpu", "hard", 11),
])
def test_single_piece_byte_identical(request, tmp_path, engine, kind, seed):
    gen = generate_paf if kind == "basic" else generate_hard_paf
    paf = tmp_path / f"sp_{kind}{seed}.paf"
    paf.write_text(gen(n_contigs=20, seed=seed))
    _assert_identical(_gold(request, paf, tmp_path, engine, "single_piece"),
                      _run_engine_sp(paf, tmp_path, engine=engine))


def test_single_piece_actually_changes_outputs(sp_oracle, oracle_bin, tmp_path):
    """Sanity: the mode is not a no-op — on at least one corpus the
    SINGLE_PIECE outputs differ from ALT_PATH's."""
    from tests.conftest import run_oracle

    for seed in range(12):
        paf = tmp_path / f"chg{seed}.paf"
        paf.write_text(generate_paf(n_contigs=20, seed=seed))
        alt_outs = run_oracle(oracle_bin, paf, tmp_path)
        sp_dir = tmp_path / f"sp{seed}"
        sp_dir.mkdir()
        sp_paf = sp_dir / paf.name
        sp_paf.write_bytes(paf.read_bytes())
        sp_outs = _run_sp_oracle(sp_paf)
        if any(a.read_bytes() != s.read_bytes()
               for a, s in zip(alt_outs, sp_outs)):
            return
    pytest.fail("SINGLE_PIECE never diverged from ALT_PATH on 12 corpora")


def test_single_piece_with_alt_merge_and_flags(sp_oracle, tmp_path):
    """single_piece combined with -a alt merge and --non_skip_linkable,
    byte-for-byte vs the SP oracle."""
    from alignasm_tpu.testing.synth import generate_alt_paf

    main = generate_paf(n_contigs=15, seed=9)
    paf = tmp_path / "spalt.paf"
    paf.write_text(main)
    alt = tmp_path / "spalt_in.paf"
    alt.write_text(generate_alt_paf(main, seed=9))
    assert alt.stat().st_size > 0
    subprocess.run([str(SP_BIN), str(paf), "-a", str(alt),
                    "--non_skip_linkable"], check=True, capture_output=True)
    stem = str(paf)[: -len(".paf")]
    oracle_outs = [pathlib.Path(stem + f".aln{sfx}.paf")
                   for sfx in ("", ".alt", ".all")]
    eng = tmp_path / "eng_spalt.paf"
    eng.write_bytes(paf.read_bytes())
    subprocess.run(
        [sys.executable, "-m", "alignasm_tpu.cli", str(eng),
         "-a", str(alt), "--non_skip_linkable",
         "--engine", "exact", "--upgrade_mode", "single_piece"],
        check=True, capture_output=True,
    )
    estem = str(eng)[: -len(".paf")]
    _assert_identical(oracle_outs,
                      [pathlib.Path(estem + f".aln{sfx}.paf")
                       for sfx in ("", ".alt", ".all")])


NU_BIN = ORACLE_DIR / "bin" / "alignasm_ref_nu"


@pytest.fixture(scope="module")
def nu_oracle():
    return _build(NU_BIN, "noupdate")


@pytest.mark.parametrize("engine,seed", [
    ("exact", 5), ("native", 13), ("tpu", 5),
])
def test_no_update_byte_identical(request, tmp_path, engine, seed):
    """no_update vs a reference build with UPGRADE_MODE == NO_UPDATE."""
    paf = tmp_path / f"nu{seed}.paf"
    paf.write_text(generate_hard_paf(n_contigs=15, seed=seed))
    oracle_outs = _gold(request, paf, tmp_path, engine, "no_update")
    eng = tmp_path / f"eng_nu{seed}.paf"
    eng.write_bytes(paf.read_bytes())
    subprocess.run(
        [sys.executable, "-m", "alignasm_tpu.cli", str(eng),
         "--engine", engine, "--upgrade_mode", "no_update"],
        check=True, capture_output=True,
    )
    estem = str(eng)[: -len(".paf")]
    _assert_identical(oracle_outs,
                      [pathlib.Path(estem + f".aln{sfx}.paf")
                       for sfx in ("", ".alt", ".all")])
