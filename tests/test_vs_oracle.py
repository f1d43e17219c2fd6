"""Golden-output tests: the engine must match the C++ reference
byte-for-byte on all three output PAFs (SURVEY.md §4 test strategy).
The native and tpu engines compare against ``reference_outputs`` (the
oracle where its sources exist, else the exact engine); the exact
engine's own cases need the oracle and skip without it."""

import pathlib
import subprocess
import sys

import pytest

from alignasm_tpu.testing.synth import (
    generate_alt_paf, generate_boundary_paf, generate_hard_paf, generate_paf,
)
from tests.conftest import run_oracle


def _run_engine(paf: pathlib.Path, workdir: pathlib.Path, extra=()):
    local = workdir / ("eng_" + paf.name)
    local.write_bytes(paf.read_bytes())
    subprocess.run(
        [sys.executable, "-m", "alignasm_tpu.cli", str(local), *extra],
        check=True, capture_output=True,
    )
    stem = str(local)[: -len(".paf")]
    return (
        pathlib.Path(stem + ".aln.paf"),
        pathlib.Path(stem + ".aln.alt.paf"),
        pathlib.Path(stem + ".aln.all.paf"),
    )


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


@pytest.mark.parametrize("seed", [7, 11, 23])
def test_byte_identical_basic(reference_outputs, tmp_path, seed):
    paf = tmp_path / f"basic{seed}.paf"
    paf.write_text(generate_paf(n_contigs=25, seed=seed))
    _assert_identical(
        reference_outputs(paf, tmp_path), _run_engine(paf, tmp_path)
    )


@pytest.mark.parametrize("seed", [11, 42])
def test_byte_identical_hard(reference_outputs, tmp_path, seed):
    """Exercises alt-path slope scan and coverage ties."""
    paf = tmp_path / f"hard{seed}.paf"
    paf.write_text(generate_hard_paf(n_contigs=25, seed=seed))
    gold = reference_outputs(paf, tmp_path)
    assert len(gold[1]) > 0, "hard data must produce alt output"
    _assert_identical(gold, _run_engine(paf, tmp_path))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("engine", ["native", "exact"])
def test_byte_identical_boundary(request, tmp_path, engine, seed):
    """Degenerate coordinate motifs (singletons, duplicates, 1-base gaps,
    containment, mapq uint8 wrap, SV_BASELINE straddles, strand flips)."""
    paf = tmp_path / f"boundary{seed}.paf"
    paf.write_text(generate_boundary_paf(n_contigs=12, seed=seed))
    if engine == "exact":  # the exact engine's reference is the oracle
        gold = run_oracle(request.getfixturevalue("oracle_bin"), paf,
                          tmp_path)
    else:
        gold = request.getfixturevalue("reference_outputs")(paf, tmp_path)
    _assert_identical(
        gold,
        _run_engine(paf, tmp_path, extra=("--engine", engine)),
    )


def test_byte_identical_with_alt_merge(reference_outputs, tmp_path):
    main = generate_paf(n_contigs=20, seed=5)
    paf = tmp_path / "merged.paf"
    paf.write_text(main)
    alt = tmp_path / "alt_in.paf"
    alt.write_text(generate_alt_paf(main, seed=5))
    assert alt.stat().st_size > 0
    _assert_identical(
        reference_outputs(paf, tmp_path, extra=["-a", str(alt)]),
        _run_engine(paf, tmp_path, extra=["-a", str(alt)]),
    )


def test_byte_identical_non_skip_linkable(reference_outputs, tmp_path):
    paf = tmp_path / "nsl.paf"
    paf.write_text(generate_hard_paf(n_contigs=15, seed=3))
    _assert_identical(
        reference_outputs(paf, tmp_path, extra=["--non_skip_linkable"]),
        _run_engine(paf, tmp_path, extra=["--non_skip_linkable"]),
    )


@pytest.mark.parametrize(
    "kind,seed", [("basic", 31), ("hard", 8), ("boundary", 2)]
)
def test_byte_identical_tpu_engine_cli(reference_outputs, tmp_path, kind, seed):
    """The tpu engine CLI path (device kernels + native host plane +
    native writers) vs reference bytes ON DISK — incl. tie/alt-heavy data
    where every order-sensitive contig must route to the exact finish."""
    gen = {"basic": generate_paf, "hard": generate_hard_paf,
           "boundary": generate_boundary_paf}[kind]
    paf = tmp_path / f"tpu{kind}{seed}.paf"
    paf.write_text(gen(n_contigs=12, seed=seed))
    _assert_identical(
        reference_outputs(paf, tmp_path),
        _run_engine(paf, tmp_path, extra=["--engine", "tpu"]),
    )


def test_byte_identical_tpu_engine_with_alt_merge(reference_outputs, tmp_path):
    """The tpu engine with an alt-PAF merge vs reference bytes on disk."""
    main = generate_paf(n_contigs=12, seed=47)
    paf = tmp_path / "tpualt.paf"
    paf.write_text(main)
    alt = tmp_path / "tpualt_in.paf"
    alt.write_text(generate_alt_paf(main, seed=47))
    assert alt.stat().st_size > 0
    _assert_identical(
        reference_outputs(paf, tmp_path, extra=["-a", str(alt)]),
        _run_engine(paf, tmp_path, extra=["-a", str(alt), "--engine", "tpu"]),
    )


def test_custom_scoring_config_native_matches_exact(tmp_path):
    """Non-default scoring constants must produce identical outputs from
    the native and exact engines (the ABI threads every knob; the oracle
    can't check custom configs since the reference hard-compiles them)."""
    import dataclasses

    from alignasm_tpu import native
    from alignasm_tpu.config import DEFAULT_CONFIG
    from alignasm_tpu.engine.exact import solve_dataset
    from alignasm_tpu.io.paf import read_paf, write_outputs

    cfg = dataclasses.replace(
        DEFAULT_CONFIG, qry_weight=2, ref_negative_penalty=3,
        sv_inv_penalty=700, sv_trans_penalty=1500,
        sv_front_end_coefficient=3,
    )
    paf = tmp_path / "cust.paf"
    paf.write_text(generate_hard_paf(n_contigs=12, seed=29))
    native.run(str(paf), config=cfg)
    nat = [pathlib.Path(str(paf)[:-4] + f".aln{sfx}.paf").read_bytes()
           for sfx in ("", ".alt", ".all")]

    ds = read_paf(paf)
    outs, alt_outs, max_outs = solve_dataset(ds, cfg)
    stem = tmp_path / "cust_exact"
    for name, data, kw in [(".aln.paf", outs, {}), (".aln.alt.paf", alt_outs, {}),
                           (".aln.all.paf", max_outs, {"name_suffix_counts": True})]:
        with open(str(stem) + name, "w") as fh:
            write_outputs(ds, data, fh, **kw)
    exa = [pathlib.Path(str(stem) + f".aln{sfx}.paf").read_bytes()
           for sfx in ("", ".alt", ".all")]
    assert nat == exa


def test_parallel_engine_matches_serial(tmp_path):
    paf = tmp_path / "par.paf"
    paf.write_text(generate_hard_paf(n_contigs=20, seed=9))
    serial = _run_engine(paf, tmp_path)
    par_dir = tmp_path / "par2"
    par_dir.mkdir()
    parallel = _run_engine(paf, par_dir, extra=["-t", "4"])
    for s, p in zip(serial, parallel):
        assert s.read_bytes() == p.read_bytes()
