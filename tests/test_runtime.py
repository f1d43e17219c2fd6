"""Runtime subsystems: resume journal, multihost sharding, config."""

import dataclasses
import pathlib

import pytest

from alignasm_tpu.config import DEFAULT_CONFIG
from alignasm_tpu.engine.exact import solve_dataset
from alignasm_tpu.io.paf import read_paf
from alignasm_tpu.parallel.multihost import run_multihost, shard_indices
from alignasm_tpu.runtime.checkpoint import solve_dataset_resumable
from alignasm_tpu.testing.synth import generate_hard_paf


def _dataset(tmp_path, seed=3, n=8):
    p = tmp_path / "r.paf"
    p.write_text(generate_hard_paf(n_contigs=n, seed=seed))
    return p


def test_resume_journal(tmp_path):
    p = _dataset(tmp_path)
    journal = tmp_path / "journal.bin"

    ds = read_paf(p)
    o1, a1, m1, stats1 = solve_dataset_resumable(ds, DEFAULT_CONFIG, str(journal))
    assert stats1 == {"resumed": 0, "solved": len(ds.contigs)}

    # second run: everything resumes, nothing re-solves
    ds2 = read_paf(p)
    o2, a2, m2, stats2 = solve_dataset_resumable(ds2, DEFAULT_CONFIG, str(journal))
    assert stats2 == {"resumed": len(ds.contigs), "solved": 0}
    assert (o1, a1, m1) == (o2, a2, m2)

    # matches the non-resumable engine
    ds3 = read_paf(p)
    assert solve_dataset(ds3, DEFAULT_CONFIG) == (o1, a1, m1)


def test_resume_journal_survives_truncation(tmp_path):
    p = _dataset(tmp_path)
    journal = tmp_path / "journal.bin"
    ds = read_paf(p)
    solve_dataset_resumable(ds, DEFAULT_CONFIG, str(journal))
    # simulate a crash mid-write: chop bytes off the tail
    raw = journal.read_bytes()
    journal.write_bytes(raw[: len(raw) - 7])
    ds2 = read_paf(p)
    o, a, m, stats = solve_dataset_resumable(ds2, DEFAULT_CONFIG, str(journal))
    assert stats["solved"] >= 1  # the truncated record re-solves
    assert solve_dataset(read_paf(p), DEFAULT_CONFIG) == (o, a, m)


def test_resume_journal_truncates_corrupt_tail_before_append(tmp_path):
    """Entries appended AFTER a crash-corrupted record must be readable
    on the next load: the journal cuts back to the last whole record
    before appending (code-review finding: without the truncate, run 2's
    entries land after the garbage and run 3 can never see them)."""
    p = _dataset(tmp_path)
    journal = tmp_path / "journal.bin"
    ds = read_paf(p)
    solve_dataset_resumable(ds, DEFAULT_CONFIG, str(journal))
    raw = journal.read_bytes()
    journal.write_bytes(raw[: len(raw) - 7])  # run 1 "crashed" mid-dump

    # run 2: re-solves the chopped contig and appends it
    solve_dataset_resumable(read_paf(p), DEFAULT_CONFIG, str(journal))
    # run 3: EVERY contig must now resume from the journal
    o, a, m, stats = solve_dataset_resumable(
        read_paf(p), DEFAULT_CONFIG, str(journal))
    assert stats["solved"] == 0, stats
    assert stats["resumed"] == len(read_paf(p).contigs)
    assert solve_dataset(read_paf(p), DEFAULT_CONFIG) == (o, a, m)


def test_resume_journal_keyed_by_config(tmp_path):
    # a journal written under one config must NOT satisfy a run under a
    # different config (scoring/flags change the graph and the outputs)
    p = _dataset(tmp_path)
    journal = tmp_path / "journal.bin"
    ds = read_paf(p)
    solve_dataset_resumable(ds, DEFAULT_CONFIG, str(journal))

    cfg2 = dataclasses.replace(DEFAULT_CONFIG, non_skip_linkable=True)
    ds2 = read_paf(p)
    o, a, m, stats = solve_dataset_resumable(ds2, cfg2, str(journal))
    assert stats == {"resumed": 0, "solved": len(ds2.contigs)}
    assert solve_dataset(read_paf(p), cfg2) == (o, a, m)


def test_resume_journal_keyed_by_all_record_fields(tmp_path):
    # mutating a field outside the old digest (aln_len is written through
    # output columns) must invalidate the entry
    p = _dataset(tmp_path, n=2)
    journal = tmp_path / "journal.bin"
    ds = read_paf(p)
    solve_dataset_resumable(ds, DEFAULT_CONFIG, str(journal))

    ds2 = read_paf(p)
    ds2.contigs[0][0].aln_len += 1
    _o, _a, _m, stats = solve_dataset_resumable(ds2, DEFAULT_CONFIG, str(journal))
    assert stats["solved"] >= 1


@pytest.mark.parametrize("engine", ["native", "tpu"])
def test_resume_native_and_tpu_engines(tmp_path, reference_outputs, engine):
    """Resume must work for the production engines: a journal holding a
    PREFIX of the contigs (simulating a crash mid-run) must yield
    resumed > 0 plus byte-identical final outputs."""
    import subprocess
    import sys

    p = _dataset(tmp_path, seed=21, n=10)
    gold = reference_outputs(p, tmp_path)

    # phase 1: journal only the first half (the "crashed" run)
    from alignasm_tpu.runtime.checkpoint import Journal, contig_digest

    ds = read_paf(p)
    half = tmp_path / "half.paf"
    journal = tmp_path / "j.bin"
    from alignasm_tpu.engine.exact import solve_contig

    j = Journal(str(journal))
    for contig in ds.contigs[:5]:
        j.put(contig_digest(contig, DEFAULT_CONFIG),
              solve_contig(contig, DEFAULT_CONFIG))
    j.close()

    # phase 2: full run resumes through the CLI with the real engine
    eng = tmp_path / "eng.paf"
    eng.write_bytes(p.read_bytes())
    proc = subprocess.run(
        [sys.executable, "-m", "alignasm_tpu.cli", str(eng),
         "--engine", engine, "--resume", str(journal)],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "'resumed': 5" in proc.stdout, proc.stdout
    if engine == "tpu":
        # tpu resume must run on the PRODUCTION (native) host plane,
        # not the far slower Python plane
        assert "'host_plane': 'native'" in proc.stdout, proc.stdout
    for g, suffix in zip(gold, ("", ".alt", ".all")):
        got = pathlib.Path(str(eng)[:-4] + f".aln{suffix}.paf")
        assert g == got.read_bytes(), f"aln{suffix}"


def test_resume_survives_kill9(tmp_path):
    """kill -9 mid-run, rerun with the same journal: outputs equal a
    clean run and at least one contig resumes from the journal."""
    import signal
    import subprocess
    import sys
    import time as _time

    p = tmp_path / "k.paf"
    from alignasm_tpu.testing.synth import generate_paf

    p.write_text(generate_paf(n_contigs=300, seed=13))
    journal = tmp_path / "jk.bin"
    cmd = [sys.executable, "-m", "alignasm_tpu.cli", str(p),
           "--engine", "exact", "--resume", str(journal)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    # let it journal some contigs, then kill hard
    deadline = _time.time() + 30
    while _time.time() < deadline:
        if journal.exists() and journal.stat().st_size > 0:
            break
        if proc.poll() is not None:
            break
        _time.sleep(0.02)
    if proc.poll() is None:
        proc.send_signal(signal.SIGKILL)
        proc.wait()

    out = subprocess.run(cmd, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]
    if proc.returncode not in (0,):  # it was actually killed mid-run
        assert "'resumed': " in out.stdout

    # equality with a clean non-resumable run
    clean = tmp_path / "clean.paf"
    clean.write_bytes(p.read_bytes())
    subprocess.run([sys.executable, "-m", "alignasm_tpu.cli", str(clean),
                    "--engine", "exact"], check=True, capture_output=True)
    for suffix in ("", ".alt", ".all"):
        a = pathlib.Path(str(p)[:-4] + f".aln{suffix}.paf").read_bytes()
        b = pathlib.Path(str(clean)[:-4] + f".aln{suffix}.paf").read_bytes()
        assert a == b, f"aln{suffix}"


def test_shard_indices_cover_and_partition():
    n, world = 23, 4
    seen = []
    for r in range(world):
        seen += shard_indices(n, r, world)
    assert sorted(seen) == list(range(n))


def test_multihost_single_process_matches_cli(tmp_path, reference_outputs):
    p = _dataset(tmp_path, seed=9, n=6)
    gold = reference_outputs(p, tmp_path)
    mh = tmp_path / "mh.paf"
    mh.write_bytes(p.read_bytes())
    run_multihost(str(mh))
    for g, suffix in zip(gold, ("", ".alt", ".all")):
        got = pathlib.Path(str(mh)[:-4] + f".aln{suffix}.paf")
        assert g == got.read_bytes()


def test_config_reference_defaults():
    c = DEFAULT_CONFIG
    assert (c.qry_weight, c.ref_weight, c.ref_negative_penalty) == (1, 1, 2)
    assert (c.sv_baseline, c.sv_trans_penalty, c.sv_inv_penalty) == (10**6, 2000, 500)
    assert (c.sv_front_end_coefficient, c.max_path_count, c.max_anom) == (2, 10**4, 1)
    assert c.alt_baseline == 0.5 and c.non_skip_linkable is False
    # frozen: configs are immutable values
    try:
        c.qry_weight = 2
        assert False
    except dataclasses.FrozenInstanceError:
        pass


def test_multihost_two_processes_no_coordinator(tmp_path, reference_outputs):
    """Coordinator-less launch (file-based barrier only): rank/world come
    from the flags, outputs byte-identical to the reference."""
    import os
    import subprocess
    import sys

    p = _dataset(tmp_path, seed=17, n=8)
    gold = reference_outputs(p, tmp_path)
    mh = tmp_path / "mhnc.paf"
    mh.write_bytes(p.read_bytes())
    env = dict(os.environ)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "alignasm_tpu.parallel.multihost", str(mh),
             "--num-processes", "2", "--process-id", str(rank)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for rank in range(2)
    ]
    for proc in procs:
        out, _ = proc.communicate(timeout=180)
        assert proc.returncode == 0, out.decode()[-2000:]
    for g, suffix in zip(gold, ("", ".alt", ".all")):
        got = pathlib.Path(str(mh)[:-4] + f".aln{suffix}.paf")
        assert g == got.read_bytes(), f"aln{suffix}"


def test_multihost_local_procs_launcher(tmp_path, reference_outputs):
    """--local-procs W: the single-host launcher spawns all W ranks
    itself; outputs byte-identical."""
    import subprocess
    import sys

    p = _dataset(tmp_path, seed=23, n=7)
    gold = reference_outputs(p, tmp_path)
    mh = tmp_path / "mhlp.paf"
    mh.write_bytes(p.read_bytes())
    proc = subprocess.run(
        [sys.executable, "-m", "alignasm_tpu.parallel.multihost", str(mh),
         "--local-procs", "2"],
        capture_output=True, timeout=180)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    for g, suffix in zip(gold, ("", ".alt", ".all")):
        got = pathlib.Path(str(mh)[:-4] + f".aln{suffix}.paf")
        assert g == got.read_bytes(), f"aln{suffix}"


def test_multihost_sharded_alt_merge(tmp_path, reference_outputs):
    """3-rank shard run WITH an alt file: the sharded alt merge (group
    transitions tracked for every line, records parsed only for local
    target contigs, global alt row provenance) must stay byte-identical
    to the reference."""
    import os
    import subprocess
    import sys

    from alignasm_tpu.testing.synth import generate_alt_paf
    p = _dataset(tmp_path, seed=31, n=9)
    alt = tmp_path / "ralt.paf"
    alt.write_text(generate_alt_paf(p.read_text(), seed=5))
    gold = reference_outputs(p, tmp_path, extra=("-a", str(alt)))
    mh = tmp_path / "mha.paf"
    mh.write_bytes(p.read_bytes())
    env = dict(os.environ)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "alignasm_tpu.parallel.multihost", str(mh),
             "--num-processes", "3", "--process-id", str(rank),
             "-a", str(alt)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for rank in range(3)
    ]
    for proc in procs:
        out, _ = proc.communicate(timeout=180)
        assert proc.returncode == 0, out.decode()[-2000:]
    for g, suffix in zip(gold, ("", ".alt", ".all")):
        got = pathlib.Path(str(mh)[:-4] + f".aln{suffix}.paf")
        assert g == got.read_bytes(), f"aln{suffix}"


def test_multihost_two_processes(tmp_path, reference_outputs):
    """2 rank processes with threaded ranks (-t 2), started in reverse
    order: range-sharded contigs, rank-0 ordered merge — byte-identical
    to the reference."""
    import os
    import subprocess
    import sys

    p = _dataset(tmp_path, seed=12, n=8)
    gold = reference_outputs(p, tmp_path)
    mh = tmp_path / "mh2p.paf"
    mh.write_bytes(p.read_bytes())

    env = dict(os.environ)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "alignasm_tpu.parallel.multihost", str(mh),
             "--num-processes", "2", "--process-id", str(rank), "-t", "2"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for rank in (1, 0)
    ]
    for proc in procs:
        out, _ = proc.communicate(timeout=180)
        assert proc.returncode == 0, out.decode()[-2000:]
    for g, suffix in zip(gold, ("", ".alt", ".all")):
        got = pathlib.Path(str(mh)[:-4] + f".aln{suffix}.paf")
        assert g == got.read_bytes(), f"aln{suffix}"


def test_multihost_rejects_stale_partial_from_other_config(tmp_path, monkeypatch):
    """A leftover rank-1 partial produced under DIFFERENT solver flags
    (here: a different alt_baseline reflected in its meta digest) must
    never be merged — rank 0 keeps polling and times out instead of
    silently mixing configs (code-review finding, round 2)."""
    import numpy as np

    p = _dataset(tmp_path, seed=21, n=4)
    mh = tmp_path / "stale.paf"
    mh.write_bytes(p.read_bytes())

    # plant a rank-1 partial with a bogus digest (as if from another run)
    stem = str(mh)[: -len(".paf")]
    empty = np.empty((0, 6), np.int64)
    np.savez(f"{stem}.part1.npz.tmp.npz",
             counts=np.zeros((4, 3), np.int64), gsizes=empty[:, 0],
             main=empty, alt=empty, max=empty,
             meta=np.asarray([12345, 2, 1, 4], np.int64))
    import os
    os.replace(f"{stem}.part1.npz.tmp.npz", f"{stem}.part1.npz")

    monkeypatch.setenv("ALIGNASM_MERGE_TIMEOUT_S", "2")
    import pytest as _pytest
    with _pytest.raises(TimeoutError):
        run_multihost(str(mh), num_processes=2, process_id=0)


def test_multihost_upgrade_mode_single_piece(tmp_path, reference_outputs):
    """2-rank shard run with --upgrade_mode single_piece must match the
    reference in that mode (the constant-flipped oracle build, or the
    exact engine) byte-for-byte."""
    import os
    import subprocess
    import sys

    p = _dataset(tmp_path, seed=41, n=8)
    gold = reference_outputs(p, tmp_path,
                             extra=("--upgrade_mode", "single_piece"))
    mh = tmp_path / "mhsp.paf"
    mh.write_bytes(p.read_bytes())
    env = dict(os.environ)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "alignasm_tpu.parallel.multihost", str(mh),
             "--num-processes", "2", "--process-id", str(rank),
             "--upgrade_mode", "single_piece"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for rank in range(2)
    ]
    for proc in procs:
        out, _ = proc.communicate(timeout=180)
        assert proc.returncode == 0, out.decode()[-2000:]
    for g, suffix in zip(gold, ("", ".alt", ".all")):
        got = pathlib.Path(str(mh)[:-4] + f".aln{suffix}.paf")
        assert g == got.read_bytes(), f"aln{suffix}"


def test_drain_teardowns_joins_background_frees(tmp_path):
    """run() and GraphExporter.close() push their bulk frees onto
    registered background threads; drain_teardowns() must join every
    pending one and be idempotent on an empty registry (bench loops
    call it between reps so free() churn can't cross rep boundaries)."""
    from alignasm_tpu import native

    p = _dataset(tmp_path, seed=9, n=6)
    native.run(str(p), threads=2, out_prefix=str(tmp_path / "dt"))
    e = native.GraphExporter(str(p))
    assert len(e) > 0
    e.close()
    native.drain_teardowns()   # joins both pending teardowns
    native.drain_teardowns()   # idempotent on empty registry


def test_multihost_range_sharding_byte_identity(tmp_path, reference_outputs):
    """The byte-range sharded parse (contiguous record-balanced ranges,
    local chr interning, global cord_row via prefix line counts) must
    be byte-identical to the reference at several world sizes — including
    worlds larger than the contig count would balance evenly.  Ranks
    run in-process, rank 0 last (it appends shards as they land)."""
    import pathlib

    from alignasm_tpu.testing.synth import generate_hard_paf
    p = tmp_path / "w.paf"
    p.write_text(generate_hard_paf(n_contigs=23, seed=17))
    gold = reference_outputs(p, tmp_path)

    for world in (2, 3, 5):
        mh = tmp_path / f"mh{world}.paf"
        mh.write_bytes(p.read_bytes())
        for rank in range(world - 1, -1, -1):  # rank 0 last
            run_multihost(str(mh), num_processes=world, process_id=rank,
                          threads=2)
        for g, suffix in zip(gold, ("", ".alt", ".all")):
            got = pathlib.Path(str(mh)[:-4] + f".aln{suffix}.paf")
            assert g == got.read_bytes(), f"world={world} aln{suffix}"
        assert not list(tmp_path.glob(f"mh{world}.shard*.bin"))


def test_devbench_deep_merge():
    """The streaming bench harvest (bench.py merges devbench's
    per-section JSON lines) rests on this helper: nested dicts merge,
    scalars overwrite, unrelated keys survive."""
    from alignasm_tpu.runtime.devbench import _deep_merge

    d = {"kernels": {"topo": {"a": 1}}, "x": 1}
    _deep_merge(d, {"kernels": {"bigv": {"b": 2}}, "y": 3})
    _deep_merge(d, {"kernels": {"topo": {"a": 9, "c": 4}}, "x": 2})
    assert d == {"kernels": {"topo": {"a": 9, "c": 4}, "bigv": {"b": 2}},
                 "x": 2, "y": 3}


def test_devbench_peak_table_rejects_unknown_device():
    """Roofline shares divide by the published peaks of the card the
    run is on: a device without a row (here the CPU) is an error, never
    a default."""
    from alignasm_tpu.runtime.devbench import device_peaks

    h100 = device_peaks("NVIDIA H100 80GB HBM3")
    assert h100["hbm_bytes_per_s"] == 3.35e12
    assert h100["bf16_flops_per_s"] == 989e12
    assert h100["int8_ops_per_s"] == 1979e12
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks("NVIDIA A100-SXM4-80GB")
    with pytest.raises(KeyError, match="'cpu'"):
        device_peaks()  # the running device


def test_devbench_failed_section_fails_the_run(monkeypatch, capsys):
    """A failed section is recorded in the streamed output AND makes
    the process exit non-zero; the other sections still run."""
    import json
    import sys

    from alignasm_tpu.runtime import devbench

    def boom(*a, **k):
        raise RuntimeError("section exploded")

    monkeypatch.setattr(devbench, "bench_end_to_end", boom)
    monkeypatch.setattr(devbench, "bench_kernels", lambda: {"topo": {}})
    monkeypatch.setattr(devbench, "bench_bigv", lambda: {"V": 8})
    monkeypatch.setattr(sys, "argv", ["devbench", "10"])
    with pytest.raises(SystemExit) as exc:
        devbench.main()
    assert exc.value.code not in (0, None)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "section exploded" in last["end_to_end_error"]
    assert last["kernels"] == {"topo": {}, "bigv": {"V": 8}}
    assert last["device"]["platform"] == "cpu"


def test_ensure_jax_compile_cache_respects_env(monkeypatch, tmp_path):
    """Engine-level compile cache (round-5): a pre-set env dir wins,
    and an already-imported jax picks it up via config.update."""
    from alignasm_tpu.runtime import ensure_jax_compile_cache

    target = str(tmp_path / "jcache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
    assert ensure_jax_compile_cache() == target
    import jax

    assert jax.config.jax_compilation_cache_dir == target


def test_multihost_split_weight_mismatch_rejected(tmp_path):
    """A cross-rank ALN_SHARD_R0W mismatch changes group ownership;
    the digest must REJECT the mismatched shard (rank 0 times out with
    no output published) instead of silently merging mis-split groups."""
    import os
    import subprocess
    import sys

    p = _dataset(tmp_path, seed=41, n=8)
    mh = tmp_path / "mhw.paf"
    mh.write_bytes(p.read_bytes())
    procs = []
    for rank, w in ((0, "0.95"), (1, "0.5")):
        env = dict(os.environ)
        env["ALN_SHARD_R0W"] = w
        env["ALIGNASM_MERGE_TIMEOUT_S"] = "2"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "alignasm_tpu.parallel.multihost",
             str(mh), "--num-processes", "2", "--process-id", str(rank)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = [pr.communicate(timeout=120)[0] for pr in procs]
    assert procs[0].returncode != 0, outs[0].decode()[-500:]
    assert b"never appeared/matched" in outs[0]
    assert procs[1].returncode == 0, outs[1].decode()[-500:]
    # the failed merge must leave no output files behind
    for suffix in ("", ".alt", ".all"):
        assert not (tmp_path / f"mhw.aln{suffix}.paf").exists(), suffix


def test_effective_r0w_matches_native_clamp(monkeypatch):
    """The digest's split-weight replica must mirror io.cc: strict
    decimal form, (0.1, 1.5] clamp, default 0.95 for everything else."""
    from alignasm_tpu.parallel.multihost import _effective_r0w

    cases = {
        None: 0.95, "0.9": 0.9, "1.5": 1.5, "1": 1.0, "5.": 0.95,
        "0.05": 0.95, "2.0": 0.95, "abc": 0.95, "0.9abc": 0.95,
        "-0.9": 0.95, "": 0.95, ".": 0.95, ".5": 0.5, "1e0": 0.95,
    }
    for raw, want in cases.items():
        if raw is None:
            monkeypatch.delenv("ALN_SHARD_R0W", raising=False)
        else:
            monkeypatch.setenv("ALN_SHARD_R0W", raw)
        assert _effective_r0w() == want, (raw, want)
