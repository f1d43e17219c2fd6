"""Device-engine tests on the virtual CPU mesh (conftest forces
JAX_PLATFORMS=cpu with 8 fake devices)."""

import numpy as np
import pytest

import dataclasses

from alignasm_tpu.config import DEFAULT_CONFIG
from alignasm_tpu.testing.synth import (
    generate_chain_paf, generate_hard_paf, generate_paf,
)

# Device tests must FORCE the bucket pipeline: the production default
# (device_routing="auto") routes work on an uncalibrated device (the CPU) to the fused
# native plane (runtime/costmodel.py), which would silently stop
# exercising the device path these tests cover.
DEVICE_CFG = dataclasses.replace(DEFAULT_CONFIG, device_routing="always")


def _read(tmp_path, text, name="t.paf"):
    from alignasm_tpu.io.paf import read_paf

    p = tmp_path / name
    p.write_text(text)
    return read_paf(p)


@pytest.mark.parametrize("kind,seed", [("basic", 0), ("basic", 3), ("hard", 0), ("hard", 5)])
def test_device_engine_matches_exact(tmp_path, kind, seed):
    import copy

    from alignasm_tpu.engine.exact import solve_dataset
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    gen = generate_paf if kind == "basic" else generate_hard_paf
    ds = _read(tmp_path, gen(n_contigs=10, seed=seed))
    ds2 = copy.deepcopy(ds)
    assert solve_dataset_tpu(ds, DEFAULT_CONFIG) == solve_dataset(ds2, DEFAULT_CONFIG)


@pytest.mark.parametrize("seed", [11, 23, 37])
def test_device_engine_order_sensitive_contigs(tmp_path, seed):
    """Tie-heavy corpora: every contig whose outputs depend on the
    walk-enumeration order must route through the exact finish — results
    equal the exact engine byte-for-byte even in the no-exporter path
    (advisor finding: fraction-descending order is NOT the lazy-queue
    emission order for multi-sidetrack walks)."""
    import copy

    from alignasm_tpu.engine.exact import solve_dataset
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    ds = _read(tmp_path, generate_hard_paf(n_contigs=12, seed=seed))
    ds2 = copy.deepcopy(ds)
    got = solve_dataset_tpu(ds, DEFAULT_CONFIG)
    stats = solve_dataset_tpu.last_stats
    assert got == solve_dataset(ds2, DEFAULT_CONFIG)
    # the hard generator produces tie/alt contigs: fallbacks must be
    # attributed to a reason, never silent
    assert stats["fallback"] == sum(stats["fallback_reasons"].values())


def test_device_engine_zero_fallbacks_on_tie_free_corpus(tmp_path):
    """The bench-like corpus is tie-free: the device fast path must
    handle every multi-record contig with no fallback at all."""
    import copy

    from alignasm_tpu.engine.exact import solve_dataset
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    ds = _read(tmp_path, generate_paf(n_contigs=30, seed=77))
    ds2 = copy.deepcopy(ds)
    got = solve_dataset_tpu(ds, DEFAULT_CONFIG)
    stats = solve_dataset_tpu.last_stats
    assert stats["fallback"] == 0, stats
    assert stats["device"] > 0
    assert got == solve_dataset(ds2, DEFAULT_CONFIG)


def test_kernel_matches_host_dp(tmp_path):
    """Device d[]/best[]/floor vs the host exact engine's own DPs."""
    from alignasm_tpu.engine import dial
    from alignasm_tpu.engine.device import pack_graph
    from alignasm_tpu.engine.graph import build_graph
    from alignasm_tpu.engine.kshortest import KShortestWalks
    from alignasm_tpu.model import distance as D
    from alignasm_tpu.ops.relax import solve_graph_batch

    ds = _read(tmp_path, generate_hard_paf(n_contigs=6, seed=1))
    for contig in ds.contigs:
        if len(contig) < 2:
            continue
        g = build_graph(contig, DEFAULT_CONFIG)
        pg = pack_graph(g)
        E = len(pg.eu)
        dev = solve_graph_batch(
            pg.eu[None], pg.ev[None], pg.es[None], pg.ea[None],
            pg.enz[None], pg.etot[None], pg.erank[None],
            np.ones((1, E), bool),
            np.asarray([g.src], np.int32), np.asarray([g.dest], np.int32),
            V=g.n_vertices, n_sweeps=g.n + 2,
        )
        solver = KShortestWalks(g.adj, D.CALC_SUM)
        solver.solve(g.src, g.dest, 1)
        for u in range(g.n_vertices):
            hd = solver.d[u]
            if hd is D.MAX_DIST:
                assert int(dev["d_s"][0][u]) >= 2**62
            else:
                assert int(dev["d_s"][0][u]) == hd[0] + hd[1], u
                assert int(dev["d_a"][0][u]) == hd[2], u
                assert int(dev["d_nz"][0][u]) == hd[3], u
                assert int(dev["d_tot"][0][u]) == hd[4], u
                if u != g.dest:
                    # best tree agreement
                    e = int(dev["d_eid"][0][u])
                    assert int(pg.ev[e]) == solver.best[u], u
        anom_adj = [[(v, w[D.A]) for v, w in row] for row in g.adj]
        anom_dis, _ = dial.k_weighted_bfs(anom_adj, g.src, 2)
        assert int(dev["floor_a"][0][g.src]) == anom_dis[g.dest]


def test_graph_sharded_contig_byte_identical(tmp_path, reference_outputs):
    """An oversized contig routed over the edge-sharded graph axis
    (8-device virtual mesh) must produce PAF BYTES identical to the
    reference — the full path-recovery + write pipeline, not just d[]."""
    import dataclasses
    import pathlib

    import jax

    from alignasm_tpu.io.paf import read_paf, write_outputs
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    if jax.device_count() < 2:
        pytest.skip("needs the virtual multi-device mesh")
    paf = tmp_path / "shard.paf"
    paf.write_text(generate_paf(n_contigs=1, seed=6,
                                max_records_per_contig=60, mean_segment=250))
    gold = reference_outputs(paf, tmp_path)

    ds = read_paf(paf)
    n_big = len(ds.contigs[0])
    assert n_big >= 40
    cfg = dataclasses.replace(DEFAULT_CONFIG, max_device_records=16,
                              graph_shard_min_records=32)
    outs, alt_outs, max_outs = solve_dataset_tpu(ds, cfg)
    assert solve_dataset_tpu.last_stats.get("graph_sharded", 0) == 1

    stem = tmp_path / "eng"
    for name, data, kw in [(".aln.paf", outs, {}), (".aln.alt.paf", alt_outs, {}),
                           (".aln.all.paf", max_outs, {"name_suffix_counts": True})]:
        with open(str(stem) + name, "w") as fh:
            write_outputs(ds, data, fh, **kw)
    for g, suffix in zip(gold, ("", ".alt", ".all")):
        got = pathlib.Path(str(stem) + f".aln{suffix}.paf")
        assert g == got.read_bytes(), f"aln{suffix}"


def test_dryrun_multichip_virtual():
    import __graft_entry__ as ge
    import jax

    n = min(8, len(jax.devices()))
    ge.dryrun_multichip(n)


def test_entry_compiles():
    import __graft_entry__ as ge
    import jax

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert "d_s" in out


def test_int64_kernel_path_for_large_coordinates(tmp_path):
    """Chromosome-scale coordinates exceed the int32 path-sum bound and
    must route to the int64 kernel — results still match exact."""
    import copy

    from alignasm_tpu.engine.exact import solve_dataset
    from alignasm_tpu.io.paf import read_paf
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    base = 480_000_000  # near the top of a large chromosome
    total = 500_000_000
    rows = []
    q = 1000
    for k in range(6):
        ln = 5000 + 17 * k
        rows.append(
            f"big\t{total}\t{q}\t{q + ln}\t+\tchrX\t{total}\t{base + q}\t{base + q + ln}"
            f"\t{ln}\t{ln}\t60\tcs:Z::{ln}"
        )
        q += ln + 100 + k
    p = tmp_path / "bigco.paf"
    p.write_text("\n".join(rows) + "\n")
    ds = read_paf(p)
    ds2 = copy.deepcopy(ds)
    t = solve_dataset_tpu(ds, DEFAULT_CONFIG)
    assert solve_dataset_tpu.last_stats["int32_buckets"] == 0, (
        "large coordinates must use the int64 kernel"
    )
    assert t == solve_dataset(ds2, DEFAULT_CONFIG)


def test_native_plane_routes_giant_contigs_to_graph_axis(tmp_path, reference_outputs):
    """A 512 GB-class contig must reach the edge-sharded graph axis even
    when the caller asked for the native host plane (src_paths given),
    and the rest of the dataset must KEEP the native plane — the sharded
    solve's rows are injected into the native result store
    (aln_store_rows) rather than degrading the whole run to Python."""
    import copy
    import dataclasses

    import jax

    from alignasm_tpu.engine.exact import solve_dataset
    from alignasm_tpu.io.paf import read_paf
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    if jax.device_count() < 2:
        pytest.skip("needs the virtual multi-device mesh")
    p = tmp_path / "giant.paf"
    small = generate_paf(n_contigs=4, seed=9, max_records_per_contig=12)
    big = generate_paf(n_contigs=1, seed=6, max_records_per_contig=60,
                       mean_segment=250)
    big = "\n".join("\t".join(["giantctg"] + ln.split("\t")[1:])
                    for ln in big.splitlines() if ln) + "\n"
    p.write_text(small + big)
    ds = read_paf(p)
    ds2 = copy.deepcopy(ds)
    n_big = max(len(c) for c in ds.contigs)
    cfg = dataclasses.replace(DEFAULT_CONFIG, device_routing="always",
                              max_device_records=max(16, n_big - 1),
                              graph_shard_min_records=min(n_big, 48))
    t = solve_dataset_tpu(ds, cfg, src_paths=(str(p), None))
    stats = solve_dataset_tpu.last_stats
    # the giant contig reaches the mesh axis WITHOUT degrading the rest
    # of the dataset off the native host plane (its sharded rows are
    # injected into the native result store)
    assert stats.get("host_plane") == "native", stats
    assert stats.get("graph_sharded", 0) >= 1, stats
    assert t == solve_dataset(ds2, cfg)

    # and through the production write boundary the injected sharded
    # rows must serialize byte-identically to the reference (default cfg:
    # the oracle has no shard knobs, so re-solve with defaults)

    gold = reference_outputs(p, tmp_path)
    dev = tmp_path / "dev.paf"
    dev.write_bytes(p.read_bytes())
    n_big2 = max(len(c) for c in read_paf(dev).contigs)
    cfg2 = dataclasses.replace(DEFAULT_CONFIG, device_routing="always",
                               max_device_records=max(16, n_big2 - 1),
                               graph_shard_min_records=min(n_big2, 48))
    solve_dataset_tpu(read_paf(dev), cfg2, src_paths=(str(dev), None),
                      write_prefix=str(tmp_path / "dev"))
    stats2 = solve_dataset_tpu.last_stats
    assert stats2.get("graph_sharded", 0) >= 1, stats2
    for g, suffix in zip(gold, ("", ".alt", ".all")):
        got = (tmp_path / f"dev.aln{suffix}.paf").read_bytes()
        assert got == g, f"dev.aln{suffix}.paf differs"


def test_device_failure_degrades_to_native_solve(tmp_path, reference_outputs,
                                                 monkeypatch):
    """A device-section failure (a backend error) must never
    sink an --engine tpu run: the scheduler records the reason and the
    threaded native solve covers every contig — on-disk outputs stay
    byte-identical to the reference."""
    import pathlib
    import warnings

    from alignasm_tpu.io.paf import read_paf
    from alignasm_tpu.runtime import scheduler

    p = tmp_path / "degrade.paf"
    p.write_text(generate_paf(n_contigs=8, seed=5))
    gold = reference_outputs(p, tmp_path)

    def boom(*a, **k):
        raise RuntimeError("simulated backend failure")

    monkeypatch.setattr(scheduler, "_launch_buckets", boom)
    eng = tmp_path / "e.paf"
    eng.write_bytes(p.read_bytes())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        scheduler.solve_dataset_tpu(
            read_paf(eng), DEVICE_CFG, src_paths=(str(eng), None),
            write_prefix=str(eng)[:-4])
    stats = scheduler.solve_dataset_tpu.last_stats
    assert "simulated backend failure" in stats.get("device_error", ""), stats
    assert stats["device"] == 0
    assert stats["native_direct"] > 0
    for g, suffix in zip(gold, ("", ".alt", ".all")):
        got = pathlib.Path(str(eng)[:-4] + f".aln{suffix}.paf")
        assert g == got.read_bytes(), f"aln{suffix}"


def test_device_engine_shards_over_data_mesh(tmp_path):
    """With multiple devices visible, the production device path shards
    bucket batches over the data mesh and still equals exact."""
    import copy

    import jax

    from alignasm_tpu.engine.exact import solve_dataset
    from alignasm_tpu.io.paf import read_paf
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    if jax.device_count() < 2:
        import pytest

        pytest.skip("needs the virtual multi-device mesh")
    p = tmp_path / "m.paf"
    p.write_text(generate_paf(n_contigs=12, seed=33))
    ds = read_paf(p)
    ds2 = copy.deepcopy(ds)
    t = solve_dataset_tpu(ds, DEVICE_CFG, src_paths=(str(p), None))
    assert solve_dataset_tpu.last_stats.get("data_mesh_devices") == jax.device_count()
    assert t == solve_dataset(ds2, DEFAULT_CONFIG)


def test_int16_bucket_path_byte_identical(tmp_path, reference_outputs):
    """With dense_max_v raised past the 256 default, contigs whose
    graphs exceed V = 256 route through the int16 nxt rows
    (dense_solve_wire_topo_nxt + the C++ finish's host gate and
    successor chase) instead of the uint8 fast path — the only
    consumer of aln_finish_bulk.  Byte-check that path against the
    reference through the full write boundary and assert the bucket
    actually ran at V > 256 with at least one device-fast finish
    (otherwise this test silently stops covering the chase)."""
    import dataclasses


    from alignasm_tpu.io.paf import read_paf
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    # a long same-chromosome chain keeps edge scores small (the packed
    # wire's 28-bit envelope caps bound < 2^27 — translocation-rich
    # corpora overflow it and route native) while V grows past 256
    txt = generate_chain_paf(220, seed=9)
    p = tmp_path / "big.paf"
    p.write_text(txt)

    # capture the reference bytes BEFORE the engine run: the engine writes
    # to the same prefix, so comparing paths afterwards would compare
    # the engine output with itself
    gold = reference_outputs(p, tmp_path)

    ds = read_paf(p)
    cfg = dataclasses.replace(DEFAULT_CONFIG, device_routing="always",
                              dense_max_v=1024)
    solve_dataset_tpu(ds, cfg, src_paths=(str(p), None),
                      write_prefix=str(tmp_path / "big"))
    stats = solve_dataset_tpu.last_stats
    assert any(v > 256 for v in stats.get("bucket_vs", [])), stats
    assert stats["device"] >= 1, stats
    for g, suffix in zip(gold, ("", ".alt", ".all")):
        got = (tmp_path / f"big.aln{suffix}.paf").read_bytes()
        assert got == g, f"big.aln{suffix}.paf differs"


def test_graph_shard_failure_degrades_to_native(tmp_path, reference_outputs,
                                                monkeypatch):
    """A failure inside the edge-sharded mesh solve must degrade to the
    native solve for the affected contig (store_rows never ran, so
    solve_remaining covers it) with the reason recorded — never sink
    the run.  Outputs stay byte-identical to the reference."""
    import dataclasses
    import pathlib

    from alignasm_tpu.io.paf import read_paf
    from alignasm_tpu.parallel import mesh
    from alignasm_tpu.runtime import scheduler

    p = tmp_path / "shardfail.paf"
    small = generate_paf(n_contigs=4, seed=11, max_records_per_contig=12)
    big = generate_paf(n_contigs=1, seed=6, max_records_per_contig=60,
                       mean_segment=250)
    big = "\n".join(
        "\t".join(["bigctg"] + line.split("\t")[1:])
        for line in big.splitlines() if line
    ) + "\n"
    p.write_text(small + big)
    gold = reference_outputs(p, tmp_path)

    def boom(*a, **k):
        raise RuntimeError("simulated mesh failure")

    monkeypatch.setattr(mesh, "solve_contig_sharded_native", boom)
    ds = read_paf(p)
    n_big = max(len(c) for c in ds.contigs)
    cfg = dataclasses.replace(DEFAULT_CONFIG, device_routing="always",
                              max_device_records=max(16, n_big - 1),
                              graph_shard_min_records=min(n_big, 48))
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # degrade notice
        scheduler.solve_dataset_tpu(ds, cfg, src_paths=(str(p), None),
                                    write_prefix=str(p)[:-4])
    stats = scheduler.solve_dataset_tpu.last_stats
    assert "simulated mesh failure" in stats.get("device_error", ""), stats
    assert stats.get("graph_sharded", 0) == 0, stats
    # the big contig must still be covered: since the single-chip
    # big-contig path landed, the degrade target is the device bucket
    # pipeline when the contig fits the vertex ceiling, else the
    # native solve — either way outputs stay byte-identical below
    assert (stats["native_direct"] >= 1
            or stats["device"] + stats["fallback"] >= 5), stats
    for g, suffix in zip(gold, ("", ".alt", ".all")):
        got = pathlib.Path(str(p)[:-4] + f".aln{suffix}.paf")
        assert g == got.read_bytes(), f"aln{suffix}"


def test_big_contig_single_chip_device_path(tmp_path, reference_outputs):
    """A contig larger than max_device_records (but within the
    device_max_v vertex ceiling) must take the single-chip big-contig
    device path — tiny-B bucket, int16 gate rows (V > 256) — and stay
    byte-identical to the reference.  Round-2 verdict item 4: the device
    engine must stop handing its hardest inputs to the CPU."""
    import pathlib

    from alignasm_tpu.io.paf import read_paf
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    p = tmp_path / "bigdev.paf"
    # ~800 records -> ~1000 vertices: > max_device_records (512) and
    # > the uint8 V bound (256), well within device_max_v
    p.write_text(generate_chain_paf(600, seed=11))
    n_rec = p.read_text().count("\n")
    assert n_rec > DEFAULT_CONFIG.max_device_records

    gold = reference_outputs(p, tmp_path)
    eng = tmp_path / "engbig.paf"
    eng.write_bytes(p.read_bytes())
    solve_dataset_tpu(read_paf(eng), DEVICE_CFG,
                      src_paths=(str(eng), None),
                      write_prefix=str(eng)[:-4])
    stats = solve_dataset_tpu.last_stats
    assert stats["oversize"] == 1, stats
    assert stats["device"] + stats["fallback"] >= 1, stats
    assert any(v > 256 for v in stats.get("bucket_vs", [])), stats
    for g, suffix in zip(gold, ("", ".alt", ".all")):
        got = pathlib.Path(str(eng)[:-4] + f".aln{suffix}.paf")
        assert g == got.read_bytes(), f"aln{suffix}"


def test_big_contig_batched_bucket_device_path(tmp_path, reference_outputs):
    """Several big contigs whose padded V lands in ONE bucket must ride
    a single batched blocked launch (padB > 1 — the batched branch of
    the production Bk rule) and stay byte-identical."""
    import pathlib

    from alignasm_tpu.io.paf import read_paf
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    # four ~600-segment chain contigs: each ~750-1050 vertices, all
    # padding into the same V bucket
    parts = []
    for k, seed in enumerate((11, 23, 37, 51)):
        txt = generate_chain_paf(600, seed=seed)
        parts.append(txt.replace("bigctg", f"bigctg{k}"))
    p = tmp_path / "bigbatch.paf"
    p.write_text("".join(parts))

    gold = reference_outputs(p, tmp_path)
    eng = tmp_path / "engbatch.paf"
    eng.write_bytes(p.read_bytes())
    solve_dataset_tpu(read_paf(eng), DEVICE_CFG,
                      src_paths=(str(eng), None),
                      write_prefix=str(eng)[:-4])
    stats = solve_dataset_tpu.last_stats
    big_buckets = [(v, n) for v, n, *_ in stats.get("bucket_phases", [])
                   if v > 256]
    assert any(n >= 2 for _v, n in big_buckets), stats  # batched launch
    assert stats["device"] + stats["fallback"] >= 4, stats
    for g, suffix in zip(gold, ("", ".alt", ".all")):
        got = pathlib.Path(str(eng)[:-4] + f".aln{suffix}.paf")
        assert g == got.read_bytes(), f"aln{suffix}"


def test_nxt16_gate_rows_match_full_dp():
    """dense_solve_wire_topo_nxt16 (int16 gate rows for V > 256) must
    agree with the full-DP rows: identical nxt array, src, and a fast
    flag equal to the host gate on unclamped values."""
    from alignasm_tpu.ops.dense import (
        ANOM_SHIFT, INF32, dense_solve_wire_topo,
        dense_solve_wire_topo_nxt16,
    )

    rng = np.random.default_rng(29)
    B, V = 4, 300  # V > 256: the uint8 form cannot represent positions
    mask = np.triu(rng.random((B, V, V)) < 0.03, k=1)
    ws = np.where(mask, rng.integers(1, 2**20, (B, V, V)), INF32).astype(np.int32)
    wa = np.where(mask, rng.integers(0, 4, (B, V, V)), 0).astype(np.int32)
    dests = rng.integers(V // 2, V, B).astype(np.int32)
    srcs = rng.integers(0, V // 2, B).astype(np.int32)
    for b in range(B):
        mask[b, dests[b], :] = False
    E = int(mask.sum(axis=(1, 2)).max())
    wire = np.empty((B, 2, E + 3), np.int32)
    wire[:, 0] = V * (V + 1)
    wire[:, 1] = 0
    for b in range(B):
        us, vs = np.nonzero(mask[b])
        k = len(us)
        wire[b, 0, :k] = (us * V + vs).astype(np.int32)
        wire[b, 1, :k] = ws[b, us, vs] | (wa[b, us, vs] << ANOM_SHIFT)
        wire[b, 0, k] = V * V
        wire[b, 1, k] = dests[b]
        wire[b, 0, k + 1] = V * V + 1
        wire[b, 1, k + 1] = srcs[b]
    full = np.asarray(dense_solve_wire_topo(wire, V=V))
    r16 = np.asarray(dense_solve_wire_topo_nxt16(wire, V=V))
    assert r16.dtype == np.int16 and r16.shape == (B, V + 2)
    for b in range(B):
        d_a = full[b, V : 2 * V]
        fl, ct, cm, src = full[b, 2 * V :]
        want_fast = cm == 1 and not (ct >= 2 and d_a[src] != fl)
        assert bool(r16[b, V]) == want_fast, b
        assert r16[b, V + 1] == src


def test_wire16_single_device_end_to_end(tmp_path, reference_outputs):
    """The 16-bit wire is the single-device production transport, which
    the 8-device virtual mesh never exercises — run the engine in a
    1-device CPU subprocess and byte-compare against the reference."""
    import os
    import pathlib
    import subprocess
    import sys


    p = tmp_path / "w16e.paf"
    p.write_text(generate_hard_paf(n_contigs=12, seed=91))
    gold = reference_outputs(p, tmp_path)
    eng = tmp_path / "w16eng.paf"
    eng.write_bytes(p.read_bytes())
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = ""  # exactly one device
    code = (
        "from alignasm_tpu.io.paf import read_paf\n"
        "from alignasm_tpu.runtime.scheduler import solve_dataset_tpu\n"
        "import dataclasses\n"
        "from alignasm_tpu.config import DEFAULT_CONFIG\n"
        "cfg = dataclasses.replace(DEFAULT_CONFIG, device_routing='always')\n"
        f"ds = read_paf({str(eng)!r})\n"
        f"solve_dataset_tpu(ds, cfg, src_paths=({str(eng)!r}, None),\n"
        f"                  write_prefix={str(eng)[:-4]!r})\n"
        "st = solve_dataset_tpu.last_stats\n"
        "assert st.get('wire16_buckets', 0) >= 1, st\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for g, suffix in zip(gold, ("", ".alt", ".all")):
        got = pathlib.Path(str(eng)[:-4] + f".aln{suffix}.paf")
        assert g == got.read_bytes(), f"aln{suffix}"


def test_device_path_refuses_silent_cpu_fallback(tmp_path, monkeypatch):
    """Where JAX finds no GPU, the device path raises — unless the
    caller chose the CPU through JAX_PLATFORMS, as these tests do — and
    every run records the platform it ran on."""
    import jax

    from alignasm_tpu.runtime.scheduler import (
        device_platform, solve_dataset_tpu,
    )

    assert device_platform() == {"platform": "cpu", "device_kind": "cpu",
                                 "device_count": jax.device_count()}
    p = tmp_path / "fb.paf"
    p.write_text(generate_paf(n_contigs=4, seed=1))
    for chosen in (None, "cuda,cpu"):
        if chosen is None:
            monkeypatch.delenv("JAX_PLATFORMS")
        else:
            monkeypatch.setenv("JAX_PLATFORMS", chosen)
        with pytest.raises(RuntimeError, match="needs a GPU"):
            device_platform()
        with pytest.raises(RuntimeError, match="needs a GPU"):
            solve_dataset_tpu(None, DEVICE_CFG, src_paths=(str(p), None),
                              write_prefix=str(p)[:-4])
        # the native-routed path never touches the device: it only
        # records where it ran
        assert device_platform(require_gpu=False)["platform"] == "cpu"
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    solve_dataset_tpu(None, DEVICE_CFG, src_paths=(str(p), None),
                      write_prefix=str(p)[:-4])
    st = solve_dataset_tpu.last_stats
    assert st["platform"] == "cpu" and st["device"] >= 1, st


def test_cli_profile_traces_the_tpu_engine(tmp_path):
    """--profile wraps the production --engine tpu route (the native
    plane branch included) in a jax.profiler trace and writes its stats."""
    import json

    from alignasm_tpu import cli

    p = tmp_path / "prof.paf"
    p.write_text(generate_paf(n_contigs=6, seed=2))
    trace = tmp_path / "trace"
    assert cli.run([str(p), "--engine", "tpu", "--profile", str(trace)]) == 0
    assert list(trace.glob("plugins/profile/*/*.xplane.pb"))
    stats = json.loads((trace / "stats.json").read_text())
    assert stats["n_contigs"] == 6 and stats["platform"] == "cpu"
    assert (tmp_path / "prof.aln.paf").stat().st_size > 0
