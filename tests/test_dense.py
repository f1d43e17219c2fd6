"""Production dense kernel (ops/dense.py) vs the host engine's DPs."""

import numpy as np
import pytest

from alignasm_tpu.config import DEFAULT_CONFIG
from alignasm_tpu.testing.synth import generate_hard_paf, generate_paf


def _packed_graphs(tmp_path, text):
    from alignasm_tpu.engine.device import pack_graph
    from alignasm_tpu.engine.graph import build_graph
    from alignasm_tpu.io.paf import read_paf

    p = tmp_path / "d.paf"
    p.write_text(text)
    ds = read_paf(p)
    return [
        (contig, pack_graph(build_graph(contig, DEFAULT_CONFIG)))
        for contig in ds.contigs
        if len(contig) >= 2
    ]


@pytest.mark.parametrize("kind,seed", [("basic", 2), ("hard", 4)])
def test_dense_kernel_matches_host_dps(tmp_path, kind, seed):
    """d_s/d_a/floor/cnt_tot/cnt_min from the dense kernel vs the exact
    engine's own machinery, per vertex."""
    from alignasm_tpu.engine import dial
    from alignasm_tpu.engine.kshortest import KShortestWalks
    from alignasm_tpu.model import distance as D
    from alignasm_tpu.ops.dense import INF32, dense_solve_batch, pack_dense_bucket

    gen = generate_paf if kind == "basic" else generate_hard_paf
    pgs = _packed_graphs(tmp_path, gen(n_contigs=8, seed=seed))
    chunk = [(i, pg) for i, (_c, pg) in enumerate(pgs)]
    V = 1 << max(pg.g.n_vertices for _i, pg in chunk).bit_length()
    n_sweeps = max(pg.g.n for _i, pg in chunk) + 2
    ws, wa, dests = pack_dense_bucket(chunk, V)
    out = np.asarray(dense_solve_batch(ws, wa, dests, n_sweeps=n_sweeps))

    for b, (_i, pg) in enumerate(chunk):
        g = pg.g
        d_s, d_a, floor_a, cnt_tot, cnt_min = out[b]
        solver = KShortestWalks(g.adj, D.CALC_SUM)
        kd = solver.solve(g.src, g.dest, DEFAULT_CONFIG.max_path_count)
        for u in range(g.n_vertices):
            hd = solver.d[u]
            if hd is D.MAX_DIST:
                assert d_s[u] >= INF32, u
            else:
                assert int(d_s[u]) == hd[0] + hd[1], u
                assert int(d_a[u]) == hd[2], u
        anom_adj = [[(v, w[D.A]) for v, w in row] for row in g.adj]
        anom_dis, _ = dial.k_weighted_bfs(anom_adj, g.src, 2)
        assert int(floor_a[g.src]) == anom_dis[g.dest]
        # tie-group size == walks sharing the min (sum, anom)
        tie = sum(1 for d in kd if D.eq_sum_anom(kd[0], d))
        sat = min(len(kd), 10_001)
        assert int(cnt_min[g.src]) == min(tie, 10_001) or tie >= 10_001
        assert int(cnt_tot[g.src]) >= sat or int(cnt_tot[g.src]) == 10_001


def test_dense_sparse_wire_matches_unpacked():
    """dense_solve_wire (sparse transport + on-device scatter) must
    equal dense_solve_batch on random DAG buckets."""
    from alignasm_tpu.ops.dense import (
        ANOM_SHIFT, INF32, dense_solve_batch, dense_solve_wire,
    )

    rng = np.random.default_rng(8)
    B, V, S = 6, 32, 16
    mask = np.triu(rng.random((B, V, V)) < 0.2, k=1)
    ws = np.where(mask, rng.integers(1, 2**27, (B, V, V)), INF32).astype(np.int32)
    wa = np.where(mask, rng.integers(0, 4, (B, V, V)), 0).astype(np.int32)
    dests = rng.integers(V // 2, V, B).astype(np.int32)
    srcs = rng.integers(0, V // 2, B).astype(np.int32)
    E = int(mask.sum(axis=(1, 2)).max())
    W = E + 3
    wire = np.empty((B, 2, W), np.int32)
    wire[:, 0] = V * (V + 1)  # trash
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
    a = np.asarray(dense_solve_batch(ws, wa, dests, n_sweeps=S))
    c = np.asarray(dense_solve_wire(wire, V=V, n_sweeps=S))
    for b in range(B):
        s = int(srcs[b])
        exp = np.concatenate([
            a[b, 0], a[b, 1],
            [a[b, 2, s], a[b, 3, s], a[b, 4, s], s],
        ]).astype(np.int32)
        np.testing.assert_array_equal(exp, c[b])


def test_topo_scan_matches_sweeps():
    """dense_solve_wire_topo (the production single-scan kernel on
    topo-ordered wires) must be bit-equal to the sweep kernel on random
    upper-triangular DAGs — including dests that are not at V-1 and
    vertices that cannot reach dest."""
    from alignasm_tpu.ops.dense import (
        ANOM_SHIFT, INF32, dense_solve_wire, dense_solve_wire_topo,
    )

    rng = np.random.default_rng(21)
    B, V, S = 8, 32, 64
    mask = np.triu(rng.random((B, V, V)) < 0.15, k=1)
    ws = np.where(mask, rng.integers(1, 2**27, (B, V, V)), INF32).astype(np.int32)
    wa = np.where(mask, rng.integers(0, 4, (B, V, V)), 0).astype(np.int32)
    dests = rng.integers(V // 2, V, B).astype(np.int32)
    srcs = rng.integers(0, V // 2, B).astype(np.int32)
    for b in range(B):
        mask[b, dests[b], :] = False  # dest is a sink (exporter contract)
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
    a = np.asarray(dense_solve_wire(wire, V=V, n_sweeps=S))
    c = np.asarray(dense_solve_wire_topo(wire, V=V))
    np.testing.assert_array_equal(a, c)


def test_topo_nxt_rows_match_dp(tmp_path):
    """dense_solve_wire_topo_nxt (production compact int16 rows) must
    agree with the full-DP kernel: same scalars (int16-clamped) and,
    whenever cnt_min == 1, an achieving-successor array whose host
    chase from src walks achieving edges src->dest (the unique min
    walk — the chase the C++ finish performs)."""
    from alignasm_tpu.ops.dense import (
        ANOM_SHIFT, I16_INF, INF32, dense_solve_wire_topo,
        dense_solve_wire_topo_nxt,
    )

    rng = np.random.default_rng(5)
    B, V = 16, 24
    mask = np.triu(rng.random((B, V, V)) < 0.18, k=1)
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
    rows = np.asarray(dense_solve_wire_topo_nxt(wire, V=V))
    assert rows.dtype == np.int16 and rows.shape == (B, V + 5)
    ws = np.where(mask, ws, INF32)
    n_unique = 0
    for b in range(B):
        d_s, d_a = full[b, :V], full[b, V : 2 * V]
        fl, ct, cm, src = full[b, 2 * V :]
        assert rows[b, V] == min(fl, I16_INF)
        assert rows[b, V + 1] == ct
        assert rows[b, V + 2] == min(cm, I16_INF)
        assert rows[b, V + 3] == min(d_a[src], I16_INF)
        assert rows[b, V + 4] == src
        if cm != 1:
            continue
        n_unique += 1
        nxt = rows[b, :V]
        u = int(src)
        for _ in range(V):  # chase as the C++ finish does
            if u == dests[b]:
                break
            v = int(nxt[u])
            assert v > u, "achieving successors must increase"
            assert mask[b, u, v], "chase step is not an edge"
            assert ws[b, u, v] + d_s[v] == d_s[u]
            assert wa[b, u, v] + d_a[v] == d_a[u]
            u = v
        assert u == dests[b], "chase must reach dest"
    assert n_unique > 0


def test_topo_nxt8_rows_match_int16(tmp_path):
    """dense_solve_wire_topo_nxt8 (uint8 rows, gate evaluated on
    device) must agree with the int16 rows: identical nxt array,
    identical src, and a fast flag equal to the host gate
    cnt_min == 1 and not (cnt_tot >= 2 and d_a != floor_a) evaluated on
    the UNclamped DP values."""
    from alignasm_tpu.ops.dense import (
        ANOM_SHIFT, INF32, dense_solve_wire_topo,
        dense_solve_wire_topo_nxt, dense_solve_wire_topo_nxt8,
    )

    rng = np.random.default_rng(13)
    B, V = 16, 24
    mask = np.triu(rng.random((B, V, V)) < 0.18, k=1)
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
    r16 = np.asarray(dense_solve_wire_topo_nxt(wire, V=V))
    r8 = np.asarray(dense_solve_wire_topo_nxt8(wire, V=V))
    assert r8.dtype == np.uint8 and r8.shape == (B, V + 2)
    n_fast = 0
    for b in range(B):
        d_a = full[b, V : 2 * V]
        fl, ct, cm, src = full[b, 2 * V :]
        want_fast = cm == 1 and not (ct >= 2 and d_a[src] != fl)
        assert bool(r8[b, V]) == want_fast, b
        assert r8[b, V + 1] == src
        np.testing.assert_array_equal(
            r8[b, :V].astype(np.int16), r16[b, :V], err_msg=f"nxt b={b}")
        n_fast += want_fast
    assert 0 < n_fast  # the corpus exercises both gate outcomes
    assert n_fast < B


def test_exporter_wire_is_topological(tmp_path):
    """The native exporter's wire cells must be topologically relabeled
    (row < col for every edge) with dest/src at their Kahn positions —
    the contract dense_solve_wire_topo relies on."""
    from alignasm_tpu import native
    from alignasm_tpu.config import DEFAULT_CONFIG as cfg

    p = tmp_path / "topo.paf"
    p.write_text(generate_hard_paf(n_contigs=6, seed=9))
    native.build()
    exp = native.GraphExporter(str(p), config=cfg)
    try:
        meta = exp.meta_bulk()
        idx = np.where(meta[:, 0] == 1)[0]
        assert len(idx) > 0
        V = 1 << int(meta[idx, 2].max() - 1).bit_length()
        W = 1 << int(meta[idx, 3].max() + 2 - 1).bit_length()
        wire, ok = exp.export_wire(idx, V, W)
        assert ok.all()
        trash = V * (V + 1)
        n_checked = 0
        for b in range(len(idx)):
            cells = wire[b, 0]
            edges = cells[(cells >= 0) & (cells < V * V)]
            u, v = edges // V, edges % V
            assert (u < v).all(), "edge against topo order"
            dest_slots = wire[b, 1][cells == V * V]
            src_slots = wire[b, 1][cells == V * V + 1]
            assert len(dest_slots) == 1 and len(src_slots) == 1
            # dest is a sink: nothing may leave its relabeled row
            assert (u != dest_slots[0]).all()
            assert (cells[cells >= V * V + 2] == trash).all()
            n_checked += len(edges)
        assert n_checked > 0
    finally:
        exp.close()


def test_dense_rejects_parallel_edges():
    """pack_dense_bucket must refuse duplicate (u, v) cells."""
    import dataclasses

    from alignasm_tpu.engine.device import PackedGraph
    from alignasm_tpu.ops.dense import pack_dense_bucket

    @dataclasses.dataclass
    class GStub:
        n_vertices: int = 4
        dest: int = 3
        n: int = 2

    pg = PackedGraph(
        g=GStub(),
        eu=np.array([0, 0], np.int32), ev=np.array([1, 1], np.int32),
        es=np.array([5, 7], np.int64), ea=np.zeros(2, np.int32),
        enz=np.zeros(2, np.int32), etot=np.zeros(2, np.int32),
        erank=np.zeros(2, np.int64), edge_w=[],
    )
    assert pack_dense_bucket([(0, pg)], 4) is None


def test_dense_bucket_partition():
    """Buckets must PARTITION the contig set (each index exactly once),
    respect the V bound, and split groups at the cell cap — regression
    for a bucket slice that overran its V group into all remaining
    contigs (heap overrun in the C++ dense pack)."""
    from alignasm_tpu.runtime.scheduler import _dense_buckets

    rng = np.random.default_rng(0)
    n_v = rng.integers(3, 120, 200)
    order = np.argsort(n_v, kind="stable")
    buckets = _dense_buckets(order, n_v, dense_cells=64 * 64 * 4,
                             merge_bonus=0)
    seen = np.concatenate([idxs for _v, idxs in buckets])
    assert sorted(seen.tolist()) == list(range(200))
    for V, idxs in buckets:
        assert (n_v[idxs] <= V).all()
        assert len(idxs) * V * V <= max(64 * 64 * 4, V * V)
    # the small cap must have split large groups into multiple buckets
    assert len(buckets) > 5


def test_dense_bucket_merge_collapses_small_groups():
    """With the default merge bonus, a bench-shaped V distribution must
    collapse into ONE launch (every launch pays a fixed dispatch and
    transfer cost); a huge group of tiny contigs must NOT be lifted
    to a lone giant contig's V."""
    from alignasm_tpu.runtime.scheduler import _dense_buckets

    rng = np.random.default_rng(1)
    n_v = rng.integers(4, 60, 2000)
    order = np.argsort(n_v, kind="stable")
    buckets = _dense_buckets(order, n_v)
    assert len(buckets) == 1
    assert buckets[0][0] == 64

    n_v2 = np.concatenate([rng.integers(4, 9, 100_000), [250]])
    order2 = np.argsort(n_v2, kind="stable")
    buckets2 = _dense_buckets(order2, n_v2)
    assert all((n_v2[idxs] <= V).all() for V, idxs in buckets2)
    big = [V for V, idxs in buckets2 if 100_000 in idxs]
    assert big == [256]
    small = [(V, len(i)) for V, i in buckets2 if 100_000 not in i]
    assert all(v == 8 for v, _c in small)


def test_device_engine_uses_dense_kernel(tmp_path):
    """Bench-like contigs must route through the dense kernel and still
    equal the exact engine."""
    import copy

    from alignasm_tpu.engine.exact import solve_dataset
    from alignasm_tpu.io.paf import read_paf
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    p = tmp_path / "dd.paf"
    p.write_text(generate_paf(n_contigs=16, seed=55))
    ds = read_paf(p)
    ds2 = copy.deepcopy(ds)
    got = solve_dataset_tpu(ds, DEFAULT_CONFIG)
    stats = solve_dataset_tpu.last_stats
    assert stats["dense_buckets"] > 0, stats
    assert got == solve_dataset(ds2, DEFAULT_CONFIG)


def test_ragged_wire_parity_with_slab_wire(tmp_path):
    """The ragged wire (export_wire_ragged + _densify_wire_ragged) and
    the slab wire (export_wire + _densify_wire) are two encodings of ONE
    layout contract; this pins them together end to end: identical
    densified slabs and bit-identical nxt/nxt8 production rows for the
    same bucket — including a rejected contig (empty well-formed slab in
    the ragged stream, dropped via the ok mask) and padB > B padding
    rows."""
    from alignasm_tpu import native
    from alignasm_tpu.config import DEFAULT_CONFIG as cfg
    from alignasm_tpu.ops.dense import (
        _densify_wire, _densify_wire_ragged, dense_solve_wire_topo_nxt,
        dense_solve_wire_topo_nxt8, dense_solve_wire_topo_nxt8_ragged,
        dense_solve_wire_topo_nxt_ragged, INF32,
    )

    p = tmp_path / "rp.paf"
    p.write_text(generate_hard_paf(n_contigs=8, seed=21))
    native.build()
    exp = native.GraphExporter(str(p), config=cfg)
    try:
        meta = exp.meta_bulk()
        idx = np.where((meta[:, 0] == 1) & (meta[:, 1] >= 2))[0]
        assert len(idx) >= 4
        V = 1 << int(meta[idx, 2].max() - 1).bit_length()
        n_edges = meta[idx, 3]
        W = 1 << int(n_edges.max() + 2 - 1).bit_length()
        padB = 1 << (len(idx) - 1).bit_length()
        if padB == len(idx):
            padB *= 2  # force real padding rows

        slab_wire, ok_s = exp.export_wire(idx, V, W)
        rag_wire, ok_r, _cap = exp.export_wire_ragged(idx, V, n_edges, padB)
        assert ok_s.all() and ok_r.all()

        slabs_s = np.asarray(_densify_wire(slab_wire, V))
        slabs_r = np.asarray(_densify_wire_ragged(rag_wire, padB, V))
        np.testing.assert_array_equal(slabs_s, slabs_r[: len(idx)])
        # padding rows decode to empty well-formed slabs: no edges, and
        # dest/src seeded at vertex 0
        for b in range(len(idx), padB):
            assert (slabs_r[b, :V] == INF32).all()
            assert slabs_r[b, V, 0] == 0 and slabs_r[b, V, 1] == 0

        r16_s = np.asarray(dense_solve_wire_topo_nxt(slab_wire, V=V))
        r16_r = np.asarray(dense_solve_wire_topo_nxt_ragged(
            rag_wire, B=padB, V=V))
        np.testing.assert_array_equal(r16_s, r16_r[: len(idx)])
        if V <= 256:
            r8_s = np.asarray(dense_solve_wire_topo_nxt8(slab_wire, V=V))
            r8_r = np.asarray(dense_solve_wire_topo_nxt8_ragged(
                rag_wire, B=padB, V=V))
            np.testing.assert_array_equal(r8_s, r8_r[: len(idx)])

        # a rejected contig: lie about one contig's edge count so the
        # ragged exporter fails it (status 3) — its span must decode to
        # an empty well-formed slab and its ok flag must drop it
        bad_edges = n_edges.copy()
        bad_edges[1] += 1
        rag_bad, ok_bad, _cap2 = exp.export_wire_ragged(
            idx, V, bad_edges, padB)
        assert not ok_bad[1] and ok_bad[0]
        slabs_bad = np.asarray(_densify_wire_ragged(rag_bad, padB, V))
        assert (slabs_bad[1, :V] == INF32).all()
        assert slabs_bad[1, V, 0] == 0 and slabs_bad[1, V, 1] == 0
        keep = np.where(ok_bad)[0]
        np.testing.assert_array_equal(slabs_bad[keep], slabs_s[keep])
    finally:
        exp.close()


def test_wire16_parity_with_ragged_wire(tmp_path):
    """The 16-bit wire (u16 deltas + u16 dictionary values) must densify
    to slabs bit-identical to the i32 ragged wire for the same bucket —
    including rejected contigs (inline vertex-0 seeds) and padding rows
    — and produce bit-identical nxt8 production rows."""
    from alignasm_tpu import native
    from alignasm_tpu.config import DEFAULT_CONFIG as cfg
    from alignasm_tpu.ops.dense import (
        _densify_wire16, _densify_wire_ragged,
        dense_solve_wire16_topo_nxt8, dense_solve_wire_topo_nxt8_ragged,
    )

    p = tmp_path / "w16.paf"
    p.write_text(generate_hard_paf(n_contigs=10, seed=17))
    native.build()
    exp = native.GraphExporter(str(p), config=cfg)
    try:
        meta = exp.meta_bulk()
        idx = np.where((meta[:, 0] == 1) & (meta[:, 1] >= 2))[0]
        assert len(idx) >= 4
        V = 1 << int(meta[idx, 2].max() - 1).bit_length()
        assert V <= 128
        n_edges = meta[idx, 3]
        padB = (1 << (len(idx) - 1).bit_length()) * 2  # force padding

        rag, ok_r, _cap = exp.export_wire_ragged(idx, V, n_edges, padB)
        w16 = exp.export_wire16(idx, V, n_edges, padB)
        assert w16 is not None
        deltas, vidx, table, n_real, seeds, ok_16 = w16
        np.testing.assert_array_equal(ok_r, ok_16)

        slabs_r = np.asarray(_densify_wire_ragged(rag, padB, V))
        slabs_16 = np.asarray(_densify_wire16(
            deltas, vidx, table, seeds, n_real, padB, V))
        np.testing.assert_array_equal(slabs_16, slabs_r)

        rows_r = np.asarray(dense_solve_wire_topo_nxt8_ragged(
            rag, B=padB, V=V))
        rows_16 = np.asarray(dense_solve_wire16_topo_nxt8(
            deltas, vidx, table, seeds, n_real, B=padB, V=V))
        np.testing.assert_array_equal(rows_16, rows_r)

        # force a rejected contig (lie about one edge count): both
        # transports must agree on the ok mask and on every kept slab,
        # and the rejected slab must decode empty + well-formed
        bad_edges = n_edges.copy()
        bad_edges[2] += 1
        rag_b, ok_rb, _c2 = exp.export_wire_ragged(idx, V, bad_edges, padB)
        w16_b = exp.export_wire16(idx, V, bad_edges, padB)
        assert w16_b is not None
        d_b, vi_b, tb_b, nr_b, sd_b, ok_16b = w16_b
        np.testing.assert_array_equal(ok_rb, ok_16b)
        assert not ok_16b[2]
        s_r = np.asarray(_densify_wire_ragged(rag_b, padB, V))
        s_16 = np.asarray(_densify_wire16(d_b, vi_b, tb_b, sd_b, nr_b,
                                          padB, V))
        from alignasm_tpu.ops.dense import INF32
        np.testing.assert_array_equal(s_16, s_r)
        assert (s_16[2, :V] == INF32).all()
        assert s_16[2, V, 0] == 0 and s_16[2, V, 1] == 0
    finally:
        exp.close()


def _rand_wire(B, V, density, seed, nv=None, score_max=1000):
    """Random topo-ordered DAG in the ragged wire format (the
    export.cc:aln_export_wire_ragged layout)."""
    from alignasm_tpu.ops.dense import ANOM_SHIFT

    rng = np.random.default_rng(seed)
    entries = []
    for b in range(B):
        n = nv or V
        mask = np.triu(rng.random((V, V)) < density, k=1)
        mask[n - 1:, :] = False  # dest row empty; padding rows empty
        mask[:, n:] = False
        us, vs = np.nonzero(mask)
        ws = rng.integers(0, score_max, len(us)).astype(np.int64)
        wa = rng.integers(0, 4, len(us)).astype(np.int64)
        val = (ws | (wa << ANOM_SHIFT)).astype(np.int32)
        base = b * V * (V + 1)
        ent = np.stack([base + us * V + vs, val])
        extra = np.array([[base + V * V, base + V * V + 1], [n - 1, 0]])
        entries.append(np.concatenate([ent, extra], axis=1))
    w = np.concatenate(entries, axis=1).astype(np.int32)
    trash = np.array([[B * V * (V + 1)], [0]], np.int32)
    return np.concatenate([w, np.repeat(trash, 5, axis=1)], axis=1)


@pytest.mark.parametrize("V,Bk,density,seed,nv", [
    (256, 128, 0.05, 0, None),   # sparse
    (256, 128, 0.3, 1, None),    # dense
    (256, 128, 0.05, 3, 150),    # padding past nv (dest mid-slab)
    (256, 64, 0.0005, 4, None),  # mostly unreachable
    (128, 64, 0.002, 11, 70),    # tiny + padding
    (256, 128, 0.9, 10, None),   # near-complete DAG (deep tie sets)
    (512, 64, 0.08, 9, None),
    (512, 32, 0.08, 9, None),
    (256, 32, 0.3, 2, None),     # small Bk, dense
    (512, 256, 0.02, 6, 400),    # the production single-slab Bk
])
def test_blocked_matches_scan(V, Bk, density, seed, nv):
    """The blocked tropical triangular solve (log-depth closures +
    panel updates, the big-V production kernel) must be BIT-EQUAL to
    the reverse-topo scan's int16 gate rows on arbitrary topo-ordered
    DAG wires — including padding slabs, unreachable sources, and
    tie-rich graphs (where the count-saturation-at-2 abstraction has
    to agree with the scan's saturation at 10001 through the gate)."""
    from alignasm_tpu.ops.dense import (
        dense_solve_wire_topo_nxt16_blocked_ragged,
        dense_solve_wire_topo_nxt16_ragged,
    )

    B = 2
    w = _rand_wire(B, V, density, seed, nv)
    ref = np.asarray(dense_solve_wire_topo_nxt16_ragged(w, B=B, V=V))
    got = np.asarray(
        dense_solve_wire_topo_nxt16_blocked_ragged(w, B=B, V=V, Bk=Bk))
    assert (ref == got).all()


def test_blocked_dp_vectors_match_scan():
    """All six DP vectors (not just the shipped row) agree with the
    scan, with counts compared through the {0,1,2+} quotient."""
    import jax

    from alignasm_tpu.ops.dense import (
        _blocked_dp, _densify_wire_ragged, _topo_scan,
    )

    V = 256
    w = _rand_wire(1, V, 0.08, 42, nv=200)
    arr = _densify_wire_ragged(w, 1, V)[0]
    (s, a, fa, ct, cm, nxt), dest, src = jax.jit(
        lambda x: _topo_scan(x, V))(arr)
    (s2, a2, fa2, ct2, cm2, nxt2), d2, s2_ = jax.jit(
        lambda x: _blocked_dp(x, V, 64))(arr)
    assert (np.asarray(s) == np.asarray(s2)).all()
    assert (np.asarray(a) == np.asarray(a2)).all()
    assert (np.asarray(fa) == np.asarray(fa2)).all()
    assert (np.minimum(np.asarray(ct), 2) == np.asarray(ct2)).all()
    assert (np.minimum(np.asarray(cm), 2) == np.asarray(cm2)).all()
    assert (np.asarray(nxt) == np.asarray(nxt2)).all()
    assert int(d2) == int(dest) and int(s2_) == int(src)


def test_blocked_count_closure_states_its_precision():
    """Every matmul of the blocked kernel's count closures takes bfloat16
    operands with float32 accumulation (exact for {0, 1, 2} operands),
    so no backend default (TF32 on the GPU) can round it; and with that
    precision the rows stay bit-equal to the scan on a tie-rich DAG
    whose counts saturate inside the closures."""
    import jax
    import jax.numpy as jnp

    from alignasm_tpu.ops.dense import (
        _blocked_dp, dense_solve_wire_topo_nxt16_blocked_ragged,
        dense_solve_wire_topo_nxt16_ragged,
    )

    V, Bk = 256, 64
    arr = jnp.zeros((V + 1, V), jnp.int32)
    jaxpr = jax.make_jaxpr(lambda x: _blocked_dp(x, V, Bk))(arr)

    def dots(jx):  # every dot_general, loop bodies included
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                yield eqn
            for v in eqn.params.values():
                for sub in v if isinstance(v, (tuple, list)) else (v,):
                    sub = getattr(sub, "jaxpr", sub)
                    if hasattr(sub, "eqns"):
                        yield from dots(sub)

    found = list(dots(jaxpr.jaxpr))
    assert found, "no count-closure matmul traced"
    for eqn in found:
        assert [v.aval.dtype for v in eqn.invars] == [jnp.bfloat16] * 2
        assert eqn.params["preferred_element_type"] == jnp.float32
        assert eqn.outvars[0].aval.dtype == jnp.float32

    w = _rand_wire(2, V, 0.6, 17)
    ref = np.asarray(dense_solve_wire_topo_nxt16_ragged(w, B=2, V=V))
    got = np.asarray(
        dense_solve_wire_topo_nxt16_blocked_ragged(w, B=2, V=V, Bk=Bk))
    assert (ref == got).all()


@pytest.mark.chip
@pytest.mark.parametrize("V,B,Bk", [(1024, 8, 128), (8192, 1, 256)])
def test_blocked_matches_scan_on_card(gpu, V, B, Bk):
    """On the card, at the production big-V shapes, the blocked kernel's
    rows are bit-equal to the reverse-topo scan's."""
    from alignasm_tpu.ops.dense import (
        dense_solve_wire_topo_nxt16_blocked_ragged,
        dense_solve_wire_topo_nxt16_ragged,
    )

    w = _rand_wire(B, V, 4.0 / V, 5)
    ref = np.asarray(dense_solve_wire_topo_nxt16_ragged(w, B=B, V=V))
    got = np.asarray(
        dense_solve_wire_topo_nxt16_blocked_ragged(w, B=B, V=V, Bk=Bk))
    assert (ref == got).all()


@pytest.mark.parametrize("V,B,want", [
    (512, 1, 256), (8192, 1, 256), (512, 2, 128), (1024, 8, 128),
    (8192, 8, 128), (256, 1, 256), (128, 1, 128),
])
def test_blocked_bk_rule(V, B, want):
    """The big-V bucket's block size: 256 for one slab, 128 for a batch,
    never more than V (the kernel needs V % Bk == 0)."""
    from alignasm_tpu.runtime.scheduler import _blocked_bk

    assert _blocked_bk(V, B) == want
    assert V % _blocked_bk(V, B) == 0
