"""Multi-chip parallelism over a jax.sharding.Mesh.

Two axes of scale (SURVEY.md §2.9/§5.7-5.8):
  * ``data`` — contig-batch data parallelism: the batched relaxation
    program is embarrassingly parallel over contigs (the TPU-native
    analogue of the reference's TBB parallel_for, alignasm.cpp:346-361).
    Sharding the batch dim over the mesh lets XLA run each shard's
    sweeps locally with zero communication.
  * ``graph`` — edge-sharded relaxation for 512 GB-class contig graphs
    (BASELINE.json configs[4]): each device holds an edge shard and
    sweeps exchange per-vertex running minima via lexicographic pmin
    collectives over ICI — the reference has no analogue (it simply
    demands a 512 GB host, README.md:25).

Why the two axes are separate 1D meshes rather than one static 2D mesh:
the phases are sequential (bucketed small contigs, then oversize ones)
and contigs are independent, so each phase gets ALL devices — a 1D
view per phase.  A static (data x graph) split would idle 1 - 1/n of
the machine in whichever phase doesn't use its axis.  Pipelining
several giants concurrently over disjoint submeshes only pays when a
dataset has many >graph_shard_min_records contigs AND host graph
construction stops being the bottleneck; revisit then.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from alignasm_tpu.ops.relax import INF, _qul_key, _pack_k1

# NamedSharding is re-exported for callers building data-axis specs; the
# production data-parallel sharding lives in runtime/scheduler.py
# (_solve_tpu_native sharding bucket batches over a 'data' mesh).
__all__ = ["Mesh", "NamedSharding", "P", "make_edge_sharded_sp",
           "solve_contig_sharded", "solve_contig_sharded_native"]


def make_edge_sharded_sp(mesh: Mesh, axis: str, V: int, n_sweeps: int):
    """Edge-sharded distance-to-sink: each device relaxes its own edge
    shard; per-sweep vertex minima merge with three masked pmin rounds
    (the lexicographic (k1, qul, rank) tie-break needs one collective
    per key).  Returns a jitted function over per-device edge shards.

    Shapes: all edge arrays (E,) get split on their leading dim across
    ``axis``; vertex state (V,) is replicated.
    """

    def local_min(vals, seg):
        return jax.ops.segment_min(vals, seg, num_segments=V)

    def step(_, carry):
        ds, da, dnz, dtot, drank, eu, ev, es, ea, enz, etot, erank, evalid = carry
        cs = ds[ev] + es
        ca = da[ev] + ea
        cnz = dnz[ev] + enz
        ctot = dtot[ev] + etot
        ok = evalid & (ds[ev] < INF)
        ck1 = jnp.where(ok, _pack_k1(cs, ca), INF)
        m1 = jax.lax.pmin(local_min(ck1, eu), axis)
        on1 = ok & (ck1 == m1[eu])
        ck2 = _qul_key(cnz, ctot)
        m2 = jax.lax.pmin(local_min(jnp.where(on1, ck2, INF), eu), axis)
        on2 = on1 & (ck2 == m2[eu])
        m3 = jax.lax.pmin(local_min(jnp.where(on2, erank, INF), eu), axis)
        cur1 = jnp.where(ds < INF, _pack_k1(ds, da), INF)
        cur2 = _qul_key(dnz, dtot)
        better = (m1 < cur1) | ((m1 == cur1) & (m2 < cur2)) | (
            (m1 == cur1) & (m2 == cur2) & (m3 < drank)
        )
        # gather the winning candidate locally, merge across shards
        win = on2 & (erank == m3[eu]) & better[eu]
        big = jnp.int64(2**62)
        pick = lambda c: jax.lax.pmin(local_min(jnp.where(win, c, big), eu), axis)
        ws, wa, wnz, wtot = pick(cs), pick(ca), pick(cnz), pick(ctot)
        got = better & (ws < big)
        ds = jnp.where(got, ws, ds)
        da = jnp.where(got, wa, da)
        dnz = jnp.where(got, wnz, dnz)
        dtot = jnp.where(got, wtot, dtot)
        drank = jnp.where(got, m3, drank)
        return ds, da, dnz, dtot, drank, eu, ev, es, ea, enz, etot, erank, evalid

    def sharded_sp(eu, ev, es, ea, enz, etot, erank, evalid, dest):
        ds = jnp.full((V,), INF, jnp.int64).at[dest].set(0)
        da = jnp.zeros((V,), jnp.int64)
        dnz = jnp.zeros((V,), jnp.int64)
        dtot = jnp.zeros((V,), jnp.int64)
        drank = jnp.full((V,), INF, jnp.int64).at[dest].set(-1)
        carry = (ds, da, dnz, dtot, drank,
                 eu, ev, es, ea, enz, etot, erank, evalid)
        carry = jax.lax.fori_loop(0, n_sweeps, step, carry)
        return carry[0], carry[1], carry[2], carry[3]

    sharded = jax.shard_map(
        sharded_sp,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
                  P(axis), P(axis), P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


_SHARDED_SP_CACHE: dict = {}


def _edge_sharded_sp_cached(mesh: Mesh, axis: str, V: int, n_sweeps: int):
    """make_edge_sharded_sp returns a fresh jax.jit wrapper per call;
    cache it on (mesh devices, axis, V, n_sweeps) so several oversize
    contigs with the same padded shapes share ONE compile."""
    key = (tuple(d.id for d in mesh.devices.flat), axis, V, n_sweeps)
    fn = _SHARDED_SP_CACHE.get(key)
    if fn is None:
        fn = _SHARDED_SP_CACHE[key] = make_edge_sharded_sp(
            mesh, axis, V=V, n_sweeps=n_sweeps)
    return fn


def _host_floor_counts(pg, d_s, d_a, max_count=10_001):
    """Exact anomaly floor and walk counts in one O(V + E) reverse-topo
    pass on host — the relaxation (O(E * sweeps) and the memory) is what
    the device mesh distributes; these gate quantities are a single
    cheap scan of the CSR."""
    import numpy as np

    from alignasm_tpu.engine.kshortest import topology_sort

    g = pg.g
    V = g.n_vertices
    INF_ = np.int64(2**62)
    fa = np.full(V, INF_)
    cnt_tot = np.zeros(V, np.int64)
    cnt_min = np.zeros(V, np.int64)
    fa[g.dest] = 0
    cnt_tot[g.dest] = 1
    cnt_min[g.dest] = 1
    for u in reversed(topology_sort(g.adj)):
        for v, w in g.adj[u]:
            if fa[v] < INF_:
                fa[u] = min(fa[u], fa[v] + w[2])
            if cnt_tot[v]:
                cnt_tot[u] = min(cnt_tot[u] + cnt_tot[v], max_count)
            if (cnt_min[v] and d_s[v] < INF_
                    and d_s[v] + w[0] + w[1] == d_s[u]
                    and d_a[v] + w[2] == d_a[u]):
                cnt_min[u] = min(cnt_min[u] + cnt_min[v], max_count)
    return fa, cnt_tot, cnt_min


def _pad_shapes(E, V, n, n_dev):
    """pow2-padded (Ep, Vp, n_sweeps): all three paddings bound the set
    of compiled shapes; Ep additionally rounds up to a mesh multiple
    (pow2 alone fails to shard on e.g. 6-device meshes)."""
    Ep = 1 << max(3, (E - 1).bit_length())
    Ep = ((Ep + n_dev - 1) // n_dev) * n_dev
    Vp = 1 << max(3, (V - 1).bit_length())
    n_sweeps = 1 << max(3, (n + 1).bit_length())
    return Ep, Vp, n_sweeps


def solve_contig_sharded_native(exporter, i, cfg, mesh: Mesh = None,
                                axis: str = "graph"):
    """Production graph-axis solve: contig ``i``'s DAG is built and its
    edge tables exported by the C++ host plane (threaded sparse-table
    build), the relaxation edge-shards
    over the device mesh, and the floor/counts/gate/finish run back in
    C++ (aln_finish_sharded), which stores the result in the exporter.
    No per-contig Python beyond array padding.  Returns True when the device-assisted fast finish ran."""
    import numpy as np

    if mesh is None:
        mesh = Mesh(np.array(jax.devices()), (axis,))
    n_dev = int(np.prod(mesh.devices.shape))

    exporter.build_graph_one(i)
    built, V, E, _src, dest, n = exporter.edge_meta(i)
    assert built
    eu, ev, es, ea, enz, etot, erank = exporter.export_edges(i)
    Ep, Vp, n_sweeps = _pad_shapes(E, V, n, n_dev)

    def padE(a, dtype, fill=0):
        out = np.full((Ep,), fill, dtype)
        out[:E] = a
        return out

    sp = _edge_sharded_sp_cached(mesh, axis, V=Vp, n_sweeps=n_sweeps)
    ds, da, _dnz, _dtot = sp(
        padE(eu, np.int32), padE(ev, np.int32), padE(es, np.int64),
        padE(ea, np.int32), padE(enz, np.int32), padE(etot, np.int32),
        padE(erank, np.int64), padE(np.ones(E, bool), bool, False),
        np.int32(dest),
    )
    # padded vertices have no edges: their d stays INF and cannot
    # influence real vertices — slice them off before the C++ finish
    return exporter.finish_sharded(i, np.asarray(ds)[:V], np.asarray(da)[:V])


def solve_contig_sharded(contig, cfg, mesh: Mesh = None, axis: str = "graph"):
    """Full per-contig solve with the relaxation EDGE-SHARDED over the
    device mesh — the 512 GB-class graph path (BASELINE.json configs[4]):
    each device holds 1/n of the edge tables and the per-sweep vertex
    minima merge over ICI with lexicographic pmin rounds.  The reference
    has no analogue (it demands a >512 GB host, README.md:25).

    Returns (out, alt_out, max_out), byte-faithful: the order-insensitive
    case finishes from the sharded d[]; anything walk-order-sensitive
    falls back to the exact engine on the already-built graph.

    This is the PYTHON-plane variant (parsed records in, results out)
    used by the test/fallback scheduler path; the production native
    plane routes through solve_contig_sharded_native, whose graph
    build, edge export, and finish all run in C++.
    """
    import numpy as np

    from alignasm_tpu.engine.device import (
        Fallback, finish_contig, finish_contig_exact, pack_graph,
    )
    from alignasm_tpu.engine.graph import build_graph

    if mesh is None:
        mesh = Mesh(np.array(jax.devices()), (axis,))
    n_dev = int(np.prod(mesh.devices.shape))

    g = build_graph(contig, cfg)
    pg = pack_graph(g)
    E = len(pg.eu)
    V = g.n_vertices
    Ep, Vp, n_sweeps = _pad_shapes(E, V, g.n, n_dev)

    def padE(a, dtype, fill=0):
        out = np.full((Ep,), fill, dtype)
        out[:E] = a
        return out

    sp = _edge_sharded_sp_cached(mesh, axis, V=Vp, n_sweeps=n_sweeps)
    ds, da, _dnz, _dtot = sp(
        padE(pg.eu, np.int32), padE(pg.ev, np.int32),
        padE(pg.es, np.int64), padE(pg.ea, np.int32),
        padE(pg.enz, np.int32), padE(pg.etot, np.int32),
        padE(pg.erank, np.int64), padE(np.ones(E, bool), bool, False),
        np.int32(g.dest),
    )
    # padded vertices have no edges: their d stays INF and cannot
    # influence real vertices — slice them off before the host finish
    d_s = np.asarray(ds)[:V]
    d_a = np.asarray(da)[:V]
    floor_a, cnt_tot, cnt_min = _host_floor_counts(pg, d_s, d_a)
    dev = {"d_s": d_s, "d_a": d_a, "floor_a": floor_a,
           "cnt_tot": cnt_tot, "cnt_min": cnt_min}
    try:
        return finish_contig(pg, dev, cfg, inf=int(2**62))
    except Fallback:
        return finish_contig_exact(pg, dev, cfg)
