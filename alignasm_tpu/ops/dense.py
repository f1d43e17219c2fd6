"""Production dense relaxation program for device buckets.

The device fast path (engine/device.py:finish_contig) only consumes:

  d_s, d_a   — per-vertex min (score-sum, anomaly) key to dest
  floor_a    — min possible anomaly count (Dial BFS analogue)
  cnt_tot    — saturating walk count
  cnt_min    — walks achieving (d_s, d_a) at src (tie-group size)

and reconstructs the unique best path on host by following achieving
edges (unique whenever cnt_min == 1, the only case the fast path
handles).  The mapq-fraction and arrival-rank tie-break components of
the full ``PafDistance`` order (paf_data.hpp:146-158) influence WHICH
tree edge the reference stores, but never these five quantities — so
the production kernel drops them entirely: a contig is two dense
(V, V) int32 matrices (score sum, anomaly; INF32 = no edge), and one
relaxation sweep is a broadcast add + row-min — no gathers, no scatter,
no segment ops.  Three of the five matrices of the full formulation
(score, anomaly, mapq numerator/total, arrival rank) are gone.

Dense min-plus trades redundant work (V^2 vs E lanes) for regularity
(see PAPERS.md, the tensorized-APSP literature).

Walk counts are adjacency-matrix powers: cnt' = base + A @ cnt with
saturation at the reference's k budget + 1 (values stay far below
int32: V * 10001 < 2^31).

Parity: d[]'s (sum, anom) components of shortest_path_dag
(k_shortest_walks.hpp:160-175), k_weighted_bfs (k_weighted_bfs.hpp:16),
and the walk-count semantics of the tie sweep (paf_data.cpp:1595-1611);
validated against the host engine and ops/relax.py in tests/test_dense.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

INF32 = np.int32(2**30)
COUNT_SAT = np.int32(10_001)
I16_INF = np.int32(16_384)  # int16-safe "infinity" for compact rows
ANOM_SHIFT = 28  # edge anomaly (<= 3) packed above the 28-bit score

DENSE_ROWS = ("d_s", "d_a", "floor_a", "cnt_tot", "cnt_min")


def _densify_wire(wire, V):
    """Scatter the sparse wire into (B, V+1, V) slabs on device — THE
    layout contract with the native exporter (export.cc:aln_export_wire):
    rows 0..V-1 are the dense score|anom<<28 matrix (INF32 = no edge),
    row V holds [dest, src, ...], and flat index V*(V+1) is the trash
    cell padding slots point at.  Single definition shared by every
    wire entry point so the format cannot desync between the production
    and parity-test paths."""
    idx = wire[:, 0]
    val = wire[:, 1]

    def one(i, v):
        flat = jnp.full((V * (V + 1) + 1,), INF32, jnp.int32).at[i].set(v)
        return flat[: V * (V + 1)].reshape(V + 1, V)

    return jax.vmap(one)(idx, val)


@functools.partial(jax.jit, static_argnames=("V", "n_sweeps"))
def dense_solve_wire(wire, V, n_sweeps):
    """Batched dense solve from the SPARSE wire format — the production
    transport: host->device moves one (B, 2, W) int32 tensor holding
    per-edge (flat cell index u*V+v, score|anom<<28) pairs plus
    (V*V, dest) and (V*V+1, src) entries; padding slots point at a
    trash cell past the matrix.  A batched scatter densifies on device;
    the wire is ~16x smaller than the dense matrices it expands to.

    Returns (B, 2V + 4) int32 rows: [d_s (V), d_a (V), floor_a@src,
    cnt_tot@src, cnt_min@src, src] — the walk counts and the anomaly
    floor are only consumed AT src (engine/device.py finish contract),
    so the device->host result is ~60% smaller than the (5, V) stack."""
    packed = _densify_wire(wire, V)
    return jax.vmap(lambda arr: solve_slab(arr, V, n_sweeps))(packed)


@functools.partial(jax.jit, static_argnames=("V",))
def dense_solve_wire_topo(wire, V):
    """Production batched solve from the TOPO-RELABELED sparse wire
    (native export.cc:aln_export_wire): same transport as
    ``dense_solve_wire``, but the host relabeled vertices into a
    topological order (every edge's flat cell has row < col), so all
    five suffix DPs — the (sum, anom) lex shortest path, the anomaly
    floor, and both walk counts — resolve in ONE reverse scan of V
    steps (each O(B*V) work) instead of ``n_sweeps`` O(B*V^2) full
    relaxation sweeps: ~n_sweeps x less compute AND no per-shape
    ``n_sweeps`` recompile axis.  When step u runs, every successor
    (higher index) is final, so each value is written exactly once —
    the fixed point the sweep kernels iterate toward; outputs are
    bit-equal (tests/test_dense.py::test_topo_scan_matches_sweeps).

    Returns (B, 2V + 4) int32 rows in the relabeled numbering:
    [d_s (V), d_a (V), floor_a@src, cnt_tot@src, cnt_min@src, src_pos];
    the C++ finish un-permutes via the stored Kahn positions."""
    packed = _densify_wire(wire, V)
    return jax.vmap(lambda arr: solve_slab_topo(arr, V))(packed)


def _topo_scan(arr, V):
    """One contig's production math on a topo-ordered (V+1, V) slab:
    a single reverse-topological scan.  Requires every edge (u, v) to
    satisfy u < v in the slab numbering (dest may sit anywhere — its
    row is guarded, not skipped).  Value parity with solve_slab is the
    standard DAG-DP argument: the sweep kernels' fixed point assigns
    each vertex the value computed from its successors' finals, which
    is exactly what this scan writes (successors are final when their
    predecessor's step runs, because edges only point to higher
    indices).  Also records nxt[u] — the lowest-index achieving
    successor (-1 if none / u == dest), which is THE unique min-walk
    edge whenever cnt_min[u] == 1 (each achieving edge contributes
    cnt_min >= 1), i.e. exactly the contigs the fast finish handles."""
    wsa = arr[:V]
    dest = arr[V, 0]
    src = arr[V, 1]
    mask = jnp.int32((1 << ANOM_SHIFT) - 1)

    s0 = jnp.full((V,), INF32, jnp.int32).at[dest].set(0)
    ct0 = jnp.zeros((V,), jnp.int32).at[dest].set(1)
    init = (s0, jnp.zeros((V,), jnp.int32), s0, ct0, ct0,
            jnp.full((V,), -1, jnp.int32))

    def step(t, st):
        s, a, fa, ct, cm, nxt = st
        u = V - 1 - t
        row = jax.lax.dynamic_slice_in_dim(wsa, u, 1, 0)[0]
        edge = row != INF32
        ws = row & mask
        wa = jax.lax.shift_right_logical(row, jnp.int32(ANOM_SHIFT))
        cs = jnp.where(edge, ws + s, INF32)
        m1 = jnp.min(cs)
        on = edge & (cs == m1)
        m2 = jnp.min(jnp.where(on, wa + a, INF32))
        reach = m1 < INF32
        s_u = jnp.where(reach, m1, INF32)
        a_u = jnp.where(reach, m2, 0)
        fa_u = jnp.min(jnp.where(edge, wa + fa, INF32))
        ct_u = jnp.minimum(
            jnp.sum(jnp.where(edge, ct, 0), dtype=jnp.int32), COUNT_SAT)
        # achieving edges off the just-final (s_u, a_u) — cnt_min in the
        # same scan (the sweep form needs a second loop AFTER s, a fix)
        ach = edge & (s < INF32) & (ws + s == s_u) & (wa + a == a_u)
        cm_u = jnp.minimum(
            jnp.sum(jnp.where(ach, cm, 0), dtype=jnp.int32), COUNT_SAT)
        nxt_u = jnp.where(ach.any(), jnp.argmax(ach).astype(jnp.int32),
                          jnp.int32(-1))
        keep = u == dest  # dest's base values are the DP anchors

        def upd(vec, x):
            return vec.at[u].set(jnp.where(keep, vec[u], x))

        return (upd(s, s_u), upd(a, a_u), upd(fa, fa_u),
                upd(ct, ct_u), upd(cm, cm_u), upd(nxt, nxt_u))

    return jax.lax.fori_loop(0, V, step, init), dest, src


def solve_slab_topo(arr, V):
    """Full-DP-row form of the topo scan (parity testing vs the sweep
    kernels); production uses solve_slab_topo_nxt."""
    (s, a, fa, ct, cm, _nxt), dest, src = _topo_scan(arr, V)
    return jnp.concatenate([
        s, a, jnp.stack([fa[src], ct[src], cm[src], src]),
    ])


def solve_slab_topo_nxt(arr, V):
    """Production compact form: ship the achieving-successor array
    itself as an int16 row

        [nxt (V entries, dest-encoded), floor_a@src, cnt_tot@src,
         cnt_min@src, d_a@src, src]                       (V + 5,)

    and let the C++ finish chase the min-walk path from src on host
    (nanoseconds).  Chasing ON DEVICE would be a second V-step
    sequential scan.  nxt[u] is
    the lowest-index achieving successor (strictly > u in the topo
    numbering, so a host chase always terminates in <= V steps); -1
    ("no achieving edge") is encoded as dest — the host only follows
    nxt along a path cnt_min == 1 proves achieving-complete, and the
    dest encoding keeps entries unsigned-friendly.  All payloads fit
    int16: nxt entries < V <= 2048, counts saturate at 10001, and
    anomaly sums are <= 3*(V-1) whenever src reaches dest — which
    cnt_min == 1 (the only case the C++ fast finish consumes the
    nxt/anomaly fields in) guarantees; infinities are clamped to
    I16_INF."""
    (s, a, fa, ct, cm, nxt), dest, src = _topo_scan(arr, V)
    clamp = jnp.int32(I16_INF)
    tail = jnp.stack([jnp.minimum(fa[src], clamp), ct[src],
                      jnp.minimum(cm[src], clamp),
                      jnp.minimum(a[src], clamp), src])
    return jnp.concatenate(
        [jnp.where(nxt < 0, dest, nxt), tail]).astype(jnp.int16)


@functools.partial(jax.jit, static_argnames=("V",))
def dense_solve_wire_topo_nxt(wire, V):
    """Batched production solve returning compact int16 nxt rows; see
    dense_solve_wire_topo for the wire format and solve_slab_topo_nxt
    for the row layout."""
    packed = _densify_wire(wire, V)
    return jax.vmap(lambda arr: solve_slab_topo_nxt(arr, V))(packed)


def solve_slab_topo_nxt8(arr, V):
    """uint8 production row for V <= 256: the host finish consumes
    floor_a/cnt_tot/cnt_min/d_a ONLY through the order-insensitivity
    gate

        fast = (cnt_min == 1) and not (cnt_tot >= 2 and d_a != floor_a)

    so evaluate the gate ON DEVICE in exact int32 (no clamping at any
    V — the int16 row's I16_INF clamps and their V-bound disappear) and
    ship just

        [nxt (V entries, dest-encoded), fast, src]        (V + 2,) uint8

    nxt entries and src are topo positions < V <= 256, so they fit
    uint8 exactly.  Same D2H size as shipping the chased path, but no
    on-device chase scan (see solve_slab_topo_nxt)."""
    (s, a, fa, ct, cm, nxt), dest, src = _topo_scan(arr, V)
    fast = (cm[src] == 1) & ~((ct[src] >= 2) & (a[src] != fa[src]))
    tail = jnp.stack([fast.astype(jnp.int32), src])
    return jnp.concatenate(
        [jnp.where(nxt < 0, dest, nxt), tail]).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("V",))
def dense_solve_wire_topo_nxt8(wire, V):
    """Batched production solve returning (B, V + 2) uint8 rows with the
    on-device order-insensitivity gate; see solve_slab_topo_nxt8."""
    assert V <= 256, "uint8 nxt entries require V <= 256"
    packed = _densify_wire(wire, V)
    return jax.vmap(lambda arr: solve_slab_topo_nxt8(arr, V))(packed)


def solve_slab_topo_nxt16(arr, V):
    """int16 production row for 256 < V <= 32767 — the single-chip
    big-contig path (a 5,000-record contig's DAG has ~6,400 vertices).
    Same shape of idea as solve_slab_topo_nxt8: the order-insensitivity
    gate is evaluated ON DEVICE in exact int32, so no clamped DP value
    is ever shipped (the V+5 int16 row's I16_INF clamps bounded
    soundness at V <= 5461; this row has no DP fields at all) and the
    row is just

        [nxt (V entries, dest-encoded), fast, src]        (V + 2,) int16

    nxt entries and src are topo positions < V <= 32767: int16-exact."""
    (s, a, fa, ct, cm, nxt), dest, src = _topo_scan(arr, V)
    fast = (cm[src] == 1) & ~((ct[src] >= 2) & (a[src] != fa[src]))
    tail = jnp.stack([fast.astype(jnp.int32), src])
    return jnp.concatenate(
        [jnp.where(nxt < 0, dest, nxt), tail]).astype(jnp.int16)


@functools.partial(jax.jit, static_argnames=("V",))
def dense_solve_wire_topo_nxt16(wire, V):
    """Batched production solve returning (B, V + 2) int16 gate rows
    for 256 < V <= 32767; see solve_slab_topo_nxt16."""
    assert V <= 32767, "int16 nxt entries require V <= 32767"
    packed = _densify_wire(wire, V)
    return jax.vmap(lambda arr: solve_slab_topo_nxt16(arr, V))(packed)


def _count_dot(x, y):
    """Product of two {0, 1, 2}-valued count operands, stated precision:
    bfloat16 operands (exact for these values) with float32 accumulation
    (every product <= 4, every sum <= 4 * Bk < 2^24, so exact too).  On
    the GPU this is a tensor-core product that gives the same bits as a
    HIGHEST-precision float32 product, without TF32 rounding."""
    return jnp.matmul(x.astype(jnp.bfloat16), y.astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32)


def _blocked_dp(arr, V, Bk=128):
    """Blocked big-V solve — the tropical triangular-solve formulation
    The reverse-topo scan (_topo_scan) is V sequential steps, each a
    few small dependent operations, so at large V the step latency, not
    memory, bounds it.  This kernel cuts the sequential depth from V to
    (V/Bk) * log2(Bk):

    * vertices partition into V/Bk diagonal blocks, processed last to
      first (edges only point low -> high in the topo numbering);
    * per block, a dense (Bk, V) PANEL reduction folds the
      already-final suffix state into per-vertex external candidates —
      bulk elementwise work, one read of the block's slab rows;
    * the (Bk, Bk) intra-block dependency is resolved by a LOG-DEPTH
      path-doubling closure: (I + A)^Bk via log2(Bk) min-plus matrix
      squarings (idempotent min makes repeated squaring exact), then
      one min-plus mat-vec applies it to the external candidates.

    The five DPs decompose into scalar solves (no two-component lex
    semiring in any closure):

      1. s  — min-plus on score weights;
      2. a  — min-plus on anomaly weights over the s-ACHIEVING subgraph
              (the lex DP's second component recurses only through
              s-achieving edges: _topo_scan's ``on`` mask), which is
              known as soon as the block's s values are final;
      3. fa — min-plus on anomaly weights over all edges;
      4. ct — path counting over all edges, SATURATED AT 2: the gate
              consumes counts only through (cnt_min == 1) and
              (cnt_tot >= 2), and min(x, 2) is a quotient-semiring
              homomorphism for the {0, 1, >=2} abstraction, so the
              closure becomes exact small-int tensor-core matmuls
              (P' = P + Q @ P, Q' = Q @ Q with clamping): operands in
              {0, 1, 2} are exact in bfloat16, and with float32
              accumulation (products <= 4, sums <= 4*Bk < 2^24) so is
              every sum — see _count_dot;
      5. cm — the same counting solve over the (s, a)-achieving mask.

    nxt (lowest-index achieving successor) needs no recursion at all
    once s and a are final: one vectorized argmax per block row.

    Overflow discipline: closure entries clamp at INFH = INF32 - 2^28
    (real path sums are < 2^27 by the device-eligibility envelope, so
    the clamp never touches a real value), panel candidates clamp at
    INF32, and every add stays < 2^31.  Anomaly solves use the INFA
    domain (sums <= 3*(V-1) < 2^15).

    Output is BIT-EQUAL to solve_slab_topo_nxt16 (same [nxt
    (dest-encoded), fast, src] int16 row); parity is a fixed-point
    argument per solve plus the count-abstraction homomorphism
    (tests/test_dense.py::test_blocked_matches_scan)."""
    assert V % Bk == 0 and V >= Bk
    nb = V // Bk
    nlev = max(1, (Bk - 1).bit_length())  # closure covers paths < 2^nlev >= Bk
    wsa = arr[:V]
    dest = jnp.reshape(arr[V : V + 1, 0:1], ())
    src = jnp.reshape(arr[V : V + 1, 1:2], ())
    maskc = jnp.int32((1 << ANOM_SHIFT) - 1)
    INFH = jnp.int32(INF32 - (1 << ANOM_SHIFT))
    INFA = jnp.int32(1 << 20)
    INFAH = jnp.int32((1 << 20) - 16)

    vidx = jax.lax.broadcasted_iota(jnp.int32, (V, 1), 0)[:, 0]
    bidx = jax.lax.broadcasted_iota(jnp.int32, (Bk, 1), 0)[:, 0]
    on_dest = vidx == dest
    zero = jnp.int32(0)
    b_s = jnp.where(on_dest, zero, INF32)
    b_a = jnp.where(on_dest, zero, INFA)
    b_c = jnp.where(on_dest, jnp.int32(1), zero)
    eye = bidx[:, None] == bidx[None, :]

    def mp_closure(A, inf_h):
        """(I + A)^Bk in min-plus via log-depth squaring; A entries
        pre-clamped at inf_h ("no path")."""
        M0 = jnp.where(eye, jnp.int32(0), A)

        def sq(_, M):
            return jnp.minimum(
                jnp.min(M[:, :, None] + M[None, :, :], axis=1), inf_h)

        return jax.lax.fori_loop(0, nlev, sq, M0)

    def cnt_closure(adj):
        """P[i,k] = #paths i->k within the block (incl. empty), values
        abstracted to {0, 1, 2}; exact matmuls (see _count_dot)."""
        A0 = adj.astype(jnp.bfloat16)
        P0 = eye.astype(jnp.bfloat16)  # P_m = sum_{l < 2^m} A^l; P_0 = I

        def dbl(_, st):
            P, Q = st  # Q = A^(2^m): P_{m+1} = P_m + Q P_m (unique
            # split at the length-2^m prefix), Q doubles by squaring
            P2 = jnp.minimum(P + _count_dot(Q, P), 2.0)
            Q2 = jnp.minimum(_count_dot(Q, Q), 2.0)
            return P2.astype(jnp.bfloat16), Q2.astype(jnp.bfloat16)

        P, _ = jax.lax.fori_loop(0, nlev, dbl, (P0, A0))
        return P

    init = (b_s, jnp.zeros((V,), jnp.int32), b_s, b_c, b_c,
            jnp.full((V,), -1, jnp.int32))

    def block_step(t, st):
        s, a, fa, ct, cm, nxt = st
        lo = (nb - 1 - t) * Bk
        R = jax.lax.dynamic_slice_in_dim(wsa, lo, Bk, 0)  # (Bk, V)
        rid = lo + bidx
        # dest's outgoing row is guarded in the scan (keep): mask it
        R = jnp.where((rid == dest)[:, None], INF32, R)
        edge = R != INF32
        ws = R & maskc
        wa = jax.lax.shift_right_logical(R, jnp.int32(ANOM_SHIFT))
        tail = (vidx >= lo + Bk)[None, :]
        e_tail = edge & tail

        def blk(vec):
            return jax.lax.dynamic_slice_in_dim(vec, lo, Bk, 0)

        def incols(mat):
            return jax.lax.dynamic_slice(mat, (0, lo), (Bk, Bk))

        e_in = incols(edge) & ~eye  # strictly upper triangular
        ws_in = incols(ws)
        wa_in = incols(wa)

        # --- 1. s: min-plus on scores --------------------------------
        ps = jnp.minimum(
            jnp.min(jnp.where(e_tail, ws + s[None, :], INF32), axis=1),
            blk(b_s))
        Ms = mp_closure(jnp.where(e_in, jnp.minimum(ws_in, INFH), INFH),
                        INFH)
        xs = jnp.min(Ms + ps[None, :], axis=1)
        xs = jnp.where(xs >= INFH, INF32, xs)

        # --- 2. a: min-plus on anomalies over the s-achieving graph --
        s_upd = jax.lax.dynamic_update_slice_in_dim(s, xs, lo, 0)
        ach = e_tail & (s[None, :] < INF32) & (ws + s[None, :] == xs[:, None])
        pa = jnp.minimum(
            jnp.min(jnp.where(ach, wa + a[None, :], INFA), axis=1),
            blk(b_a))
        ach_in = e_in & (xs[None, :] < INF32) \
            & (ws_in + xs[None, :] == xs[:, None])
        Ma = mp_closure(jnp.where(ach_in, wa_in, INFAH), INFAH)
        xa = jnp.min(Ma + pa[None, :], axis=1)
        xa = jnp.where(xs < INF32, xa, jnp.int32(0))  # scan: a_u = 0 if unreachable

        # --- 3. fa: min-plus on anomalies over all edges --------------
        pfa = jnp.minimum(
            jnp.min(jnp.where(e_tail, wa + jnp.minimum(fa, INFA)[None, :],
                              INFA), axis=1),
            blk(b_a))
        Mf = mp_closure(jnp.where(e_in, wa_in, INFAH), INFAH)
        xfa = jnp.min(Mf + pfa[None, :], axis=1)
        xfa = jnp.where(xfa >= INFAH, INF32, xfa)

        # --- 4. ct: {0,1,2+} path counting over all edges -------------
        pct = jnp.minimum(
            blk(b_c) + jnp.sum(jnp.where(e_tail, ct[None, :], jnp.int32(0)),
                               dtype=jnp.int32, axis=1), 2)
        Pct = cnt_closure(e_in)
        xct = jnp.minimum(_count_dot(Pct, pct), 2.0).astype(jnp.int32)

        # --- 5. cm: counting over the (s, a)-achieving mask ------------
        a_upd = jax.lax.dynamic_update_slice_in_dim(a, xa, lo, 0)
        ach2 = ach & (wa + a[None, :] == xa[:, None])
        ach2_in = ach_in & (wa_in + xa[None, :] == xa[:, None])
        pcm = jnp.minimum(
            blk(b_c) + jnp.sum(jnp.where(ach2, cm[None, :], jnp.int32(0)),
                               dtype=jnp.int32, axis=1), 2)
        Pcm = cnt_closure(ach2_in)
        xcm = jnp.minimum(_count_dot(Pcm, pcm), 2.0).astype(jnp.int32)

        # --- nxt: lowest-index achieving successor (no recursion) -----
        ach_full = edge & (s_upd[None, :] < INF32) \
            & (ws + s_upd[None, :] == xs[:, None]) \
            & (wa + a_upd[None, :] == xa[:, None])
        xnxt = jnp.where(ach_full.any(axis=1),
                         jnp.argmax(ach_full, axis=1).astype(jnp.int32),
                         jnp.int32(-1))

        def upd(vec, x):
            return jax.lax.dynamic_update_slice_in_dim(vec, x, lo, 0)

        return (s_upd, upd(a, xa), upd(fa, xfa), upd(ct, xct),
                upd(cm, xcm), upd(nxt, xnxt))

    st = jax.lax.fori_loop(0, nb, block_step, init)
    return st, dest, src


def solve_slab_topo_nxt16_blocked(arr, V, Bk=128):
    """int16 [nxt (dest-encoded), fast, src] row from the blocked DP —
    bit-equal to solve_slab_topo_nxt16 (see _blocked_dp)."""
    (s, a, fa, ct, cm, nxt), dest, src = _blocked_dp(arr, V, Bk)
    vidx = jax.lax.broadcasted_iota(jnp.int32, (V, 1), 0)[:, 0]

    def pick(vec):  # vec[src] without a dynamic scalar gather
        return jnp.sum(jnp.where(vidx == src, vec, jnp.int32(0)),
                       dtype=jnp.int32)

    fast = (pick(cm) == 1) & ~((pick(ct) >= 2) & (pick(a) != pick(fa)))
    tail16 = jnp.stack([fast.astype(jnp.int32), src])
    return jnp.concatenate(
        [jnp.where(nxt < 0, dest, nxt), tail16]).astype(jnp.int16)


@functools.partial(jax.jit, static_argnames=("B", "V", "Bk"))
def dense_solve_wire_topo_nxt16_blocked_ragged(wire, B, V, Bk=128):
    """Batched blocked big-V solve from the ragged wire — the
    production path for V >= 512 buckets (bit-equal rows to
    dense_solve_wire_topo_nxt16_ragged; see solve_slab_topo_nxt16_blocked)."""
    assert V <= 32767, "int16 nxt entries require V <= 32767"
    packed = _densify_wire_ragged(wire, B, V)
    return jax.vmap(
        lambda arr: solve_slab_topo_nxt16_blocked(arr, V, Bk))(packed)


def _densify_wire_ragged(wire, B, V):
    """Scatter the RAGGED wire into (B, V+1, V) slabs on device — the
    layout contract with export.cc:aln_export_wire_ragged: one (2, capN)
    int32 stream, row 0 global flat indices b*V*(V+1) + cell (cell as in
    _densify_wire), row 1 packed values; padding points at the trash
    cell B*V*(V+1).  ONE batched scatter for the whole bucket, and the
    transport carries no per-contig W padding (~2-3x fewer H2D bytes at
    scale than the (B, 2, W) form)."""
    M = V * (V + 1)
    flat = jnp.full((B * M + 1,), INF32, jnp.int32).at[wire[0]].set(wire[1])
    return flat[: B * M].reshape(B, V + 1, V)


@functools.partial(jax.jit, static_argnames=("B", "V"))
def dense_solve_wire_topo_nxt_ragged(wire, B, V):
    """Batched production solve from the ragged wire returning compact
    int16 nxt rows (solve_slab_topo_nxt layout)."""
    packed = _densify_wire_ragged(wire, B, V)
    return jax.vmap(lambda arr: solve_slab_topo_nxt(arr, V))(packed)


@functools.partial(jax.jit, static_argnames=("B", "V"))
def dense_solve_wire_topo_nxt8_ragged(wire, B, V):
    """Batched production solve from the ragged wire returning
    (B, V + 2) uint8 rows with the on-device order-insensitivity gate
    (solve_slab_topo_nxt8)."""
    assert V <= 256, "uint8 nxt entries require V <= 256"
    packed = _densify_wire_ragged(wire, B, V)
    return jax.vmap(lambda arr: solve_slab_topo_nxt8(arr, V))(packed)


@functools.partial(jax.jit, static_argnames=("B", "V"))
def dense_solve_wire_topo_nxt16_ragged(wire, B, V):
    """Batched production solve from the ragged wire returning
    (B, V + 2) int16 gate rows for 256 < V <= 32767 — the single-chip
    big-contig path (solve_slab_topo_nxt16)."""
    assert V <= 32767, "int16 nxt entries require V <= 32767"
    packed = _densify_wire_ragged(wire, B, V)
    return jax.vmap(lambda arr: solve_slab_topo_nxt16(arr, V))(packed)


def _densify_wire16(deltas, vidx, table, seeds, n_real, B, V):
    """Scatter the 16-BIT wire into (B, V+1, V) slabs on device — the
    layout contract with export.cc:aln_export_wire16: absolute cell i =
    cumsum(u16 deltas)[i] (per-contig cells are exported sorted, so
    every delta is a u16), value i = table[u16 vidx[i]] (the packed
    score|anom values are ~3.5 % unique, so a per-bucket dictionary
    halves the value stream).  HALF the H2D bytes of the i32 ragged
    wire.  Entries past ``n_real`` are redirected to the trash cell
    regardless of content; ``seeds`` adds the padding contigs' dest/src
    cells."""
    M = V * (V + 1)
    trash = B * M
    pos = jnp.cumsum(deltas.astype(jnp.int32))
    pos = jnp.where(
        jnp.arange(deltas.shape[0], dtype=jnp.int32) < n_real, pos, trash)
    val = table[vidx]
    flat = (jnp.full((B * M + 1,), INF32, jnp.int32)
            .at[pos].set(val)
            .at[seeds[0]].set(seeds[1]))
    return flat[: B * M].reshape(B, V + 1, V)


@functools.partial(jax.jit, static_argnames=("B", "V"))
def dense_solve_wire16_topo_nxt8(deltas, vidx, table, seeds, n_real, B, V):
    """Batched production solve from the 16-bit wire returning
    (B, V + 2) uint8 gate rows (solve_slab_topo_nxt8)."""
    assert V <= 255, "the 16-bit wire requires V*(V+1) <= 65535"
    packed = _densify_wire16(deltas, vidx, table, seeds, n_real, B, V)
    return jax.vmap(lambda arr: solve_slab_topo_nxt8(arr, V))(packed)


@functools.partial(jax.jit, static_argnames=("n_sweeps",))
def dense_solve_batch(ws, wa, dest, n_sweeps):
    """Batched (B, V, V) dense solve; returns (B, 5, V) int32 stacked
    [d_s, d_a, floor_a, cnt_tot, cnt_min] — one device->host transfer.

    ``ws``/``wa``: dense score-sum / anomaly edge matrices, INF32 where
    no edge exists; ``dest``: (B,) sink vertex per contig.
    ``n_sweeps`` must be >= the longest path length (host guarantees
    max records + 2, pow2-rounded).
    """
    B, V, _ = ws.shape

    def one(ws, wa, dest):
        return _solve_one(ws, wa, ws < INF32, dest, V, n_sweeps)

    return jax.vmap(one)(ws, wa, dest)


def _solve_one(ws, wa, edge, dest, V, n_sweeps):
    # dest-anchored init vectors via iota compare, not .at[].set
    vidx = jax.lax.broadcasted_iota(jnp.int32, (V, 1), 0)[:, 0]
    on_dest = vidx == dest
    # --- (sum, anom) lexicographic min to dest -------------------
    s0 = jnp.where(on_dest, jnp.zeros((V,), jnp.int32),
                   jnp.full((V,), INF32, jnp.int32))
    a0 = jnp.zeros((V,), jnp.int32)

    def sweep(_, st):
        s, a = st
        cs = jnp.where(edge, ws + s[None, :], INF32)
        m1 = jnp.min(cs, axis=1)
        on = edge & (cs == m1[:, None])
        ca = jnp.where(on, wa + a[None, :], INF32)
        m2 = jnp.min(ca, axis=1)
        better = (m1 < s) | ((m1 == s) & (m2 < a))
        better = better & (m1 < INF32)
        return jnp.where(better, m1, s), jnp.where(better, m2, a)

    s, a = jax.lax.fori_loop(0, n_sweeps, sweep, (s0, a0))

    # --- anomaly floor (min-plus on the anomaly weights) ---------
    wa_open = jnp.where(edge, wa, INF32)

    def fsweep(_, fa):
        c = jnp.where(edge, wa_open + fa[None, :], INF32)
        return jnp.minimum(fa, jnp.min(c, axis=1))

    fa = jax.lax.fori_loop(0, n_sweeps, fsweep, s0)

    # --- walk counts (saturating adjacency powers) ---------------
    base = jnp.where(on_dest, jnp.full((V,), 1, jnp.int32),
                     jnp.zeros((V,), jnp.int32))
    adj = jnp.where(edge, jnp.full((V, V), 1, jnp.int32),
                    jnp.zeros((V, V), jnp.int32))

    def csweep(_, c):
        return jnp.minimum(
            base + jnp.sum(adj * c[None, :], axis=1, dtype=jnp.int32),
            COUNT_SAT)

    cnt_tot = jax.lax.fori_loop(0, n_sweeps, csweep, base)

    # achieving edges: suffix optimality is forced by lex-additivity,
    # so the tie group at src is exactly the achieving-path count
    ach = (edge & (s[None, :] < INF32)
           & (ws + s[None, :] == s[:, None])
           & (wa + a[None, :] == a[:, None]))
    achm = ach.astype(jnp.int32)

    def msweep(_, c):
        return jnp.minimum(
            base + jnp.sum(achm * c[None, :], axis=1, dtype=jnp.int32),
            COUNT_SAT)

    cnt_min = jax.lax.fori_loop(0, n_sweeps, msweep, base)

    return jnp.stack([s, a, fa, cnt_tot, cnt_min])



def solve_slab(arr, V, n_sweeps):
    """The per-contig sweep math on one densified (V+1, V) slab
    (dense_solve_wire)."""
    wsa = arr[:V]
    dest = jnp.reshape(arr[V : V + 1, 0:1], ())
    src = jnp.reshape(arr[V : V + 1, 1:2], ())
    edge = wsa != INF32
    ws = wsa & jnp.int32((1 << ANOM_SHIFT) - 1)
    wa = jax.lax.shift_right_logical(wsa, jnp.int32(ANOM_SHIFT))
    out5 = _solve_one(ws, wa, edge, dest, V, n_sweeps)
    vidx = jax.lax.broadcasted_iota(jnp.int32, (V, 1), 0)[:, 0]
    at_src = vidx == src
    pick = lambda v: jnp.sum(jnp.where(at_src, v, 0), dtype=jnp.int32)
    return jnp.concatenate([
        out5[0], out5[1],
        jnp.stack([pick(out5[2]), pick(out5[3]), pick(out5[4]), src]),
    ])


def unpack_dense(stacked_row):
    """Per-contig dict view of one (5, V) stacked dense result, matching
    the finish_contig contract (no d_eid: the finish backtracks by
    achieving edges, unique when cnt_min == 1)."""
    return {k: stacked_row[j] for j, k in enumerate(DENSE_ROWS)}


def pack_dense_bucket(chunk, V: int):
    """Vectorized host packing of a bucket into (B, V, V) matrices.

    ``chunk`` is the scheduler's list of (contig index, PackedGraph).
    Returns (ws, wa, dests) or None if any contig has parallel edges
    between the same vertex pair (dense cells can hold one edge; the
    sparse kernel handles the rest) — builders never emit those, so
    this is a safety check, not a hot path.
    """
    B = len(chunk)
    bs, us, vs, ss, as_ = [], [], [], [], []
    dests = np.empty((B,), np.int32)
    for b, (_i, pg) in enumerate(chunk):
        n_e = len(pg.eu)
        if n_e:
            keys = pg.eu.astype(np.int64) * V + pg.ev
            if len(np.unique(keys)) != n_e:
                return None
        bs.append(np.full(n_e, b, np.int32))
        us.append(pg.eu)
        vs.append(pg.ev)
        ss.append(pg.es.astype(np.int32))
        as_.append(pg.ea)
        dests[b] = pg.g.dest
    ws = np.full((B, V, V), INF32, np.int32)
    wa = np.zeros((B, V, V), np.int32)
    b = np.concatenate(bs) if bs else np.empty(0, np.int32)
    u = np.concatenate(us) if us else np.empty(0, np.int32)
    v = np.concatenate(vs) if vs else np.empty(0, np.int32)
    ws[b, u, v] = np.concatenate(ss) if ss else []
    wa[b, u, v] = np.concatenate(as_) if as_ else []
    return ws, wa, dests
