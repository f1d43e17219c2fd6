"""int32 variant of the batched DAG relaxation program.

The packed-key kernels in ops/relax.py compare int64 keys; this
variant keeps every comparison in int32 while preserving exact
semantics: (sum, anom) compare as
two masked passes instead of one packed key (path sums must fit int32 —
the host guards per bucket and falls back to the int64 kernel
otherwise).  Only the (sum, anom) components are tracked: the device
finish consumes d_s/d_a/floor_a/cnt_tot/cnt_min and routes every
fraction/rank-order-sensitive contig to the host engines, so the
reference DP's lower-priority tie-break state never reaches this
kernel (ops/relax.py keeps the full-lex form).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

INF32 = jnp.int32(2**30)
COUNT_SAT = jnp.int32(10_001)


def _seg_min(vals, seg, num):
    return jax.ops.segment_min(vals, seg, num_segments=num)


def _seg_sum(vals, seg, num):
    return jax.ops.segment_sum(vals, seg, num_segments=num)


@functools.partial(jax.jit, static_argnames=("V", "n_sweeps"))
def sp_batch32(eu, ev, es, ea, evalid, src, dest, V, n_sweeps=None):
    """Phase 1: distance-to-sink, anomaly floor, walk counts (int32).

    Tracks only the (sum, anom) components: the device finish accepts a
    contig only when its min walk is UNIQUE (cnt_min == 1) and
    backtracks by (sum, anom) equality, so the mapq-fraction / arrival-
    rank tie-break state the reference's DP carries is dead weight here
    — any contig whose output could depend on it routes to the host
    engines.  (The fraction is a lower-priority lex key, so dropping it
    leaves d_s/d_a and the achieving-edge counts unchanged.)"""
    B, E = eu.shape
    if n_sweeps is None:
        n_sweeps = V

    def one(eu, ev, es, ea, evalid, src, dest):
        init = dict(
            s=jnp.full((V,), INF32).at[dest].set(0),
            a=jnp.zeros((V,), jnp.int32),
        )

        def sweep(_, st):
            cs = st["s"][ev] + es
            ca = st["a"][ev] + ea
            ok = evalid & (st["s"][ev] < INF32)
            k1 = jnp.where(ok, cs, INF32)
            m1 = _seg_min(k1, eu, V)
            on = ok & (k1 == m1[eu])
            m2 = _seg_min(jnp.where(on, ca, INF32), eu, V)
            better = (m1 < INF32) & (
                (m1 < st["s"]) | ((m1 == st["s"]) & (m2 < st["a"]))
            )
            return dict(
                s=jnp.where(better, m1, st["s"]),
                a=jnp.where(better, m2, st["a"]),
            )

        d = jax.lax.fori_loop(0, n_sweeps, sweep, init)

        # anomaly floor
        fa = jnp.full((V,), INF32).at[dest].set(0)

        def sweep_anom(_, fa):
            c = jnp.where(evalid & (fa[ev] < INF32), fa[ev] + ea, INF32)
            return jnp.minimum(fa, _seg_min(c, eu, V))

        fa = jax.lax.fori_loop(0, n_sweeps, sweep_anom, fa)

        # walk counts (saturating int32)
        base = jnp.zeros((V,), jnp.int32).at[dest].set(1)

        def sweep_cnt(_, c):
            return jnp.minimum(
                base + _seg_sum(jnp.where(evalid, c[ev], 0), eu, V), COUNT_SAT
            )

        cnt_tot = jax.lax.fori_loop(0, n_sweeps, sweep_cnt, base)

        ach = evalid & (d["s"][ev] < INF32) & (
            (d["s"][ev] + es == d["s"][eu]) & (d["a"][ev] + ea == d["a"][eu])
        )

        def sweep_cmin(_, c):
            return jnp.minimum(
                base + _seg_sum(jnp.where(ach, c[ev], 0), eu, V), COUNT_SAT
            )

        cnt_min = jax.lax.fori_loop(0, n_sweeps, sweep_cmin, base)

        # one stacked result -> ONE device-to-host transfer per bucket
        return jnp.stack([d["s"], d["a"], fa, cnt_tot, cnt_min])

    return jax.vmap(one)(eu, ev, es, ea, evalid, src, dest)


SP_ROWS = ("d_s", "d_a", "floor_a", "cnt_tot", "cnt_min")


def unpack_sp(stacked_row):
    """Per-contig dict view of one (5, V) stacked phase-1 result."""
    return {k: stacked_row[j] for j, k in enumerate(SP_ROWS)}

