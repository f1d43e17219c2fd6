"""Host-side contig scheduling.

The reference parallelizes with a TBB ``parallel_for`` over contigs
(alignasm.cpp:346-361); contigs share nothing, so this is task/data
parallelism.  Host equivalent: a process pool with dynamic chunking
(contig cost is heavily skewed by record count).  Device equivalent:
bucket-by-size batching feeding the device kernels (ops/, parallel/).
"""

from __future__ import annotations

import multiprocessing as mp
import os

from alignasm_tpu.config import AlignasmConfig
from alignasm_tpu.engine.exact import solve_contig

_WORKER_CFG = None


def _init_worker(cfg):
    global _WORKER_CFG
    _WORKER_CFG = cfg


def _solve_one(args):
    idx, contig = args
    return idx, solve_contig(contig, _WORKER_CFG)


def solve_dataset_parallel(dataset, cfg: AlignasmConfig, n_workers: int):
    """Solve all contigs with a process pool; output order preserved."""
    n = len(dataset.contigs)
    n_workers = max(1, min(n_workers, os.cpu_count() or 1))
    outs = [None] * n
    alt_outs = [None] * n
    max_outs = [None] * n
    # largest contigs first for load balance
    order = sorted(range(n), key=lambda i: -len(dataset.contigs[i]))
    with mp.Pool(n_workers, initializer=_init_worker, initargs=(cfg,)) as pool:
        for idx, (o, a, m) in pool.imap_unordered(
            _solve_one, ((i, dataset.contigs[i]) for i in order), chunksize=1
        ):
            outs[idx] = o
            alt_outs[idx] = a
            max_outs[idx] = m
    return outs, alt_outs, max_outs


def _next_pow2(x: int) -> int:
    return 1 << max(3, (x - 1).bit_length())


def device_platform(require_gpu: bool = True) -> dict:
    """The device the device path runs on, as JAX reports it, for the
    run's stats.  With ``require_gpu`` it raises where JAX's backend is
    not a GPU, unless the caller chose that platform through
    ``JAX_PLATFORMS`` (tests and rehearsals set ``JAX_PLATFORMS=cpu``):
    the device path never falls back to XLA:CPU unannounced."""
    import jax

    backend = jax.default_backend()
    chosen = os.environ.get("JAX_PLATFORMS", "").split(",")[0].strip()
    if require_gpu and backend != "gpu" and chosen != backend:
        raise RuntimeError(
            f"the device path needs a GPU, but JAX found only {backend!r} "
            f"(JAX_PLATFORMS={os.environ.get('JAX_PLATFORMS', '')!r}); set "
            f"JAX_PLATFORMS={backend} to run it there on purpose")
    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": jax.device_count()}


def _routing(cfg, model):
    """(mode, allow_device): "always" forces the bucket device pipeline,
    "never" the native plane, "auto" the device only where the device's
    own cost model (None: no calibration for this device) says some
    bucket can win."""
    mode = getattr(cfg, "device_routing", "always")
    allow = mode == "always" or (
        mode == "auto" and model is not None and model.any_possible_win())
    return mode, allow


def _cost_model_stats(model, model_prov) -> dict:
    return {**(model.summary() if model is not None else {}),
            "calibration": model_prov}


def solve_dataset_tpu(dataset, cfg: AlignasmConfig, batch_size: int = 256,
                      src_paths=None, write_prefix=None):
    """Batched device solve.

    The host plane builds + packs the contig DAGs — natively (C++) when
    ``src_paths=(paf, alt_or_None)`` is given, else in Python — groups
    them into padded buckets (shared static shapes → bounded
    recompiles), runs the batched relaxation program per bucket, then
    finishes each contig on host.  Contigs whose outcome is
    walk-order-sensitive (Fallback) or oversized run through the exact
    host engine — results are always byte-identical to the reference.

    The Python host plane (no ``src_paths``) is TEST/FALLBACK-ONLY: it
    exists so kernel tests and datasets without a source file can drive
    the device kernels, and as the visible degrade target when the
    native plane fails.  It is far slower than the C++ plane and is
    NOT the production wire format (the native plane's ragged wire is);
    production callers always pass ``src_paths``.
    """
    import numpy as np

    if src_paths is not None:
        # production path: C++ host plane end to end (parse -> build ->
        # dense pack -> device DP -> finish -> write), no per-contig
        # Python.  A native-plane failure must be VISIBLE: it degrades
        # to the Python plane below with a warning + recorded reason (a
        # silent degrade would hide a 30x slowdown behind identical
        # outputs).
        from alignasm_tpu import native
        from alignasm_tpu.runtime.costmodel import load_model_info

        # Routing policy: dispatch work to the device only when the
        # device's measured cost model predicts a win; otherwise "auto"
        # routes the whole corpus to the SAME fused native pipeline
        # --engine native uses, so this engine can never lose to it.
        # "always" keeps the bucket device pipeline (tests, fuzz
        # campaigns, kernel benches); "never" forces the native plane.
        model, model_prov = load_model_info()
        mode, allow_device = _routing(cfg, model)
        try:
            if not allow_device and write_prefix is not None:
                return _solve_native_routed(cfg, src_paths, write_prefix,
                                            model, mode, model_prov)
            return _solve_tpu_native(dataset, cfg, src_paths, write_prefix,
                                     allow_device=allow_device,
                                     model=model, mode=mode,
                                     model_prov=model_prov)
        except native.NativeError as exc:
            if dataset is None:
                raise  # no parsed dataset to degrade to — surface it
            import warnings

            warnings.warn(f"native host plane unavailable: {exc}",
                          RuntimeWarning, stacklevel=2)
            _solve_tpu_native.last_error = str(exc)

    # Python device plane (test/fallback-only, see docstring) — the
    # jax-importing modules load here so the fused-native route above
    # never pays the device stack's import cost
    from alignasm_tpu.engine.device import (
        Fallback, finish_contig, finish_contig_exact, pack_graph,
    )
    from alignasm_tpu.engine.exact import solve_contig
    from alignasm_tpu.engine.graph import build_graph
    from alignasm_tpu.ops.relax import solve_graph_batch

    from alignasm_tpu.runtime import ensure_jax_compile_cache

    ensure_jax_compile_cache()
    n = len(dataset.contigs)
    outs = [None] * n
    alt_outs = [None] * n
    max_outs = [None] * n
    stats = {"device": 0, "fallback": 0, "singleton": 0, "oversize": 0,
             "host_plane": "python", "fallback_reasons": {},
             **device_platform()}

    packed = []  # (contig index, PackedGraph)
    for i, contig in enumerate(dataset.contigs):
        if len(contig) == 1:
            # single source of truth for the singleton passthrough
            # (incl. its ctg_sorted_index bookkeeping): the exact solver
            outs[i], alt_outs[i], max_outs[i] = solve_contig(contig, cfg)
            stats["singleton"] += 1
            continue
        if len(contig) > cfg.max_device_records:
            import jax

            if (len(contig) >= cfg.graph_shard_min_records
                    and jax.device_count() > 1):
                # 512 GB-class contig: edge-shard the relaxation over
                # the device mesh (parallel/mesh.py)
                from alignasm_tpu.parallel.mesh import solve_contig_sharded

                outs[i], alt_outs[i], max_outs[i] = solve_contig_sharded(
                    contig, cfg
                )
                stats["graph_sharded"] = stats.get("graph_sharded", 0) + 1
            else:
                outs[i], alt_outs[i], max_outs[i] = solve_contig(contig, cfg)
            stats["oversize"] += 1
            continue
        packed.append((i, pack_graph(build_graph(contig, cfg))))

    from alignasm_tpu.ops.dense import (
        dense_solve_batch, pack_dense_bucket, unpack_dense,
    )
    from alignasm_tpu.ops.relax32 import sp_batch32, unpack_sp

    # int32 eligibility: every path sum is bounded by the sum over
    # vertices of their max outgoing edge score; guard well under the
    # int32 kernel's 2^30 sentinel.
    # (No mapq-fraction bound is needed any more: the int32 kernels
    # track only the exact-integer (sum, anom) components — fraction
    # tie-breaks never reach a device kernel.)
    def fits32(pg) -> bool:
        if len(pg.eu) == 0:
            return True
        seg_max = {}
        for u, s in zip(pg.eu.tolist(), pg.es.tolist()):
            if s > seg_max.get(u, -1):
                seg_max[u] = s
        return sum(seg_max.values()) < 2**29

    stats["int32_buckets"] = 0
    stats["dense_buckets"] = 0
    # bucket by padded shapes
    packed.sort(key=lambda t: (t[1].g.n_vertices, len(t[1].eu)))
    bucket_inputs = []
    for lo in range(0, len(packed), batch_size):
        chunk = packed[lo:lo + batch_size]
        B = len(chunk)
        V = _next_pow2(max(pg.g.n_vertices for _i, pg in chunk))
        E = _next_pow2(max(max(len(pg.eu), 1) for _i, pg in chunk))
        # pow2-rounded so bucket shapes (and XLA compiles) stay bounded
        n_sweeps = _next_pow2(max(pg.g.n for _i, pg in chunk) + 2)
        use32 = all(fits32(pg) for _i, pg in chunk)

        # dense formulation (ops/dense.py): the production kernel
        # for bucket-sized contigs — broadcast+row-min sweeps, no
        # gather/scatter.  Needs int32 scores and one edge per (u, v).
        if use32 and V <= cfg.dense_max_v:
            dense = pack_dense_bucket(chunk, V)
            if dense is not None:
                ws, wa, dests = dense
                bucket_inputs.append(dict(
                    chunk=chunk, B=B, V=V, n_sweeps=n_sweeps,
                    kind="dense", args=(ws, wa, dests),
                ))
                continue

        def pad(arrs, dtype, fill):
            out = np.full((B, E), fill, dtype)
            for b, a in enumerate(arrs):
                out[b, : len(a)] = a
            return out

        idt = np.int32 if use32 else np.int64
        eu = pad([pg.eu for _i, pg in chunk], np.int32, 0)
        ev = pad([pg.ev for _i, pg in chunk], np.int32, 0)
        es = pad([pg.es for _i, pg in chunk], idt, 0)
        ea = pad([pg.ea for _i, pg in chunk], np.int32, 0)
        evalid = np.zeros((B, E), bool)
        for b, (_i, pg) in enumerate(chunk):
            evalid[b, : len(pg.eu)] = True
        srcs = np.asarray([pg.g.src for _i, pg in chunk], np.int32)
        dests = np.asarray([pg.g.dest for _i, pg in chunk], np.int32)

        if use32:
            # the int32 kernel tracks only (sum, anom) — the finish
            # never consumes fraction/rank state (ops/relax32.py)
            args = (eu, ev, es, ea, evalid, srcs, dests)
        else:
            enz = pad([pg.enz for _i, pg in chunk], np.int32, 0)
            etot = pad([pg.etot for _i, pg in chunk], np.int32, 0)
            erank = pad([pg.erank for _i, pg in chunk], idt, 0)
            args = (eu, ev, es, ea, enz, etot, erank, evalid, srcs, dests)

        bucket_inputs.append(dict(
            chunk=chunk, B=B, V=V, n_sweeps=n_sweeps,
            kind="sparse32" if use32 else "sparse64",
            args=args,
        ))

    # with more than one device, shard the bucket batch dim over a data
    # mesh — contigs are independent, so XLA runs shards with zero
    # communication (the multi-device analogue of the reference's TBB
    # loop)
    import jax

    n_dev = jax.device_count()
    shard_batch = None
    if n_dev > 1:
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        mesh = Mesh(np.array(jax.devices()), ("data",))
        spec = NamedSharding(mesh, P("data"))

        def shard_batch(args):
            eu = args[0]
            B = eu.shape[0]
            padB = ((B + n_dev - 1) // n_dev) * n_dev
            if padB != B:
                args = tuple(
                    np.concatenate([a] + [a[-1:]] * (padB - B), axis=0)
                    for a in args
                )
            return tuple(jax.device_put(a, spec) for a in args), B

        stats["data_mesh_devices"] = n_dev

    # launch every phase-1 kernel before syncing any — buckets overlap
    # on device and transfer latency amortizes across the dataset
    for binp in bucket_inputs:
        args = binp["args"]
        binp["realB"] = binp["B"]
        if binp["kind"] == "dense":
            stats["dense_buckets"] += 1
            if shard_batch is not None:
                args, binp["realB"] = shard_batch(args)
            binp["pending"] = dense_solve_batch(
                *args, n_sweeps=binp["n_sweeps"]
            )
        elif binp["kind"] == "sparse32":
            stats["int32_buckets"] += 1
            if shard_batch is not None:
                args, binp["realB"] = shard_batch(args)
            binp["pending"] = sp_batch32(
                *args, V=binp["V"], n_sweeps=binp["n_sweeps"]
            )

    for binp in bucket_inputs:
        chunk = binp["chunk"]
        B = binp["B"]
        V = binp["V"]
        n_sweeps = binp["n_sweeps"]
        if binp["kind"] == "dense":
            stacked = np.asarray(binp["pending"])  # (B, 5, V): one transfer
            stacked = stacked[: binp["realB"]]     # drop mesh padding
            pers = [unpack_dense(stacked[b]) for b in range(B)]
            inf = 2**30
        elif binp["kind"] == "sparse32":
            stacked = np.asarray(binp["pending"])  # (B, 5, V): one transfer
            stacked = stacked[: binp["realB"]]     # drop mesh padding
            pers = [unpack_sp(stacked[b]) for b in range(B)]
            inf = 2**30
        else:
            eu, ev, es, ea, enz, etot, erank, evalid, srcs, dests = binp["args"]
            dev = solve_graph_batch(
                eu, ev, es, ea, enz, etot, erank, evalid, srcs, dests,
                V=V, n_sweeps=n_sweeps,
            )
            dev = {k: np.asarray(v) for k, v in dev.items()}
            pers = [{k: v[b] for k, v in dev.items()} for b in range(B)]
            inf = 2**62

        for b, (i, pg) in enumerate(chunk):
            per = pers[b]
            try:
                outs[i], alt_outs[i], max_outs[i] = finish_contig(
                    pg, per, cfg, inf=inf
                )
                stats["device"] += 1
            except Fallback as fb:
                # order-sensitive contig: finish with the exact engine's
                # real walk enumeration on the already-built graph
                outs[i], alt_outs[i], max_outs[i] = finish_contig_exact(
                    pg, per, cfg
                )
                stats["fallback"] += 1
                reason = str(fb)
                reasons = stats["fallback_reasons"]
                reasons[reason] = reasons.get(reason, 0) + 1

    solve_dataset_tpu.last_stats = stats
    return outs, alt_outs, max_outs


def _dense_buckets(order, n_v, dense_cells: int = 2**26,
                   merge_bonus: int = 2**23):
    """Partition `order` (contig indices sorted by vertex count) into
    (V, idxs) buckets: pow2-padded V per group, each bucket capped at
    ``dense_cells`` total matrix cells (<= 256 MB at the default).
    Every contig lands in exactly one bucket and every bucket satisfies
    n_v[idx] <= V.

    Adjacent V groups MERGE (the smaller group pads up) when the extra
    padding cells stay under ``merge_bonus``: every launch pays a fixed
    dispatch and transfer cost, so a bench-shaped dataset of small
    contigs should collapse into ONE launch.
    """
    groups = []  # (V, lo, hi)
    lo = 0
    while lo < len(order):
        V = _next_pow2(max(int(n_v[order[lo]]), 8))
        hi = lo
        while hi < len(order) and n_v[order[hi]] <= V:
            hi += 1
        groups.append((V, lo, hi))
        lo = hi

    merged = []
    for V, lo, hi in groups:
        if merged:
            pV, plo, phi = merged[-1]
            extra = (phi - plo) * (V * V - pV * pV)
            if extra <= merge_bonus and \
                    (hi - plo) * V * V <= max(dense_cells, V * V):
                merged[-1] = (V, plo, hi)
                continue
        merged.append((V, lo, hi))

    buckets = []
    for V, lo, hi in merged:
        cap = max(1, dense_cells // (V * V))
        for s in range(lo, hi, cap):
            idxs = order[s:min(s + cap, hi)]
            assert (n_v[idxs] <= V).all()
            buckets.append((V, idxs))
    return buckets


def _blocked_bk(V: int, B: int) -> int:
    """Diagonal block size of the blocked big-V kernel for a bucket of
    B slabs of V vertices, from ``devbench --bigv-sweep`` on the GPU
    (V 1024-8192, B 1-8, Bk 32-256; CHANGES.md): the kernel is a chain
    of short dependent steps, so the largest block — the shallowest
    chain — wins while its (B, Bk, Bk, Bk) min-plus squarings stay
    small: Bk=256 for a single slab, Bk=128 for a batch (where 256 ran
    ~10x slower)."""
    return min(256 if B == 1 else 128, V)


def _launch_buckets(buckets, n_edges, exporter, spec, n_dev, launches,
                    stats):
    """Export each bucket's sparse wire and dispatch its device program
    (async); appends 5-tuples ``(idxs, realB, V, pending, ok)`` to
    ``launches`` — ``ok`` is the per-contig export-accept mask when any
    contig was rejected (ragged wire), else None."""
    import jax
    import numpy as np

    from alignasm_tpu.ops.dense import (
        dense_solve_wire16_topo_nxt8,
        dense_solve_wire_topo_nxt8, dense_solve_wire_topo_nxt8_ragged,
        dense_solve_wire_topo_nxt16,
        dense_solve_wire_topo_nxt16_blocked_ragged,
        dense_solve_wire_topo_nxt16_ragged,
    )

    for V, idxs in buckets:
        realB = len(idxs)
        # pow2-pad B for bounded compile shapes.  Big-V buckets (the
        # single-chip big-contig path) drop the pow2 floor of 8 — a
        # lone 8192-vertex contig must cost one 268 MB slab, not eight
        # — and always take the ragged single-device path: their B is
        # too small to shard over a data mesh, and mesh B-padding would
        # multiply the slab by the device count.
        if V > 256:
            padB = 1 << (realB - 1).bit_length() if realB > 1 else 1
        else:
            padB = _next_pow2(realB)
        if spec is None or V > 256:
            # single-device production transport, smallest first:
            # (1) 16-BIT wire — u16 cell deltas + u16 dictionary value
            #     indices, HALF the i32 ragged bytes (V <= 128 buckets;
            #     falls back when the value table overflows);
            # (2) RAGGED i32 wire — one (2, capN) stream carrying only
            #     real edge entries.
            # Bad contigs (parallel edges / envelope) decode to empty
            # slabs and their result rows drop before the finish.
            w16 = exporter.export_wire16(idxs, V, n_edges[idxs], padB) \
                if V <= 128 else None
            if w16 is not None:
                deltas, vidx, table, n_real, seeds, ok = w16
                pending = dense_solve_wire16_topo_nxt8(
                    deltas, vidx, table, seeds, n_real, B=padB, V=V)
                stats["wire16_buckets"] = stats.get("wire16_buckets", 0) + 1
                stats["h2d_bytes"] = stats.get("h2d_bytes", 0) + (
                    deltas.nbytes + vidx.nbytes + table.nbytes + seeds.nbytes)
            else:
                wire, ok, _cap = exporter.export_wire_ragged(
                    idxs, V, n_edges[idxs], padB)
                if V <= 256:
                    pending = dense_solve_wire_topo_nxt8_ragged(
                        wire, B=padB, V=V)
                else:
                    # big-V buckets: the BLOCKED tropical triangular
                    # solve (ops/dense.py:_blocked_dp) — sequential
                    # depth (V/Bk)*log2(Bk) instead of V, rows bit-equal
                    # to the reverse-topo scan
                    pending = dense_solve_wire_topo_nxt16_blocked_ragged(
                        wire, B=padB, V=V, Bk=_blocked_bk(V, padB))
                stats["h2d_bytes"] = stats.get("h2d_bytes", 0) + wire.nbytes
            launches.append((idxs, realB, V, pending,
                             None if ok.all() else ok))
            stats["dense_buckets"] += 1
            stats.setdefault("bucket_vs", []).append(int(V))
            continue
        # multi-device: (B, 2, W) wire whose dim 0 shards over the data
        # mesh — contigs are independent, so XLA runs shards with zero
        # communication
        W = _next_pow2(int(n_edges[idxs].max()) + 2)
        wire, ok = exporter.export_wire(idxs, V, W)
        if not ok.all():
            wire = wire[ok]
            idxs = idxs[ok]
            if not len(idxs):
                continue
        realB = len(idxs)
        padB = _next_pow2(realB)
        # the data-mesh axis shards dim 0: pad to a multiple of
        # the device count (pow2 alone fails on e.g. 6 devices)
        padB = ((padB + n_dev - 1) // n_dev) * n_dev
        if padB != realB:
            wire = np.concatenate(
                [wire, np.repeat(wire[-1:], padB - realB, 0)])
        wire = jax.device_put(wire, spec)
        # topo-relabeled wire -> single reverse-scan kernel shipping
        # the achieving-successor array (the C++ finish chases the
        # min-walk path on host — a second on-device chase scan cost
        # ~40% of the launch); compiled variants are bounded by the
        # (padB, V, W) bucket shapes alone.  V <= 256 buckets get uint8
        # gate rows, larger (big-contig) buckets int16 gate rows — the
        # order-insensitivity gate is evaluated ON DEVICE in exact
        # int32 either way, so rows carry no clamped DP values and the
        # D2H stays 1-2 bytes per vertex
        if V <= 256:
            pending = dense_solve_wire_topo_nxt8(wire, V=V)
        else:
            pending = dense_solve_wire_topo_nxt16(wire, V=V)
        launches.append((idxs, realB, V, pending, None))
        stats["dense_buckets"] += 1
        stats.setdefault("bucket_vs", []).append(int(V))


def _device_cap(cfg) -> int:
    """Vertex ceiling of the single-chip device engine: cfg.device_max_v
    bounded by 32767 (int16 topo positions in the gate rows)."""
    return min(cfg.device_max_v, 32767)


def _eligible_mask(meta, cfg):
    """Device-envelope eligibility over all contigs.

    Score envelope 2^28 (packed wire format reserves bits 28-29 for the
    edge anomaly); bound is a path-sum upper bound, so every edge score
    and every DP value stays packable.  The vertex ceiling is
    _device_cap: V <= 256 buckets ship uint8 gate rows, larger ones
    int16 gate rows (nxt entries are topo positions, int16-exact to
    32767) — the gate is evaluated ON DEVICE in exact int32 either way,
    so no clamped DP value ever reaches the host (the legacy V+5 int16
    rows' I16_INF clamps, which bounded soundness at V <= 5461, are off
    the production path)."""
    built = meta[:, 0] == 1
    n_v, bound = meta[:, 2], meta[:, 6]
    return built & (n_v <= _device_cap(cfg)) & (bound < 2**27)


def _device_assist(exporter, cfg: AlignasmConfig, meta, idx_pool, stats,
                   overlap=None, model=None):
    """Run the bucket device pipeline over the device-eligible members
    of ``idx_pool`` (contig indices into the exporter): bucket by
    padded V, export each bucket's ragged wire, dispatch all device
    programs, then sync + threaded C++ finish per bucket.  Finished
    contigs (fast path or native fallback, decided in C++) get results
    stored in the exporter.

    ``overlap``: optional 0-arg callable executed on a HOST THREAD
    while the main thread waits on device results — the caller's native
    solves of non-device contigs ride under the device sync for free
    (ctypes releases the GIL; the exporter's result slots are
    per-contig, and caller guarantees the overlap set is disjoint from
    ``idx_pool``).

    The device section must never sink the run: any failure (a backend
    error at launch or sync, a result-integrity mismatch) leaves the
    affected contigs without stored results — the caller's
    solve_remaining/solve_subset covers them — with the reason recorded
    in ``stats``.  Outputs stay byte-identical either way; only
    throughput changes.

    Returns the np array of contig indices with stored results."""
    import threading
    import time

    from alignasm_tpu.runtime import ensure_jax_compile_cache

    ensure_jax_compile_cache()
    import jax
    import numpy as np

    eligible = _eligible_mask(meta, cfg)
    pool_mask = np.zeros(len(meta), bool)
    pool_mask[idx_pool] = True
    idx_all = np.where(eligible & pool_mask)[0]
    n_v, n_edges = meta[:, 2], meta[:, 3]

    # bucket by padded V; cap the per-bucket dense footprint and pad
    # B to pow2 so compiled shapes stay bounded
    order = idx_all[np.argsort(n_v[idx_all], kind="stable")]
    buckets = _dense_buckets(order, n_v)

    if model is not None:
        # cost-gated routing (device_routing="auto" on a device where
        # SOME bucket can win): launch a bucket only when the predicted
        # device route beats the native solve of the same contigs —
        # gated buckets fall to the caller's solve_remaining
        n_rec = meta[:, 1]
        kept = []
        for V, idxs in buckets:
            wire_b = int(n_edges[idxs].sum()) * 8 + 64  # ~i32 ragged wire
            row_b = len(idxs) * (V + 2)                 # uint8 gate rows
            if model.bucket_profitable(len(idxs), int(V), wire_b, row_b,
                                       int(n_rec[idxs].sum())):
                kept.append((V, idxs))
            else:
                stats["buckets_gated"] = stats.get("buckets_gated", 0) + 1
                stats["contigs_gated"] = (
                    stats.get("contigs_gated", 0) + len(idxs))
        buckets = kept

    # multi-device: shard bucket batches over a data mesh — contigs
    # are independent, so XLA runs shards with zero communication
    n_dev = jax.device_count()
    spec = None
    if n_dev > 1:
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        mesh = Mesh(np.array(jax.devices()), ("data",))
        spec = NamedSharding(mesh, P("data"))
        stats["data_mesh_devices"] = n_dev

    t0 = time.perf_counter()
    launches = []
    try:
        _launch_buckets(buckets, n_edges, exporter, spec, n_dev,
                        launches, stats)
    except Exception as exc:
        stats["device_error"] = f"launch: {exc!r}"[:500]
        launches = []
    stats["launch_s"] = round(time.perf_counter() - t0, 4)

    overlap_thread = None
    if overlap is not None:
        # the native solve of non-device contigs runs while the wires
        # move and the device computes: the sync wait is host-idle time
        overlap_thread = threading.Thread(target=overlap, daemon=True)
        overlap_thread.start()

    t0 = time.perf_counter()
    sync_s = cfinish_s = 0.0
    covered = []
    # request every bucket's D2H up front: transfers then progress
    # while earlier buckets run the threaded C++ finish, instead of
    # serializing transfer -> finish -> transfer per bucket (matters
    # on multi-bucket corpora).  Best-effort — np.asarray below is
    # authoritative.
    for *_rest, pending, _ok in launches:
        try:
            pending.copy_to_host_async()
        except Exception:
            pass
    for idxs, realB, V, pending, ok in launches:
        t1 = time.perf_counter()
        try:
            dp = np.asarray(pending)[:realB]
            stats["d2h_bytes"] = stats.get("d2h_bytes", 0) + dp.nbytes
        except Exception as exc:
            stats["device_error"] = f"sync: {exc!r}"[:500]
            sync_s += time.perf_counter() - t1
            continue  # these contigs fall to the caller's native solve
        if ok is not None:
            # ragged-wire bucket with export-rejected contigs: drop
            # their (empty-slab) rows; the caller's native solve covers
            dp = dp[ok]
            idxs = idxs[ok]
            if not len(idxs):
                continue
        t2 = time.perf_counter()
        sync_s += t2 - t1
        try:
            if dp.dtype == np.uint8:
                n_fast, n_fb = exporter.finish_bulk8(idxs, dp, V)
            elif dp.shape[1] == V + 2:  # int16 gate rows (big-contig path)
                n_fast, n_fb = exporter.finish_bulk16(idxs, dp, V)
            else:  # legacy (V + 5) int16 DP rows
                n_fast, n_fb = exporter.finish_bulk(idxs, dp, V)
        except Exception as exc:
            stats["device_error"] = f"finish: {exc!r}"[:500]
            cfinish_s += time.perf_counter() - t2
            continue
        cfinish_s += time.perf_counter() - t2
        # (V, contigs, sync_s, finish_s, contigs finished by the device)
        stats.setdefault("bucket_phases", []).append(
            (int(V), int(len(idxs)), round(t2 - t1, 4),
             round(time.perf_counter() - t2, 4), int(n_fast)))
        covered.append(idxs)
        stats["device"] += n_fast
        stats["fallback"] += n_fb
    if "device_error" in stats:
        import warnings

        warnings.warn(
            "device path degraded to native solve: "
            + stats["device_error"], RuntimeWarning, stacklevel=2)
    if overlap_thread is not None:
        t1 = time.perf_counter()
        overlap_thread.join()
        stats["overlap_join_s"] = round(time.perf_counter() - t1, 4)
    stats["finish_s"] = round(time.perf_counter() - t0, 4)
    stats["sync_s"] = round(sync_s, 4)      # device wait + transfer
    stats["cfinish_s"] = round(cfinish_s, 4)  # threaded C++ finish
    return np.concatenate(covered) if covered else np.empty(0, np.int64)


def _solve_native_routed(cfg: AlignasmConfig, src_paths, write_prefix,
                         model, mode, model_prov=None):
    """The cost model routed the whole corpus away from the device:
    run the SAME fused native pipeline ``--engine native`` uses (one
    parallel parse->solve->format pass, three streamed flushes) so the
    tpu engine matches it within noise, and record the decision in
    stats (device_routed_frac = 0 where the device has no calibration
    or its offloadable slice costs more than it saves)."""
    import time

    from alignasm_tpu import native

    t0 = time.perf_counter()
    alt = src_paths[1]
    if alt and os.path.getsize(alt) == 0:
        alt = None  # zero-size alt disables the merge (alignasm.cpp:196-201)
    run_stats = native.run(
        src_paths[0], alt_path=alt, alt_baseline=cfg.alt_baseline,
        non_skip_linkable=cfg.non_skip_linkable, threads=0,
        out_prefix=write_prefix, config=cfg,
    )
    stats = {
        "device": 0, "fallback": 0,
        "singleton": 0, "oversize": 0,
        "host_plane": "native", "routing": mode,
        "routed": "fused-native",
        "device_routed_frac": 0.0,
        # which measurement the gate ran on: every routed run states its
        # calibration's provenance + age (or that there is none)
        "cost_model": _cost_model_stats(model, model_prov),
        **device_platform(require_gpu=False),
        "written_natively": True,
        "read_s": run_stats["read_s"], "solve_s": run_stats["solve_s"],
        "write_s": run_stats["write_s"],
        "n_contigs": run_stats["contigs"],
        "n_records": run_stats["records"],
        "total_s": round(time.perf_counter() - t0, 4),
    }
    solve_dataset_tpu.last_stats = stats
    return (None, None, None)


def _solve_tpu_native(dataset, cfg: AlignasmConfig, src_paths, write_prefix,
                      allow_device=True, model=None, mode="always",
                      model_prov=None):
    """Production device path: the C++ host plane does parse -> graph
    build -> dense pack -> device-assisted finish -> output writing; the
    Python layer only orchestrates bucket-shaped device launches.  There
    are NO per-contig Python loops.

    Per bucket: one C++ dense-pack call, one jitted device program, one
    device->host transfer of the compact result rows, one C++ finish
    call (threaded; device-assisted fast path or full native solve per
    contig).  Contigs outside the dense envelope (singletons, oversize,
    int32-unsafe, parallel-edge) solve natively on a host thread that
    OVERLAPS the device sync wait.
    """
    import time

    import numpy as np

    from alignasm_tpu import native

    t_start = time.perf_counter()
    # keep freed parse/graph pages mapped so repeated opens don't
    # re-fault the working set (native/src/heap.cc)
    native.tune_heap()
    stats = {"device": 0, "fallback": 0, "singleton": 0, "oversize": 0,
             "host_plane": "native", "dense_buckets": 0, "native_direct": 0,
             "routing": mode, "cost_model": _cost_model_stats(model,
                                                              model_prov),
             **device_platform(require_gpu=allow_device)}
    exporter = native.GraphExporter(
        src_paths[0], alt_path=src_paths[1],
        alt_baseline=cfg.alt_baseline,
        non_skip_linkable=cfg.non_skip_linkable,
        # build graphs up to the single-chip vertex ceiling so big
        # contigs (records > max_device_records) can take the tiny-B
        # int16-gate-row device path instead of falling to the CPU
        max_records=max(cfg.max_device_records, _device_cap(cfg)),
        config=cfg,
    )
    stats["pack_open_s"] = round(time.perf_counter() - t_start, 4)
    try:
        n = len(exporter)
        if dataset is not None:
            assert n == len(dataset.contigs), "native/python contig count mismatch"
        meta = exporter.meta_bulk()
        n_rec = meta[:, 1]
        stats["singleton"] = int((n_rec == 1).sum())
        stats["oversize"] = int((n_rec > cfg.max_device_records).sum())
        stats["n_contigs"] = n
        stats["n_records"] = int(n_rec.sum())
        stats["pack_s"] = round(time.perf_counter() - t_start, 4)

        # 512 GB-class contigs (over BOTH device-record and shard
        # thresholds): solve through the edge-sharded graph axis on the
        # device mesh — graph build, edge export, and the floor/counts/
        # gate/finish all in C++ (parallel/mesh.py:
        # solve_contig_sharded_native); only the relaxation's O(E *
        # sweeps) runs on the mesh.  The rest of the dataset keeps the
        # native bucket plane.  Like every other device interaction, a
        # failure degrades to the native solve (no result was stored,
        # so solve_remaining covers the contig) instead of sinking the
        # run.
        import jax

        sharded_ok = np.empty(0, np.int64)
        if allow_device and jax.device_count() > 1:
            big = np.where((n_rec > cfg.max_device_records)
                           & (n_rec >= cfg.graph_shard_min_records))[0]
            if len(big):
                from alignasm_tpu.parallel.mesh import (
                    solve_contig_sharded_native,
                )

                t0 = time.perf_counter()
                done = []
                for i in big:
                    try:
                        solve_contig_sharded_native(exporter, int(i), cfg)
                    except Exception as exc:
                        stats["device_error"] = f"shard: {exc!r}"[:500]
                        break  # device plane is sick; native covers the rest
                    done.append(i)
                    stats["graph_sharded"] = stats.get("graph_sharded", 0) + 1
                sharded_ok = np.asarray(done, np.int64)
                stats["shard_s"] = round(time.perf_counter() - t0, 4)

        # non-device set (never eligible for a bucket): solved natively
        # on a host thread that overlaps the device sync below
        eligible = _eligible_mask(meta, cfg) if allow_device \
            else np.zeros(n, bool)
        non_device = np.where(~eligible)[0]
        idx_pool = np.arange(n)
        if len(sharded_ok):
            non_device = np.setdiff1d(non_device, sharded_ok)
            idx_pool = np.setdiff1d(idx_pool, sharded_ok)
        exporter.prepare_results()  # pre-size result slots: the overlap
        # thread and the finish calls must not race a lazy resize
        if allow_device:
            overlap = None
            if len(non_device):
                def overlap(idx=non_device):
                    import time as _t

                    t1 = _t.perf_counter()
                    try:
                        exporter.solve_subset(idx, format_out=True)
                    except Exception as exc:  # pragma: no cover - surfaced via stats
                        stats["overlap_error"] = repr(exc)[:500]
                    stats["overlap_solve_s"] = round(_t.perf_counter() - t1, 4)

            _device_assist(exporter, cfg, meta, idx_pool, stats,
                           overlap=overlap, model=model if mode == "auto"
                           else None)
        else:
            # cost model (or device_routing="never") routed everything
            # to the native plane; the exporter plane is kept only
            # because the caller needs in-memory results (write paths
            # take the fused pipeline in _solve_native_routed)
            stats["routed"] = "native-plane"
            t0 = time.perf_counter()
            exporter.solve_subset(non_device,
                                  format_out=write_prefix is not None)
            stats["overlap_solve_s"] = round(time.perf_counter() - t0, 4)
        # leftovers: export-rejected / device-error contigs (and the
        # overlap set if its thread failed)
        stats["native_direct"] = exporter.solve_remaining() \
            + len(non_device) - stats["singleton"]
        stats["device_routed_frac"] = round(stats["device"] / n, 4) if n else 0.0

        if write_prefix is not None:
            t0 = time.perf_counter()
            exporter.write_results(write_prefix)
            stats["written_natively"] = True
            stats["write_s"] = round(time.perf_counter() - t0, 4)
            result = (None, None, None)
        else:
            result = exporter.fetch_results()
    finally:
        exporter.close()
    stats["total_s"] = round(time.perf_counter() - t_start, 4)
    solve_dataset_tpu.last_stats = stats
    return result


def solve_missing_tpu_native(cfg: AlignasmConfig, src_paths, missing,
                             put_chunk=None, chunk: int = 4096,
                             threads: int = 0, expected_n=None):
    """Device-engine solve of an explicit contig subset on the NATIVE
    host plane — the production resume path (checkpoint.py engine=tpu).

    Opens one exporter (one parse), runs the bucket device pipeline
    over the device-eligible members of ``missing`` while the
    non-eligible members solve natively under the device sync, then
    native-solves any device leftovers and streams results back via
    ``put_chunk(indices, outs, alts, maxes)`` in ``chunk``-sized slices
    (journal flush granularity).  Returns the stats dict."""
    import time

    import numpy as np

    from alignasm_tpu import native

    t_start = time.perf_counter()
    native.tune_heap()
    stats = {"device": 0, "fallback": 0, "singleton": 0, "oversize": 0,
             "host_plane": "native", "dense_buckets": 0, "native_direct": 0}
    missing = np.ascontiguousarray(np.sort(np.asarray(missing, np.int64)))
    exporter = native.GraphExporter(
        src_paths[0], alt_path=src_paths[1],
        alt_baseline=cfg.alt_baseline,
        non_skip_linkable=cfg.non_skip_linkable,
        max_records=max(cfg.max_device_records, _device_cap(cfg)),
        config=cfg, threads=threads,
    )
    try:
        meta = exporter.meta_bulk()
        stats["n_contigs_file"] = len(meta)
        if expected_n is not None and len(meta) != expected_n:
            # load-bearing: a count mismatch means src_paths does not
            # describe the caller's dataset, and any results stored
            # under its digests would cross-contaminate the journal —
            # raise BEFORE any put_chunk runs
            raise RuntimeError(
                f"native parse found {len(meta)} contigs but the caller "
                f"expects {expected_n}: src_paths does not match dataset")
        # same routing policy as the batch path: the device only sees
        # work the cost model predicts it wins
        from alignasm_tpu.runtime.costmodel import load_model_info

        model, model_prov = load_model_info()
        mode, allow_device = _routing(cfg, model)
        stats["routing"] = mode
        stats["cost_model"] = _cost_model_stats(model, model_prov)
        stats.update(device_platform(require_gpu=allow_device))
        eligible = _eligible_mask(meta, cfg) if allow_device \
            else np.zeros(len(meta), bool)
        non_device = missing[~eligible[missing]]
        exporter.prepare_results()
        overlap = None
        if len(non_device):
            def overlap(idx=non_device):
                t1 = time.perf_counter()
                try:
                    exporter.solve_subset(idx, threads=threads)
                except Exception as exc:  # pragma: no cover
                    stats["overlap_error"] = repr(exc)[:500]
                stats["overlap_solve_s"] = round(time.perf_counter() - t1, 4)

        if allow_device:
            covered = _device_assist(exporter, cfg, meta, missing, stats,
                                     overlap=overlap,
                                     model=model if mode == "auto" else None)
        else:
            covered = np.empty(0, np.int64)
            if overlap is not None:
                overlap()
        leftover = np.setdiff1d(missing, np.concatenate([covered, non_device]))
        if len(leftover):
            exporter.solve_subset(leftover, threads=threads)
        stats["native_direct"] = int(len(non_device) + len(leftover))
        if put_chunk is not None:
            for lo in range(0, len(missing), chunk):
                part = missing[lo:lo + chunk]
                o, a, m = exporter.fetch_results_for(part)
                put_chunk(part, o, a, m)
    finally:
        exporter.close()
    stats["total_s"] = round(time.perf_counter() - t_start, 4)
    solve_dataset_tpu.last_stats = stats
    return stats
