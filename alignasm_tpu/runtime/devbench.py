"""Device-engine benchmark: end-to-end throughput + kernel roofline.

bench.py runs this module in a SUBPROCESS so that a fatal runtime error
or a teardown abort can never take down the main bench.  Standalone use:

    python -m alignasm_tpu.runtime.devbench [n_contigs]
    python -m alignasm_tpu.runtime.devbench --calibrate [--out PATH]
    python -m alignasm_tpu.runtime.devbench --bigv-sweep

STREAMING output: each section — end_to_end, kernels, bigv — prints its
own complete JSON line the moment it finishes; the LAST line is the
deep-merged full object.  A failed section is recorded as
``<section>_error`` and makes the process exit non-zero.

``--calibrate`` measures every DeviceCostModel field on the CURRENT
build + device and writes the dated calibration artifact that
runtime/costmodel.py consumes.

The merged object looks like:
  {"tpu_engine_contigs_per_s": ..., "tpu_engine_stats": {...},
   "kernels": {"topo": {...}, "dense": {...}, "sparse": {...},
               "bigv": {...}}, "sections_skipped": [...]}

"topo" is the PRODUCTION kernel (single reverse-topo scan + on-device
order-insensitivity gate) and carries contigs_per_s + marginal
per-contig cost; "dense"/"sparse" are the legacy sweep formulations
kept for the sweeps/s roofline comparison.

Kernel roofline methodology (BASELINE.json's "relaxation sweeps/s/chip"
metric): time the jitted bucket program on a representative synthetic
bucket (B contigs x V vertices, n_sweeps relaxation sweeps), best of
``reps`` after a warm-up compile.  ``bytes_per_sweep`` is the HBM-model
traffic of ONE d-relaxation sweep over the whole bucket:

  dense:  read ws + wa ((B, V, V) int32 each)       = B * 2 * V^2 * 4
  sparse: read 7 edge arrays + gather 4 state arrays
          + segment-min traffic ~ 10 V-vectors      = B*(11*E + 10*V)*4

If the achieved bytes/s exceeds the card's HBM peak, the matrices stay
in on-chip memory (L2 / shared memory) across the sweep loop; the
number is then an EFFECTIVE bandwidth, reported as such via
``above_hbm_peak``.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time

# Published peaks by device_kind, the denominators of every roofline
# share this module reports.  Source: NVIDIA H100 Tensor Core GPU data
# sheet, SXM5 part, dense rates without sparsity, at its 700 W power
# limit (a card set below it cannot hold its top clock under load).
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "bf16_flops_per_s": 989e12,      # tensor cores
        "tf32_flops_per_s": 495e12,      # tensor cores
        "fp32_flops_per_s": 67e12,       # CUDA cores
        "int8_ops_per_s": 1979e12,       # tensor cores
    },
}


def device_peaks(kind: str | None = None) -> dict:
    """The peak row of ``kind`` (default: the running device).  A device
    without a row is an error, never a default."""
    if kind is None:
        import jax

        kind = jax.devices()[0].device_kind
    if kind not in DEVICE_PEAKS:
        raise KeyError(f"no published peaks for device {kind!r}; add its "
                       f"row to devbench.DEVICE_PEAKS with the source")
    return DEVICE_PEAKS[kind]


def _device_peak():
    """(device_kind, HBM peak bytes/s) of the running device."""
    import jax

    kind = jax.devices()[0].device_kind
    return kind, device_peaks(kind)["hbm_bytes_per_s"]


def bench_end_to_end(n_contigs: int, seed: int = 2024, reps: int = 5):
    """Timed solve_dataset_tpu over the bench corpus (native host
    plane), warm: the first run pays the jit compiles.

    Two configurations are measured:

    * PRODUCTION (``device_routing="auto"``, the default): the cost
      model routes each piece of work to whichever plane wins (see
      runtime/costmodel.py).
    * FORCED (``device_routing="always"``): the bucket device pipeline
      end to end, so the device path's real cost stays measured and
      regressions in it stay visible.
    """
    import dataclasses
    import os
    import pathlib

    from alignasm_tpu.config import DEFAULT_CONFIG
    from alignasm_tpu.runtime import scheduler
    from alignasm_tpu.testing.synth import generate_paf

    # memory-backed work dir when available, so disk speed stays out of
    # the timing
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    work = pathlib.Path(tempfile.mkdtemp(prefix="alignasm_devbench_", dir=shm))
    import atexit
    import shutil

    atexit.register(shutil.rmtree, work, True)  # tmpfs pins RAM, not disk
    paf = work / "bench_tpu.paf"
    paf.write_text(generate_paf(n_contigs=n_contigs, seed=seed,
                                max_records_per_contig=24))
    # the production boundary: parse -> solve -> the three output PAFs
    # WRITTEN (the same boundary the native bench measures); the
    # fetch-to-Python-objects API path is a test/debug surface
    paths = (str(paf), None)
    prefix = str(paf)[: -len(".paf")]
    from alignasm_tpu import native

    forced_cfg = dataclasses.replace(DEFAULT_CONFIG, device_routing="always")
    results = {}
    native_best = float("inf")
    # interleave the two configurations so a shared-VM steal window
    # cannot hit one side only (same rationale as bench.py's
    # reference/native interleave)
    for label, cfg in (("auto", DEFAULT_CONFIG), ("forced", forced_cfg)):
        # dataset=None: the native plane parses the file itself; a
        # Python read_paf here only slowed the warm pass
        scheduler.solve_dataset_tpu(None, cfg, src_paths=paths,
                                    write_prefix=prefix)  # warm
        results[label] = [float("inf"), scheduler.solve_dataset_tpu.last_stats]
    for _ in range(reps):
        # same-process native baseline, interleaved with the engine
        # reps: the routing criterion "tpu >= native within noise" is
        # judged on THIS ratio (a cross-process comparison of a ~20 ms
        # job is rep-noise-dominated)
        native.drain_teardowns()
        t0 = time.perf_counter()
        native.run(str(paf), threads=0)
        native_best = min(native_best, time.perf_counter() - t0)
        for label, cfg in (("auto", DEFAULT_CONFIG), ("forced", forced_cfg)):
            # join the previous rep's background context teardown so its
            # free() churn doesn't compete with this rep's timed work
            native.drain_teardowns()
            t0 = time.perf_counter()
            scheduler.solve_dataset_tpu(None, cfg, src_paths=paths,
                                        write_prefix=prefix)
            elapsed = time.perf_counter() - t0
            if elapsed < results[label][0]:
                results[label] = [elapsed,
                                  scheduler.solve_dataset_tpu.last_stats]
    return {
        "tpu_engine_contigs_per_s": round(n_contigs / results["auto"][0], 2),
        "tpu_engine_stats": results["auto"][1],
        "tpu_engine_forced_contigs_per_s":
            round(n_contigs / results["forced"][0], 2),
        "tpu_engine_forced_stats": results["forced"][1],
        "native_inproc_contigs_per_s": round(n_contigs / native_best, 2),
        "tpu_vs_native_inproc":
            round(native_best / results["auto"][0], 4),
        "reps_done": reps,
    }


def _bench_one(launch, n_launch_sweeps, bytes_per_sweep, reps=9):
    """Kernel COMPUTE roofline: inputs are device-resident (the
    end-to-end stats carry the transfer costs)."""
    import statistics

    import jax

    jax.block_until_ready(launch())  # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(launch())
        times.append(time.perf_counter() - t0)
    best = min(times)
    kind, peak = _device_peak()
    eff = bytes_per_sweep * n_launch_sweeps / best
    return {
        "s_per_launch": round(best, 6),
        # dispatch jitter estimate: median minus min of the reps — used
        # to decide whether a differenced marginal cost is resolvable
        "noise_s": round(statistics.median(times) - best, 6),
        "sweeps_per_s": round(n_launch_sweeps / best, 1),
        "model_bytes_per_sweep": bytes_per_sweep,
        "effective_GB_per_s": round(eff / 1e9, 1),
        "pct_of_hbm_peak": round(100 * eff / peak, 1),
        "above_hbm_peak": eff > peak,
        "device_kind": kind,
        "hbm_peak_GB_per_s": round(peak / 1e9, 1),
    }


def _marginal(t_lo, t_hi, noise_lo, noise_hi, n_delta, bytes_per_unit):
    """Marginal per-unit cost by differencing two launch sizes so the
    fixed dispatch cost cancels.  When the measured difference is below
    the dispatch-jitter floor the marginal fields are None rather than
    a nonsense number."""
    _kind, peak = _device_peak()
    diff = t_hi - t_lo
    floor = 2 * max(noise_lo, noise_hi, 1e-4)
    if diff <= floor:
        return {"marginal_note":
                f"unresolvable: size delta changed launch time by "
                f"{diff * 1e3:.2f} ms, below the {floor * 1e3:.2f} ms "
                f"dispatch-jitter floor"}, None
    marg = diff / n_delta
    eff = bytes_per_unit / marg
    return {
        "marginal_GB_per_s": round(eff / 1e9, 1),
        "marginal_pct_of_hbm_peak": round(100 * eff / peak, 1),
    }, marg


def bench_kernels(B=256, V=64, E=256, n_sweeps=32, seed=0):
    """Roofline for the dense and sparse bucket kernels on a synthetic
    random-DAG bucket shaped like the bench workload."""
    import numpy as np

    from alignasm_tpu.ops.dense import ANOM_SHIFT, INF32, dense_solve_wire
    from alignasm_tpu.ops.relax32 import sp_batch32

    rng = np.random.default_rng(seed)

    # dense (the production packed wire format): strict upper-triangular
    # random edges (a DAG by construction), score|anom<<28 cells + dest row
    mask = np.triu(rng.random((B, V, V)) < 0.08, k=1)
    ws = rng.integers(1, 1000, (B, V, V)).astype(np.int32)
    wa = rng.integers(0, 2, (B, V, V)).astype(np.int32)
    # production sparse wire: (cell index, packed val) pairs + dest entry
    E2 = int(mask.sum(axis=(1, 2)).max()) + 3
    wire = np.empty((B, 2, E2), np.int32)
    wire[:, 0] = V * (V + 1)
    wire[:, 1] = 0
    for b in range(B):
        us, vs = np.nonzero(mask[b])
        k = len(us)
        wire[b, 0, :k] = (us * V + vs).astype(np.int32)
        wire[b, 1, :k] = ws[b, us, vs] | (wa[b, us, vs] << ANOM_SHIFT)
        wire[b, 0, k] = V * V
        wire[b, 1, k] = V - 1
        wire[b, 0, k + 1] = V * V + 1
        wire[b, 1, k + 1] = 0
    import jax

    wire_d = jax.device_put(wire)

    # production kernel: single reverse-topo scan + on-device path chase
    # + on-device order-insensitivity gate, uint8 rows
    # (ops/dense.py:dense_solve_wire_topo_nxt8).  Marginal per-contig
    # cost differences two batch sizes so the fixed dispatch round trip
    # cancels; model bytes = the minimal traffic (one pass over the
    # densified slab + the compact uint8 output).
    from alignasm_tpu.ops.dense import dense_solve_wire_topo_nxt8

    # a 128x larger batch, so the compute signal clears the dispatch
    # jitter
    B_hi = 128 * B
    wire_hi = jax.device_put(np.repeat(wire, 128, axis=0))
    contig_bytes = V * (V + 1) * 4 + (V + 2)
    topo = _bench_one(
        lambda: dense_solve_wire_topo_nxt8(wire_d, V=V),
        n_launch_sweeps=B,  # "sweeps" = contig solves for this kernel
        bytes_per_sweep=contig_bytes,
    )
    hi = _bench_one(
        lambda: dense_solve_wire_topo_nxt8(wire_hi, V=V),
        n_launch_sweeps=B_hi,
        bytes_per_sweep=contig_bytes,
    )
    topo["contigs_per_s"] = topo.pop("sweeps_per_s")
    topo["model_bytes_per_contig"] = topo.pop("model_bytes_per_sweep")
    mfields, marg = _marginal(topo["s_per_launch"], hi["s_per_launch"],
                              topo["noise_s"], hi["noise_s"],
                              B_hi - B, contig_bytes)
    if marg is not None:
        topo["marginal_s_per_contig"] = round(marg, 9)
        topo["marginal_contigs_per_s"] = round(1.0 / marg, 1)
    topo.update(mfields)

    # chained-launch timing: queue N launches back to back and sync
    # once, so the dispatch round trip amortizes across the chain
    B_ch = 8 * B
    wire_ch = jax.device_put(np.repeat(wire, 8, axis=0))
    jax.block_until_ready(dense_solve_wire_topo_nxt8(wire_ch, V=V))
    n_chain = 30
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [dense_solve_wire_topo_nxt8(wire_ch, V=V)
                for _ in range(n_chain)]
        jax.block_until_ready(outs)
        best = min(best, (time.perf_counter() - t0) / n_chain)
    topo["chained_s_per_launch"] = round(best, 6)
    topo["chained_s_per_contig"] = round(best / B_ch, 9)
    topo["chained_contigs_per_s"] = round(B_ch / best, 1)
    topo["chained_B"] = B_ch
    topo.update(B=B, V=V, wire_bytes=int(wire.nbytes))

    dense = _bench_one(
        lambda: dense_solve_wire(wire_d, V=V, n_sweeps=n_sweeps),
        n_launch_sweeps=n_sweeps,
        bytes_per_sweep=B * V * V * 4,
    )
    dense.update(B=B, V=V, n_sweeps=n_sweeps, wire_bytes=int(wire.nbytes))

    # marginal per-sweep cost: difference two sweep counts so the fixed
    # dispatch latency cancels — this is the COMPUTE roofline
    hi_sweeps = 32 * n_sweeps
    hi = _bench_one(
        lambda: dense_solve_wire(wire_d, V=V, n_sweeps=hi_sweeps),
        n_launch_sweeps=hi_sweeps, bytes_per_sweep=B * V * V * 4,
    )
    mfields, marg = _marginal(dense["s_per_launch"], hi["s_per_launch"],
                              dense["noise_s"], hi["noise_s"],
                              hi_sweeps - n_sweeps, B * V * V * 4)
    if marg is not None:
        dense["marginal_s_per_sweep"] = round(marg, 9)
        dense["marginal_sweeps_per_s"] = round(1.0 / marg, 1)
        _kind, peak = _device_peak()
        dense["marginal_above_hbm_peak"] = mfields["marginal_GB_per_s"] * 1e9 > peak
    dense.update(mfields)

    # sparse: E random forward edges per contig
    eu = np.sort(rng.integers(0, V - 1, (B, E)), axis=1).astype(np.int32)
    ev = (eu + 1 + rng.integers(0, 4, (B, E)) % (V - 1 - eu)).astype(np.int32)
    es = rng.integers(1, 1000, (B, E)).astype(np.int32)
    ea = rng.integers(0, 2, (B, E)).astype(np.int32)
    evalid = np.ones((B, E), bool)
    srcs = np.zeros((B,), np.int32)
    dests = np.full((B,), V - 1, np.int32)
    eu, ev, es, ea, evalid, srcs, dests = (
        jax.device_put(a)
        for a in (eu, ev, es, ea, evalid, srcs, dests))
    sparse = _bench_one(
        lambda: sp_batch32(eu, ev, es, ea, evalid,
                           srcs, dests, V=V, n_sweeps=n_sweeps),
        n_launch_sweeps=n_sweeps,
        # HBM model: per sweep read 4 int32 edge arrays + bool valid
        # (~17 B/edge) and read/update the (s, a) vertex state (~6
        # passes x 4 B over V with the segment gathers/scatters)
        bytes_per_sweep=B * (17 * E + 24 * V),
    )
    sparse.update(B=B, V=V, E=E, n_sweeps=n_sweeps)
    return {"topo": topo, "dense": dense, "sparse": sparse}


def _tc_peak():
    """bf16 tensor-core peak of the running device: the blocked kernel's
    count-closure matmuls take bf16 operands ({0,1,2}-valued, exact)
    with fp32 accumulation (ops/dense.py:_count_dot)."""
    return device_peaks()["bf16_flops_per_s"]


def _blocked_flops(V: int, Bk: int) -> dict:
    """Deterministic op-count model of one blocked big-V solve
    (ops/dense.py:_blocked_dp): per block step the two count closures
    run log2(Bk) doublings of two (Bk,Bk)@(Bk,Bk) bf16 matmuls (tensor
    cores), and the three min-plus closures run log2(Bk) (Bk,Bk,Bk)
    broadcast-min-add squarings (int32 elementwise on the CUDA cores)."""
    nlev = max(1, (Bk - 1).bit_length())
    nb = V // Bk
    tc = nb * 2 * nlev * 2 * (2 * Bk**3)        # 8 * V * Bk^2 * nlev
    alu = nb * 3 * nlev * (2 * Bk**3)           # add + min per cell
    return {"tc_flops": tc, "minplus_ops": alu}


def _batched_bigv_wire(V: int, B: int, seed: int = 0):
    """B copies of the chain-shaped slab as ONE ragged wire (global
    flat indices offset by b*V*(V+1), the _densify_wire_ragged
    contract)."""
    import numpy as np

    one = _bigv_wire(V, seed)
    M = V * (V + 1)
    parts = [one + np.array([[b * M], [0]], np.int64) for b in range(B)]
    return np.concatenate(parts, axis=1).astype(np.int32)


def bench_bigv(V=8192, seed=0, n_chain=6, reps=3):
    """Big-V kernel A/B: the reverse-topo scan (V sequential steps) vs
    the blocked tropical triangular solve (ops/dense.py:_blocked_dp —
    (V/Bk)*log2(Bk) depth) on a chain-shaped V-vertex slab, chained
    launches so the dispatch round trip amortizes.  Reports per-launch time, the slab-traffic bandwidth
    (the kernel reads the (V+1, V) densified slab once), and
    bit-equality of the int16 gate rows."""
    import time as _t

    import jax
    import numpy as np

    from alignasm_tpu.ops.dense import (
        dense_solve_wire_topo_nxt16_blocked_ragged,
        dense_solve_wire_topo_nxt16_ragged,
    )
    from alignasm_tpu.runtime.scheduler import _blocked_bk

    wire_h = _bigv_wire(V, seed)  # the one shared construction
    wire = jax.device_put(wire_h)
    n_edges = wire_h.shape[1] - 2  # minus the dest/src sentinel entries

    def timeit(fn):
        r = np.asarray(fn())  # compile + warm
        best = float("inf")
        for _ in range(reps):
            t0 = _t.perf_counter()
            outs = [fn() for _ in range(n_chain)]
            jax.block_until_ready(outs)
            best = min(best, (_t.perf_counter() - t0) / n_chain)
        return r, best

    ref, t_scan = timeit(
        lambda: dense_solve_wire_topo_nxt16_ragged(wire, B=1, V=V))
    bk1 = _blocked_bk(V, 1)
    got, t_blk = timeit(
        lambda: dense_solve_wire_topo_nxt16_blocked_ragged(
            wire, B=1, V=V, Bk=bk1))
    slab = V * (V + 1) * 4
    kind, peak = _device_peak()
    out = {
        "V": V, "E": int(n_edges), "device_kind": kind,
        "scan_s_per_launch": round(t_scan, 5),
        "blocked_s_per_launch": round(t_blk, 5),
        "blocked_speedup": round(t_scan / t_blk, 2),
        "bit_equal": bool((ref == got).all()),
        "slab_bytes": slab,
        "scan_GB_per_s": round(slab / t_scan / 1e9, 2),
        "blocked_GB_per_s": round(slab / t_blk / 1e9, 2),
        "blocked_pct_of_hbm_peak": round(100 * slab / t_blk / peak, 2),
    }
    fl = _blocked_flops(V, bk1)
    out["Bk"] = bk1
    out["closure_tc_GFLOP"] = round(fl["tc_flops"] / 1e9, 2)
    out["closure_tc_pct_of_bf16_peak"] = round(
        100 * fl["tc_flops"] / t_blk / _tc_peak(), 3)
    out["minplus_Gops_per_s"] = round(fl["minplus_ops"] / t_blk / 1e9, 1)

    # batched big-V: a karyotype corpus can hold many V<=8192 contigs —
    # amortize the dispatch + step overhead across B slabs per launch
    B = 8
    bkB = _blocked_bk(V, B)
    flB = _blocked_flops(V, bkB)
    wireB = jax.device_put(_batched_bigv_wire(V, B, seed))
    launchB = lambda: dense_solve_wire_topo_nxt16_blocked_ragged(
        wireB, B=B, V=V, Bk=bkB)
    refB = np.asarray(launchB())  # compile + warm
    bestB = float("inf")
    for _ in range(reps):
        t0 = _t.perf_counter()
        outs = [launchB() for _ in range(n_chain)]
        jax.block_until_ready(outs)
        bestB = min(bestB, (_t.perf_counter() - t0) / n_chain)
    out["batched"] = {
        "B": B, "Bk": bkB,
        "s_per_launch": round(bestB, 5),
        "s_per_contig": round(bestB / B, 5),
        "bit_equal_rows": bool((refB == refB[0]).all()
                               and (refB[0] == got[0]).all()),
        "slab_GB_per_s": round(B * slab / bestB / 1e9, 2),
        "closure_tc_pct_of_bf16_peak": round(
            100 * B * flB["tc_flops"] / bestB / _tc_peak(), 3),
        "minplus_Gops_per_s": round(
            B * flB["minplus_ops"] / bestB / 1e9, 1),
    }
    return out


def bench_bigv_sweep(Vs=(1024, 2048, 8192), Bks=(32, 64, 128),
                     Bs=(1, 4, 8), seed=0, n_chain=4, reps=2):
    """Full (V, B, Bk) sweep of the blocked big-V kernel — run by hand
    (`devbench --bigv-sweep`); each combo is its own compile, so this is
    not one of the bench sections.  Every combo's rows are checked
    equal to the reverse-topo scan's rows for its V, and each row
    carries the scan's own time for comparison."""
    import time as _t

    import jax
    import numpy as np

    from alignasm_tpu.ops.dense import (
        dense_solve_wire_topo_nxt16_blocked_ragged,
        dense_solve_wire_topo_nxt16_ragged,
    )

    kind, hbm_peak = _device_peak()
    results = {"device_kind": kind, "rows": []}
    for V in Vs:
        wire1 = jax.device_put(_bigv_wire(V, seed))
        scan = lambda: dense_solve_wire_topo_nxt16_ragged(wire1, B=1, V=V)
        ref = np.asarray(scan())
        t_scan = float("inf")
        for _ in range(reps):
            t0 = _t.perf_counter()
            jax.block_until_ready([scan() for _ in range(n_chain)])
            t_scan = min(t_scan, (_t.perf_counter() - t0) / n_chain)
        slab = V * (V + 1) * 4
        for B in Bs:
            wireB = jax.device_put(_batched_bigv_wire(V, B, seed))
            for Bk in Bks:
                launch = lambda: dense_solve_wire_topo_nxt16_blocked_ragged(
                    wireB, B=B, V=V, Bk=Bk)
                t_c0 = _t.perf_counter()
                got = np.asarray(launch())  # compile + warm
                compile_s = _t.perf_counter() - t_c0
                best = float("inf")
                for _ in range(reps):
                    t0 = _t.perf_counter()
                    outs = [launch() for _ in range(n_chain)]
                    jax.block_until_ready(outs)
                    best = min(best, (_t.perf_counter() - t0) / n_chain)
                fl = _blocked_flops(V, Bk)
                results["rows"].append({
                    "V": V, "B": B, "Bk": Bk,
                    "s_per_launch": best,
                    "s_per_contig": best / B,
                    "scan_s_per_contig": t_scan,
                    "bit_equal": bool((got == ref[None, 0]).all()),
                    "slab_GB_per_s": round(B * slab / best / 1e9, 2),
                    "pct_of_hbm_peak": round(
                        100 * B * slab / best / hbm_peak, 2),
                    "closure_tc_pct_of_bf16_peak": round(
                        100 * B * fl["tc_flops"] / best / _tc_peak(), 3),
                    "minplus_Gops_per_s": round(
                        B * fl["minplus_ops"] / best / 1e9, 1),
                    "compile_s": round(compile_s, 2),
                })
                _emit({"bigv_sweep_row": results["rows"][-1]})
    return results


def calibrate(n_contigs: int = 20000, seed: int = 2024) -> dict:
    """Measure every DeviceCostModel field on the CURRENT build +
    device.  Returns the calibration dict ``runtime/costmodel.py``
    consumes: model fields at the top level plus a ``_meta`` block with
    date / shelf life / device / method / raw readings."""
    import datetime
    import os
    import pathlib
    import shutil
    import tempfile

    import jax
    import numpy as np

    from alignasm_tpu import native
    from alignasm_tpu.config import DEFAULT_CONFIG
    from alignasm_tpu.ops.dense import dense_solve_wire_topo_nxt8
    from alignasm_tpu.runtime.scheduler import (
        _dense_buckets, _device_cap, _eligible_mask, _next_pow2,
    )
    from alignasm_tpu.testing.synth import generate_paf

    details: dict = {}

    # --- transfer ------------------------------------------------------
    f = jax.jit(lambda v: v + 1)
    x = jax.device_put(np.zeros(8, np.int32))
    np.asarray(f(x))  # warm: compile
    rtt = min(_timed(lambda: np.asarray(f(x))) for _ in range(15))
    details["rtt_reps"] = 15

    # h2d with sparse-wire-shaped content (what the device path ships)
    rng = np.random.default_rng(seed)
    blob = np.empty((1 << 22, 2), np.int32)  # ~33 MB of (cell, packed val)
    blob[:, 0] = np.arange(len(blob), dtype=np.int32) % (64 * 65)
    blob[:, 1] = rng.integers(1, 1000, len(blob)) | (
        rng.integers(0, 4, len(blob)) << 28)
    jax.block_until_ready(jax.device_put(blob))  # warm
    t_h2d = min(_timed(lambda: jax.block_until_ready(jax.device_put(blob)))
                for _ in range(3))
    h2d = blob.nbytes / max(t_h2d - rtt, 1e-9)
    details["h2d_MB"] = round(blob.nbytes / 1e6, 1)

    # d2h with gate-row-shaped content (uint8 rows are what comes
    # back).  One FRESH device array per rep: a jax Array caches its
    # host copy after the first np.asarray, so re-fetching the same
    # buffer times a no-op (the first calibrate draft measured 4 PB/s)
    mk_rows = jax.jit(lambda v, i: ((v + i) % 251).astype(jax.numpy.uint8))
    base = jax.device_put(np.arange(4 << 20, dtype=np.int32))
    fresh = [mk_rows(base, i) for i in range(4)]
    jax.block_until_ready(fresh)
    np.asarray(fresh[0])  # warm
    t_d2h = min(_timed(lambda r=r: np.asarray(r)) for r in fresh[1:])
    d2h = (4 << 20) / max(t_d2h - rtt, 1e-9)
    details["d2h_MB"] = round((4 << 20) / 1e6, 1)

    # --- host plane ----------------------------------------------------
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    work = pathlib.Path(tempfile.mkdtemp(prefix="alignasm_cal_", dir=shm))
    try:
        paf = work / "cal.paf"
        paf.write_text(generate_paf(n_contigs=n_contigs, seed=seed,
                                    max_records_per_contig=24))
        native.run(str(paf), threads=0)  # warm (build lib, page cache)
        best = None
        for _ in range(3):
            native.drain_teardowns()
            st = native.run(str(paf), threads=0)
            if best is None or st["solve_s"] < best["solve_s"]:
                best = st
        solve_per_record = best["solve_s"] / max(best["records"], 1)
        details["host_solve_s"] = best["solve_s"]
        details["host_records"] = best["records"]

        tiny = work / "tiny.paf"
        tiny.write_text(generate_paf(n_contigs=max(n_contigs // 2, 1000),
                                     seed=seed + 1,
                                     max_records_per_contig=3))
        native.run(str(tiny), threads=0)
        st = min((native.run(str(tiny), threads=0) for _ in range(2)),
                 key=lambda s: s["solve_s"])
        solve_contig_min = st["solve_s"] / max(st["contigs"], 1)

        # --- the Amdahl ratio: finish vs solve, identical cold graphs --
        # 1. one pass to harvest device DP rows for the eligible buckets
        cfg = DEFAULT_CONFIG
        finish_work = []
        with native.GraphExporter(str(paf),
                                  max_records=max(cfg.max_device_records,
                                                  _device_cap(cfg)),
                                  config=cfg) as ex:
            meta = ex.meta_bulk()
            n_v, n_edges = meta[:, 2], meta[:, 3]
            idx_all = np.where(_eligible_mask(meta, cfg))[0]
            order = idx_all[np.argsort(n_v[idx_all], kind="stable")]
            for V, idxs in _dense_buckets(order, n_v):
                if V > 256:
                    continue  # calibrate on the uint8 fast path
                W = _next_pow2(int(n_edges[idxs].max()) + 2)
                wire, ok = ex.export_wire(idxs, V, W)
                idxs = idxs[ok]
                if not len(idxs):
                    continue
                dp = np.asarray(
                    dense_solve_wire_topo_nxt8(
                        jax.device_put(wire[ok]), V=V))
                finish_work.append((idxs, dp, V, W))
        idx_used = np.concatenate([w[0] for w in finish_work]) \
            if finish_work else np.empty(0, np.int64)

        # 2. A: full native solve, cold exporter
        def cold_solve():
            with native.GraphExporter(str(paf), max_records=max(
                    cfg.max_device_records, _device_cap(cfg)),
                    config=cfg) as ex:
                ex.meta_bulk()
                ex.prepare_results()
                return _timed(lambda: ex.solve_subset(idx_used, threads=0))

        # 3. B: export (graph build + pack) + device-assisted finish —
        #    everything the device route pays on host except the DP
        def cold_finish():
            with native.GraphExporter(str(paf), max_records=max(
                    cfg.max_device_records, _device_cap(cfg)),
                    config=cfg) as ex:
                ex.meta_bulk()
                ex.prepare_results()

                def go():
                    for idxs, dp, V, W in finish_work:
                        ex.export_wire(idxs, V, W)
                        ex.finish_bulk8(idxs, dp, V)
                return _timed(go)

        if len(idx_used):
            cold_solve(), cold_finish()  # warm (page cache, lib)
            t_solve = min(cold_solve() for _ in range(3))
            t_finish = min(cold_finish() for _ in range(3))
            finish_vs_solve = t_finish / t_solve
            details["amdahl_t_solve_s"] = round(t_solve, 4)
            details["amdahl_t_finish_s"] = round(t_finish, 4)
            details["amdahl_contigs"] = int(len(idx_used))
        else:  # no eligible work (shouldn't happen on the cal corpus)
            finish_vs_solve = None
    finally:
        shutil.rmtree(work, True)

    # --- device compute ------------------------------------------------
    # marginal per-contig cost: chained launches so the dispatch RTT
    # amortizes (same method as bench_kernels' chained row)
    B, V = 2048, 64
    mask = np.triu(np.random.default_rng(seed).random((B, V, V)) < 0.08,
                   k=1)
    ws = rng.integers(1, 1000, (B, V, V)).astype(np.int32)
    wa = rng.integers(0, 2, (B, V, V)).astype(np.int32)
    from alignasm_tpu.ops.dense import ANOM_SHIFT

    E2 = int(mask.sum(axis=(1, 2)).max()) + 3
    wire = np.empty((B, 2, E2), np.int32)
    wire[:, 0] = V * (V + 1)
    wire[:, 1] = 0
    for b in range(B):
        us, vs = np.nonzero(mask[b])
        k = len(us)
        wire[b, 0, :k] = (us * V + vs).astype(np.int32)
        wire[b, 1, :k] = ws[b, us, vs] | (wa[b, us, vs] << ANOM_SHIFT)
        wire[b, 0, k] = V * V
        wire[b, 1, k] = V - 1
        wire[b, 0, k + 1] = V * V + 1
        wire[b, 1, k + 1] = 0
    wire_d = jax.device_put(wire)
    jax.block_until_ready(dense_solve_wire_topo_nxt8(wire_d, V=V))
    n_chain = 20
    best = float("inf")
    for _ in range(3):
        t = _timed(lambda: jax.block_until_ready(
            [dense_solve_wire_topo_nxt8(wire_d, V=V)
             for _ in range(n_chain)]))
        best = min(best, t / n_chain)
    dev_per_contig = best / B

    # per-vertex cost of the big-V blocked kernel (one V=8192 slab)
    from alignasm_tpu.ops.dense import (
        dense_solve_wire_topo_nxt16_blocked_ragged,
    )
    from alignasm_tpu.runtime.scheduler import _blocked_bk

    bw = _bigv_wire(V=8192, seed=seed)
    bw_d = jax.device_put(bw)
    launch = lambda: dense_solve_wire_topo_nxt16_blocked_ragged(
        bw_d, B=1, V=8192, Bk=_blocked_bk(8192, 1))
    jax.block_until_ready(launch())
    t_big = min(_timed(lambda: jax.block_until_ready(
        [launch() for _ in range(4)])) / 4 for _ in range(2))
    dev_per_step = t_big / 8192

    from alignasm_tpu.runtime.costmodel import current_device_kind

    kind = current_device_kind()
    today = datetime.date.today()
    fields = {
        "dispatch_rtt_s": round(rtt, 5),
        "h2d_bytes_per_s": round(h2d, -3),
        "d2h_bytes_per_s": round(d2h, -3),
        "solve_s_per_record": float(f"{solve_per_record:.3g}"),
        "solve_s_per_contig_min": float(f"{solve_contig_min:.3g}"),
        "device_s_per_contig": float(f"{dev_per_contig:.3g}"),
        "device_s_per_step": float(f"{dev_per_step:.3g}"),
    }
    if finish_vs_solve is not None:
        fields["finish_vs_solve"] = round(finish_vs_solve, 3)
    fields["_meta"] = {
        "date": today.isoformat(),
        "stale_after": (today + datetime.timedelta(days=120)).isoformat(),
        "device_kind": kind,
        "method": "devbench --calibrate (transfer round trips, native "
                  "solve phases, cold-graph Amdahl A/B with the finish "
                  "side paying export/pack + finish_bulk8 and no DP, "
                  "chained kernel launches)",
        "n_contigs": n_contigs,
        "details": details,
    }
    return fields


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _bigv_wire(V: int, seed: int):
    """Chain-shaped V-vertex ragged wire (same construction as
    bench_bigv)."""
    import numpy as np

    from alignasm_tpu.ops.dense import ANOM_SHIFT

    rng = np.random.default_rng(seed)
    us = np.repeat(np.arange(V - 1), 4)
    span = rng.integers(1, 16, len(us))
    vs = np.minimum(us + span, V - 1)
    keep = us < vs
    keys = np.unique(us[keep].astype(np.int64) * V + vs[keep])
    us, vs = keys // V, keys % V
    ws = rng.integers(0, 3000, len(us)).astype(np.int64)
    wa = rng.integers(0, 4, len(us)).astype(np.int64)
    val = (ws | (wa << ANOM_SHIFT)).astype(np.int32)
    ent = np.stack([us * V + vs, val])
    extra = np.array([[V * V, V * V + 1], [V - 1, 0]])
    return np.concatenate([ent, extra], axis=1).astype(np.int32)


def _deep_merge(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def device_label() -> dict:
    """The device every result of this module was measured on."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": jax.device_count()}


def main() -> None:
    from alignasm_tpu.runtime import ensure_jax_compile_cache

    ensure_jax_compile_cache()
    argv = sys.argv[1:]
    if "--bigv-sweep" in argv:
        _emit(bench_bigv_sweep())
        return
    if "--calibrate" in argv:
        argv.remove("--calibrate")
        out_path = None
        if "--out" in argv:
            i = argv.index("--out")
            out_path = argv[i + 1]
            del argv[i:i + 2]
        if out_path is None:
            from alignasm_tpu.runtime.costmodel import CALIBRATION_PATH
            out_path = CALIBRATION_PATH
        n = int(argv[0]) if argv else 20000
        cal = calibrate(n_contigs=n)
        tmp = out_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(cal, fh, indent=1)
            fh.write("\n")
        import os

        os.replace(tmp, out_path)
        _emit({"calibration": cal, "written": out_path})
        return

    n = int(argv[0]) if argv else 2000
    sections = (
        ("end_to_end", lambda: bench_end_to_end(n)),
        ("kernels", lambda: {"kernels": bench_kernels()}),
        ("bigv", lambda: {"kernels": {"bigv": bench_bigv()}}),
    )
    merged: dict = {"device": device_label()}
    failed = []
    for name, fn in sections:
        try:
            part = fn()
        except Exception as exc:  # later sections still run ...
            part = {f"{name}_error": repr(exc)[:300]}
            failed.append(name)
        _deep_merge(merged, part)
        _emit(part)  # streaming: a later failure can't lose this section
    _emit(merged)  # the last line is the full object
    if failed:  # ... but a failed section fails the run
        sys.exit(f"devbench sections failed: {failed}")


if __name__ == "__main__":
    main()
