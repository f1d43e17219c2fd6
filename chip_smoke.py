#!/usr/bin/env python3
"""Chip smoke test: the device engine end to end on an NVIDIA GPU.

    python3 chip_smoke.py            # the main path on one card
    python3 chip_smoke.py --four     # only the multi-device path, 4 cards

Everything runs in ONE process (``cli.run`` and
``scheduler.solve_dataset_tpu`` are called in-process), so one JAX
client holds the card.  Phases:

* draft — a fragmented draft assembly (50,000 contigs, ~840k records,
  ~100 MB of PAF): the native engine's bytes are the gold; ``--engine
  tpu`` as shipped and the forced device path must reproduce them, and
  the forced device path must equal the plain reference engine
  (engine/exact.py) on the seeded 2,000-contig slice.
* chains — chromosome-scale contigs that take the other device routes:
  4 contigs of ~6,400 DAG vertices (blocked kernel, one V=8192 slab per
  launch), 8 of ~950 (one batched blocked launch at V=1024) and 16 of
  ~200 (ragged uint8 rows at V=256).  Outputs must equal both the
  native and the exact engine.
* kernels — compile seconds, ``memory_analysis()`` and device time of
  the bucket programs at those shapes, the blocked kernel's rows
  checked bit-equal to the reverse-topological scan's.

Any failure exits non-zero; so does a run where JAX finds no GPU.  The
last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

DRAFT = dict(n_contigs=50_000, seed=2024, max_records_per_contig=24)
SLICE_CONTIGS = 2_000
# (segments per contig, seeds, name prefix): seeds picked so each group
# pads to one bucket V — 8192, 1024 and 256
CHAINS = ((4_000, range(1, 5), "chrom"), (600, range(1, 9), "scaf"),
          (120, range(1, 17), "frag"))
OUT = (".aln.paf", ".aln.alt.paf", ".aln.all.paf")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def outputs(paf: pathlib.Path) -> list[bytes]:
    stem = str(paf)[: -len(".paf")]
    return [pathlib.Path(stem + s).read_bytes() for s in OUT]


def same(label: str, got: list[bytes], want: list[bytes]) -> None:
    for sfx, g, w in zip(OUT, got, want):
        if g != w:
            raise AssertionError(f"{label}: {sfx} differs "
                                 f"({len(g)} vs {len(w)} bytes)")
    log(f"  {label}: byte-identical ({sum(map(len, got))} bytes)")


def place(text_or_src, dst: pathlib.Path) -> pathlib.Path:
    """A copy of the input under its own stem (outputs land beside it)."""
    if isinstance(text_or_src, pathlib.Path):
        shutil.copyfile(text_or_src, dst)
    else:
        dst.write_text(text_or_src)
    return dst


def run_native(paf: pathlib.Path) -> list[bytes]:
    from alignasm_tpu import native

    native.run(str(paf), threads=0)
    return outputs(paf)


def run_exact(paf: pathlib.Path) -> list[bytes]:
    from alignasm_tpu import cli

    if cli.run([str(paf), "--engine", "exact"]) != 0:
        raise RuntimeError(f"exact engine failed on {paf}")
    return outputs(paf)


def run_forced(paf: pathlib.Path) -> tuple[list[bytes], dict]:
    """The device path exactly as ``cli.run --engine tpu`` calls it, with
    the routing forced onto the device."""
    from alignasm_tpu.config import DEFAULT_CONFIG
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu

    cfg = dataclasses.replace(DEFAULT_CONFIG, device_routing="always")
    solve_dataset_tpu(None, cfg, src_paths=(str(paf), None),
                      write_prefix=str(paf)[: -len(".paf")])
    return outputs(paf), dict(solve_dataset_tpu.last_stats)


def check_device_stats(label: str, st: dict, platform: str = "gpu") -> None:
    errors = {k: st[k] for k in ("device_error", "overlap_error") if k in st}
    if errors:
        raise AssertionError(f"{label}: {errors}")
    if st.get("platform") != platform:
        raise AssertionError(f"{label}: ran on {st.get('platform')!r}")
    if st["device"] <= 0:
        raise AssertionError(f"{label}: no contig finished on the device")
    phases = {k: st.get(k) for k in (
        "pack_s", "launch_s", "sync_s", "cfinish_s", "overlap_solve_s",
        "write_s", "total_s", "h2d_bytes", "d2h_bytes")}
    log(f"  {label}: device {st['device']} fallback {st['fallback']} "
        f"native_direct {st['native_direct']} buckets {st['bucket_vs']} "
        f"wire16_buckets {st.get('wire16_buckets', 0)} "
        f"device_routed_frac {st['device_routed_frac']} {phases}")


def phase_draft(work: pathlib.Path, platform: str = "gpu",
                draft=DRAFT, slice_contigs=SLICE_CONTIGS) -> None:
    from alignasm_tpu import cli
    from alignasm_tpu.runtime.scheduler import solve_dataset_tpu
    from alignasm_tpu.testing.synth import generate_paf

    t0 = time.perf_counter()
    text = generate_paf(**draft)
    log(f"  draft corpus: {draft['n_contigs']} contigs, "
        f"{text.count(chr(10))} records, {len(text)} bytes "
        f"(generated in {time.perf_counter() - t0:.1f} s)")
    src = place(text, work / "draft.paf")
    gold = run_native(place(src, work / "draft_native.paf"))

    # --engine tpu as shipped: routing by the card's own calibration
    shipped = place(src, work / "draft_cli.paf")
    if cli.run([str(shipped), "--engine", "tpu"]) != 0:
        raise RuntimeError("cli --engine tpu failed")
    st = solve_dataset_tpu.last_stats
    log(f"  as shipped: device_routed_frac {st['device_routed_frac']} "
        f"routed {st.get('routed')} calibration "
        f"{json.dumps(st['cost_model']['calibration'])}")
    same("cli --engine tpu vs native", outputs(shipped), gold)

    forced = place(src, work / "draft_forced.paf")
    for run in ("first run, compiles included", "second run"):
        got, st = run_forced(forced)
        check_device_stats(f"forced device path, {run}", st, platform)
        if not st.get("wire16_buckets"):
            raise AssertionError(f"draft took no wire16 bucket: {st}")
        same("forced device path vs native", got, gold)

    # the plain reference on the seeded slice (a prefix of the corpus)
    head = generate_paf(**{**draft, "n_contigs": slice_contigs})
    if not text.startswith(head):
        raise AssertionError("the slice is not a prefix of the draft")
    ref = run_exact(place(head, work / "slice_exact.paf"))
    got, st = run_forced(place(head, work / "slice_forced.paf"))
    check_device_stats("forced device path, slice", st, platform)
    same(f"forced device path vs exact engine, {slice_contigs} contigs",
         got, ref)


def chain_corpus(chains=CHAINS) -> str:
    from alignasm_tpu.testing.synth import generate_chain_paf

    return "".join(generate_chain_paf(n, seed=s, name=f"{prefix}{s}")
                   for n, seeds, prefix in chains for s in seeds)


def phase_chains(work: pathlib.Path, platform: str = "gpu", chains=CHAINS,
                 bucket_vs=(8192, 1024, 256), batched=(1024, 8),
                 single=8192) -> None:
    text = chain_corpus(chains)
    log(f"  chain corpus: {sum(len(c[1]) for c in chains)} contigs, "
        f"{text.count(chr(10))} records")
    src = place(text, work / "chains.paf")
    gold = run_native(place(src, work / "chains_native.paf"))
    ref = run_exact(place(src, work / "chains_exact.paf"))
    same("exact engine vs native", ref, gold)
    got, st = run_forced(place(src, work / "chains_forced.paf"))
    check_device_stats("forced device path", st, platform)
    same("forced device path vs native (and exact)", got, gold)

    phases = st.get("bucket_phases", [])
    log(f"  bucket_phases (V, contigs, sync_s, finish_s, device): {phases}")
    for V in bucket_vs:
        n_dev = sum(p[4] for p in phases if p[0] == V)
        if V not in st["bucket_vs"] or n_dev < 1:
            raise AssertionError(f"route V={V}: device {n_dev}, {st}")
    if not any(p[0] == batched[0] and p[1] == batched[1] for p in phases):
        raise AssertionError(f"no batched bucket {batched}: {phases}")
    if any(p[1] != 1 for p in phases if p[0] == single):
        raise AssertionError(f"V={single} slabs share a launch")


def kernel_programs(shapes=((8192, 1), (1024, 8)), small=(256, 16)):
    """(label, jitted fn, static kwargs, V, B) of every bucket program of
    the chain corpus, the reverse-topological scan beside each blocked
    program it is checked against."""
    from alignasm_tpu.ops import dense
    from alignasm_tpu.runtime.scheduler import _blocked_bk

    progs = []
    for V, B in shapes:
        progs.append((f"scan V={V} B={B}",
                      dense.dense_solve_wire_topo_nxt16_ragged,
                      dict(B=B, V=V), V, B))
        progs.append((f"blocked V={V} B={B} Bk={_blocked_bk(V, B)}",
                      dense.dense_solve_wire_topo_nxt16_blocked_ragged,
                      dict(B=B, V=V, Bk=_blocked_bk(V, B)), V, B))
    V, B = small
    progs.append((f"scan uint8 V={V} B={B}",
                  dense.dense_solve_wire_topo_nxt8_ragged, dict(B=B, V=V),
                  V, B))
    return progs


def phase_kernels(card: str, programs=None, reps: int = 5) -> None:
    import jax
    import numpy as np

    from alignasm_tpu.runtime.devbench import _batched_bigv_wire

    rows = {}
    for label, fn, kw, V, B in programs or kernel_programs():
        wire = jax.device_put(_batched_bigv_wire(V, B))
        t0 = time.perf_counter()
        compiled = fn.lower(wire, **kw).compile()
        compile_s = time.perf_counter() - t0
        mem = compiled.memory_analysis()
        out = np.asarray(compiled(wire))  # warm
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(compiled(wire))
            best = min(best, time.perf_counter() - t0)
        mem_s = ("not reported" if mem is None else
                 f"argument {mem.argument_size_in_bytes} output "
                 f"{mem.output_size_in_bytes} temp {mem.temp_size_in_bytes} "
                 f"code {mem.generated_code_size_in_bytes} bytes")
        log(f"  [{card}] {label}: compile {compile_s:.3f} s, device time "
            f"{best * 1e3:.3f} ms/launch ({best * 1e3 / B:.3f} ms/contig, "
            f"best of {reps}, block_until_ready), memory_analysis: {mem_s}")
        rows[(V, B, label.split()[0])] = out
    for (V, B, kind), out in rows.items():
        if kind == "blocked":
            if not (out == rows[(V, B, "scan")]).all():
                raise AssertionError(f"blocked rows differ from scan, "
                                     f"V={V} B={B}")
            log(f"  blocked rows bit-equal to the scan at V={V} B={B}")


def phase_four(work: pathlib.Path, n: int = 4, draft=DRAFT) -> None:
    """The multi-device path: the forced device path over the ``data``
    mesh on the draft corpus, byte-compared with the native engine, then
    dryrun_multichip on the real devices."""
    import jax

    import __graft_entry__
    from alignasm_tpu.testing.synth import generate_paf

    if jax.device_count() < n:
        raise RuntimeError(f"--four needs {n} devices: {jax.devices()}")
    src = place(generate_paf(**draft), work / "draft.paf")
    gold = run_native(place(src, work / "draft_native.paf"))
    got, st = run_forced(place(src, work / "draft_forced.paf"))
    check_device_stats("forced device path over the data mesh", st,
                       jax.devices()[0].platform)
    if st.get("data_mesh_devices") != n:
        raise AssertionError(f"data mesh has {st.get('data_mesh_devices')} "
                             f"devices, want {n}")
    same(f"forced device path on {n} devices vs native", got, gold)
    __graft_entry__.dryrun_multichip(n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device path, on four cards")
    args = ap.parse_args(argv)

    import jax

    from alignasm_tpu import native
    from alignasm_tpu.runtime import ensure_jax_compile_cache

    if jax.default_backend() != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU ({jax.devices()})")
    n_cards = 4 if args.four else 1
    if jax.device_count() < n_cards:
        sys.exit(f"chip_smoke: needs {n_cards} GPUs, JAX has "
                 f"{jax.device_count()}")

    t_all = time.perf_counter()
    log(f"jax {jax.__version__} devices: {jax.devices()}")
    cards = card_lines()
    for line in cards:
        log(line)
    card = cards[0]
    log(f"compile cache: {ensure_jax_compile_cache()}")
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    t0 = time.perf_counter()
    native.build()
    log(f"{gxx}; native library ready in {time.perf_counter() - t0:.1f} s")

    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        phases = ((("four", lambda: phase_four(work)),) if args.four else (
            ("draft", lambda: phase_draft(work)),
            ("chains", lambda: phase_chains(work)),
            ("kernels", lambda: phase_kernels(card)),
        ))
        for name, fn in phases:
            log(f"== {name}")
            t0 = time.perf_counter()
            fn()
            log(f"== {name} ok in {time.perf_counter() - t0:.1f} s")
        peak = [d.memory_stats().get("peak_bytes_in_use")
                for d in jax.devices()[:n_cards]]
        log(f"[{card}] peak_bytes_in_use {peak}; "
            f"wall {time.perf_counter() - t_all:.1f} s")
    finally:
        native.drain_teardowns()
        shutil.rmtree(work, ignore_errors=True)

    dev = jax.devices()[0]
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
