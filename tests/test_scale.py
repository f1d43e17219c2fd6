"""Scale behavior: large single contigs must stay fast and lean —
the reference's dense n^2 cut matrices demand a 512 GB-class host for
karyotype inputs (README.md:25); sparse tables remove that by design."""

import resource
import time

from alignasm_tpu.testing.synth import generate_chain_paf


def test_native_big_contig_fast_and_lean(tmp_path, reference_outputs):
    from alignasm_tpu import native

    paf = tmp_path / "big.paf"
    paf.write_text(generate_chain_paf(1200))
    n_records = paf.read_text().count("\n")
    assert n_records >= 1500

    gold = reference_outputs(paf, tmp_path)

    nat = tmp_path / "nbig.paf"
    nat.write_bytes(paf.read_bytes())
    native.build()  # a post-edit g++ rebuild must not eat the time budget
    rss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.perf_counter()
    stats = native.run(str(nat), threads=2)
    elapsed = time.perf_counter() - t0
    assert stats["records"] == n_records
    assert elapsed < 5.0, f"big contig took {elapsed:.1f}s"

    for g, suffix in zip(gold, ("", ".alt", ".all")):
        got = (tmp_path / f"nbig.aln{suffix}.paf").read_bytes()
        assert g == got, f"aln{suffix} differs on big contig"


def test_parallel_build_byte_identical(tmp_path):
    """Intra-contig parallel graph build (solver.cc build_graph_into:
    chunked cut sweep + per-block edge ranges, engaged at >= 64k
    records): -t4 (parallel build path) must be byte-identical to -t1
    (serial path, helper cap 0).  The oracle cannot run at this scale
    (dense n^2 matrices); serial-vs-parallel is the cross-validation,
    matching the configs[4] protocol."""
    from alignasm_tpu import native

    # ~55k segments -> ~72k records: over the 64k kParBuildMin gate
    paf = tmp_path / "pbuild.paf"
    paf.write_text(generate_chain_paf(55_000, seed=7))
    n_records = paf.read_text().count("\n")
    assert n_records >= (64 << 10) + 1000

    p1 = tmp_path / "pb1.paf"
    p1.write_bytes(paf.read_bytes())
    native.run(str(p1), threads=1)
    native.run(str(paf), threads=4)
    for suffix in ("", ".alt", ".all"):
        a = (tmp_path / f"pb1.aln{suffix}.paf").read_bytes()
        b = (tmp_path / f"pbuild.aln{suffix}.paf").read_bytes()
        assert a == b, f"aln{suffix} differs between -t1 and -t4"
    assert len((tmp_path / "pbuild.aln.paf").read_bytes()) > 0


def test_run_arena_block_crossing_single_worker(tmp_path, reference_outputs):
    """A single parse worker (-t1) over enough records that its RunArena
    spans multiple 32k-pair blocks, plus PairMap growth and scratch-graph
    reuse across many differently-sized contigs — byte-compared to the
    reference.  Guards the block-boundary/rehash/stale-scratch edges of the
    round-3 allocation structures (types.h RunArena/RunSpan,
    solver.h PairMap, build_graph_into)."""
    from alignasm_tpu import native
    from alignasm_tpu.testing.synth import generate_paf

    paf = tmp_path / "arena.paf"
    paf.write_text(generate_paf(n_contigs=1500, seed=912, max_records_per_contig=24))
    n_records = paf.read_text().count("\n")
    assert n_records > 18_000  # ~15+ runs/record -> several arena blocks

    gold = reference_outputs(paf, tmp_path)
    nat = tmp_path / "narena.paf"
    nat.write_bytes(paf.read_bytes())
    stats = native.run(str(nat), threads=1)
    assert stats["records"] == n_records
    for g, suffix in zip(gold, ("", ".alt", ".all")):
        got = (tmp_path / f"narena.aln{suffix}.paf").read_bytes()
        assert g == got, f"aln{suffix} differs"


def test_cooperative_big_group_parse_byte_identical(tmp_path):
    """Contigs >= 32k lines parse cooperatively across the worker pool
    (read_paf splits them into chunks) and format in parallel chunks;
    t1 takes the fully serial path.  Outputs must be byte-identical —
    this is the committed regression for both mechanisms (the 1M-record
    configs[4] runs exercised them manually)."""
    import hashlib

    from alignasm_tpu import native

    p = tmp_path / "coop.paf"
    # ~26k segments -> ~34k records: over the 32k-line cooperative
    # threshold, plus a few small contigs around it
    big = generate_chain_paf(26_000, seed=21)
    small = []
    from alignasm_tpu.testing.synth import generate_paf

    small = generate_paf(n_contigs=12, seed=22)
    p.write_text(small + big)
    n_lines = (small + big).count("\n")
    assert n_lines > 33_000

    def h3():
        return [hashlib.sha256(
            (tmp_path / f"coop.aln{s}.paf").read_bytes()).hexdigest()
            for s in ("", ".alt", ".all")]

    native.run(str(p), threads=4)
    h4 = h3()
    native.run(str(p), threads=1)
    assert h3() == h4
