"""alignasm_tpu — an assembly-alignment engine with a JAX device path.

A from-scratch re-design of the capabilities of ACCtools/alignasm
(reference: /root/reference): parse contig-vs-reference PAF records,
build per-contig alignment DAGs, score transitions (gaps, inversions,
translocations), and infer best / alternative reference paths per contig
via k-shortest-walk search — with the heavy per-contig graph math executed
as batched JAX/XLA programs on an NVIDIA GPU, and contig batches scaled
data-parallel over a `jax.sharding.Mesh`.

Layers (bottom-up):
  io/        host data plane: PAF read/write, cs:Z: tag machinery
  model/     record containers and the PafDistance scoring semiring
  engine/    exact (oracle-faithful) host solver
  ops/       JAX device kernels (cut points, DAG relaxation, top-K)
  parallel/  mesh / shard_map contig-batch data parallelism
  runtime/   bucketing scheduler, progress, resume
"""

__version__ = "0.1.0"

from alignasm_tpu.config import AlignasmConfig  # noqa: F401
