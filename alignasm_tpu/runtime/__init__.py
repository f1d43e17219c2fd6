"""Runtime orchestration: scheduler, cost model, checkpointing, bench."""

from __future__ import annotations

import os
import pathlib
import sys


def ensure_jax_compile_cache() -> str:
    """Point JAX's persistent compilation cache at the framework cache
    dir, so every device entry point (CLI tpu engine, devbench, fuzz
    harness, chip_smoke.py) reuses compiles across processes.

    Honors a pre-set ``JAX_COMPILATION_CACHE_DIR``; otherwise uses
    ``<checkout>/.jax_cache`` (an installed package: the user's cache
    dir).  Returns the directory in use.  Safe to call before or after
    the jax import: jax snapshots the env at import, so when jax is
    already loaded the config is updated directly.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        root = pathlib.Path(__file__).resolve().parents[2]
        if (root / "bench.py").exists():  # running from the repo tree
            d = root / ".jax_cache"
        else:
            d = pathlib.Path.home() / ".cache" / "alignasm_tpu" / "jax_cache"
        try:
            d.mkdir(parents=True, exist_ok=True)
        except OSError:
            return ""
        path = str(d)
        os.environ["JAX_COMPILATION_CACHE_DIR"] = path
    if "jax" in sys.modules:
        try:
            import jax

            jax.config.update("jax_compilation_cache_dir", path)
        except Exception:
            pass  # cache is an optimization; never sink the caller
    return path
