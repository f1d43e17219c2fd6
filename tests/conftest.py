"""Test configuration.

JAX tests run on a virtual 8-device CPU mesh (the standard trick for
testing sharding without several cards) unless the caller picked the
platform through ``JAX_PLATFORMS``; both must be set before jax is
imported.  Tests marked ``chip`` need an NVIDIA GPU and skip elsewhere:

    python -m pytest tests/ -m chip      # on a machine with the card
"""

import os
import pathlib
import shutil
import subprocess

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

from tests.reference import (  # noqa: E402,F401
    DATA_DIR, ORACLE_BIN, ORACLE_DIR, OUT_SUFFIXES, REPO, oracle_available,
    reference_src, run_oracle,
)


@pytest.fixture(scope="session")
def oracle_bin() -> pathlib.Path:
    """Build (if needed) and return the reference oracle binary; skips
    where the C++ reference sources are not present."""
    if not ORACLE_BIN.exists():
        if not reference_src().is_dir():
            pytest.skip(f"C++ reference sources not present at "
                        f"{reference_src()} (tests/oracle/Makefile REF)")
        subprocess.run(["make", "-C", str(ORACLE_DIR)], check=True,
                       capture_output=True)
    return ORACLE_BIN


@pytest.fixture(scope="session")
def reference_outputs():
    """``ref(paf, workdir, extra=()) -> [bytes] * 3``: the three golden
    outputs for ``paf`` run with the reference CLI flags ``extra``.  The
    C++ oracle produces them where its sources are present, the exact
    Python engine (engine/exact.py, the same flag surface) otherwise.
    The run happens on a copy in its own directory, so no output of the
    caller is overwritten."""
    use_oracle = oracle_available()
    # the oracle's upgrade mode is a compile-time constant: one build each
    builds = {"alt_path": ("all", "alignasm_ref"),
              "single_piece": ("single", "alignasm_ref_sp"),
              "no_update": ("noupdate", "alignasm_ref_nu")}

    def ref(paf, workdir, extra=()):
        paf = pathlib.Path(paf)
        d = pathlib.Path(workdir) / "reference_outputs"
        d.mkdir(parents=True, exist_ok=True)
        if use_oracle:
            extra = list(extra)
            mode = "alt_path"
            if "--upgrade_mode" in extra:
                i = extra.index("--upgrade_mode")
                mode = extra[i + 1]
                del extra[i:i + 2]
            target, name = builds[mode]
            binary = ORACLE_DIR / "bin" / name
            if not binary.exists():
                subprocess.run(["make", "-C", str(ORACLE_DIR), target],
                               check=True, capture_output=True)
            outs = run_oracle(binary, paf, d, extra)
        else:
            from alignasm_tpu import cli

            local = d / paf.name
            shutil.copy(paf, local)
            assert cli.run([str(local), "--engine", "exact", *extra]) == 0
            stem = str(local)[: -len(".paf")]
            outs = [pathlib.Path(stem + s) for s in OUT_SUFFIXES]
        return [o.read_bytes() for o in outs]

    return ref


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX finds none."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest tests/ "
                    "-m chip on a machine with the card)")
    return jax.devices()[0]
