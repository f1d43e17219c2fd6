"""Where the golden outputs come from: the C++ reference oracle built
from the sources tests/oracle/Makefile names, where they are present.
Importing this module has no side effects (unlike conftest.py, which
picks the test platform)."""

import pathlib
import re
import shutil
import subprocess

REPO = pathlib.Path(__file__).resolve().parent.parent
ORACLE_DIR = REPO / "tests" / "oracle"
ORACLE_BIN = ORACLE_DIR / "bin" / "alignasm_ref"
DATA_DIR = REPO / "tests" / "data"
OUT_SUFFIXES = (".aln.paf", ".aln.alt.paf", ".aln.all.paf")


def reference_src() -> pathlib.Path:
    """The C++ reference sources the oracle Makefile compiles (its REF)."""
    text = (ORACLE_DIR / "Makefile").read_text()
    return pathlib.Path(re.search(r"^REF\s*:?=\s*(\S+)", text, re.M).group(1))


def oracle_available() -> bool:
    return ORACLE_BIN.exists() or reference_src().is_dir()


def run_oracle(oracle: pathlib.Path, paf: pathlib.Path, workdir: pathlib.Path, extra=()):
    """Run the oracle on a copy of ``paf`` inside ``workdir``; returns the
    three output paths."""
    local = workdir / paf.name
    if local.resolve() != paf.resolve():
        shutil.copy(paf, local)
    subprocess.run(
        [str(oracle), str(local), *extra],
        check=True, capture_output=True, cwd=workdir,
    )
    stem = str(local)[: -len(".paf")]
    return tuple(pathlib.Path(stem + s) for s in OUT_SUFFIXES)
