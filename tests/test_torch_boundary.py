"""The port's import boundary: no module of dream_yara_tpu_torch/ and no line
of chip_smoke.py imports `jax` or the JAX package `dream_yara_tpu`, directly,
through an attribute of `jax`, or by a module name handed to importlib. The
scan reads the source (ast) and imports nothing; its own rules are held to
snippets that must and must not be flagged."""

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "dream_yara_tpu_torch"
SOURCES = sorted(p.relative_to(REPO) for p in PKG.rglob("*.py")
                 if "build" not in p.relative_to(PKG).parts) + [Path("chip_smoke.py")]
FORBIDDEN = ("jax", "dream_yara_tpu")
# a string that is exactly a dotted module name under a forbidden package
_MODULE_NAME = re.compile(r"^(jax|dream_yara_tpu)(\.[A-Za-z_]\w*)*$")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def boundary_faults(source: str) -> list[str]:
    """Every place in `source` that reaches jax or dream_yara_tpu."""
    faults = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            faults += [f"import {a.name}" for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                faults.append(f"from {node.module} import ...")
        elif isinstance(node, ast.Name) and node.id == "jax":
            faults.append(f"name jax at line {node.lineno}")
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and _MODULE_NAME.match(node.value)):
            faults.append(f"module name {node.value!r} at line {node.lineno}")
    return faults


@pytest.mark.parametrize("path", SOURCES, ids=str)
def test_port_source_imports_no_jax(path):
    assert boundary_faults((REPO / path).read_text()) == []


def test_no_import_door_left():
    """The port keeps its own host code: the old door into the reference's
    modules is gone, and each host subpackage has its copy."""
    assert not (PKG / "_shared.py").exists()
    for sub in ("utils", "native", "index", "io", "golden"):
        assert (PKG / sub / "__init__.py").exists(), sub
    assert sorted(p.name for p in (PKG / "native").glob("*.cpp")) == [
        "align.cpp", "readpack.cpp", "sais.cpp", "samfmt.cpp", "scatter.cpp",
        "seqio.cpp"]


@pytest.mark.parametrize("snippet", [
    "import jax",
    "import jax.numpy as jnp",
    "from jax import lax",
    "from jax.experimental import pallas as pl",
    "import dream_yara_tpu",
    "import dream_yara_tpu.pipeline.writer as w",
    "from dream_yara_tpu.io.seqstore import SeqStore",
    "from dream_yara_tpu import native",
    "def f():\n    from dream_yara_tpu.native import readpack\n",
    "importlib.import_module('dream_yara_tpu.ops.rank')",
    "__import__('jax')",
    "mod = importlib.util.find_spec('jax.numpy')",
    "x = jax.numpy.zeros(3)",
])
def test_scan_flags_every_way_in(snippet):
    assert boundary_faults(snippet), snippet


@pytest.mark.parametrize("snippet", [
    "import dream_yara_tpu_torch",
    "from dream_yara_tpu_torch.io.seqstore import SeqStore",
    "from .index.fmindex import FMIndex",
    "from ..native import readpack",
    "'''Counterpart of dream_yara_tpu/ops/verify.py::banded_verify.'''",
    "replaces = 'dream_yara_tpu/ops/pallas_verify.py:30'",
    "name = 'dream_yara_tpu_torch.ops'",
    "jaxlike = 1",
])
def test_scan_passes_the_port_itself(snippet):
    assert boundary_faults(snippet) == [], snippet
