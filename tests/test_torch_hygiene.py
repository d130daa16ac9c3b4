"""Import hygiene and copy drift of the torch port.

* Importing every ``repro_torch`` module loads no ``jax*`` and no
  ``repro.*`` module (checked in a fresh interpreter).
* No source of the port, nor ``chip_smoke.py``, imports JAX or the JAX
  package.  Import statements are found with ``ast``: the verbatim copy of
  ``api/__init__.py`` quotes ``from repro import api`` in its docstring.
* Every host-only module the port copies verbatim is, as text, identical
  to the JAX package's file, so the paper's SMR/SCOT code stays one code
  in two packages."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"

COPIED_DIRS = ("configs", "api", "core/smr", "core/structures", "runtime")
COPIED_FILES = ("core/__init__.py", "core/atomics.py", "core/workload.py",
                "serving/policies.py", "serving/sampling.py",
                "serving/faults.py", "serving/watchdog.py")
VERBATIM = sorted(
    [str(p.relative_to(REF)) for d in COPIED_DIRS
     for p in (REF / d).glob("*.py")] + list(COPIED_FILES))
PORT_SOURCES = sorted(str(p.relative_to(ROOT))
                      for p in PORT.rglob("*.py")) + ["chip_smoke.py"]


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib', 'repro.')) or k == 'repro')\n"
        "n = sum(k.startswith('repro_torch') for k in sys.modules)\n"
        "print(n, bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert bad == "[]", bad
    assert int(n) >= 40, "walk_packages found too few port modules"


@pytest.mark.parametrize("rel", PORT_SOURCES)
def test_source_imports_neither_jax_nor_repro(rel):
    text = (ROOT / rel).read_text()
    assert "import jax" not in text
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (rel, name)


@pytest.mark.parametrize("rel", VERBATIM)
def test_host_module_is_a_verbatim_copy(rel):
    port = PORT / rel
    assert port.exists(), f"{rel} is not copied into the port"
    assert port.read_text() == (REF / rel).read_text(), \
        f"{rel} drifted from the reference"
