"""Nothing under msmbench/ imports JAX or the JAX package, and the reference
imports nothing of the program.  Module names are compared by their whole
top-level name (the part before the first dot): the port's name begins with
the JAX package's, so a test of prefixes would be wrong."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from msmbench import FORBIDDEN_MODULES, PORT, testroot

HERE = os.path.join(testroot.REPO, "msmbench")


def _sources():
    for d, _, files in os.walk(HERE):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported_tops(path: str) -> set[str]:
    """The top-level names of the absolute imports of one source file."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(node.args[0].value.split(".", 1)[0])
    return tops


def test_top_level_names_are_compared_whole():
    assert PORT.startswith(FORBIDDEN_MODULES[-1]) and PORT not in FORBIDDEN_MODULES


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = imported_tops(path) & set(FORBIDDEN_MODULES)
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    path = os.path.join(HERE, "reference.py")
    assert imported_tops(path) <= {"__future__", "numpy"}
    with open(path) as f:
        assert PORT not in f.read()


def _loaded_after(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
                         cwd=testroot.REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    mods = ", ".join(os.path.splitext(os.path.basename(p))[0] for p in _sources()
                     if "test_" not in p and "metrics" not in p and "__" not in p)
    tops = _loaded_after(f"from msmbench import {mods}\nimport {PORT}\n"
                         f"from {PORT}.ops.kernels import _build")
    assert PORT in tops and not set(tops) & set(FORBIDDEN_MODULES)


def test_the_reference_loads_nothing_of_the_program():
    tops = _loaded_after("from msmbench import reference")
    assert PORT not in tops and not set(tops) & set(FORBIDDEN_MODULES)
