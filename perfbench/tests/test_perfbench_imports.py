"""Nothing under perfbench/ imports JAX or the JAX package (top-level
names compared whole), and the reference imports nothing of the program."""
import ast
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "pyscf_isdf_tpu"}
PORT = "pyscf_isdf_tpu_torch"
HERE = os.path.join(ROOT, "perfbench")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _modules():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_import_anywhere():
    found = {p: sorted(set(_imports(p)) & FORBIDDEN) for p in _modules()}
    assert not {p: v for p, v in found.items() if v}
    # the port's name begins with the JAX package's: compared whole, it passes
    assert PORT.split(".")[0] not in FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for d, _, files in os.walk(ref):
        for f in files:
            if f.endswith(".py"):
                names = set(_imports(os.path.join(d, f)))
                assert PORT not in names and "perfbench" not in names, f
                assert names <= {"__future__", "dataclasses", "functools", "json", "math",
                                 "os", "numpy", "scipy", "torch"}, (f, names)


RUN = """
import sys, time, json
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import pathlib
import conftest
from perfbench import harness, registry
bench, base = conftest.make_tiny(pathlib.Path({tmp!r}))
r = harness.run_cell(bench, registry.find_workload(bench, "prim9.scf"), 3, 0.2, False,
                     "cpu", time.perf_counter(), base=base)
print(json.dumps(dict(correct=r["correct"], bad=harness.forbidden_modules())))
"""


def test_no_jax_module_after_a_run(tmp_path):
    code = RUN.format(root=ROOT, tests=os.path.dirname(os.path.abspath(__file__)),
                      tmp=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last == '{"correct": true, "bad": []}'
