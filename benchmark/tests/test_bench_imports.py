"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's); the plain reference imports nothing of the port either; and
nothing reads the JAX package's old bench files."""

import ast
import os
import subprocess
import sys

from benchmark import run as bench

BENCH = os.path.join(bench.ROOT, "benchmark")
JAX = {"jax", "jaxlib", "flax", "bulletproofs_r1cs_gadgets_tpu"}
PORT = "bulletproofs_r1cs_gadgets_tpu_torch"


def _sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_import_line_names_jax_or_the_jax_package():
    for path in _sources():
        banned = JAX | ({PORT} if os.sep + "reference" + os.sep in path else set())
        assert not set(_imports(path)) & banned, path


def test_the_guard_compares_whole_top_level_names():
    saved = dict(sys.modules)
    try:
        sys.modules["bulletproofs_r1cs_gadgets_tpu_torch_fake.x"] = object()
        assert bench.banned_modules() == []
        sys.modules["bulletproofs_r1cs_gadgets_tpu.ops"] = object()
        assert bench.banned_modules() == ["bulletproofs_r1cs_gadgets_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


LOAD = """
import sys
for name in ("jax", "jaxlib", "flax", "bulletproofs_r1cs_gadgets_tpu"):
    sys.modules[name] = None  # any import of them fails
import bulletproofs_r1cs_gadgets_tpu_torch
import os
from benchmark import (control, counts, drive, faults, inputs, judge, named,
                       run, spans, system, trace)
from benchmark.reference import verify
for folder in ("traffic", "circuits", "reference/circuits", "metrics"):
    d = os.path.join(named.HERE, folder)
    for f in sorted(os.listdir(d)):
        if f.endswith(".py") and f != "__init__.py":
            named.load(folder, f[:-3])
for name in ("jax", "jaxlib", "flax", "bulletproofs_r1cs_gadgets_tpu"):
    del sys.modules[name]
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def test_the_harness_loads_without_jax():
    got = subprocess.run([sys.executable, "-c", LOAD], cwd=bench.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-2000:]
    loaded = set(eval(got.stdout.strip().splitlines()[-1]))
    assert not loaded & JAX


def test_nothing_reads_the_old_bench_files():
    for path in _sources():
        text = open(path).read()
        for old in ("bench.py", "BENCH_", "BASELINE", "MEGA4096", "MULTICHIP"):
            assert old not in text or path.endswith(
                "test_bench_imports.py"), (path, old)
