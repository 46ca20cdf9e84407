"""Nothing the benchmark runs imports JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's); the reference
imports nothing of the port; nothing reads the JAX package's old records."""
import ast
import os
import subprocess
import sys

from port_bench import core, harness

FORBIDDEN = {"jax", "jaxlib", "flax", "python_ray_tracer_tpu"}
PORT = "python_ray_tracer_tpu_torch"


def _sources(sub=""):
    base = os.path.join(core.PKG, sub)
    for dirpath, _, files in os.walk(base):
        if os.sep + "tests" in dirpath or "__pycache__" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for sub in ("reference", "frozen"):
        for path in _sources(sub):
            assert PORT not in set(_imports(path)), path


def test_only_system_and_the_kinds_import_the_port():
    users = {os.path.relpath(p, core.PKG) for p in _sources() if PORT in set(_imports(p))}
    assert "system.py" in users
    assert all(u == "system.py" or u.startswith("kinds" + os.sep) for u in users), users


def test_loaded_modules_hold_no_jax():
    code = ("import sys; import port_bench.harness, port_bench.system, port_bench.calibrate; "
            "from port_bench.harness import forbidden_modules; "
            "from port_bench.core import Manifest; m = Manifest(); "
            "[m.kind(m.traffic(w['traffic'])['kind']) for w in m.data['workloads']]; "
            "import port_bench.reference.render, port_bench.reference.fit; "
            "print(forbidden_modules()); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'python_ray_tracer_tpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT, capture_output=True,
                         text=True, check=True).stdout.split("\n")
    assert out[0] == "[]" and out[1] == "[]"


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["python_ray_tracer_tpu_torch.train", "jaxtyping",
                                      "numpy"]) == []
    assert harness.forbidden_modules(["python_ray_tracer_tpu.cli", "jax.numpy"]) == [
        "jax", "python_ray_tracer_tpu"]


def test_nothing_reads_the_old_records():
    for path in _sources():
        with open(path) as f:
            text = f.read()
        for word in ("benchmarks/", "bench.py", "BENCH_", "BASELINE", "chip_smoke"):
            assert word not in text, (path, word)
