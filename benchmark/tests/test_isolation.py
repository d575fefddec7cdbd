"""Nothing the benchmark runs loads JAX or the JAX package, and its
reference and yardstick import nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "object_detection_tracking_tpu"}
PROGRAM = "object_detection_tracking_tpu_torch"
# the benchmark's own files that the program may not reach
PLAIN = ("reference", os.path.join("harness", "work.py"),
         os.path.join("harness", "check.py"),
         os.path.join("harness", "weights.py"),
         os.path.join("harness", "traffic.py"))


def _py_files():
    for d, _, files in os.walk(spec.BENCH_DIR):
        if ".cache" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_no_jax_import_anywhere():
    for path in _py_files():
        for mod in _imports(path):
            assert mod.split(".", 1)[0] not in FORBIDDEN, (path, mod)


def test_reference_imports_nothing_of_the_program():
    for path in _py_files():
        rel = os.path.relpath(path, spec.BENCH_DIR)
        if rel.startswith(PLAIN):
            for mod in _imports(path):
                assert mod.split(".", 1)[0] != PROGRAM, (path, mod)


def test_a_run_loads_no_jax(tmp_path):
    """A tiny CPU run of a cell through the video driver leaves no module
    of a forbidden top-level name (compared whole: the port's name starts
    with the JAX package's)."""
    code = (
        "import sys, time, torch\n"
        "torch.set_num_threads(2)\n"
        "from benchmark.tests.tiny import tiny_driver, tiny_files\n"
        "from benchmark import run\n"
        "f = tiny_files('meva_video_720p')\n"
        "tiny_driver().run(f, 3, 0.5, False, time.perf_counter(),"
        " device='cpu')\n"
        "print('LOADED', run.jax_loaded())\n")
    env = dict(os.environ, PYTHONPATH=spec.ROOT, TMPDIR=str(tmp_path),
               OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout
