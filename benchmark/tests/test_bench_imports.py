"""What the benchmark imports: never JAX or the JAX package (top-level
names compared whole), and the reference nothing of the port."""

import ast
import pathlib
import subprocess
import sys

import pytest

from benchmark import run

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "opencl_path_tracer_tpu"}
PORT = "opencl_path_tracer_tpu_torch"
# The modules that must not touch the program: everything but program.py.
PLAIN = ["reference.py", "scenes.py", "compare.py", "peaks.py", "loops.py",
         "trace.py", "manifest.py", "readings.py", "ranks.py"]


def top_imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not top_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", PLAIN)
def test_plain_modules_do_not_import_the_port(name):
    assert PORT not in top_imports(HERE / name)


def test_reference_loads_no_port_module():
    code = ("import sys; import benchmark.reference, benchmark.compare; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True).stdout
    assert PORT not in out and "'jax'" not in out


def test_run_and_program_load_no_jax():
    code = ("import benchmark.run as r, benchmark.program, benchmark.readings; "
            "print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True).stdout
    assert out.strip() == "[]"


def test_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "opencl_path_tracer_tpu_torch_x", sys)
    assert "opencl_path_tracer_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "opencl_path_tracer_tpu.ops", sys)
    assert "opencl_path_tracer_tpu" in run.forbidden_modules()
