"""The port stands alone: no module of `opencl_path_tracer_tpu_torch`, no
twin in `examples_torch/`, no probe in `probes_torch/` and not
`chip_smoke.py` imports JAX or the JAX package, and its kernels are built
the one way the port allows (nvcc for sm_90a, no fast math)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "opencl_path_tracer_tpu_torch"
TWINS = sorted((ROOT / "examples_torch").glob("*.py"))
FILES = (sorted(PORT.rglob("*.py")) + TWINS
         + sorted((ROOT / "probes_torch").glob("*.py"))
         + [ROOT / "chip_smoke.py"])


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib") or top == "opencl_path_tracer_tpu"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imported(tree) if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_port_has_its_modules_and_kernel_sources():
    assert len(FILES) > 20
    for f in ("minarg.cu", "refine1.cu", "spheres.cu", "anyhit.cu",
              "tilecull.cu", "sphere_table.cu", "smooth_refine.cu",
              "pair_cand.cu", "pair_visit.cu", "attr_fetch.cu",
              "pair_vpu.cu", "cluster.cu", "group.cu", "cluster_block.cuh",
              "march.cu", "materialize.cu", "flat.cu", "lazy.cu",
              "march_visit.cuh", "minarg_fused.cu", "mxu.cu"):
        assert (PORT / "csrc" / f).exists()
    for f in ("ops/kernels/march_kernel.py", "ops/kernels/flat_march.py",
              "ops/kernels/lazy_march.py", "models/lazy.py",
              "runtime/anim.py", "runtime/viewer.py", "parallel/mesh.py",
              "parallel/shard.py", "parallel/launch.py", "version.py",
              "utils/determinism.py", "utils/profiling.py",
              "utils/logging.py", "utils/oracle.py"):
        assert (PORT / f) in FILES
    jax_examples = sorted(p.name for p in (ROOT / "examples").glob("*.py"))
    assert [p.name for p in TWINS] == jax_examples and len(TWINS) == 12


def test_build_flags():
    from opencl_path_tracer_tpu_torch.ops.kernels import _build
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--fmad=false" in flags and "fast_math" not in flags
    # Sources with no Pallas counterpart (K21: the JAX megakernel's
    # shading is plain XLA) say so; every other source names the TPU
    # kernel it replaces.
    no_pallas = {"bounce.cu"}
    for name, (src, _sym, _args) in _build.KERNELS.items():
        text = (PORT / "csrc" / src).read_text()
        if src in no_pallas:
            assert "replaces no tpu kernel" in text.lower(), src
        else:
            assert "replaces the tpu kernel" in text.lower(), src
        assert "bounds it" in text.lower(), src
