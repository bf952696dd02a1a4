"""The port's `utils/` against the JAX package's on the CPU:
`check_deterministic` (a megakernel step is deterministic; a function
made to differ is not, with jax.tree_util.keystr-style paths through
NamedTuples, dataclasses, dicts and tuples), `device_timer` and
`trace_profile`, `get_logger` (the handler's format and level equal
JAX's), `version.py` and the package root's exports."""

import collections
import dataclasses
import glob
import itertools
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

import opencl_path_tracer_tpu as jpkg
import opencl_path_tracer_tpu_torch as pkg
from opencl_path_tracer_tpu.utils import logging as jlog
from opencl_path_tracer_tpu_torch import utils
from opencl_path_tracer_tpu_torch.models import megakernel
from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
from opencl_path_tracer_tpu_torch.scene import library
from opencl_path_tracer_tpu_torch.utils import determinism, profiling
from opencl_path_tracer_tpu_torch.utils import logging as plog

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

Pair = collections.namedtuple("Pair", ["left", "right"])


@dataclasses.dataclass
class Box:
    items: tuple
    note: dict


def test_version_and_root_exports():
    assert pkg.__version__ == jpkg.__version__ == "0.1.0"
    assert pkg.__all__ == jpkg.__all__ == ["__version__", "config"]
    assert pkg.config.RenderConfig().width == jpkg.config.RenderConfig().width
    assert utils.__all__ == ["trace_profile", "device_timer", "get_logger",
                             "check_deterministic"]


def _step(accel, mode):
    w = h = 8
    scene = library.cornell_box(with_spheres=True)
    cam = library.cornell_camera(w, h)
    isect = make_intersect_fn(scene, accel)

    def step(st):
        return megakernel.trace_sample(
            cam, scene.mats, st, intersect_fn=isect, iterations=2,
            mode=mode, key=(0, 1))

    return step, megakernel.init_state(w * h, 1)


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_megakernel_step_is_deterministic(mode):
    step, state = _step("auto", mode)
    assert utils.check_deterministic(step, state) == []
    assert utils.check_deterministic(step, state, runs=3) == []


def test_a_function_made_to_differ_is_flagged():
    """As tests/test_runtime.py:200-227 flags a counter; the paths name
    the NamedTuple field, the dataclass field and the tuple slot."""
    counter = itertools.count()
    fixed = torch.arange(4.0)

    def bad(_):
        k = float(next(counter))
        return Pair(left=fixed, right=(fixed + k, Box(
            items=(fixed, torch.full((2,), k)), note={"n": 3, "k": k})))

    got = utils.check_deterministic(bad, None)
    assert got == [".right[0]", ".right[1].items[1]", ".right[1].note['k']"]
    assert utils.check_deterministic(bad, None, runs=1) == []
    # The step's own state: a TraceState whose sample counter moves.
    step, state = _step("auto", "parity")
    held = [state]

    def chained(_):
        held[0] = step(held[0])
        return held[0]

    got = utils.check_deterministic(chained, None)
    assert ".sample" in got and ".rng_state" in got
    assert all(p.startswith((".colors[", ".rng_state", ".sample"))
               for p in got)


def test_paths_are_jax_keystr_paths():
    tree = Pair(left={"a": np.zeros(2), "b": (np.ones(1), np.ones(3))},
                right=[np.zeros(1)])
    ref = [jax.tree_util.keystr(p)
           for p, _ in jax.tree.leaves_with_path(tree)]
    ours = [p for p, _ in determinism.tree_leaves_with_path(tree)]
    assert sorted(ours) == sorted(ref)


@pytest.mark.parametrize("a,b,same", [
    (torch.tensor([1.0, float("nan")]), torch.tensor([1.0, float("nan")]),
     True),
    (torch.tensor([0.0]), torch.tensor([-0.0]), False),
    (torch.tensor([1.0]), torch.tensor([1.0], dtype=torch.float64), False),
    (torch.tensor([1, 2]), torch.tensor([1, 2]), True),
    (torch.tensor([True]), torch.tensor([False]), False),
    (torch.zeros(2), torch.zeros(3), False),
    (float("nan"), float("nan"), True),
    (3, 3, True),
    (3, 3.0, False),
    (np.float32([np.nan, 1]), np.float32([np.nan, 1]), True),
    (np.float32([0.0]), np.float32([-0.0]), False),
    (np.zeros(2), torch.zeros(2, dtype=torch.float64), False),
])
def test_bitwise_equal(a, b, same):
    assert determinism.bitwise_equal(a, b) is same


def test_device_timer_returns_seconds_a_call():
    step, state = _step("auto", "fast")
    dt = utils.device_timer(step, state, iters=2, warmup=1)
    assert isinstance(dt, float) and dt > 0.0
    # The fetch: first elements of every output tensor, as float32.
    out = Pair(left=torch.tensor([2.0, 5.0]), right=(torch.tensor([3]), 7))
    assert float(profiling._scalarize(out)) == 5.0


def test_trace_profile_writes_a_trace(tmp_path):
    logdir = tmp_path / "prof"
    step, state = _step("auto", "fast")
    with utils.trace_profile(str(logdir)):
        step(state)
    files = glob.glob(os.path.join(logdir, "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    # Written when the block raises, too.
    with pytest.raises(ZeroDivisionError):
        with utils.trace_profile(str(logdir)):
            1 / 0
    assert len(glob.glob(os.path.join(logdir, "trace_*.json"))) == 2


@pytest.fixture
def fresh_ptx_logger(monkeypatch):
    root = logging.getLogger("ptx")
    saved = (root.handlers[:], root.level, root.propagate)
    monkeypatch.setenv("PTX_LOG", "debug")
    yield root
    root.handlers[:], root.level, root.propagate = saved
    plog._CONFIGURED = jlog._CONFIGURED = False


def _configure(mod, root):
    root.handlers.clear()
    root.setLevel(logging.NOTSET)
    mod._CONFIGURED = False
    logger = mod.get_logger("ptx.child")
    (handler,) = root.handlers
    return (logger.name, handler.formatter._fmt, handler.stream,
            root.level, root.propagate)


def test_get_logger_matches_jax(fresh_ptx_logger):
    ours = _configure(plog, fresh_ptx_logger)
    ref = _configure(jlog, fresh_ptx_logger)
    assert ours == ref
    assert ours[3] == logging.DEBUG and ours[4] is False
    # Configured once: a second call adds no handler.
    plog.get_logger()
    assert utils.get_logger().name == "ptx"
    assert len(fresh_ptx_logger.handlers) == 1
