"""Determinism checking: rerun a function and compare its outputs bit
for bit.

Port of `opencl_path_tracer_tpu/utils/determinism.py`, the JAX
package's analog of race detection. The reference's only shared-memory
hazard is the RNG's read-modify-write of its global seed buffer, safe
because each work-item owns its slot (prog.cl:72-77). On the card the
port's hazards are the ones a rerun exposes: float atomics whose order
the scheduler picks (`index_add_` on CUDA) and kernels whose merge could
depend on the order in which blocks or lanes arrive.

`tree_leaves_with_path` is the port's counterpart of
`jax.tree.leaves_with_path` with `jax.tree_util.keystr` paths: it walks
tuples and lists ("[i]"), dicts ("['key']"), NamedTuples and
dataclasses (".field", as the port's TraceState, WavefrontState and
Hits).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

_INT_VIEW = {torch.float64: torch.int64, torch.float32: torch.int32,
             torch.float16: torch.int16, torch.bfloat16: torch.int16}


def tree_leaves_with_path(tree, path: str = "") -> list:
    """[(path, leaf)] of every leaf that is not None, depth first in
    field, key and index order."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f".{f.name}", getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    elif isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in tree]
    else:
        return [(path, tree)]
    out = []
    for key, sub in items:
        out += tree_leaves_with_path(sub, path + key)
    return out


def bitwise_equal(a, b) -> bool:
    """Whether two leaves hold the same bits (NaN equal to NaN, whatever
    its payload; -0.0 unequal to +0.0). Tensors are compared on their
    own device, numpy arrays on the host; other leaves (host ints,
    floats, strings) with ==."""
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        a, b = (torch.from_numpy(np.ascontiguousarray(x)) for x in (a, b))
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
            return False
        if (a.shape != b.shape or a.dtype != b.dtype
                or a.device != b.device):
            return False
        if a.dtype in _INT_VIEW:
            view = _INT_VIEW[a.dtype]
            same = (a.contiguous().view(view) == b.contiguous().view(view)) \
                | (torch.isnan(a) & torch.isnan(b))
            return bool(same.all())
        return torch.equal(a, b)
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return type(a) is type(b) and a == b


def check_deterministic(fn, *args, runs: int = 2) -> list[str]:
    """Run fn(*args) `runs` times; return the sorted paths of the output
    leaves that differ bitwise from the first run's (empty: the function
    is deterministic). A leaf missing from a run counts as differing."""
    baseline = tree_leaves_with_path(fn(*args))
    problems: set[str] = set()
    for _ in range(runs - 1):
        again = dict(tree_leaves_with_path(fn(*args)))
        for path, a in baseline:
            if path not in again or not bitwise_equal(a, again[path]):
                problems.add(path)
    return sorted(problems)
