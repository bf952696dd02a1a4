"""Checkpoint and resume of the progressive render state.

Port of `opencl_path_tracer_tpu/io/checkpoint.py` (the reference has no
checkpoints: its accumulation lives only in the device `colors` buffer,
main.cpp:1100-1148). The file is the JAX package's, key for key and
dtype for dtype, so each package resumes the other's checkpoints: an
`.npz` (written by `np.savez_compressed`) with a JSON string `meta`
holding `version` (FORMAT_VERSION) and `model`, and

  * megakernel (`TraceState`): `colors` (N, 3) float32, `rng_state` (N,)
    uint32 and `sample` a 0-d int32 (the port holds the Lehmer states as
    int64 values below 2^31 and the counter as a host int);
  * wavefront (`WavefrontState`): every field in the dataclass's order,
    each V3 field stacked to (N, 3) float32 beside a `<name>__v3` True
    marker, `rng_state` uint32 and `step` a 0-d uint32 (a host int in
    the port).

A version-1 checkpoint without `model` is a megakernel state. Wavefront
fields that an older file lacks load as zeros (bool `had_diffuse`,
float32 `prev_pdf` and `lum_m2`): a resumed adaptive render restarts its
variance estimate; finished samples are unaffected.

`np.savez_compressed` appends `.npz` to a path that does not end in it,
as in the JAX package: `save_checkpoint("run", st)` writes `run.npz`.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from opencl_path_tracer_tpu_torch import interop
from opencl_path_tracer_tpu_torch.models.wavefront import WavefrontState

FORMAT_VERSION = 1


def save_checkpoint(path: str, state, meta: dict | None = None) -> None:
    """state: a TraceState or a WavefrontState (its model goes in meta)."""
    if isinstance(state, WavefrontState):
        arrays = {}
        for name, v in interop.wavefront_state_to_numpy(state).items():
            if isinstance(v, tuple):
                arrays[name] = np.stack(v, -1)
                arrays[name + "__v3"] = np.asarray(True)
            elif name == "step":
                arrays[name] = np.asarray(v, np.uint32)
            else:
                arrays[name] = v
        model = "wavefront"
    else:
        st = interop.state_to_numpy(state)
        arrays = {"colors": st["colors"], "rng_state": st["rng_state"],
                  "sample": np.asarray(st["sample"], np.int32)}
        model = "megakernel"
    np.savez_compressed(path, **arrays, meta=json.dumps(
        {"version": FORMAT_VERSION, "model": model, **(meta or {})}))


def load_checkpoint(path: str, device="cpu"):
    """(state, meta), the state on `device`; its type follows
    meta["model"] ("megakernel" when absent)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("version") != FORMAT_VERSION:
            raise ValueError(f"checkpoint version {meta.get('version')} != "
                             f"{FORMAT_VERSION}")
        if meta.get("model", "megakernel") == "wavefront":
            n = z["samples"].shape[0]
            fields = {}
            for f in dataclasses.fields(WavefrontState):
                if f.name not in z:
                    fields[f.name] = np.zeros(
                        n, bool if f.name == "had_diffuse" else np.float32)
                elif f.name + "__v3" in z:
                    a = z[f.name]
                    fields[f.name] = tuple(a[:, k] for k in range(3))
                else:
                    fields[f.name] = z[f.name]
            return interop.wavefront_state_from_numpy(fields, device), meta
        state = interop.state_from_numpy(z["colors"], z["rng_state"],
                                         int(z["sample"]), device=device)
    return state, meta
