"""Render configuration.

Port of `opencl_path_tracer_tpu/config.py`: the same fields and
defaults (reference globals main.cpp:19-43), JSON round-trippable. The
port honours the megakernel and wavefront models, both modes, the
camera, bounce depth, spp, seed, tonemap, QMC jitter, Russian roulette
(wavefront), next-event estimation (nee, nee_select, nee_anyhit), smooth
shading and the 'auto' / 'minarg' / 'pallas' / 'tilecull' / 'pairwin' /
'pair' / 'cluster' / 'group' / 'march' / 'flat' / 'bruteforce' accels; every
other field raises NotImplementedError when it is set away from its
default.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

REF_WIDTH = 192 * 8  # 1536
REF_HEIGHT = 108 * 8  # 864
REF_MAX_ITERATIONS = 50
ACCELS = ("auto", "minarg", "pallas", "tilecull", "pairwin", "pair",
          "cluster", "group", "march", "flat", "bruteforce")


@dataclasses.dataclass
class CameraConfig:
    """Camera pose (main.cpp:30-43)."""

    fov: float = 75.0
    yaw: float = -13.800002 - 50
    pitch: float = 5.599997 + 10
    shift: tuple[float, float, float] = (265.055481, 162.305969, 360.414001)


@dataclasses.dataclass
class RenderConfig:
    width: int = REF_WIDTH
    height: int = REF_HEIGHT
    iterations: int = 4
    max_iterations: int = REF_MAX_ITERATIONS
    spp: int = 16
    mode: str = "fast"
    seed: int = 1
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    tonemap: str = "reinhard"
    accel: str = "auto"
    qmc: bool = False
    # 'megakernel' (one full sample per step) or 'wavefront' (path
    # regeneration, the throughput model; bit-identical to the megakernel
    # at equal per-pixel spp in parity mode).
    model: str = "megakernel"
    # Russian roulette after rr_start bounces, survival floored at rr_pmin
    # (wavefront only; None = off).
    rr_start: int | None = None
    rr_pmin: float = 0.05
    # Next-event estimation with MIS (ops/nee.py): one shadow ray per
    # diffuse vertex. nee_select: 'power' (global power-proportional) or
    # 'distance' (per-lane distance weights; sphere emitters only).
    # nee_anyhit: shadow rays through the any-hit kernel K7 instead of the
    # nearest-hit intersector (the same bits, but for rays that graze a
    # zero-area triangle: ROADMAP.md queue 3).
    nee: bool = False
    nee_select: str = "power"
    nee_anyhit: bool = True
    # Smooth shading: interpolated vertex normals at triangle hits (the
    # scene must carry them: Scene.attribs).
    smooth: bool = False
    # Fields of the JAX package's config that this port does not honour
    # yet; validate() refuses them away from these defaults.
    accel_force: bool = False
    textured: bool = False
    env_light: bool = False
    env_sky: tuple[float, float, float] = (0.0, 0.75, 2.0)
    env_deep: tuple[float, float, float] = (1.0, 1.0, 1.0)
    env_map: str | None = None
    env_scale: float = 1.0
    env_nee: bool = True
    env_sample_res: tuple[int, int] = (64, 32)
    dof_aperture: float = 0.0
    dof_focus: float = 0.0
    devices: int = 1

    UNPORTED = ("accel_force", "textured", "env_light",
                "env_sky", "env_deep", "env_map", "env_scale", "env_nee",
                "env_sample_res", "dof_aperture", "dof_focus", "devices")

    def validate(self) -> "RenderConfig":
        defaults = RenderConfig()
        for name in self.UNPORTED:
            if getattr(self, name) != getattr(defaults, name):
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported yet "
                    "(ROADMAP.md queue 1); the port renders without it")
        if self.width <= 0 or self.height <= 0:
            raise ValueError("width/height must be positive")
        if not (1 <= self.iterations <= self.max_iterations):
            raise ValueError(
                f"iterations must be in [1, {self.max_iterations}]")
        if self.mode not in ("parity", "fast"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.tonemap not in ("reinhard", "filmic", "none"):
            raise ValueError(f"unknown tonemap {self.tonemap!r}")
        if self.accel not in ACCELS:
            raise NotImplementedError(
                f"accel {self.accel!r} is not ported yet (ROADMAP.md queue 1, "
                f"the bvh and median accels); the port has {ACCELS}")
        if self.model not in ("megakernel", "wavefront"):
            raise ValueError(f"unknown model {self.model!r}")
        if self.nee_select not in ("power", "distance"):
            raise ValueError(f"unknown nee_select {self.nee_select!r} "
                             "('power' or 'distance')")
        if self.qmc and self.mode != "fast":
            raise ValueError("qmc needs mode='fast' (parity mode's "
                             "per-pixel Lehmer draws are the reference spec)")
        if self.rr_start is not None:
            if self.model != "wavefront":
                raise ValueError(
                    "rr_start needs model='wavefront' (the megakernel runs "
                    "its fixed bounce loop in lockstep; roulette there adds "
                    "variance and saves nothing)")
            if self.rr_start < 1:
                raise ValueError("rr_start must be >= 1")
            if not 0.0 < self.rr_pmin <= 1.0:
                raise ValueError("rr_pmin must be in (0, 1]")
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "RenderConfig":
        raw: dict[str, Any] = json.loads(text)
        cam = raw.pop("camera", None)
        for key in ("env_sky", "env_deep", "env_sample_res"):
            if key in raw:
                raw[key] = tuple(raw[key])
        cfg = cls(**raw)
        if cam is not None:
            cam["shift"] = tuple(cam.get("shift", CameraConfig().shift))
            cfg.camera = CameraConfig(**cam)
        return cfg.validate()
