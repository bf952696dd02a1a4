"""Render configuration.

Port of `opencl_path_tracer_tpu/config.py`: the same fields and
defaults (reference globals main.cpp:19-43), JSON round-trippable. The
port honours the megakernel and wavefront models, both modes, the
camera, bounce depth, spp, seed, tonemap, QMC jitter, Russian roulette
(wavefront), next-event estimation (nee, nee_select, nee_anyhit), smooth
shading, image textures (textured), the environment (env_light with
env_sky and env_deep, or env_map with env_scale, env_nee and
env_sample_res), thin-lens depth of field (dof_aperture, dof_focus) and
the 'auto' / 'minarg' / 'pallas' / 'tilecull' / 'pairwin' / 'pairmx' /
'pair' / 'cluster' / 'group' / 'march' / 'flat' / 'bvh' / 'median' /
'bruteforce' accels and accel_force (the engine runs 'bvh' and 'median'
on CUDA only with it), and devices (the render sharded over that many
ranks of a torch.distributed world, 0 for all; `parallel/`).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

REF_WIDTH = 192 * 8  # 1536
REF_HEIGHT = 108 * 8  # 864
REF_MAX_ITERATIONS = 50
ACCELS = ("auto", "minarg", "pallas", "tilecull", "pairwin", "pairmx",
          "pair", "cluster", "group", "march", "flat", "bvh", "median",
          "bruteforce")


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
    # Image textures: kd multiplied by each material's map_Kd sample at the
    # hit's UV (the scene must carry Scene.textures and corner UVs; the
    # same ids-reporting accels as smooth shading).
    textured: bool = False
    # The reference's dormant miss-branch sky (prog.cl:367-376;
    # models.megakernel.EnvLight): False is the shipped kernel's plain
    # break on a miss.
    env_light: bool = False
    env_sky: tuple[float, float, float] = (0.0, 0.75, 2.0)
    env_deep: tuple[float, float, float] = (1.0, 1.0, 1.0)
    # An environment map (ops/envmap.py): 'gradient', 'sunsky' or a
    # .pfm/.npy/.png path; env_nee adds the importance-sampled gather and
    # its MIS split. Exclusive with env_light.
    env_map: str | None = None
    env_scale: float = 1.0
    env_nee: bool = True
    env_sample_res: tuple[int, int] = (64, 32)
    # Thin-lens depth of field: lens radius and focal-plane distance in
    # world units; aperture 0 is the reference's pinhole.
    dof_aperture: float = 0.0
    dof_focus: float = 0.0
    # Run the accels the engine refuses on CUDA ('bvh', 'median').
    accel_force: bool = False
    # Shard the render over this many ranks (0: every rank of the world;
    # RenderEngine, parallel/launch.py).
    devices: int = 1

    def validate(self) -> "RenderConfig":
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
            raise ValueError(f"unknown accel {self.accel!r}; the port has "
                             f"{ACCELS}")
        if self.model not in ("megakernel", "wavefront"):
            raise ValueError(f"unknown model {self.model!r}")
        if self.nee_select not in ("power", "distance"):
            raise ValueError(f"unknown nee_select {self.nee_select!r} "
                             "('power' or 'distance')")
        if self.devices < 0:
            raise ValueError("devices must be >= 0 (0 = all)")
        if len(self.env_sky) != 3 or len(self.env_deep) != 3:
            raise ValueError("env_sky/env_deep must be RGB 3-tuples")
        if self.env_map is not None:
            if self.env_light:
                raise ValueError("env_map and env_light are mutually "
                                 "exclusive (one environment at a time)")
            if self.env_scale <= 0.0:
                raise ValueError("env_scale must be > 0")
            if (len(self.env_sample_res) != 2
                    or min(self.env_sample_res) < 1):
                raise ValueError(
                    "env_sample_res must be (Ws, Hs) positive ints")
        if self.dof_aperture < 0.0:
            raise ValueError("dof_aperture must be >= 0")
        if self.dof_aperture > 0.0 and self.dof_focus <= 0.0:
            raise ValueError("dof_aperture > 0 needs dof_focus > 0 (the "
                             "focal-plane distance in world units)")
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
