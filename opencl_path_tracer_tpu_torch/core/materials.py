"""Materials.

Port of `opencl_path_tracer_tpu/core/materials.py`: the host Material
(main.cpp:92-112) and the device struct (prog.cl:1-5). Types: 0 diffuse
(Lambert kd + Blinn ks), 1 specular conductor, 2 refractive dielectric,
3 emitter (adds emission, then continues with a diffuse bounce).
Conductor F0 per channel from the complex IOR (n, k) (main.cpp:104-110);
the scalar refraction index is mean(n) (main.cpp:103).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class MaterialType(enum.IntEnum):
    DIFFUSE = 0
    SPECULAR = 1
    REFRACTIVE = 2
    EMITTER = 3


def conductor_f0(n, k) -> np.ndarray:
    """Per-channel reflectance at normal incidence (main.cpp:104-110)."""
    n = np.asarray(n, np.float32)
    k = np.asarray(k, np.float32)
    a = (n - 1.0) * (n - 1.0)
    b = (n + 1.0) * (n + 1.0)
    return (k * k + a) / (k * k + b)


@dataclasses.dataclass(frozen=True)
class MaterialsSoA:
    """All scene materials (M entries). Colors are V3 tuples of (M,)
    float32 tensors; n, shininess (M,) float32; type (M,) int32."""

    kd: tuple
    ks: tuple
    emission: tuple
    f0: tuple
    n: torch.Tensor
    shininess: torch.Tensor
    type: torch.Tensor

    @property
    def count(self) -> int:
        return int(self.n.shape[0])

    def take(self, idx: torch.Tensor) -> "MaterialsSoA":
        """Per-ray material fetch: one gather per component."""
        idx = idx.long()

        def g(a):
            return tuple(c[idx] for c in a) if isinstance(a, tuple) else a[idx]

        return MaterialsSoA(**{
            f.name: g(getattr(self, f.name)) for f in dataclasses.fields(self)
        })

    def to(self, device) -> "MaterialsSoA":
        def mv(a):
            return (tuple(c.to(device) for c in a) if isinstance(a, tuple)
                    else a.to(device))

        return MaterialsSoA(**{
            f.name: mv(getattr(self, f.name)) for f in dataclasses.fields(self)
        })


def make_material(kd, ks, emission, N, K, shininess, type) -> dict:
    """One material row as numpy, reference ctor semantics
    (main.cpp:101-111): F0 from (N, K) per channel, n = mean(N)."""
    N = np.asarray(N, np.float32)
    return dict(
        kd=np.asarray(kd, np.float32),
        ks=np.asarray(ks, np.float32),
        emission=np.asarray(emission, np.float32),
        f0=conductor_f0(N, np.asarray(K, np.float32)),
        n=np.float32((N[0] + N[1] + N[2]) / 3.0),
        shininess=np.float32(shininess),
        type=np.int32(type),
    )


def stack_materials(rows: list[dict], device="cpu") -> MaterialsSoA:
    """Stack make_material() rows into a MaterialsSoA on `device`."""
    if not rows:
        rows = [make_material((0, 0, 0), (0, 0, 0), (0, 0, 0),
                              (0, 0, 0), (0, 0, 0), 0, 0)]

    def col(k):
        return torch.as_tensor(np.stack([r[k] for r in rows]), device=device)

    def col3(k):
        a = np.stack([r[k] for r in rows])
        return tuple(torch.as_tensor(np.ascontiguousarray(a[:, i]),
                                     device=device) for i in range(3))

    return MaterialsSoA(
        kd=col3("kd"), ks=col3("ks"), emission=col3("emission"),
        f0=col3("f0"), n=col("n"), shininess=col("shininess"),
        type=col("type"),
    )


def reference_archetypes() -> list[dict]:
    """The ten hardcoded archetypes of the reference scene script
    (main.cpp:751-762)."""
    m = make_material
    z3 = (0.0, 0.0, 0.0)
    return [
        m(z3, z3, (120.0, 100.0, 80.0), z3, z3, 0, 3),            # LAMP
        m(z3, z3, (300.0, 250.0, 200.0), z3, z3, 0, 3),           # SUN
        m((0.3, 0.3, 0.3), z3, z3, z3, z3, 50, 0),                # WHITE_DIFFUSE
        m((0.3, 0.1, 0.1), z3, z3, z3, z3, 50, 0),                # RED_DIFFUSE
        m((0.1, 0.3, 0.1), z3, z3, z3, z3, 50, 0),                # GREEN_DIFFUSE
        m((0.3, 0.0, 0.0), (0.3, 0.3, 0.3), z3, z3, z3, 200, 0),  # PURPLE_SPECULAR
        m((0.05, 0.05, 0.05), (0.3, 0.3, 0.3), z3, z3, z3, 200, 0),  # BLACK_SPECULAR
        m(z3, z3, z3, (3.10, 3.05, 2.05), (3.3, 3.3, 2.9), 0, 1),  # CHROMIUM
        m(z3, z3, z3, (0.17, 0.35, 1.50), (3.1, 2.7, 1.9), 0, 1),  # GOLD
        m(z3, z3, z3, (1.50, 1.50, 1.50), z3, 0, 2),               # GLASS
    ]
