"""Scenes and progressive state carried across from the JAX package.

No counterpart module in `opencl_path_tracer_tpu`. These functions take
plain numpy arrays, so a JAX `Scene`, `TraceState`, `WavefrontState`,
`LazyState`, `ClusterScene`, `EnvMap`, `TexturesSoA` or the fused
pipeline's packed `(F, I, step)` (or a checkpoint of one) converts with
`np.asarray` on each field and no import of JAX here.
Triangle constants are rebuilt from the vertices; they come out bit-equal
to the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.core.materials import MaterialsSoA
from opencl_path_tracer_tpu_torch.core.spheres import SpheresSoA
from opencl_path_tracer_tpu_torch.core.textures import TexturesSoA
from opencl_path_tracer_tpu_torch.models.lazy import LazyState
from opencl_path_tracer_tpu_torch.models.megakernel import TraceState
from opencl_path_tracer_tpu_torch.models.wavefront import WavefrontState
from opencl_path_tracer_tpu_torch.ops.envmap import EnvMap
from opencl_path_tracer_tpu_torch.ops.kernels.cluster_kernel import (
    ClusterScene,
)
from opencl_path_tracer_tpu_torch.ops.shading import VertexAttribs
from opencl_path_tracer_tpu_torch.scene.builder import Scene


def vertex_attribs_from_numpy(fields, device="cpu") -> VertexAttribs:
    """VertexAttribs from a JAX VertexAttribs' `packed` ((T, 17) rows
    [gu gv u0 v0 n1 n2 n3]) and `uv1`, `uv2`, `uv3` (2-tuples of (T,)
    arrays), given as a mapping of those names, e.g. `{f: getattr(
    jax_attribs, f) for f in ("packed", "uv1", "uv2", "uv3")}`. The
    other fields are columns of `packed`, so the copy is bit-equal."""
    packed = torch.as_tensor(np.array(fields["packed"], np.float32),
                             device=device)

    def col(k):
        return packed[:, k].contiguous()

    def v3(base):
        return (col(base), col(base + 1), col(base + 2))

    def uv(name):
        return tuple(torch.as_tensor(np.array(c, np.float32), device=device)
                     for c in fields[name])

    return VertexAttribs(n1=v3(8), n2=v3(11), n3=v3(14), gu=v3(0),
                         gv=v3(3), u0=col(6), v0=col(7), uv1=uv("uv1"),
                         uv2=uv("uv2"), uv3=uv("uv3"), packed=packed)


def scene_from_numpy(r1, r2, r3, mati, mats: dict, *, object_ranges=None,
                     spheres: dict | None = None,
                     attribs: dict | None = None, device="cpu") -> Scene:
    """The port's Scene from a JAX Scene's arrays.

    r1, r2, r3: (T, 3) vertices; mati: (T,) material ids.
    mats: kd, ks, emission, f0 as (M, 3) or V3 tuples of (M,) arrays; n,
    shininess, type as (M,) arrays. spheres: optional dict with c ((S, 3)
    or a V3 tuple), rad (S,), mati (S,). attribs: optional mapping of a
    VertexAttribs' fields (`vertex_attribs_from_numpy`)."""
    tris = TrianglesSoA.build(r1, r2, r3, mati).to(device)

    def col3(v):
        a = (np.stack([np.asarray(c, np.float32) for c in v], -1)
             if isinstance(v, (tuple, list)) else np.asarray(v, np.float32))
        return tuple(torch.as_tensor(np.ascontiguousarray(a[:, k]),
                                     device=device) for k in range(3))

    def col(v, dtype):
        return torch.as_tensor(np.asarray(v, dtype), device=device)

    materials = MaterialsSoA(
        kd=col3(mats["kd"]), ks=col3(mats["ks"]),
        emission=col3(mats["emission"]), f0=col3(mats["f0"]),
        n=col(mats["n"], np.float32),
        shininess=col(mats["shininess"], np.float32),
        type=col(mats["type"], np.int32),
    )
    sph = None
    if spheres is not None:
        c = spheres["c"]
        if isinstance(c, (tuple, list)):
            c = np.stack([np.asarray(x, np.float32) for x in c], -1)
        sph = SpheresSoA.build(c, spheres["rad"], spheres["mati"],
                               device=device)
    if object_ranges is None:
        object_ranges = np.asarray([(0, tris.count)], np.int64)
    return Scene(tris=tris, mats=materials,
                 object_ranges=np.asarray(object_ranges, np.int64),
                 spheres=sph,
                 attribs=(None if attribs is None
                          else vertex_attribs_from_numpy(attribs, device)))


def textures_from_numpy(atlas, height, width, mat_texi, hm: int, wm: int,
                        device="cpu") -> TexturesSoA:
    """TexturesSoA from a JAX TexturesSoA's fields: atlas a V3 of
    (N * hm * wm,) arrays, height, width (N,) and mat_texi (M,) integers,
    hm and wm the padded size. The values are copied as they are."""
    rows = np.zeros((np.asarray(atlas[0]).shape[0], 4), np.float32)
    for k in range(3):
        rows[:, k] = np.asarray(atlas[k], np.float32)

    def i32(v):
        return torch.as_tensor(np.array(v, np.int32), device=device)

    return TexturesSoA(atlas=torch.as_tensor(rows, device=device),
                       height=i32(height), width=i32(width),
                       mat_texi=i32(mat_texi), hm=int(hm), wm=int(wm))


def textures_to_numpy(tex: TexturesSoA) -> dict:
    """{'atlas': V3 of (N * hm * wm,) float32 arrays, 'height', 'width',
    'mat_texi': int32 arrays, 'hm', 'wm': int}: the JAX TexturesSoA's
    fields (its atlas a tuple of the three components)."""
    rows = tex.atlas.cpu().numpy()
    return {"atlas": tuple(np.ascontiguousarray(rows[:, k])
                           for k in range(3)),
            "height": tex.height.cpu().numpy(),
            "width": tex.width.cpu().numpy(),
            "mat_texi": tex.mat_texi.cpu().numpy(),
            "hm": tex.hm, "wm": tex.wm}


def state_from_numpy(colors, rng_state, sample: int,
                     device="cpu") -> TraceState:
    """TraceState from (N, 3) or V3 colors, (N,) uint32 Lehmer states and
    the sample counter."""
    if isinstance(colors, (tuple, list)):
        colors = np.stack([np.asarray(c, np.float32) for c in colors], -1)
    colors = np.asarray(colors, np.float32)
    return TraceState(
        colors=tuple(torch.as_tensor(np.ascontiguousarray(colors[:, k]),
                                     device=device) for k in range(3)),
        rng_state=torch.as_tensor(np.asarray(rng_state).astype(np.int64),
                                  device=device),
        sample=int(sample),
    )


def state_to_numpy(state: TraceState) -> dict:
    """{'colors': (N, 3) float32, 'rng_state': (N,) uint32, 'sample': int}."""
    return {
        "colors": torch.stack(state.colors, -1).cpu().numpy(),
        "rng_state": state.rng_state.cpu().numpy().astype(np.uint32),
        "sample": int(state.sample),
    }


_WF_DTYPES = {"samples": torch.int32, "pixel": torch.int32,
              "rng_state": torch.int64, "inside": torch.bool,
              "bounce": torch.int32, "had_diffuse": torch.bool,
              "prev_pdf": torch.float32, "lum_m2": torch.float32}


def wavefront_state_from_numpy(fields, device="cpu") -> WavefrontState:
    """WavefrontState from a mapping of its field names to arrays, e.g.
    `{f: np.asarray(getattr(jax_state, f)) ...}` of a JAX WavefrontState
    (V3 fields as 3-tuples of (N,) arrays or (N, 3) arrays; rng_state
    uint32; step a scalar)."""
    out = {}
    for f in dataclasses.fields(WavefrontState):
        v = fields[f.name]
        if f.name == "step":
            out[f.name] = int(np.asarray(v))
        elif f.name in _WF_DTYPES:
            a = np.array(v)
            if f.name == "rng_state":
                a = a.astype(np.int64)
            out[f.name] = torch.as_tensor(a, device=device).to(
                _WF_DTYPES[f.name])
        else:
            a = (np.stack([np.asarray(c, np.float32) for c in v], -1)
                 if isinstance(v, (tuple, list)) else np.asarray(v, np.float32))
            out[f.name] = tuple(torch.as_tensor(np.ascontiguousarray(a[:, k]),
                                                device=device)
                                for k in range(3))
    return WavefrontState(**out)


def wavefront_state_to_numpy(state: WavefrontState) -> dict:
    """Field name -> numpy: V3 fields as 3-tuples of (N,) float32,
    rng_state as uint32, step as an int (the JAX state's layout)."""
    out = {}
    for f in dataclasses.fields(WavefrontState):
        v = getattr(state, f.name)
        if f.name == "step":
            out[f.name] = int(v)
        elif isinstance(v, tuple):
            out[f.name] = tuple(c.cpu().numpy() for c in v)
        elif f.name == "rng_state":
            out[f.name] = v.cpu().numpy().astype(np.uint32)
        else:
            out[f.name] = v.cpu().numpy()
    return out


_LAZY_DTYPES = {"samples": torch.int32, "pixel": torch.int32,
                "rng_state": torch.int64, "inside": torch.bool,
                "bounce": torch.int32}


def lazy_state_from_numpy(fields, device="cpu") -> LazyState:
    """LazyState from a mapping of its field names to arrays, e.g.
    `{f: jax.tree.map(np.asarray, getattr(jax_state, f)) ...}` of a JAX
    LazyState: V3 fields as 3-tuples of (N,) arrays, rng_state uint32,
    vis a tuple of CW (N,) uint32 arrays (held as one (CW, N) int32
    tensor of the same bits), step and completions scalars."""
    out = {}
    for f in dataclasses.fields(LazyState):
        v = fields[f.name]
        if f.name == "step":
            out[f.name] = int(np.asarray(v))
        elif f.name == "completions":
            out[f.name] = torch.tensor(int(np.asarray(v)), dtype=torch.int64,
                                       device=device)
        elif f.name == "vis":
            words = np.stack([np.asarray(w, np.uint32) for w in v])
            out[f.name] = torch.as_tensor(words.view(np.int32), device=device)
        elif f.name in _LAZY_DTYPES:
            a = np.array(v)
            if f.name == "rng_state":
                a = a.astype(np.int64)
            out[f.name] = torch.as_tensor(a, device=device).to(
                _LAZY_DTYPES[f.name])
        elif isinstance(v, (tuple, list)):
            out[f.name] = tuple(torch.as_tensor(np.array(c, np.float32),
                                                device=device) for c in v)
        else:
            out[f.name] = torch.as_tensor(np.array(v, np.float32),
                                          device=device)
    return LazyState(**out)


def lazy_state_to_numpy(state: LazyState) -> dict:
    """Field name -> numpy in the JAX LazyState's layout: V3 fields as
    3-tuples of (N,) float32, rng_state uint32, vis a tuple of CW (N,)
    uint32, step an int, completions a uint32 scalar."""
    out = {}
    for f in dataclasses.fields(LazyState):
        v = getattr(state, f.name)
        if f.name == "step":
            out[f.name] = int(v)
        elif f.name == "completions":
            out[f.name] = np.uint32(int(v) & 0xFFFFFFFF)
        elif f.name == "vis":
            words = v.cpu().numpy().view(np.uint32)
            out[f.name] = tuple(words[k] for k in range(words.shape[0]))
        elif isinstance(v, tuple):
            out[f.name] = tuple(c.cpu().numpy() for c in v)
        elif f.name == "rng_state":
            out[f.name] = v.cpu().numpy().astype(np.uint32)
        else:
            out[f.name] = v.cpu().numpy()
    return out


def packed_from_numpy(F, I, step, device="cpu"):
    """The fused pipeline's packed state (F (32, N) float32, I (8, N)
    int32, step int) from numpy or JAX arrays."""
    return (torch.as_tensor(np.array(F, np.float32), device=device),
            torch.as_tensor(np.array(I, np.int32), device=device),
            int(np.asarray(step)))


def packed_to_numpy(F, I, step):
    """(F, I, step) as numpy float32, numpy int32 and an int."""
    return F.cpu().numpy(), I.cpu().numpy(), int(step)


def cluster_scene_from_numpy(boxes, tri_pack, device="cpu") -> ClusterScene:
    """The port's ClusterScene from a JAX ClusterScene's boxes ((C, 8)
    float32) and tri_pack ((C, 24, K) float32), copied bit for bit, so the
    port's K12, K16 and K17 can run on the JAX package's own packs."""
    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    return ClusterScene(boxes=f32(boxes), tri_pack=f32(tri_pack))


def cluster_scene_to_numpy(scene: ClusterScene) -> dict:
    """{'boxes': (C, 8) float32, 'tri_pack': (C, 24, K) float32}."""
    return {"boxes": scene.boxes.cpu().numpy(),
            "tri_pack": scene.tri_pack.cpu().numpy()}


def envmap_from_numpy(img, prob, cum, *, Wi: int, Hi: int, Ws: int, Hs: int,
                      nee: bool = True, device="cpu") -> EnvMap:
    """EnvMap from its (Hi * Wi, 4) radiance rows, (Hs * Ws,)
    probabilities and cumulative table (float32) and its sizes."""
    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    return EnvMap(img=f32(img), prob=f32(prob), cum=f32(cum), Wi=int(Wi),
                  Hi=int(Hi), Ws=int(Ws), Hs=int(Hs), nee=bool(nee))


def envmap_to_numpy(em: EnvMap) -> dict:
    """{'img', 'prob', 'cum': float32 arrays, 'Wi', 'Hi', 'Ws', 'Hs': int,
    'nee': bool}: envmap_from_numpy(**d) rebuilds it."""
    return {"img": em.img.cpu().numpy(), "prob": em.prob.cpu().numpy(),
            "cum": em.cum.cpu().numpy(), "Wi": em.Wi, "Hi": em.Hi,
            "Ws": em.Ws, "Hs": em.Hs, "nee": em.nee}
