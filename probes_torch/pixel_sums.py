"""Do the pixel sums of several lanes a pixel change between runs on the
GPU? At 1080p with 4 lanes a pixel in three lane layouts (a pixel's
lanes W x H apart, adjacent, a seeded permutation), 6 runs each: the raw
float32 and float64 `index_add_`, `colors_by_pixel`, the engine's
`image()` and `display_u8_device()`, and a lane-order sum (the rule of
`models/wavefront.py::pixel_sum`) against the CPU's `index_add_`, with
their times. `--cpu` runs it on the CPU at 16x8.

    python3 probes_torch/pixel_sums.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs

DEV = "cpu" if "--cpu" in sys.argv else "cuda"


def ordered_index_add(out, pix, vals):
    import torch
    order = torch.argsort(pix, stable=True)
    sp = pix[order]
    n = sp.shape[0]
    pos = torch.arange(n, device=pix.device)
    new = torch.ones(n, dtype=torch.bool, device=pix.device)
    new[1:] = sp[1:] != sp[:-1]
    start = torch.cummax(torch.where(new, pos, torch.zeros_like(pos)), 0).values
    rank = pos - start
    for r in range(int(rank.max()) + 1):
        sel = order[rank == r]
        p = pix[sel]
        out[p] = out[p] + vals[sel]
    return out


def main():
    import numpy as np
    import torch
    cs.import_port()
    from opencl_path_tracer_tpu_torch.models import wavefront
    from opencl_path_tracer_tpu_torch.ops import raygen, rng
    from opencl_path_tracer_tpu_torch.runtime.engine import (
        RenderEngine, make_intersect_fn)
    from opencl_path_tracer_tpu_torch.scene import library
    from opencl_path_tracer_tpu_torch.utils import check_deterministic
    if DEV == "cuda":
        cs.device_line(torch)
    else:
        cs.W, cs.H = 16, 8
        torch.cuda.synchronize = lambda *a: None
    W, H, L = cs.W, cs.H, 4
    n = W * H
    ana = library.cornell_box(with_spheres=True, analytic_spheres=True,
                              device=DEV)
    cam = library.cornell_camera(W, H, device=DEV)
    isect = make_intersect_fn(ana, "minarg")
    key = rng.key(1)
    for layout in ("repeat", "interleave", "permuted"):
        ids = raygen.pixel_ids_like(n, device=DEV)
        ids = ids.repeat_interleave(L) if layout == "interleave" else ids.repeat(L)
        st = wavefront.init_wavefront(cam, n * L, mode="fast", key=key, ids=ids)
        for _ in range(12):
            st = wavefront.wavefront_step(cam, ana.mats, st, intersect_fn=isect,
                                          iterations=5, mode="fast", key=key)
        if layout == "permuted":
            g = torch.Generator(device=DEV).manual_seed(7)
            perm = torch.randperm(n * L, device=DEV, generator=g)
            st = wavefront._lanes(st, lambda x: x[perm])
        eng = RenderEngine(ana, cs.slice25_cfg("cornell-analytic",
                                               model="wavefront",
                                               accel="minarg"), device=DEV)
        eng.state = st
        pix = st.pixel.long()
        cols = torch.stack(st.colors, -1)
        w32 = st.samples.to(torch.float32)
        w64 = st.samples.to(torch.float64)
        fns = {
            "raw f32 index_add_": lambda s: torch.zeros((n, 3), device=DEV).index_add_(0, pix, w32[:, None] * cols),
            "raw f64 index_add_": lambda s: torch.zeros((n, 3), dtype=torch.float64, device=DEV).index_add_(0, pix, w64[:, None] * cols.double()),
            "colors_by_pixel": lambda s: wavefront.colors_by_pixel(s, n),
            "engine image": lambda s: eng.image(apply_tonemap=False),
            "engine display_u8_device": lambda s: eng.display_u8_device(),
            "ordered f32": lambda s: ordered_index_add(torch.zeros((n, 3), device=DEV), pix, w32[:, None] * cols),
        }
        for name, fn in fns.items():
            t0 = time.perf_counter()
            diff = check_deterministic(fn, st, runs=6)
            extra = ""
            if diff:
                outs = [fn(st) for _ in range(4)]
                outs = [o if isinstance(o, torch.Tensor) else torch.from_numpy(o.copy()) for o in outs]
                extra = f", values differing between runs {[int((outs[0] != o).sum()) for o in outs[1:]]}"
            print(f"probe {layout} {name}: {'deterministic' if not diff else 'differs'}{extra} ({time.perf_counter() - t0:.2f} s for 6 runs)")
        # The ordered sum on the card against the CPU's index_add_.
        cpu = torch.zeros((n, 3)).index_add_(0, pix.cpu(), (w32[:, None] * cols).cpu())
        card = ordered_index_add(torch.zeros((n, 3), device=DEV), pix, w32[:, None] * cols)
        torch.cuda.synchronize()
        print(f"probe {layout} ordered f32 on the card torch.equal to the CPU's index_add_: {torch.equal(card.cpu(), cpu)}; "
              f"raw card index_add_ equal to the CPU's: {torch.equal(fns['raw f32 index_add_'](st).cpu(), cpu)}")
        for name, fn in (("raw f32 index_add_", fns["raw f32 index_add_"]), ("ordered f32", fns["ordered f32"])):
            fn(st); torch.cuda.synchronize(); t0 = time.perf_counter()
            for _ in range(5):
                fn(st)
            torch.cuda.synchronize()
            print(f"probe {layout} {name}: {(time.perf_counter() - t0) / 5 * 1e3:.3f} ms a call")
        del eng, st


if __name__ == "__main__":
    main()
