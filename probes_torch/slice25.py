"""The kernel build and `chip_smoke.check_slice25` alone, on the GPU (about
130 s on an H100), from the root of a checkout:

    python3 probes_torch/slice25.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs


def main():
    import numpy as np
    import torch
    t0 = time.perf_counter()
    cs.import_port()
    from opencl_path_tracer_tpu_torch.scene import library
    cs.device_line(torch)
    cs.build_line()
    scenes = {
        "cornell": library.cornell_box(with_spheres=True, device="cuda"),
        "cornell-analytic": library.cornell_box(
            with_spheres=True, analytic_spheres=True, device="cuda"),
        "many-lights": library.many_light_scene(64, device="cuda"),
        "reference": library.reference_scene(cs.MODELS_DIR, smooth=True,
                                             device="cuda"),
        "stress": library.stress_scene(device="cuda"),
    }
    launches = cs.check_slice25(torch, np, scenes)
    print("launches", launches)
    print(f"slice25: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    try:
        main()
    except cs.SmokeError as e:
        print(f"FAILED: {e}")
        sys.exit(1)
