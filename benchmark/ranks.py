"""The multi-rank path: a cell whose configuration renders over `devices`
> 1 runs as one process a rank, one rank a card.

The parent (`run.run_cell`, `readings.main`) starts the ranks through the
port's own launcher (`program.launch`: NCCL one rank a GPU, the kernels
built once before the ranks start; gloo on the CPU). Every rank builds
the engine on its tile of the frame and makes the same calls, so every
collective is reached by all: the set-up and warm-up, then the window or
the two traced phases, then the output gather (`program.pixel_colors`
over the mesh). Rank 0's host clock ends the window (`agree_on_rank0`
after each call), so every rank runs the same calls. What each rank
returns goes back to the parent, which checks rank 0's colours against
the reference once every rank has ended and its memory is freed.

Set-up is counted from the parent's start (`job["t0_wall"]`, on the
wall clock: each rank's own process starts later) to the end of the
last rank's warm-up. A traced run reads rank 0's Trace with every rank's
`trace.rank_summary` beside it.
"""

from __future__ import annotations

import sys
import time

import torch
import torch.distributed as dist


def agree_on_rank0(device: torch.device):
    """agree(stop) -> rank 0's stop on every rank: an all_reduce (MAX) of
    rank 0's flag, the others giving 0."""
    flag = torch.zeros(1, dtype=torch.int32, device=device)

    def agree(stop: bool) -> bool:
        flag.fill_(int(bool(stop)) if dist.get_rank() == 0 else 0)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    return agree


def _rank_device(kind: str) -> torch.device:
    if kind == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def rank_cell(job: dict) -> dict:
    """One rank's part of a run: for each of job["seeds"], the engine on
    this rank's tile, the warm-up, the window (or the traced phases), and
    the checked pixels' colours (rank 0 keeps them). Host values only:
    the launcher pickles them back."""
    from benchmark import loops, program, scenes
    from benchmark import trace as trace_mod
    from benchmark.run import (
        _trace_phases, forbidden_modules, release, render_seed,
    )

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = _rank_device(job["device"])
    man, traffic, render = job["manifest"], job["traffic"], job["render"]
    arrays = scenes.build_scene(job["config"])
    scene = program.build_scene(arrays, dev)
    agree = agree_on_rank0(dev)
    fn, out = None, []
    for seed, pixels in zip(job["seeds"], job["pixels"]):
        eng = program.make_engine(arrays, render, render_seed(seed), dev,
                                  intersect_fn=fn, scene=scene)
        fn = eng.intersect_fn
        if rank == 0:
            print(f"# {job['workload']}: {arrays.num_triangles} triangles, "
                  f"accel {program.accel_name(eng)}, {render['width']}x"
                  f"{render['height']} over {world} ranks, seed "
                  f"{render_seed(seed)}", file=sys.stderr)
        loops.warm_up(eng, traffic)
        agree(False)                  # every rank has warmed up
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        res = dict(setup_s=time.time() - job["t0_wall"],
                   accel=program.accel_name(eng))
        asked = 1
        if job["trace"]:
            tr, last = _trace_phases(eng, traffic, dev, loops, trace_mod)
            asked += tr.rays_samples
            summaries = [None] * world
            dist.all_gather_object(summaries, trace_mod.rank_summary(tr))
            res.update(busy_s=tr.busy_s, window_s=tr.window_s)
            if rank == 0:
                tr.ranks = summaries
                metrics = {}
                for m in man.per_layer(job["workload"]):
                    v = man.reader(m["name"])(tr)
                    if v is not None:
                        metrics[m["name"]] = {"value": float(v),
                                              "unit": m["unit"]}
                res["metrics"] = metrics
                res["breakdown"] = {
                    "device_ops": trace_mod.top_ops(tr.spans),
                    "idle_gaps": trace_mod.idle_gaps(tr.spans)}
        else:
            last = loops.window(eng, traffic, job["seconds"], agree=agree)
            asked += last["samples"]
            res["end_to_end"] = loops.end_to_end(traffic, last)
        res.update(units=last["units"], asked=asked,
                   memory_peak_bytes=int(torch.cuda.max_memory_allocated(dev)
                                         if dev.type == "cuda" else 0),
                   samples=program.samples_done(eng))
        colors = program.pixel_colors(eng, pixels)
        if rank == 0:
            res["colors"] = colors
        del eng, last
        release(dev)
        out.append(res)
    return dict(rank=rank, seeds=out, forbidden=forbidden_modules())


def run(job: dict, world: int, device: str,
        rank_fn=None) -> tuple[list, list]:
    """The ranks of one job: (for each seed, rank 0's result with the
    largest set-up and memory peak over the ranks and the sums of their
    busy and traced seconds; the modules of `run.FORBIDDEN` any rank
    loaded). rank_fn: what each rank runs (rank_cell; the CPU tests plant
    faults through it)."""
    from benchmark import program
    results = program.launch(rank_fn or rank_cell, world, (job,), device)
    merged = []
    for i, res in enumerate(results[0]["seeds"]):
        each = [r["seeds"][i] for r in results]
        res = dict(res)
        res["setup_s"] = max(r["setup_s"] for r in each)
        res["memory_peak_bytes"] = max(r["memory_peak_bytes"] for r in each)
        if "busy_s" in res:
            res["busy_s"] = sum(r["busy_s"] for r in each)
            res["window_s"] = sum(r["window_s"] for r in each)
        merged.append(res)
    forbidden = sorted({m for r in results for m in r["forbidden"]})
    return merged, forbidden
