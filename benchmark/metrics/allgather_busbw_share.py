"""Mesh layer: the frame's all_gather as a share of the NVLink peak, in %:
its bus bytes ((n - 1) / n of the gathered frame, 3 float32 a pixel;
`peaks.all_gather_bus_bytes`) over the device seconds of NCCL's
all_gather kernels a call, the mean over the ranks' profiled phases, at
450 GB/s (`peaks.NVLINK_BYTES_PER_S`). A kernel's time holds any wait
for the last rank to arrive, so the share reads at most the links'."""

from benchmark import peaks


def read(t):
    if t.loop != "offline" or t.device != "cuda" or len(t.ranks) < 2:
        return None
    if not all(r["all_gather_kernels"] and r["images"] for r in t.ranks):
        return None
    per_call = sum(r["all_gather_s"] / r["images"] for r in t.ranks) / len(
        t.ranks)
    moved = peaks.all_gather_bus_bytes(peaks.frame_bytes(t.frame_pixels),
                                       len(t.ranks))
    return 100.0 * moved / per_call / peaks.NVLINK_BYTES_PER_S
