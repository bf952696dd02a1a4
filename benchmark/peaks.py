"""The chip's published peaks and the intersect's least work.

NVIDIA H100 SXM (80 GB HBM3) data sheet, dense rates, at the full 700 W
power limit: 3.35 TB/s of HBM bandwidth, 67 TFLOP/s of float32 outside
the tensor cores, 989 TFLOP/s of bf16 on them.

The intersect's floor is work that no implementation of a nearest-hit
query can skip, whatever the scene and whatever the algorithm: each
ray's fields are read once (origin and direction, 6 float32) and each
hit field is written once (t, point, normal, material id: 8 words), and
at least one ray-triangle test is made (12 float32 operations: the
plane's t and one edge side). The floor is the larger of the bytes over
the bandwidth and the operations over the float32 rate. It is bound by
bytes, so its share of the measured time reads a few percent or less.

Across cards: 450 GB/s of NVLink in each direction per H100 SXM (18
fourth-generation links of 25 GB/s each way; the data sheet's 900 GB/s
counts both directions). An all_gather of B bytes over n ranks moves
(n - 1) / n x B through each rank's links, NCCL's "bus bandwidth"
convention, so that count over the collective's time can reach the
links' peak and no further.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12

NVLINK_BYTES_PER_S = 450e9

RAY_BYTES = 6 * 4          # origin, direction
HIT_BYTES = 8 * 4          # t, point (3), normal (3), material id
RAY_FLOPS = 12             # one plane t and one edge side


def isect_floor_s(rays: int) -> float:
    """Least seconds for `rays` nearest-hit queries on one H100."""
    return max(rays * (RAY_BYTES + HIT_BYTES) / HBM_BYTES_PER_S,
               rays * RAY_FLOPS / FP32_FLOPS)


def isect_flops(rays: int) -> float:
    return float(rays * RAY_FLOPS)


def frame_bytes(pixels: int) -> int:
    """Bytes of a frame of accumulated colours: 3 float32 a pixel."""
    return int(pixels) * 3 * 4


def all_gather_bus_bytes(total_bytes: int, ranks: int) -> float:
    """Bytes through each rank's links when `ranks` ranks gather a buffer
    of total_bytes: (n - 1) / n of it (each rank already holds its part)."""
    return total_bytes * (ranks - 1) / ranks
