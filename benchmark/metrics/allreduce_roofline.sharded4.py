"""allreduce_roofline.sharded4: the least time the frame's spp all-reduce
could take over `collective_ms.sharded4`, in %.

The least time: of the frame's W x H x 3 float32 (`min_bytes`, fixed by
the frame, never by the program's byte counter), every card must take in
the other three cards' share of the sum, (n - 1) / n of the bytes for n =
4 ranks, and no algorithm (ring, tree, NVLS) moves less into one card.
The link: NVLink 4, 18 links a card on the four-card H100 80GB HBM3
machine (`nvidia-smi nvlink -s` reads 18 links at 26.562 GB/s each),
450 GB/s a direction by NVIDIA's H100 SXM data sheet (900 GB/s of NVLink a card, both directions; 25 GB/s a link and
direction), the figure used here. At 1024 x 1024 that is 9,437,184 B in
20.97 us. None where `collective_ms.sharded4` reads nothing."""

from harness.trace import named

RANKS = 4
LINK_BYTES_PER_S = 450e9
NCCL_KERNELS = named("ncclDevKernel", "ncclKernel")    # as collective_ms.sharded4


def least_ms(frame_bytes: float, ranks: int = RANKS) -> float:
    return (ranks - 1) / ranks * frame_bytes / LINK_BYTES_PER_S * 1e3


def read(ctx):
    rec = ctx.trace
    if rec is None or not ctx.min_bytes:
        return None
    ms = rec.kernel_ms_per_frame(NCCL_KERNELS)
    if ms is None:
        return None
    return 100.0 * least_ms(ctx.min_bytes) / ms
