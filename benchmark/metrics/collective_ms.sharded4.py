"""collective_ms.sharded4: device ms a frame of the NCCL kernels
(`ncclDevKernel_*`, `ncclKernel_*`) on card 0, rank 0's card, the only
one a traced run profiles. An NCCL kernel runs from the moment its rank
enters the collective until the slowest rank has added its share, so
this includes card 0's wait for the slowest rank: what a frame of the
render node loses to the collective and to the ranks being out of step.
The profiler also puts PyTorch's `nccl:all_reduce` annotation on the
device's timeline, over the same stretch; it is no kernel and is not
counted. None where no NCCL kernel ran (a run on the CPU, over gloo)."""

from harness.trace import named

NCCL_KERNELS = named("ncclDevKernel", "ncclKernel")


def read(ctx):
    rec = ctx.trace
    return None if rec is None else rec.kernel_ms_per_frame(NCCL_KERNELS)
