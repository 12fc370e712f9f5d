"""collective_bytes.sharded4: bytes a frame that rank 0 hands to the
program's collectives, from its own counter: every `srt.all_reduce` and
`srt.gather` span's bytes (`profiling.span_bytes()`) over the frames
drawn (`srt.draw` spans), counted over the run's process (set-up's
frame included: every frame runs the same collectives). A sample-
parallel frame is one all-reduce of W x H x 3 float32; a second
collective or a gather shows here. Read in a traced run on the card;
None without device events (a run on the CPU), without the counter (a
program that has none) or where no collective ran."""

COLLECTIVES = ("srt.all_reduce", "srt.gather")


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    from software_rasterizer_tpu_torch.utils import profiling

    span_bytes = getattr(profiling, "span_bytes", None)
    if span_bytes is None:
        return None
    handed = span_bytes()
    draws = profiling.span_totals().get("srt.draw", (0, 0.0))[0]
    if not draws or not any(name in handed for name in COLLECTIVES):
        return None
    return sum(handed.get(name, 0) for name in COLLECTIVES) / draws
