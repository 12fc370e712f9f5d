"""mpaths_per_s.culled: `mpaths_per_s` in the cells whose frames the
culled tier of the path kernel renders (scenes above 512 triangles). A
name of its own so that its bound follows these cells' own spread: they
keep the card busy, and run to run they spread by under 1% where the
36-triangle cell, half host time, spreads by 8-9%."""

from harness import stats


def read(ctx):
    return stats.rate(ctx.frames * ctx.work_per_frame, ctx.window_s) / 1e6
