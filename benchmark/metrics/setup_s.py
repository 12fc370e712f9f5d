"""setup_s: seconds from the process's start to the first timed frame:
imports, the CUDA context, loading (on a checkout's first run, building)
the program's kernel libraries, the scene build and upload, and one
warm-up frame. Host clock."""


def read(ctx):
    return ctx.setup_s
