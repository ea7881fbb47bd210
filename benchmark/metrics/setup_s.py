"""Seconds from the process's start to the window's: imports, the data made
from the seed, the CUDA context, the program's set-up and the warm-up of
every shape the mix uses (and, in the first run of a checkout, the build
of the port's kernels)."""


def read(ctx):
    return ctx.setup_s
