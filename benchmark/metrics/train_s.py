"""Seconds per training: the window's seconds over the trainings it
completed, all the time over all the trainings."""


def read(ctx):
    return ctx.window_s / len(ctx.records)
