"""Geometries returned in the window over the window's seconds."""


def read(ctx):
    return sum(r["n"] for r in ctx.records) / ctx.window_s
