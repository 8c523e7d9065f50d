"""Stencil points advanced a second: interior points × steps completed in
the window (a solve cut by the window's end counts its completed steps),
over the window's seconds on the host clock, in billions."""


def read(ctx):
    if ctx.window_s <= 0 or ctx.steps <= 0:
        return None
    return ctx.points * ctx.steps / ctx.window_s / 1e9
