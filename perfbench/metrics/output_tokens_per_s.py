"""New tokens delivered to clients inside the window, over the window."""


def read(ctx):
    a, b = ctx["t_open"], ctx["t_close"]
    n = sum(1 for r in ctx["records"] for t in r.times if a <= t < b)
    return n / (b - a)
