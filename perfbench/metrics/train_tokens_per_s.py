"""Tokens of every step completed in the window, over the window (which
closes at the end of its last step)."""


def read(ctx):
    steps = ctx["steps"]
    return sum(s["tokens"] for s in steps) / (ctx["t_close"] - ctx["t_open"])
