"""Due time to first token at the client, 75th percentile over every
request due in the window (about 40 at the cell's rate, so ten lie
beyond it); one that failed or never got its first token counts as
infinitely late, and the metric is then not read."""
from perfbench import readers


def read(ctx):
    a, b = ctx["t_open"], ctx["t_close"]
    return readers.pct([readers.ttft_ms(r) for r in ctx["records"]
                        if a <= r.due < b], 0.75)
