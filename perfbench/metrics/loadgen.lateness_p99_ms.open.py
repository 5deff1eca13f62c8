"""How late the load generator called submit, against each request's
due time: 99th percentile over the requests due in the window's
unprofiled stretches."""
from perfbench import readers


def read(ctx):
    ivs = readers.intervals(ctx)
    return readers.pct([(r.sent - r.due) * 1e3 for r in ctx["records"]
                        if r.sent and readers.inside(r.due, ivs)], 0.99)
