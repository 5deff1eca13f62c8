"""Seconds from the process's start to the window's open: loading, the
weights made on the card, kernel builds on a checkout's first run, the
warm-up of every shape the traffic uses and the traffic's own ramp."""


def read(ctx):
    return ctx["setup_s"]
