"""Seconds of set-up spent capturing the steps' CUDA graphs (each a
warm-up run and the capture): the engine's ``capture_s`` summed, or the
training graph's."""


def read(ctx):
    return ctx["capture_s"] or None
