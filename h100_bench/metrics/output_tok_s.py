"""Output tokens the engine added to its requests inside the window, over the window's length (host clock)."""

from h100_bench import readers


def read(run):
    return readers.output_tokens(run) / run.seconds
