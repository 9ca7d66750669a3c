"""Device ms an image request's admission: the work launched inside each range around ``engine.prepare`` (image pipeline, tower, projection, prefill; device trace)."""

from h100_bench import readers


def read(run):
    return readers.range_ms(run, "prepare")
