"""The 90th percentile of the time from sending each request due in the window to ``complete`` returning; a failed request reads as infinitely slow (host clock)."""

from h100_bench import readers


def read(run):
    return readers.latency_p90_ms(run)
