"""Device ms a decode step: the device time of the work launched inside the ranges around ``step_pipelined`` over the step graphs replayed there (device trace)."""

from h100_bench import readers


def read(run):
    return readers.decode_step_ms(run)
