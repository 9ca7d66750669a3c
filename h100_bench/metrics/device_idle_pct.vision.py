"""Share of the traced stretch in which no device operation ran (device trace)."""

from h100_bench import readers


def read(run):
    return readers.idle_pct(run)
