"""Mean busy slots (``len(engine.by_slot)``) at each dispatched chunk of the window (program counter)."""

from h100_bench import readers


def read(run):
    return readers.mean_occupancy(run)
