"""K1's share of its roofline in the decode steps: the bound of every quantized matmul of the steps traced, from the model's shapes at the slot count, over K1's device time there (device trace)."""

from h100_bench import readers


def read(run):
    return readers.k1_roofline_pct(run)
