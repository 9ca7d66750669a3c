"""Model FLOPs of every token the window processed (prompts and decode steps) over the window at the card's bf16 peak."""

from h100_bench import readers


def read(run):
    return readers.mfu_pct(run, with_images=False)
