"""As mfu_pct.chat, with the image tower's and projection's FLOPs of each image admitted."""

from h100_bench import readers


def read(run):
    return readers.mfu_pct(run, with_images=True)
