"""The plain reference the benchmark holds the served model to: a frozen
float32 copy of the Phi-3 decoder (``decoder.py``), the CLIP tower and the
image embedding (``clip.py``), the image preprocessing (``image.py``) and
the prompt tokenization (``tokenizer.py``), in plain PyTorch and NumPy.

It imports nothing of the program under test nor of JAX, and takes
nothing the program made: it reads the checkpoint-format weights that the
benchmark makes from the seed, the prompt text and raw pixels, and the
served tokens it judges.  It runs once the program's state is freed,
layer by layer over the sampled sequences, with TF32 off.
"""
