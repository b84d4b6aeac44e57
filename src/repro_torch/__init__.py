"""PyTorch + CUDA port of the Khaos reproduction, laid out module for
module like the JAX package ``repro`` beside it.

The port imports torch and numpy only (never jax, never ``repro``).
Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on a CPU tensor every kernel wrapper takes its plain
PyTorch version, on a CUDA tensor it launches the hand-written kernel.
"""
import torch

# float32 matmuls and convolutions run in full float32: the reference
# computes them at full precision, and TF32 keeps only ~3 decimal digits
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
