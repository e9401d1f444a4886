"""The plain reference that decides `correct`: plain PyTorch in float32
with TF32 off (float64 where an int8 sum must be exact), written from the
published model's equations. It imports nothing of the program, the JAX
package or JAX, and takes nothing the program made: the benchmark hands
it the seeded weights and inputs it handed the program, and it works out
everything derived from them (the int8 tower's scales and weights, the
decoder, the random masks) again.
"""

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """float32 contractions in float32: TF32 off for matmuls and cuDNN."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
