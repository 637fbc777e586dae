"""The benchmark's plain reference: frozen plain-PyTorch copies of the
port's modules (same relative paths), with every kernel call of the
original replaced by its plain version and the KPConvs in the dense
formulation.  It imports nothing of the port and nothing of JAX, and takes
nothing the program made: the harness hands it the same raw inputs and the
same seeded weights it hands the port.

Precision: IEEE float32, the configurations' precision; ``precision(True)``
runs a block in TF32 (cuBLAS and cuDNN), the correctness control.
"""
import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool = False):
    """cuBLAS products and cuDNN convolutions in TF32 (``tf32``) or IEEE
    float32 inside the block; the process's settings come back after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
