"""PyTorch + CUDA port of ``pcrcg_tpu`` for one NVIDIA H100.

The JAX package ``pcrcg_tpu`` stays the reference; this package mirrors its
module names (``ops/pyramid.py`` here is the counterpart of
``pcrcg_tpu/ops/pyramid.py``) so every function can be held against its
JAX twin.  The registration path runs here end to end:
``make_pair_batch`` -> ``build_pyramid`` -> ``KPFCNN`` (or ``PCRCG``: the
2D backbone's image features lifted onto the points first) ->
interest-point sampling -> feature matching -> RANSAC; so does training.

Its two Pallas kernels became hand-written CUDA C++ for ``sm_90a``
(``csrc/``): the tiled-search distance kernel and the candidate-tile
KPConv.  Each wrapper runs its plain PyTorch version for CPU tensors and
launches its kernel for CUDA tensors, never falling back.

Numerics: fp32 everywhere.  TF32 is switched off for matmuls and cuDNN at
import, so the unary/GCN products keep full fp32 on the card.
"""
import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names the
    CPU.  Raises when CUDA is asked for (or defaulted to) and absent — the
    port never falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev
