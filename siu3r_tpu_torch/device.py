"""Device selection for the port's entry points.

Entry points default to ``cuda`` and raise when no GPU is present. The CPU is
used only when the caller asks for it by name (as the tests do); nothing falls
back to it on its own.

The port computes in fp32. On a CUDA device TF32 would round the inputs of
every Linear layer (cuBLAS) and convolution (cuDNN) to 10 mantissa bits, and
cuDNN allows it by default, so resolving a CUDA device turns it off for the
process.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "siu3r_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
