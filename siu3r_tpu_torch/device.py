"""Device selection for the port's entry points.

Entry points default to ``cuda`` and raise when no GPU is present. The CPU is
used only when the caller asks for it by name (as the tests do); nothing falls
back to it on its own.

The compute dtype follows ``model.dtype``: fp32 by default, or bf16 in the
backbone and the adapter (parameters fp32, the rest of the model fp32). On a
CUDA device TF32 would round the inputs of every fp32 Linear layer (cuBLAS)
and convolution (cuDNN) to 10 mantissa bits, and cuDNN allows it by default,
so resolving a CUDA device turns it off for the process: TF32 stays off for
the fp32 path, whatever the dtype of the bf16 one.
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
