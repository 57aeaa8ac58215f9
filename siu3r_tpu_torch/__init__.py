"""SIU3R on PyTorch and CUDA: the recon+seg forward of ``siu3r_tpu`` over two
views or more, its validation step (novel-view rendering), its training
step and its viewer, rebuilt for one NVIDIA H100.

The JAX package ``siu3r_tpu`` is the reference each module here is held
against; this package imports neither it nor JAX. Attention (with and without
RoPE2D), multi-scale deformable attention, tile binning and tile compositing
run through hand-written CUDA kernels (``csrc/``, built by
``kernels/_build.py`` at first use); on CPU tensors every kernel wrapper runs
its plain PyTorch version instead.
"""

__version__ = "0.1.0"

from siu3r_tpu_torch.device import resolve_device  # noqa: F401
from siu3r_tpu_torch.gaussians import Gaussians  # noqa: F401
