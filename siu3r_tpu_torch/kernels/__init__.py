"""Hand-written CUDA kernels for Hopper and their Python wrappers.

``flash_attention.flash_attn`` (kernels ``flash_attn_rope`` / ``flash_attn``),
``msda.msda`` (kernel ``msda``), ``binning.bin_gaussians`` (kernel ``bin``)
and ``raster.raster`` (kernel ``raster``) launch the kernels of ``csrc/`` on
CUDA tensors and run their plain PyTorch versions on CPU tensors.
"""
