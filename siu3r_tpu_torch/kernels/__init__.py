"""Hand-written CUDA kernels for Hopper and their Python wrappers.

``flash_attention.flash_attn`` (kernels ``flash_attn_rope`` / ``flash_attn``),
``msda.msda`` (kernel ``msda``), ``binning.bin_gaussians`` (kernel ``bin``),
``raster.raster`` (kernel ``raster``) and ``raster.raster_backward`` (kernel
``raster_bwd``, the backward of ``raster``'s autograd) launch the kernels of
``csrc/`` on CUDA tensors and run their plain PyTorch versions on CPU
tensors. ``flash_attn``, ``msda`` and ``raster`` are differentiable.
"""
