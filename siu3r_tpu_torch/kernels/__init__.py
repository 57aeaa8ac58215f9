"""Hand-written CUDA kernels for Hopper and their Python wrappers.

``flash_attention.flash_attn`` (kernels ``flash_attn_rope`` / ``flash_attn``)
and ``msda.msda`` (kernel ``msda``) launch the kernels of ``csrc/`` on CUDA
tensors and run their plain PyTorch versions on CPU tensors.
"""
