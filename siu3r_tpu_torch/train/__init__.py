"""Training: the Mask2Former criterion with its matcher, LPIPS and the
optimizer (counterparts of ``siu3r_tpu/train/``)."""
