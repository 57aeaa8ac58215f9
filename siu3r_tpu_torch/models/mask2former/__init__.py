"""Video Mask2Former: pixel decoder, masked-attention decoder, post-process."""
