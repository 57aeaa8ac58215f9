"""Torch ops: RoPE2D, plain attention and its dispatch, plain deformable attention."""
