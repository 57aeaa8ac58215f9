"""The SIU3R model in PyTorch."""
