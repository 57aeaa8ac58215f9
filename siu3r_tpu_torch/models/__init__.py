"""The two-view SIU3R model in PyTorch."""
