"""DPT prediction heads."""
