"""Gaussian splat rendering: EWA projection, tile binning and compositing."""
