"""PLY export/import (reference schema), copied from the JAX package: pure numpy."""

from siu3r_tpu_torch.io.ply import export_ply, read_ply  # noqa: F401
