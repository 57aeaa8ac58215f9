"""Prediction heads: DPT, multi-resolution DPT and linear."""

from typing import Sequence

from siu3r_tpu_torch.models.heads.dpt import DPTHead, MultiResDPTGSHead, postprocess_pts3d  # noqa: F401
from siu3r_tpu_torch.models.heads.linear import LinearGS, LinearPts3d  # noqa: F401


def head_factory(head_type: str, output_mode: str, *, out_nchan: int = 3, patch_size: int = 16,
                 token_dims: Sequence[int] = (1024, 768, 768, 768)):
    """A prediction head, counterpart of ``siu3r_tpu.models.heads.head_factory``.
    ``token_dims`` are the widths of the four hooked token maps (the linear
    head reads the last): torch layers need their input widths, which flax
    infers."""
    if head_type == "linear" and output_mode == "pts3d":
        return LinearPts3d(token_dims[-1], patch_size=patch_size)
    if head_type == "dpt" and output_mode == "pts3d":
        return DPTHead(3, token_dims, head_type="regression", patch_size=patch_size)
    if head_type == "dpt" and output_mode == "gs_params":
        return DPTHead(out_nchan, token_dims, head_type="regression", patch_size=patch_size)
    if head_type == "dpt_gs" and output_mode == "gs_params":
        return DPTHead(out_nchan, token_dims, head_type="gs_params", patch_size=patch_size)
    if head_type == "multi_res_dpt_gs" and output_mode == "gs_params":
        return MultiResDPTGSHead(out_nchan, token_dims, patch_size=patch_size)
    raise NotImplementedError(f"unexpected {head_type=} {output_mode=}")
