"""Asymmetric CroCo backbones, counterparts of
``siu3r_tpu/models/backbone.py:AsymmetricCroCo`` (two views) and
``AsymmetricCroCoMulti`` (V views), and the encoder-only ``CroCoEncoderOnly``.

Both share one ViT encoder over every view with an intrinsic token (a
Linear(9 -> C) of the flattened intrinsics) appended at the synthetic
position (grid_h, 0), and two decoders, ``dec_blocks`` for view 0 and
``dec_blocks2`` for the other views. In the two-view backbone each layer
cross-attends the other view's *pre-layer* tokens; in the multi-view one it
cross-attends a bank of every view's pre-layer tokens, masked so that no
view reads its own. The module names are the same in both, so one state dict
serves both. The JAX package's ``nn.scan`` stacks become Python loops over
``nn.ModuleList``s.

``dtype`` is the compute dtype of the patch embedding and the blocks (the
JAX modules' ``dtype``); the intrinsic encoder and the decoder embedding stay
fp32, as flax's ``nn.Dense`` without a dtype computes there. Under bf16 the
encoder's residual stream is bf16 (a bf16 patch embedding, the intrinsic
token cast to it, bf16 branches), the normed encoder output is fp32, and so
is the decoders' stream (an fp32 embedding plus bf16 branches).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from siu3r_tpu_torch.config import CrocoCfg
from siu3r_tpu_torch.device import resolve_device
from siu3r_tpu_torch.models.layers import Block, DecoderBlock, LayerNorm, PatchEmbed, init_weights


@dataclasses.dataclass
class BackboneOutput:
    feat1: torch.Tensor  # [B, L, C_enc] final encoder feat, intrinsic token stripped
    feat2: torch.Tensor
    all_feat1: List[torch.Tensor]  # enc_depth x [B, L, C_enc]
    all_feat2: List[torch.Tensor]
    dec1: List[torch.Tensor]  # dec_depth+1 x [B, L, .] ([0] = encoder feat)
    dec2: List[torch.Tensor]
    shape: Tuple[int, int]


@dataclasses.dataclass
class MultiViewBackboneOutput:
    feat: torch.Tensor  # [B, V, L, C_enc] final encoder feat, intrinsic token stripped
    all_feat: List[torch.Tensor]  # enc_depth x [B, V, L, C_enc]
    dec_feat: List[torch.Tensor]  # dec_depth+1 x [B, V, L, .] ([0] = encoder feat)
    shape: Tuple[int, int]


class _CroCoEncoder(nn.Module):
    """The ViT encoder: patch embedding, ``enc_blocks``, ``enc_norm`` and,
    with ``intrinsic_token``, the intrinsic encoder (registered in that
    order, the order of the state dict and of the seeded init)."""

    def __init__(self, cfg: CrocoCfg, dtype: torch.dtype, intrinsic_token: bool):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.patch_embed = PatchEmbed(c.patch_size, c.enc_embed_dim, dtype=dtype)
        if intrinsic_token:
            self.intrinsic_encoder = nn.Linear(9, c.enc_embed_dim)
        self.enc_blocks = nn.ModuleList(
            [Block(c.enc_embed_dim, c.enc_num_heads, rope_base=c.rope_base, dtype=dtype) for _ in range(c.enc_depth)]
        )
        self.enc_norm = LayerNorm(c.enc_embed_dim)

    def _encode_flat(self, images_flat: torch.Tensor, intrinsics_flat: Optional[torch.Tensor] = None):
        """N = B*V images -> (normed feat [N, L(+1), C], pos [N, L(+1), 2],
        per-block raw outputs enc_depth x [N, L(+1), C]); the intrinsic
        token is appended where ``intrinsics_flat`` is given."""
        n, h, _, _ = images_flat.shape
        x, pos = self.patch_embed(images_flat)
        if intrinsics_flat is not None:
            intr_tok = self.intrinsic_encoder(intrinsics_flat.reshape(n, 9))
            x = torch.cat([x, intr_tok[:, None].to(x.dtype)], dim=1)  # the stream's dtype (oracle backbone.py:199)
            gh = h // self.cfg.patch_size
            # built on the device: a tensor from a host list, or an assigned
            # Python number, is copied from the host and syncs the stream
            add_pos = torch.zeros((n, 1, 2), dtype=pos.dtype, device=pos.device)
            add_pos[..., 0].fill_(gh)
            pos = torch.cat([pos, add_pos], dim=1)
        all_feat = []
        for blk in self.enc_blocks:
            x = blk(x, pos)
            all_feat.append(x)
        return self.enc_norm(x), pos, all_feat


class _CroCoBase(_CroCoEncoder):
    def __init__(self, cfg: CrocoCfg, dtype: torch.dtype = torch.float32):
        super().__init__(cfg, dtype, intrinsic_token=True)
        c = cfg
        self.decoder_embed = nn.Linear(c.enc_embed_dim, c.dec_embed_dim)
        self.dec_blocks = nn.ModuleList(
            [DecoderBlock(c.dec_embed_dim, c.dec_num_heads, rope_base=c.rope_base, dtype=dtype)
             for _ in range(c.dec_depth)]
        )
        self.dec_blocks2 = nn.ModuleList(
            [DecoderBlock(c.dec_embed_dim, c.dec_num_heads, rope_base=c.rope_base, dtype=dtype)
             for _ in range(c.dec_depth)]
        )
        self.dec_norm = LayerNorm(c.dec_embed_dim)


class AsymmetricCroCo(_CroCoBase):
    """The two-view backbone."""

    def forward(self, images: torch.Tensor, intrinsics: torch.Tensor) -> BackboneOutput:
        """images [B, 2, H, W, 3]; intrinsics [B, 2, 3, 3] (normalised)."""
        b, v, h, w, _ = images.shape
        if v != 2:
            raise ValueError("AsymmetricCroCo is the two-view backbone")
        feat, pos, all_feat = self._encode_flat(
            images.reshape(b * v, h, w, 3), intrinsics.reshape(b * v, 3, 3)
        )
        lp1 = feat.shape[1]
        feat = feat.view(b, v, lp1, -1)
        pos = pos.reshape(b, v, lp1, 2)
        feat1, feat2 = feat[:, 0], feat[:, 1]
        pos1, pos2 = pos[:, 0].contiguous(), pos[:, 1].contiguous()

        f1 = self.decoder_embed(feat1)
        f2 = self.decoder_embed(feat2)
        dec1, dec2 = [feat1], [feat2]
        for blk1, blk2 in zip(self.dec_blocks, self.dec_blocks2):
            # both blocks read the pre-layer tokens of the other view
            f1, f2 = blk1(f1, f2, pos1, pos2), blk2(f2, f1, pos2, pos1)
            dec1.append(f1)
            dec2.append(f2)
        dec1[-1] = self.dec_norm(dec1[-1])
        dec2[-1] = self.dec_norm(dec2[-1])

        strip = lambda t: t[:, :-1]
        all1 = [t.view(b, v, lp1, -1)[:, 0, :-1] for t in all_feat]
        all2 = [t.view(b, v, lp1, -1)[:, 1, :-1] for t in all_feat]
        return BackboneOutput(
            feat1=strip(feat1),
            feat2=strip(feat2),
            all_feat1=all1,
            all_feat2=all2,
            dec1=[strip(t) for t in dec1],
            dec2=[strip(t) for t in dec2],
            shape=(h, w),
        )


class CroCoEncoderOnly(_CroCoEncoder):
    """The encoder-only backbone, counterpart of
    ``siu3r_tpu/models/backbone.py:CroCoEncoderOnly``: the shared ViT encoder
    over every view with no intrinsic token and no decoder. Built on
    ``device`` (``cuda`` unless the caller names the CPU; raises without a
    GPU) with the seeded init of ``SIU3RModel``; ``dtype`` is the blocks'
    compute dtype."""

    def __init__(self, cfg: CrocoCfg, dtype: torch.dtype = torch.float32, device: str | torch.device = "cuda",
                 seed: int = 0):
        dev = resolve_device(device)
        with torch.device("meta"):
            super().__init__(cfg, dtype, intrinsic_token=False)
        self.to_empty(device=dev)
        init_weights(self, torch.Generator(device=dev).manual_seed(seed))

    def forward(self, images: torch.Tensor) -> BackboneOutput:
        """images [B, V, H, W, 3] (V >= 2) -> the encoder's outputs for views
        0 and 1; ``dec1`` and ``dec2`` are empty."""
        b, v, h, w, _ = images.shape
        feat, _, all_feat = self._encode_flat(images.reshape(b * v, h, w, 3))
        l = feat.shape[1]
        feat = feat.view(b, v, l, -1)
        return BackboneOutput(
            feat1=feat[:, 0],
            feat2=feat[:, 1],
            all_feat1=[t.view(b, v, l, -1)[:, 0] for t in all_feat],
            all_feat2=[t.view(b, v, l, -1)[:, 1] for t in all_feat],
            dec1=[],
            dec2=[],
            shape=(h, w),
        )


def bank_masks(v: int, lp1: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention masks over a bank of V views of ``lp1`` tokens
    each (True = attendable), built on the device: view 0's queries
    [1, lp1, V*lp1] drop view 0's keys; views 1..V-1's queries
    [1, (V-1)*lp1, V*lp1] drop their own view's keys."""
    key_view = torch.arange(v * lp1, device=device) // lp1
    mask1 = (key_view != 0)[None, None, :].expand(1, lp1, -1)
    q_view = torch.arange(lp1, v * lp1, device=device) // lp1
    mask2 = q_view[None, :, None] != key_view[None, None, :]
    return mask1, mask2


class AsymmetricCroCoMulti(_CroCoBase):
    """The V-view backbone: ``dec_blocks`` decodes view 0, the shared
    ``dec_blocks2`` views 1..V-1, each layer over the bank of every view's
    pre-layer tokens (``DecoderBlock.forward_multi``)."""

    def forward(self, images: torch.Tensor, intrinsics: torch.Tensor) -> MultiViewBackboneOutput:
        """images [B, V, H, W, 3]; intrinsics [B, V, 3, 3] (normalised)."""
        b, v, h, w, _ = images.shape
        feat, pos, all_feat = self._encode_flat(
            images.reshape(b * v, h, w, 3), intrinsics.reshape(b * v, 3, 3)
        )
        lp1 = feat.shape[1]
        feat = feat.view(b, v, lp1, -1)
        pos = pos.reshape(b, v, lp1, 2)
        bank_pos = pos.reshape(b, v * lp1, 2)
        mask1, mask2 = bank_masks(v, lp1, images.device)

        f = self.decoder_embed(feat)
        dec = [feat]
        for blk1, blk2 in zip(self.dec_blocks, self.dec_blocks2):
            bank = f.reshape(b, v * lp1, -1)
            f = torch.cat([
                blk1.forward_multi(f[:, :1], pos[:, :1], bank, bank_pos, mask1),
                blk2.forward_multi(f[:, 1:], pos[:, 1:], bank, bank_pos, mask2),
            ], dim=1)
            dec.append(f)
        dec[-1] = self.dec_norm(dec[-1])

        strip = lambda t: t[:, :, :-1]
        return MultiViewBackboneOutput(
            feat=strip(feat),
            all_feat=[strip(t.view(b, v, lp1, -1)) for t in all_feat],
            dec_feat=[strip(t) for t in dec],
            shape=(h, w),
        )
