"""siu3r_tpu_torch's pretrained-init surgeries against the JAX package's
(``siu3r_tpu/checkpoint.py``), on synthetic state dicts as
tests/test_pretrained_init.py builds them: a MASt3R-layout recon checkpoint
(no prefix, no ``dec_blocks2``, 14x14 patches, a confidence channel, a key
the model lacks) and a segmentation checkpoint (``model.`` prefix, fewer
queries, another label count, the criterion and a backbone key).

Tolerance: equal arrays. Both sides run the same numpy and torch host
operations; the overlay of the port's state dict is compared with the JAX
package's variables through ``convert_siu3r_state_dict``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from siu3r_tpu import checkpoint as jax_ckpt
from siu3r_tpu_torch import config as port_config
from siu3r_tpu_torch import pretrained
from siu3r_tpu_torch.models.model import SIU3RModel
from test_train import tiny_root_cfg


def _port_cfg(jcfg):
    return port_config._from_dict(port_config.ModelCfg, dataclasses.asdict(jcfg))


@pytest.mark.parametrize("old,new", [((14, 14), (16, 16)), ((16, 16), (8, 8)), ((16, 16), (16, 16)),
                                     ((12, 10), (16, 16))])
def test_resample_patch_embed_kernel_matches_jax(old, new):
    k = np.random.RandomState(sum(old)).randn(5, 3, *old).astype(np.float32)
    np.testing.assert_array_equal(pretrained.resample_patch_embed_kernel(k, new),
                                  jax_ckpt.resample_patch_embed_kernel(k, new))


@pytest.mark.parametrize("in_chans,i", [(1, 3), (3, 3), (4, 3), (7, 3), (1, 5)])
def test_adapt_input_conv_matches_jax(in_chans, i):
    w = np.random.RandomState(in_chans).randn(6, i, 4, 4).astype(np.float32)
    np.testing.assert_array_equal(pretrained.adapt_input_conv(in_chans, w), jax_ckpt.adapt_input_conv(in_chans, w))


def test_adapt_input_conv_refuses_what_jax_refuses():
    w = np.zeros((6, 5, 4, 4), np.float32)
    for fn in (pretrained.adapt_input_conv, jax_ckpt.adapt_input_conv):
        with pytest.raises(NotImplementedError):
            fn(4, w)


@pytest.mark.parametrize("cols", [943, 1024, 81])
def test_adapt_linear_matches_jax(cols):
    w = np.random.RandomState(cols).randn(8, cols).astype(np.float32)
    np.testing.assert_array_equal(pretrained.adapt_linear(w), jax_ckpt.adapt_linear(w))


def _tiny():
    jcfg = tiny_root_cfg().pipeline.model
    model = SIU3RModel(_port_cfg(jcfg), device="cpu", seed=0)
    return jcfg, _port_cfg(jcfg), {k: v.clone() for k, v in model.state_dict().items()}


def _recon_state(state, rng):
    """A MASt3R-layout checkpoint of the model's backbone and point heads."""
    out = {}
    for k, v in state.items():
        if k.startswith("backbone.dec_blocks2.") or not k.startswith(("backbone.", "downstream_head")):
            continue
        key = k[len("backbone."):] if k.startswith("backbone.") else k
        shape = list(v.shape)
        if key == "patch_embed.proj.weight":
            shape[-2:] = [14, 14]
        elif key.endswith("dpt.head.4.weight") or key.endswith("dpt.head.4.bias"):
            shape[0] += 1  # the confidence channel
        out[key] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    out["mask_token"] = torch.zeros(3)  # a key the model does not have
    return out


def _seg_state(state, rng, n_queries):
    out = {}
    for k, v in state.items():
        if not k.startswith(("adapter.", "mask2former.")) or "num_batches_tracked" in k:
            continue
        shape = list(v.shape)
        if "queries_embedder" in k or "queries_features" in k:
            shape[0] = n_queries
        if "class_predictor" in k:
            shape[0] += 3  # another label count
        value = rng.standard_normal(shape).astype(np.float32)
        if k.endswith("running_var"):
            value = np.abs(value) + 0.5
        out["model." + k] = torch.from_numpy(value)
    out["model.criterion.empty_weight"] = torch.ones(4)
    out["model.backbone.enc_norm.weight"] = torch.ones(8)
    return out


def test_filter_recon_state_matches_jax():
    jcfg, cfg, state = _tiny()
    recon = {k: v.numpy() for k, v in _recon_state(state, np.random.RandomState(1)).items()}
    got, want = pretrained.filter_recon_state(recon, cfg), jax_ckpt.filter_recon_state(recon, jcfg)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["backbone.patch_embed.proj.weight"].shape[-2:] == (16, 16)
    assert got["downstream_head1.dpt.head.4.weight"].shape[0] == 3
    assert any(k.startswith("backbone.dec_blocks2.") for k in got)


@pytest.mark.parametrize("n_queries", [5, 12])
def test_filter_seg_state_matches_jax(n_queries):
    jcfg, cfg, state = _tiny()
    seg = {k: v.numpy() for k, v in _seg_state(state, np.random.RandomState(2), n_queries).items()}
    got, want = pretrained.filter_seg_state(seg, cfg), jax_ckpt.filter_seg_state(seg, jcfg)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not any("class_predictor" in k or "criterion" in k or "backbone" in k for k in got)


def test_init_from_pretrained_matches_jax(tmp_path):
    jcfg, cfg, state = _tiny()
    rng = np.random.RandomState(3)
    torch.save({"model": _recon_state(state, rng)}, tmp_path / "recon.pth")
    torch.save({"state_dict": _seg_state(state, rng, 5)}, tmp_path / "seg.ckpt")
    before = {k: v.clone() for k, v in state.items()}

    got = pretrained.init_from_pretrained(state, cfg, str(tmp_path / "recon.pth"), str(tmp_path / "seg.ckpt"))
    variables = jax_ckpt.convert_siu3r_state_dict({k: v.numpy() for k, v in state.items()}, jcfg)
    want = jax_ckpt.init_from_pretrained(variables, jcfg, str(tmp_path / "recon.pth"), str(tmp_path / "seg.ckpt"))
    got_vars = jax_ckpt.convert_siu3r_state_dict({k: v.numpy() for k, v in got.items()}, jcfg)
    for collection in ("params", "batch_stats"):
        ref = dict(jax.tree_util.tree_leaves_with_path(want[collection]))
        out = dict(jax.tree_util.tree_leaves_with_path(got_vars[collection]))
        assert out.keys() == ref.keys()
        for path, value in ref.items():
            np.testing.assert_array_equal(out[path], np.asarray(value), err_msg=jax.tree_util.keystr(path))

    # the input is untouched; the class predictor keeps its init; the rest moved
    for k, v in before.items():
        assert torch.equal(state[k], v), k
    for k in ("mask2former.class_predictor.weight", "mask2former.class_predictor.bias"):
        assert torch.equal(got[k], before[k]), k
    for k in ("backbone.patch_embed.proj.weight", "backbone.dec_blocks2.0.norm1.weight",
              "downstream_head2.dpt.head.4.bias", "adapter.level_embed"):
        assert not torch.equal(got[k], before[k]), k
    q = [k for k in got if "queries_embedder" in k][0]
    assert torch.equal(got[q][5:], torch.zeros_like(got[q][5:]))
    SIU3RModel(cfg, device="cpu", seed=1).load_state_dict(got, strict=True)


def test_init_from_pretrained_refuses_a_misfit(tmp_path):
    _, cfg, state = _tiny()
    torch.save({"state_dict": {"model.adapter.level_embed": torch.zeros(2, 3)}}, tmp_path / "seg.ckpt")
    with pytest.raises(ValueError, match="adapter.level_embed"):
        pretrained.init_from_pretrained(state, cfg, seg_ckpt=str(tmp_path / "seg.ckpt"))

