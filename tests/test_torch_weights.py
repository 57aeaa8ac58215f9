"""Weights carried between the JAX package and siu3r_tpu_torch.

The port's modules carry the reference's torch names, so
``siu3r_tpu.checkpoint.convert_siu3r_state_dict`` maps a port ``state_dict``
onto the JAX variable tree, and ``siu3r_tpu_torch.weights.state_dict_from_jax``
is its exact inverse. Checked on the tiny config of tests/test_model.py; the
JAX tree's structure comes from ``jax.eval_shape`` of ``SIU3RModel.init``.
All comparisons are exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siu3r_tpu.checkpoint import convert_siu3r_state_dict
from siu3r_tpu.models.model import SIU3RModel as JaxModel
from siu3r_tpu_torch import config as port_config
from siu3r_tpu_torch.models.model import build_model
from siu3r_tpu_torch.weights import load_checkpoint, state_dict_from_jax
from test_model import tiny_model_cfg


def port_cfg(jax_cfg):
    """The port's ModelCfg with the same values as a JAX ModelCfg."""
    return port_config._from_dict(port_config.ModelCfg, dataclasses.asdict(jax_cfg))


def port_state_numpy(model):
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_model_cfg()
    model = build_model(port_cfg(jcfg), device="cpu", seed=0)
    shapes = jax.eval_shape(
        JaxModel(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 2, 64, 64, 3)), jnp.zeros((1, 2, 3, 3)),
    )
    return jcfg, model, shapes


def _paths(tree):
    return {jax.tree_util.keystr(p): leaf for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def test_port_state_dict_converts_to_the_jax_tree(tiny):
    jcfg, model, shapes = tiny
    converted = _paths(convert_siu3r_state_dict(port_state_numpy(model), jcfg))
    expected = _paths(shapes)
    assert converted.keys() == expected.keys()
    for key, leaf in expected.items():
        assert converted[key].shape == leaf.shape, key


def test_state_dict_from_jax_inverts_the_converter(tiny):
    jcfg, model, shapes = tiny
    rng = np.random.RandomState(0)
    variables = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    state = state_dict_from_jax(variables, jcfg)
    back = _paths(convert_siu3r_state_dict({k: v.numpy() for k, v in state.items()}, jcfg))
    original = _paths(variables)
    assert back.keys() == original.keys()
    for key, leaf in original.items():
        np.testing.assert_array_equal(back[key], leaf, err_msg=key)
    model.load_state_dict(state, strict=True)
    for key, value in model.state_dict().items():
        assert torch.equal(value, state[key]), key


def test_port_state_dict_round_trips(tiny):
    jcfg, _, _ = tiny
    model = build_model(port_cfg(jcfg), device="cpu", seed=1)
    state = port_state_numpy(model)
    back = state_dict_from_jax(convert_siu3r_state_dict(state, jcfg), jcfg)
    assert back.keys() == state.keys()
    for key, value in state.items():
        np.testing.assert_array_equal(back[key].numpy(), value, err_msg=key)


def test_load_checkpoint_strips_the_lightning_prefix(tiny, tmp_path):
    jcfg, _, _ = tiny
    src = build_model(port_cfg(jcfg), device="cpu", seed=2)
    path = tmp_path / "tiny.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in src.state_dict().items()}}, path)
    dst = build_model(port_cfg(jcfg), device="cpu", seed=3)
    load_checkpoint(dst, str(path))
    for key, value in src.state_dict().items():
        assert torch.equal(dst.state_dict()[key], value), key
