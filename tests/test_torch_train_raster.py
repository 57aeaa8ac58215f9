"""siu3r_tpu_torch's gradients through its kernels' wrappers and the renderer,
against the JAX package.

* Kernel 6's plain version (``tiles_backward_plain``, the VJP of the plain
  compositing) against ``jax.vjp`` of ``_tiles_jnp`` (full, partial and zero
  counts; C = 1, 3, 5) and against the interpret-mode Pallas
  ``_tiles_backward`` on one chunk, unsaturated and saturating. Tolerances
  are the JAX package's own (tests/test_rasterizer_kernel.py): rtol 1e-4,
  atol 1e-5 x max(|ref|, 1); the saturating tile atol 2e-4 x 2048.
* ``flash_attn`` (both variants), ``msda`` and ``raster`` on CPU tensors that
  require grad: their outputs have a ``grad_fn`` and their gradients equal
  ``torch.autograd`` of the plain versions (the same arithmetic: rtol 1e-6).
* The render's gradient: ``jax.grad`` of an MSE + depth loss of
  ``render_gaussians`` against the port's, in the means, covariances,
  opacities and harmonics of the same Gaussians, rtol 1e-4, atol 1e-6.

Inputs are made from a seed with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siu3r_tpu.gaussians import Gaussians as JaxGaussians
from siu3r_tpu.render.rasterizer import _CHUNK, TILE_H, TILE_W, _tiles_backward, _tiles_jnp
from siu3r_tpu.renderer import render_gaussians as jax_render_gaussians
from siu3r_tpu_torch.gaussians import Gaussians, build_covariance
from siu3r_tpu_torch.kernels.flash_attention import flash_attn, flash_attn_plain
from siu3r_tpu_torch.kernels.msda import msda, msda_plain
from siu3r_tpu_torch.kernels.raster import (
    raster,
    raster_backward,
    raster_backward_plain,
    raster_plain,
    tiles_backward_plain,
)
from siu3r_tpu_torch.ops.rope import rope2d_cos_sin
from siu3r_tpu_torch.renderer import render_gaussians

NPIX = TILE_H * TILE_W


def _random_tiles(rng, nt, k, n_channels, opacity_hi=0.35):
    params = np.zeros((nt, k, 8), np.float32)
    params[..., 0] = rng.uniform(-10, TILE_W + 10, (nt, k))
    params[..., 1] = rng.uniform(-10, TILE_H + 10, (nt, k))
    params[..., 2] = rng.uniform(0.01, 0.2, (nt, k))
    params[..., 3] = rng.uniform(-0.01, 0.01, (nt, k))
    params[..., 4] = rng.uniform(0.01, 0.2, (nt, k))
    params[..., 5] = rng.uniform(0.05, opacity_hi, (nt, k))
    params[..., 6] = rng.uniform(1, 10, (nt, k))
    return params, rng.rand(nt, k, n_channels).astype(np.float32)


def _cotangents(rng, nt, c):
    return (rng.randn(nt, c, TILE_H, TILE_W).astype(np.float32),
            rng.randn(nt, TILE_H, TILE_W).astype(np.float32),
            rng.randn(nt, TILE_H, TILE_W).astype(np.float32))


def _jax_vjp(counts, row0, col0, params, colors, gcolor, gdepth, galpha):
    args = [jnp.asarray(x) for x in (counts, row0, col0)]
    _, vjp = jax.vjp(lambda p, c: _tiles_jnp(*args, p, c), jnp.asarray(params), jnp.asarray(colors))
    gaux = np.zeros((len(counts), 8, TILE_H, TILE_W), np.float32)
    gaux[:, 0], gaux[:, 1] = gdepth, galpha
    return [np.asarray(x) for x in vjp((jnp.asarray(gcolor), jnp.asarray(gaux)))]


def _port_vjp(counts, row0, col0, params, colors, gcolor, gdepth, galpha):
    t = [torch.from_numpy(np.asarray(x)) for x in (counts, row0, col0, params, colors, gcolor, gdepth, galpha)]
    return [x.numpy() for x in tiles_backward_plain(*t)]


def _close(got, ref, rtol=1e-4, atol_scale=1e-5):
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_scale * scale)


@pytest.mark.parametrize("n_channels", [1, 3, 5])
def test_tiles_backward_plain_matches_jax_vjp(n_channels):
    """Full, partial and zero counts over three chunks."""
    rng = np.random.RandomState(n_channels)
    nt, k = 3, _CHUNK * 3
    params, colors = _random_tiles(rng, nt, k, n_channels)
    counts = np.array([k, k // 2 + 37, 0], np.int32)
    row0 = np.array([0, TILE_H, 0], np.int32)
    col0 = np.array([0, 0, TILE_W], np.int32)
    grads = _cotangents(rng, nt, n_channels)
    got = _port_vjp(counts, row0, col0, params, colors, *grads)
    ref = _jax_vjp(counts, row0, col0, params, colors, *grads)
    for g, r in zip(got, ref):
        _close(g, r)
    assert np.abs(got[0]).max() > 0 and np.abs(got[1]).max() > 0
    assert not got[0][2].any() and not got[1][2].any()  # zero count, zero gradient


@pytest.mark.parametrize("saturating", [False, True])
def test_tiles_backward_plain_matches_interpret_pallas(saturating):
    """One chunk: the Pallas backward (interpret mode) stops where the tile
    saturates, at a chunk boundary, so on one chunk only the sums' order and
    the tail below T = 1e-4 differ."""
    rng = np.random.RandomState(7)
    nt, k = 2, _CHUNK
    params, colors = _random_tiles(rng, nt, k, 3, opacity_hi=0.95 if saturating else 0.35)
    if saturating:  # fat opaque splats over the tile
        params[..., 0] = rng.uniform(0, TILE_W, (nt, k))
        params[..., 1] = rng.uniform(0, TILE_H, (nt, k))
        params[..., 2] = params[..., 4] = 0.002
        params[..., 3] = 0.0
        params[..., 5] = 0.9
    counts = np.array([k, 77], np.int32)
    row0 = np.zeros(nt, np.int32)
    col0 = np.zeros(nt, np.int32)
    gcolor, gdepth, galpha = _cotangents(rng, nt, 3)
    got = _port_vjp(counts, row0, col0, params, colors, gcolor, gdepth, galpha)
    gaux = np.zeros((nt, 8, TILE_H, TILE_W), np.float32)
    gaux[:, 0], gaux[:, 1] = gdepth, galpha
    ref = _tiles_backward(*[jnp.asarray(x) for x in (counts, row0, col0, params, colors, gcolor, gaux)],
                          k_cap=k, n_channels=3, interpret=True)
    for g, r in zip(got, ref):
        if saturating:
            np.testing.assert_allclose(g, np.asarray(r), atol=2e-4 * NPIX)
        else:
            _close(g, np.asarray(r))


def test_raster_backward_plain_is_the_vjp_of_raster_plain():
    """The whole-image plain backward (gather, tiles, scatter-add over the
    table, shared colour sets) against autograd of ``raster_plain``."""
    rng = np.random.RandomState(3)
    n, g, k, hw = 4, 300, 256, (40, 200)
    n_tiles = 3 * 2
    table = torch.from_numpy(rng.randint(0, g, (n, n_tiles, k)).astype(np.int32))
    counts = torch.from_numpy(rng.randint(0, k + 1, (n, n_tiles)).astype(np.int32))
    params = np.zeros((n, g, 8), np.float32)
    params[..., 0] = rng.uniform(0, hw[1], (n, g))
    params[..., 1] = rng.uniform(0, hw[0], (n, g))
    params[..., 2] = params[..., 4] = rng.uniform(0.02, 0.2, (n, g))
    params[..., 5] = rng.uniform(0.05, 0.5, (n, g))
    params[..., 6] = rng.uniform(1, 5, (n, g))
    params = torch.from_numpy(params).requires_grad_(True)
    colors = torch.from_numpy(rng.rand(2, g, 3).astype(np.float32)).requires_grad_(True)  # 2 views a set
    out = raster_plain(table, counts, params, colors, hw)
    cots = [torch.from_numpy(rng.randn(*o.shape).astype(np.float32)) for o in out[:3]]
    ref = torch.autograd.grad(out[:3], (params, colors), cots)
    got = raster_backward_plain(table, counts, params, colors, hw, *cots)
    same = raster_backward(table, counts, params, colors, hw, *cots)  # CPU tensors: the plain version
    for a, b, c in zip(got, ref, same):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * max(1.0, float(b.abs().max())))
        assert torch.equal(a, c)
        assert float(a.abs().max()) > 0


def _check_wrapper_grads(kern, plain, inputs):
    inputs = [x.detach().requires_grad_(True) for x in inputs]
    out = kern(*inputs)
    outs = out if isinstance(out, tuple) else (out,)
    floats = [o for o in outs if o.is_floating_point()]
    assert floats[0].grad_fn is not None
    rng = np.random.RandomState(0)
    cots = [torch.from_numpy(rng.randn(*o.shape).astype(np.float32)) for o in floats]
    got = torch.autograd.grad(floats, inputs, cots)
    ref = plain(*inputs)
    ref = [o for o in (ref if isinstance(ref, tuple) else (ref,)) if o.is_floating_point()]
    want = torch.autograd.grad(ref, inputs, cots)
    for a, b in zip(got, want):
        assert float(b.abs().max()) > 0
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * max(1.0, float(b.abs().max())))


def test_flash_attn_gradients_reach_qkv():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, 3, 17, 64).astype(np.float32)) for _ in range(3))
    pos = torch.from_numpy(rng.randint(0, 5, (2, 17, 2)))
    rope = rope2d_cos_sin(pos, 64)
    _check_wrapper_grads(lambda q, k, v: flash_attn(q, k, v, 0.125, rope, rope),
                         lambda q, k, v: flash_attn_plain(q, k, v, 0.125, rope, rope), (q, k, v))
    kv_mask = torch.from_numpy(rng.rand(2, 17) > 0.3)
    q32, k32, v32 = (x[..., :32].contiguous() for x in (q, k, v))
    _check_wrapper_grads(lambda q, k, v: flash_attn(q, k, v, 0.2, kv_mask=kv_mask),
                         lambda q, k, v: flash_attn_plain(q, k, v, 0.2, kv_mask=kv_mask), (q32, k32, v32))


def test_msda_gradients_reach_value_locations_weights():
    rng = np.random.RandomState(1)
    shapes = ((4, 4), (2, 2))
    value = torch.from_numpy(rng.randn(2, 20, 4, 32).astype(np.float32))
    loc = torch.from_numpy(rng.uniform(-0.1, 1.1, (2, 9, 4, 2, 3, 2)).astype(np.float32))
    aw = torch.softmax(torch.from_numpy(rng.randn(2, 9, 4, 6).astype(np.float32)), -1).view(2, 9, 4, 2, 3)
    _check_wrapper_grads(lambda a, b, c: msda(a, shapes, b, c), lambda a, b, c: msda_plain(a, shapes, b, c),
                         (value, loc, aw))


def test_raster_gradients_reach_params_and_colors():
    rng = np.random.RandomState(2)
    g, hw = 64, (32, 128)
    table = torch.from_numpy(np.tile(np.arange(128, dtype=np.int32) % g, (2, 2, 1)))
    counts = torch.tensor([[128, 50], [0, 90]], dtype=torch.int32)
    params = np.zeros((2, g, 8), np.float32)
    params[..., 0] = rng.uniform(0, 128, (2, g))
    params[..., 1] = rng.uniform(0, 32, (2, g))
    params[..., 2] = params[..., 4] = 0.05
    params[..., 5] = 0.6
    params[..., 6] = rng.uniform(1, 3, (2, g))
    colors = rng.rand(2, g, 3).astype(np.float32)
    _check_wrapper_grads(lambda p, c: raster(table, counts, p, c, hw),
                         lambda p, c: raster_plain(table, counts, p, c, hw),
                         (torch.from_numpy(params), torch.from_numpy(colors)))


def test_render_gradient_matches_jax():
    """The same Gaussians into both renderers; the gradient of
    mean((color - target)^2) + mean(depth * wd) in each input."""
    rng = np.random.RandomState(5)
    g, v, hw = 300, 2, (32, 64)
    means = np.concatenate([rng.uniform(-0.06, 0.06, (1, g, 2)), rng.uniform(0.25, 0.4, (1, g, 1))], -1)
    scales = rng.uniform(0.002, 0.008, (1, g, 3)).astype(np.float32)
    quats = rng.randn(1, g, 4).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    covs = build_covariance(torch.from_numpy(scales), torch.from_numpy(quats)).numpy()
    inputs = {
        "means": means.astype(np.float32), "covariances": covs,
        "opacities": rng.uniform(0.1, 0.9, (1, g)).astype(np.float32),
        "harmonics": (rng.randn(1, g, 3, 4) * 0.3).astype(np.float32),
    }
    ext = np.tile(np.eye(4, dtype=np.float32), (1, v, 1, 1))
    ext[0, 1, 0, 3] = 0.01
    intr = np.tile(np.array([[1.0, 0, 0.5], [0, 2.0, 0.5], [0, 0, 1]], np.float32), (1, v, 1, 1))
    target = rng.rand(1, v, *hw, 3).astype(np.float32)
    wd = rng.randn(1, v, *hw).astype(np.float32)
    extra = dict(scales=np.zeros((1, g, 3), np.float32), rotations=np.zeros((1, g, 4), np.float32))

    def jax_loss(x):
        r = jax_render_gaussians(JaxGaussians(**x, **{k: jnp.asarray(a) for k, a in extra.items()}),
                                 jnp.asarray(ext), jnp.asarray(intr), hw)
        return jnp.mean((r.color - target) ** 2) + jnp.mean(r.depth * wd), r.alpha

    (ref_loss, ref_alpha), ref = jax.value_and_grad(jax_loss, has_aux=True)(
        {k: jnp.asarray(a) for k, a in inputs.items()})
    tin = {k: torch.from_numpy(a).requires_grad_(True) for k, a in inputs.items()}
    r = render_gaussians(Gaussians(**tin, **{k: torch.from_numpy(a) for k, a in extra.items()}),
                         torch.from_numpy(ext), torch.from_numpy(intr), hw)
    loss = ((r.color - torch.from_numpy(target)) ** 2).mean() + (r.depth * torch.from_numpy(wd)).mean()
    loss.backward()
    assert 0.2 < float(ref_alpha.mean()) < 0.95  # the views see the scene
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    for key, x in tin.items():
        assert float(x.grad.abs().max()) > 0, key
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref[key]), rtol=1e-4, atol=1e-6, err_msg=key)
