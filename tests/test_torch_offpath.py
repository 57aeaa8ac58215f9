"""The modules that no model of siu3r_tpu_torch builds, against the JAX
package on the CPU: ``camera.py``, the linear heads and ``pixel_shuffle``,
``MultiResDPTGSHead``, ``head_factory``, ``CroCoEncoderOnly`` (fp32 and
bf16) and ``bin_gaussians_sort``; and the two-view backbone's layout after
the encoder was split out of it.

Inputs are made from numpy seeds; weights come from the JAX modules' own init
through the port's converters (``siu3r_tpu_torch.weights``), so both sides
hold the same parameters.

Tolerances: the camera functions and the fp32 modules within rtol 1e-4 /
atol 1e-5; ``pixel_shuffle`` exact; the bf16 encoder as tests/test_torch_bf16.py
holds its modules (the dtype equal to the JAX module's, the L2 norm of port -
JAX at most MODULE_FRACTION of the JAX module's own bf16 - fp32 difference);
binning exact: the counts, and each tile's table up to its count.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siu3r_tpu.camera as JC
import siu3r_tpu.render.rasterizer as JR
from siu3r_tpu.config import CrocoCfg as JaxCrocoCfg
from siu3r_tpu.models.backbone import CroCoEncoderOnly as JaxEncoderOnly
from siu3r_tpu.models.heads import LinearGS as JaxLinearGS
from siu3r_tpu.models.heads import LinearPts3d as JaxLinearPts3d
from siu3r_tpu.models.heads import MultiResDPTGSHead as JaxMultiRes
from siu3r_tpu.models.heads import head_factory as jax_head_factory
from siu3r_tpu.models.heads.linear import pixel_shuffle as jax_pixel_shuffle
from siu3r_tpu.models.backbone import AsymmetricCroCo as JaxBackbone
from siu3r_tpu_torch import camera as TC
from siu3r_tpu_torch import config as port_config
from siu3r_tpu_torch import weights
from siu3r_tpu_torch.kernels.binning import bin_gaussians_plain
from siu3r_tpu_torch.models.backbone import AsymmetricCroCo, AsymmetricCroCoMulti, CroCoEncoderOnly
from siu3r_tpu_torch.models.heads import head_factory
from siu3r_tpu_torch.models.heads.dpt import MultiResDPTGSHead
from siu3r_tpu_torch.models.heads.linear import LinearGS, LinearPts3d, pixel_shuffle
from siu3r_tpu_torch.render.rasterizer import bin_gaussians_sort
from siu3r_tpu_torch.weights import (
    encoder_only_state_dict_from_jax,
    linear_head_state_dict_from_jax,
    multi_res_head_state_dict_from_jax,
)
from test_model import tiny_model_cfg
from test_torch_bf16 import MODULE_FRACTION, _np, _same_dtype, _strict
from test_torch_render import _assert_table_equal, _jax_proj, _port_proj, _random_proj
from test_torch_train_cli import two_torch_threads  # noqa: F401  (fixture)
from test_torch_weights import port_cfg

RTOL, ATOL = 1e-4, 1e-5


def _close(port, ref, what=""):
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref, np.float32), rtol=RTOL, atol=ATOL, err_msg=what)


def _seeded_params(init, *args, seed=0):
    """Parameters of the JAX module whose ``init`` is given, drawn from a
    numpy seed on the shapes ``jax.eval_shape`` gives (running the flax init
    of these modules, jitted or not, costs seconds each): kernels uniform in
    +-1 / sqrt(fan-in), biases in +-0.1, norm scales in 1 +- 0.1."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)["params"]

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":  # conv [kh, kw, I, O]; dense [in, out], stacked [depth, in, out]
            fan_in = np.prod(s.shape[:-1]) if len(s.shape) == 4 else s.shape[-2]
            w = rng.uniform(-1.0, 1.0, s.shape) / np.sqrt(fan_in)
        elif name == "scale":
            w = 1.0 + rng.uniform(-0.1, 0.1, s.shape)
        else:
            w = rng.uniform(-0.1, 0.1, s.shape)
        return w.astype(np.float32)

    return {"params": jax.tree_util.tree_map_with_path(leaf, shapes)}


# ---------------------------------------------------------------- camera


def _rigid(rng, *lead):
    """Random camera-to-world poses [*lead, 4, 4]: a rotation (QR of a
    Gaussian matrix, det +1) and a translation."""
    q, r = np.linalg.qr(rng.standard_normal((*lead, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[..., None, :]
    q[..., :, 0] *= np.sign(np.linalg.det(q))[..., None]
    pose = np.zeros((*lead, 4, 4))
    pose[..., :3, :3] = q
    pose[..., :3, 3] = rng.standard_normal((*lead, 3))
    pose[..., 3, 3] = 1.0
    return pose.astype(np.float32)


def _intrinsics(rng, *lead):
    k = np.zeros((*lead, 3, 3), np.float32)
    k[..., 0, 0] = rng.uniform(0.8, 1.6, lead)
    k[..., 1, 1] = rng.uniform(0.8, 1.6, lead)
    k[..., 0, 2] = rng.uniform(0.4, 0.6, lead)
    k[..., 1, 2] = rng.uniform(0.4, 0.6, lead)
    k[..., 2, 2] = 1.0
    return k


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _ray_pairs(rng, n=12):
    """n ray pairs (origins, unit directions) with one parallel pair (the same
    direction: inf), one opposite pair (the minimum-norm point) and one
    axis-aligned opposite pair."""
    ox, oy = (rng.standard_normal((n, 3)).astype(np.float32) for _ in range(2))
    dx, dy = (_unit(rng.standard_normal((n, 3))) for _ in range(2))
    dy[0] = dx[0]
    dy[1] = -dx[1]
    dx[2], dy[2] = [0, 0, 1], [0, 0, -1]
    return ox, dx, oy, dy


def _camera_case(name, rng):
    """(port outputs, JAX outputs) of one camera function on seeded inputs.
    The JAX side is jitted: op by op, its first call compiles every op."""
    T = torch.from_numpy
    J = lambda f, *args: jax.jit(f)(*args)  # noqa: E731
    if name in ("homogenize_points", "homogenize_vectors"):
        x = rng.standard_normal((4, 5, 3)).astype(np.float32)
        return getattr(TC, name)(T(x)), J(getattr(JC, name), x)
    if name in ("transform_rigid", "transform_cam2world", "transform_world2cam"):
        pts = np.concatenate([rng.standard_normal((2, 3, 7, 3)), np.ones((2, 3, 7, 1))], -1).astype(np.float32)
        ext = _rigid(rng, 2, 3, 1)
        return getattr(TC, name)(T(pts), T(ext)), J(getattr(JC, name), pts, ext)
    if name == "project_camera_space":
        pts = rng.standard_normal((9, 3)).astype(np.float32)
        pts[0, 2] = 0.0  # on the camera plane: the epsilon, then the finite cut
        pts[1] = [0.0, 0.0, 0.0]
        k = _intrinsics(rng)
        return TC.project_camera_space(T(pts), T(k)), J(JC.project_camera_space, pts, k)
    if name == "project":
        pts = (rng.standard_normal((2, 8, 3)) * 2).astype(np.float32)
        ext, k = _rigid(rng, 2, 1), _intrinsics(rng, 2, 1)
        return TC.project(T(pts), T(ext), T(k)), J(JC.project, pts, ext, k)
    if name == "unproject":
        xy = rng.rand(3, 10, 2).astype(np.float32)
        z = rng.uniform(0.5, 5.0, (3, 10)).astype(np.float32)
        k = _intrinsics(rng, 3, 1)
        return TC.unproject(T(xy), T(z), T(k)), J(JC.unproject, xy, z, k)
    if name == "get_local_rays":
        xy, k = rng.rand(3, 10, 2).astype(np.float32), _intrinsics(rng, 3, 1)
        return TC.get_local_rays(T(xy), T(k)), J(JC.get_local_rays, xy, k)
    if name == "get_world_rays":
        xy = rng.rand(2, 3, 10, 2).astype(np.float32)
        ext, k = _rigid(rng, 2, 3, 1), _intrinsics(rng, 2, 3, 1)
        return TC.get_world_rays(T(xy), T(ext), T(k)), J(JC.get_world_rays, xy, ext, k)
    if name == "sample_image_grid":
        return TC.sample_image_grid((5, 7)), jax.jit(JC.sample_image_grid, static_argnums=0)((5, 7))
    if name == "intersect_rays":
        pairs = _ray_pairs(rng)
        return TC.intersect_rays(*map(T, pairs)), J(jax.vmap(JC.intersect_rays), *pairs)
    if name == "get_fov":
        k = _intrinsics(rng, 4)
        return TC.get_fov(T(k)), J(JC.get_fov, k)
    if name == "get_projection_matrix":
        near = rng.uniform(0.1, 1.0, 3).astype(np.float32)
        far = (near + rng.uniform(5.0, 100.0, 3)).astype(np.float32)
        fx, fy = (rng.uniform(0.5, 1.5, 3).astype(np.float32) for _ in range(2))
        return (TC.get_projection_matrix(T(near), T(far), T(fx), T(fy)),
                J(JC.get_projection_matrix, near, far, fx, fy))
    assert name == "relative_pose"
    poses = _rigid(rng, 2, 4)
    return TC.relative_pose(T(poses)), J(JC.relative_pose, poses)


CAMERA = ["homogenize_points", "homogenize_vectors", "transform_rigid", "transform_cam2world",
          "transform_world2cam", "project_camera_space", "project", "unproject", "get_local_rays",
          "get_world_rays", "sample_image_grid", "intersect_rays", "get_fov", "get_projection_matrix",
          "relative_pose"]


@pytest.mark.parametrize("name", CAMERA)
def test_camera_function_matches_jax(name):
    port, ref = _camera_case(name, np.random.RandomState(CAMERA.index(name)))
    port = port if isinstance(port, tuple) else (port,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert tuple(a.shape) == tuple(b.shape), f"{name} output {i}"
        if a.dtype == torch.bool or not a.is_floating_point():
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{name} output {i}")
        else:
            _close(a, b, f"{name} output {i}")


def test_intersect_rays_parallel_pairs_and_gradient():
    """The parallel pair gives inf and no NaN, the opposite pairs the JAX
    package's minimum-norm point; the gradient is finite everywhere."""
    pairs = [torch.from_numpy(a).requires_grad_(True) for a in _ray_pairs(np.random.RandomState(3))]
    out = TC.intersect_rays(*pairs)
    assert bool((out[0] == 1e10).all()) and bool(torch.isfinite(out[1:]).all())
    assert not bool((out[1:] == 1e10).any())
    out[1:].sum().backward()
    for t in pairs:
        assert bool(torch.isfinite(t.grad).all())


def test_sample_training_rays_matches_jax_at_the_drawn_pixels():
    """The port draws its pixel indices from a torch.Generator (the JAX
    package from jax.random): the rays and pixels at the drawn indices
    against the JAX package's full-grid world rays and the image."""
    rng = np.random.RandomState(11)
    b, v, h, w, n = 2, 3, 4, 5, 16
    image = rng.rand(b, v, h, w, 3).astype(np.float32)
    ext, k = _rigid(rng, b, v), _intrinsics(rng, b, v)
    T = torch.from_numpy
    o, d, px = TC.sample_training_rays(T(image), T(k), T(ext), n, torch.Generator().manual_seed(5))
    idx = torch.randint(0, v * h * w, (b, n), generator=torch.Generator().manual_seed(5)).numpy()
    xy, _ = JC.sample_image_grid((h, w))
    jo, jd = jax.jit(JC.get_world_rays)(xy[..., None, None, :], ext, k)
    grid = lambda t: np.asarray(t).transpose(2, 3, 0, 1, 4).reshape(b, v * h * w, -1)
    take = lambda t: np.take_along_axis(t, idx[..., None], axis=1)
    _close(o, take(grid(jo)), "origins")
    _close(d, take(grid(jd)), "directions")
    np.testing.assert_array_equal(px.numpy(), take(image.reshape(b, v * h * w, 3)))


# ---------------------------------------------------------------- heads


def test_pixel_shuffle_matches_jax():
    x = np.random.RandomState(0).randn(2, 3, 4, 2 * 2 * 5).astype(np.float32)
    np.testing.assert_array_equal(pixel_shuffle(torch.from_numpy(x), 2).numpy(),
                                  np.asarray(jax_pixel_shuffle(jnp.asarray(x), 2)))


@pytest.mark.parametrize("kind", ["pts3d", "pts3d_conf", "gs"])
def test_linear_head_matches_jax(kind):
    rng = np.random.RandomState(1)
    tokens = [rng.standard_normal((2, 4, 48)).astype(np.float32)]
    if kind == "gs":
        jax_head, port = JaxLinearGS(patch_size=8, d_out=11), LinearGS(48, patch_size=8, d_out=11)
    else:
        conf = kind == "pts3d_conf"
        jax_head, port = JaxLinearPts3d(patch_size=8, has_conf=conf), LinearPts3d(48, patch_size=8, has_conf=conf)
    params = _seeded_params(lambda key, t: jax_head.init(key, t, (16, 16)), tokens, seed=1)
    port.load_state_dict(linear_head_state_dict_from_jax(params["params"]), strict=True)
    out = port([torch.from_numpy(t) for t in tokens], (16, 16))
    ref = jax.jit(jax_head.apply, static_argnums=2)(params, tokens, (16, 16))
    assert out.shape == ref.shape
    _close(out, ref)


def test_multi_res_head_matches_jax():
    """tests/test_heads_extra.py's widths."""
    dims, h = (32, 24, 24, 24), 64
    rng = np.random.RandomState(2)
    tokens = [rng.standard_normal((1, (h // 16) ** 2, d)).astype(np.float32) for d in dims]
    image = rng.rand(1, h, h, 3).astype(np.float32)
    jax_head = JaxMultiRes(num_channels=11, layer_dims=(8, 12, 16, 24), feature_dim=16)
    params = _seeded_params(lambda key, t, im: jax_head.init(key, t, im, (h, h)), tokens, image, seed=2)
    port = MultiResDPTGSHead(11, dims, layer_dims=(8, 12, 16, 24), feature_dim=16)
    port.load_state_dict(multi_res_head_state_dict_from_jax(params["params"]), strict=True)
    outs = port([torch.from_numpy(t) for t in tokens], torch.from_numpy(image), (h, h))
    refs = jax.jit(jax_head.apply, static_argnums=3)(params, tokens, image, (h, h))
    assert [tuple(o.shape) for o in outs] == [(1, 16, 16, 11), (1, 8, 8, 11), (1, 4, 4, 11), (1, 2, 2, 11)]
    for i, (a, b) in enumerate(zip(outs, refs)):
        _close(a, b, f"scale {i}")


FACTORY = [("linear", "pts3d"), ("dpt", "pts3d"), ("dpt", "gs_params"), ("dpt_gs", "gs_params"),
           ("multi_res_dpt_gs", "gs_params")]


@pytest.mark.parametrize("pair", FACTORY)
def test_head_factory_builds_the_jax_packages_head(pair):
    port = head_factory(*pair, out_nchan=83)
    ref = jax_head_factory(*pair, out_nchan=83)
    assert type(port).__name__ == type(ref).__name__
    if hasattr(ref, "head_type"):
        assert port.head_type == ref.head_type
    if hasattr(ref, "num_channels"):
        last = list(port.modules())[-1]
        assert last.out_channels == ref.num_channels
    if isinstance(port, LinearPts3d):
        assert port.proj.out_features == 3 * ref.patch_size**2 and port.patch_size == ref.patch_size


def test_head_factory_refuses_other_pairs():
    for pair in (("nope", "pts3d"), ("linear", "gs_params"), ("multi_res_dpt_gs", "pts3d")):
        with pytest.raises(NotImplementedError):
            head_factory(*pair)


# ---------------------------------------------------------------- backbones


@pytest.fixture(scope="module")
def encoder_only():
    """The JAX encoder-only backbone's params at tests/test_heads_extra.py's
    config, the port's fp32 and bf16 encoders carrying them, and images."""
    jcfg = JaxCrocoCfg(enc_depth=2, dec_depth=2, enc_embed_dim=32, enc_num_heads=4)
    cfg = port_config._from_dict(port_config.CrocoCfg, dataclasses.asdict(jcfg))
    images = np.random.RandomState(4).rand(1, 2, 32, 32, 3).astype(np.float32)
    params = _seeded_params(JaxEncoderOnly(jcfg).init, images, seed=4)
    state = encoder_only_state_dict_from_jax(params["params"], cfg.enc_depth)
    ports = {}
    for dt in (torch.float32, torch.bfloat16):
        ports[dt] = CroCoEncoderOnly(cfg, dt, device="cpu", seed=3).eval()
        ports[dt].load_state_dict(state, strict=True)
    return jcfg, params, state, ports, images


def _outputs(o):
    return [o.feat1, o.feat2, *o.all_feat1, *o.all_feat2]


def test_encoder_only_layout_and_device(encoder_only, monkeypatch):
    """Only the encoder's parameters; built on the GPU unless the caller
    names the CPU, and refused where there is none."""
    _, _, state, ports, _ = encoder_only
    keys = list(ports[torch.float32].state_dict())
    assert set(keys) == set(state)
    assert all(k.split(".")[0] in ("patch_embed", "enc_blocks", "enc_norm") for k in keys)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        CroCoEncoderOnly(ports[torch.float32].cfg)


def test_encoder_only_matches_jax(encoder_only):
    jcfg, params, _, ports, images = encoder_only
    with torch.inference_mode():
        out = ports[torch.float32](torch.from_numpy(images))
    ref = jax.jit(JaxEncoderOnly(jcfg).apply)(params, images)
    assert out.dec1 == [] and out.dec2 == [] and out.shape == (32, 32)
    assert len(out.all_feat1) == jcfg.enc_depth and tuple(out.feat1.shape) == (1, 4, 32)
    for i, (a, b) in enumerate(zip(_outputs(out), _outputs(ref))):
        _close(a, b, f"output {i}")


def test_encoder_only_matches_jax_in_bf16(encoder_only):
    jcfg, params, _, ports, images = encoder_only
    with torch.inference_mode():
        out = ports[torch.bfloat16](torch.from_numpy(images))
    ref16 = _strict(JaxEncoderOnly(jcfg, dtype=jnp.bfloat16).apply, params, images)
    ref32 = jax.jit(JaxEncoderOnly(jcfg).apply)(params, images)
    for i, (a, b16, b32) in enumerate(zip(_outputs(out), _outputs(ref16), _outputs(ref32))):
        assert _same_dtype(a, b16), f"output {i}: {a.dtype} against JAX's {b16.dtype}"
        b16, b32 = _np(b16), _np(b32)
        ratio = np.linalg.norm(_np(a) - b16) / np.linalg.norm(b16 - b32)
        assert ratio <= MODULE_FRACTION, f"output {i}: port - JAX is {ratio:.3f} of JAX's bf16 - fp32"


def test_two_view_backbone_keeps_its_layout():
    """After the encoder was split out of the two backbones' base, their state
    dicts hold exactly the keys that ``state_dict_from_jax`` writes under
    ``backbone.`` (its ``_backbone``, here on the JAX backbone's own tree: the
    whole model's costs seconds more to trace), and their modules stay in the
    order that decides what a seed draws."""
    jcfg = tiny_model_cfg()
    shapes = jax.eval_shape(JaxBackbone(jcfg.croco).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 2, 64, 64, 3)), jnp.zeros((1, 2, 3, 3)))["params"]
    written = {}
    weights._backbone(written, jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), jcfg)
    written = {k.removeprefix("backbone.") for k in written}
    order = ["patch_embed", "intrinsic_encoder", "enc_blocks", "enc_norm", "decoder_embed", "dec_blocks",
             "dec_blocks2", "dec_norm"]
    for cls in (AsymmetricCroCo, AsymmetricCroCoMulti):
        with torch.device("meta"):
            bb = cls(port_cfg(jcfg).croco)
        assert set(bb.state_dict()) == written, cls.__name__
        assert [name for name, _ in bb.named_children()] == order, cls.__name__


# ---------------------------------------------------------------- binning by sort


# name: (seed, views, G, image, K, slots, proj kwargs)
SORT_CASES = {
    "three_views_dead_and_ties": (0, 3, 1000, (256, 256), 512, (4, 2), dict(ties=True, dead_frac=0.2)),
    "k_cut": (1, 2, 1024, (256, 256), 128, (16, 2), dict(max_radius=500.0)),
    "one_gaussian": (2, 2, 1, (256, 256), 128, (4, 2), dict(dead_frac=0.0)),
    "narrow_image": (3, 2, 700, (64, 256), 256, (4, 2), dict(max_radius=60.0)),
}


@pytest.mark.parametrize("name", list(SORT_CASES))
def test_bin_gaussians_sort_matches_jax_and_the_plain_binning(name):
    seed, views, g, image, k, (sy, sx), kw = SORT_CASES[name]
    rng = np.random.RandomState(seed)
    arrs = [_random_proj(rng, g, **kw) for _ in range(views)]
    stacked = _port_proj([np.stack(a) for a in zip(*arrs)])
    table, counts = bin_gaussians_sort(stacked, image, k, sy, sx)
    assert table.shape == (views, counts.shape[-1], k) and table.dtype == counts.dtype == torch.int32
    _assert_table_equal(table, counts, *bin_gaussians_plain(stacked, image, k, sy, sx))
    jax_sort = jax.jit(jax.vmap(lambda p: JR.bin_gaussians_sort(p, image, k, sy, sx)))
    _assert_table_equal(table, counts, *jax_sort(_jax_proj([np.stack(a) for a in zip(*arrs)])))
    if name == "k_cut":
        assert int(counts.max()) == k
    if name == "three_views_dead_and_ties":
        assert bool((table >= 0).all()) and bool((table < g).all())
