"""siu3r_tpu_torch's render path against the JAX package.

Inputs are made from a seed with numpy and fed to both sides. The port runs
on the CPU, where the binning and raster wrappers take their plain versions;
the JAX side runs its XLA paths and, where named, its Pallas kernels in
interpret mode. Tolerances:
  * SH colours, projection, the plain compositing against ``_tiles_jnp``:
    atol 1e-5 (fp32, other summation orders), radii and culls equal; pixel
    positions atol 1e-4 (up to ~300 px, where the fp32 ulp is 3e-5);
  * binning: exact (table entries up to each count, and the counts);
  * the plain compositing against the interpret-mode ``_raster_kernel``:
    atol 2e-4, the kernel's whole-tile exit leaving out contributions below
    transmittance 1e-4 (tests/test_rasterizer_kernel.py);
  * the dense oracle: the tolerances of tests/test_rasterizer.py (the tiled
    path cuts gaussian tails past the 3-sigma box);
  * renders: atol 1e-5 on colour and alpha in [0, 1], 1e-4 on depth in
    the 10x rescaled scene (values up to ~100, so the fp32 ulp is ~1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siu3r_tpu.render.rasterizer as JR
from siu3r_tpu.gaussians import Gaussians as JaxGaussians
from siu3r_tpu.ops.sh import eval_sh_colors as jax_eval_sh_colors
from siu3r_tpu.render.projection import ProjectedGaussians as JaxProj
from siu3r_tpu.render.projection import project_gaussians as jax_project
from siu3r_tpu import renderer as JRen
from siu3r_tpu_torch import renderer as TRen
from siu3r_tpu_torch.gaussians import Gaussians, build_covariance
from siu3r_tpu_torch.kernels.binning import bin_gaussians, bin_gaussians_plain
from siu3r_tpu_torch.kernels.raster import raster, tiles_plain
from siu3r_tpu_torch.ops.sh import eval_sh_colors
from siu3r_tpu_torch.render.projection import ProjectedGaussians, project_gaussians
from siu3r_tpu_torch.render.rasterizer import rasterize, rasterize_reference
from siu3r_tpu_torch.render.tiles import _CHUNK, TILE_H, TILE_W
from test_rasterizer import make_scene

ATOL = 1e-5
DEPTH_ATOL = 1e-4
T = torch.from_numpy


def _close(port, ref, atol=ATOL, what=""):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=0, atol=atol, err_msg=what)


# ---------------------------------------------------------------- SH, projection


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_eval_sh_colors_matches_jax(degree):
    rng = np.random.RandomState(degree)
    harm = rng.standard_normal((2, 50, 3, 25)).astype(np.float32)
    dirs = rng.standard_normal((2, 50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ref = jax_eval_sh_colors(jnp.asarray(harm), jnp.asarray(dirs), degree)
    _close(eval_sh_colors(T(harm), T(dirs), degree), ref)


def _scene(rng, g, spread=2.0, depth=(4.0, 8.0), scale=0.1):
    means = np.concatenate(
        [rng.uniform(-spread, spread, (g, 2)), rng.uniform(depth[0], depth[1], (g, 1))], -1
    ).astype(np.float32)
    scales = rng.uniform(scale * 0.5, scale, (g, 3)).astype(np.float32)
    quats = rng.standard_normal((g, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    covs = build_covariance(T(scales), T(quats)).numpy()
    opac = rng.uniform(0.3, 0.95, g).astype(np.float32)
    return means, covs, opac


def _cameras(rng, n, h, w):
    """n world-to-camera views near the identity, pixel intrinsics."""
    vms = []
    for _ in range(n):
        th = rng.standard_normal(3) * 0.1
        k = np.array([[0, -th[2], th[1]], [th[2], 0, -th[0]], [-th[1], th[0], 0]])
        rot = np.eye(3) + np.sin(0.1) * k + (1 - np.cos(0.1)) * k @ k
        u, _, vt = np.linalg.svd(rot)
        vm = np.eye(4)
        vm[:3, :3] = u @ vt
        vm[:3, 3] = rng.standard_normal(3) * 0.3
        vms.append(vm)
    fx = w * 1.2
    intr = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1.0]])
    return np.stack(vms).astype(np.float32), np.stack([intr] * n).astype(np.float32)


def test_project_gaussians_matches_jax():
    rng = np.random.RandomState(0)
    h, w = 64, 256
    means, covs, _ = _scene(rng, 1500, spread=4.0, depth=(-1.0, 9.0), scale=0.3)
    vms, intr = _cameras(rng, 3, h, w)
    port = project_gaussians(T(means), T(covs), T(vms), T(intr), (h, w), 0.2, 1000.0)
    for i in range(3):
        ref = jax_project(jnp.asarray(means), jnp.asarray(covs), jnp.asarray(vms[i]), jnp.asarray(intr[i]),
                          (h, w), 0.2, 1000.0)
        np.testing.assert_array_equal(port.radius[i].numpy(), np.asarray(ref.radius))
        live = np.asarray(ref.radius) > 0
        assert 0 < live.sum() < len(live)  # some culled, some kept
        _close(port.depth[i], ref.depth, what="depth")
        # pixel positions and conics of the gaussians that are drawn (culled
        # ones may sit at z near 0, where both sides divide by ~0)
        _close(port.mean2d[i][live], np.asarray(ref.mean2d)[live], atol=1e-4, what="mean2d")
        _close(port.conic[i][live], np.asarray(ref.conic)[live], what="conic")


# ---------------------------------------------------------------- binning


def _random_proj(rng, g, extent=276.0, max_radius=30.0, dead_frac=0.1, ties=False):
    mean2d = (rng.rand(g, 2) * (extent + 40) - 20).astype(np.float32)
    depth = (rng.permutation(g) + rng.rand(g) * 0.5).astype(np.float32)
    if ties:  # many equal depths: only a stable sort keeps submission order
        depth = np.floor(depth / 64.0).astype(np.float32)
    radius = (rng.rand(g) * max_radius).astype(np.float32)
    radius[rng.rand(g) < dead_frac] = 0.0
    conic = np.full((g, 3), 0.05, np.float32)
    return mean2d, conic, depth, radius


def _port_proj(arrs):
    return ProjectedGaussians(*(T(a) for a in arrs))


def _jax_proj(arrs):
    return JaxProj(*(jnp.asarray(a) for a in arrs))


def _assert_table_equal(table, counts, t_ref, c_ref):
    np.testing.assert_array_equal(counts.numpy(), np.asarray(c_ref))
    k = table.shape[-1]
    mask = np.arange(k) < np.asarray(c_ref)[..., None]
    np.testing.assert_array_equal(np.where(mask, table.numpy(), -1), np.where(mask, np.asarray(t_ref), -1))


BIN_CASES = {
    # name: (seed, G, image, K, slots, proj kwargs)
    "G_multiple_of_512": (0, 1536, (256, 256), 512, (4, 2), {}),
    "G_not_multiple_of_512": (0, 1061, (256, 256), 512, (4, 2), {}),
    "truncation_at_K": (1, 1024, (256, 256), 128, (16, 2), dict(max_radius=500.0, dead_frac=0.0)),
    "all_dead": (2, 512, (256, 256), 256, (4, 2), dict(dead_frac=1.0)),
    "equal_depths": (4, 2000, (64, 256), 256, (4, 2), dict(ties=True, max_radius=60.0)),
}


@pytest.mark.parametrize("name", list(BIN_CASES))
def test_binning_matches_count_oracle_and_pallas_kernel(name):
    seed, g, image, k, (sy, sx), kw = BIN_CASES[name]
    arrs = _random_proj(np.random.RandomState(seed), g, **kw)
    table, counts = bin_gaussians(_port_proj(arrs), image, k, sy, sx)
    t_cnt, c_cnt = JR.bin_gaussians_count(_jax_proj(arrs), image, k, sy, sx)
    _assert_table_equal(table, counts, t_cnt, c_cnt)
    t_pal, c_pal = JR.bin_gaussians_pallas(_jax_proj(arrs), image, k, sy, sx, interpret=True)
    _assert_table_equal(table, counts, t_pal, c_pal)
    if name == "all_dead":
        assert int(counts.sum()) == 0
    if name == "truncation_at_K":
        assert bool((counts == k).all())


def test_binning_batched_views():
    rng = np.random.RandomState(3)
    views = [_random_proj(rng, 1024) for _ in range(3)]
    stacked = ProjectedGaussians(*(T(np.stack(a)) for a in zip(*views)))
    table, counts = bin_gaussians_plain(stacked, (256, 256), 512, 4, 2)
    assert table.shape == (3, 16 * 2, 512) and counts.shape == (3, 32)
    jstacked = JaxProj(*(jnp.stack(a) for a in zip(*(_jax_proj(v) for v in views))))
    t_v, c_v = jax.vmap(lambda p: JR.bin_gaussians_pallas(p, (256, 256), 512, 4, 2, interpret=True))(jstacked)
    for i, arrs in enumerate(views):
        t_ref, c_ref = JR.bin_gaussians_count(_jax_proj(arrs), (256, 256), 512, 4, 2)
        _assert_table_equal(table[i], counts[i], t_ref, c_ref)
        _assert_table_equal(table[i], counts[i], t_v[i], c_v[i])


# ---------------------------------------------------------------- compositing


def _random_tiles(rng, nt, k, n_channels=3, opacity_hi=0.9):
    params = np.zeros((nt, k, 8), np.float32)
    params[..., 0] = rng.uniform(-10, TILE_W + 10, (nt, k))
    params[..., 1] = rng.uniform(-10, TILE_H + 10, (nt, k))
    params[..., 2] = rng.uniform(0.01, 0.2, (nt, k))
    params[..., 3] = rng.uniform(-0.01, 0.01, (nt, k))
    params[..., 4] = rng.uniform(0.01, 0.2, (nt, k))
    params[..., 5] = rng.uniform(0.05, opacity_hi, (nt, k))
    params[..., 6] = rng.uniform(1, 10, (nt, k))
    colors = rng.rand(nt, k, n_channels).astype(np.float32)
    return params, colors


def _tile_inputs():
    """Three tiles: a full list, a partial one, a short one at another tile
    position; then a saturated tile of large opaque splats."""
    rng = np.random.RandomState(0)
    k = _CHUNK * 3
    params, colors = _random_tiles(rng, 4, k, n_channels=5)
    params[3, :, 0] = rng.uniform(0, TILE_W, k)
    params[3, :, 1] = rng.uniform(0, TILE_H, k)
    params[3, :, 2] = params[3, :, 4] = 0.002
    params[3, :, 3] = 0.0
    params[3, :, 5] = 0.9
    counts = np.array([k, k // 2, 37, k], np.int32)
    row0 = np.array([0, TILE_H, 0, 0], np.int32)
    col0 = np.array([0, 0, TILE_W, 0], np.int32)
    return counts, row0, col0, params, colors


def test_tiles_plain_matches_jnp_twin():
    counts, row0, col0, params, colors = _tile_inputs()
    color, depth, alpha, swept = tiles_plain(T(counts), T(row0), T(col0), T(params), T(colors))
    ref_c, ref_aux = JR._tiles_jnp(*(jnp.asarray(x) for x in (counts, row0, col0, params, colors)))
    _close(color, ref_c, what="color")
    _close(depth, np.asarray(ref_aux)[:, 0], what="depth")
    _close(alpha, np.asarray(ref_aux)[:, 1], what="alpha")
    # the chunks the whole-tile exit would sweep: all of a list that never
    # saturates, fewer on the saturated tile
    assert swept[:3].tolist() == [3, 2, 1]
    assert 1 <= int(swept[3]) < 3


def test_tiles_plain_matches_pallas_kernel():
    counts, row0, col0, params, colors = _tile_inputs()
    color, depth, alpha, _ = tiles_plain(T(counts), T(row0), T(col0), T(params), T(colors))
    ref_c, ref_aux = JR._rasterize_tiles(
        *(jnp.asarray(x) for x in (counts, row0, col0, params, colors)),
        k_cap=params.shape[1], n_channels=colors.shape[-1], interpret=True,
    )
    assert float(np.asarray(ref_aux)[3, 1].min()) > 1 - 1e-4  # the last tile saturates
    _close(color, ref_c, atol=2e-4, what="color")
    _close(depth, np.asarray(ref_aux)[:, 0], atol=2e-4 * 10, what="depth (values up to 10)")
    _close(alpha, np.asarray(ref_aux)[:, 1], atol=2e-4, what="alpha")


def test_raster_gathers_through_the_table():
    """The wrapper's table form against the pre-gathered tiles, with colours
    shared by two views."""
    rng = np.random.RandomState(5)
    n, g, k = 2, 300, 256
    params = np.zeros((n, g, 8), np.float32)
    params[..., :7] = _random_tiles(rng, n, g)[0][..., :7]
    params[..., 0] *= 2  # over both tile columns of a 16x256 image
    colors = rng.rand(g, 4).astype(np.float32)
    table = rng.randint(0, g, (n, 2, k)).astype(np.int32)
    counts = np.array([[k, 100], [0, 7]], np.int32)
    color, depth, alpha, _ = raster(T(table), T(counts), T(params), T(colors), (16, 256))
    gp = np.take_along_axis(params[:, None], table[..., None].astype(np.int64), axis=2).reshape(n * 2, k, 8)
    gc = colors[table].reshape(n * 2, k, 4)
    ref_c, ref_aux = JR._tiles_jnp(
        jnp.asarray(counts.reshape(-1)), jnp.asarray(np.zeros(4, np.int32)),
        jnp.asarray(np.array([0, TILE_W] * 2, np.int32)), jnp.asarray(gp), jnp.asarray(gc),
    )
    ref_c = np.asarray(ref_c).reshape(n, 2, 4, TILE_H, TILE_W).transpose(0, 3, 1, 4, 2).reshape(n, 16, 256, 4)
    _close(color, ref_c)
    ref_d = np.asarray(ref_aux)[:, 0].reshape(n, 2, TILE_H, TILE_W).transpose(0, 2, 1, 3).reshape(n, 16, 256)
    _close(depth, ref_d, atol=DEPTH_ATOL)
    assert float(alpha[1, :, :128].abs().max()) == 0.0  # the empty tile


# ---------------------------------------------------------------- rasterize


def _jax_cam(h, w):
    fx = w * 1.2
    return np.eye(4, dtype=np.float32)[None], np.array([[[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1.0]]], np.float32)


def test_rasterize_matches_jax_and_the_dense_oracle():
    """The scene and camera of tests/test_rasterizer.py, whose tolerances
    against the dense oracle hold for it."""
    h, w = 64, 256
    means, covs, opac, colors = (np.array(x) for x in make_scene(300, jax.random.PRNGKey(0)))
    vm, intr = _jax_cam(h, w)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    args = (means, covs, opac, colors, vm, intr)
    color, depth, alpha = rasterize(*(T(a) for a in args), (h, w), background=T(bg), max_per_tile=512)
    jc, jd, ja = JR.rasterize(*(jnp.asarray(a) for a in args), (h, w), background=jnp.asarray(bg),
                              max_per_tile=512)
    _close(color, jc, what="color")
    _close(alpha, ja, what="alpha")
    _close(depth, jd, atol=DEPTH_ATOL, what="depth")
    rc, rd, ra = rasterize_reference(*(T(a) for a in args), (h, w), background=T(bg))
    jrc, jrd, jra = JR.rasterize_reference(*(jnp.asarray(a) for a in args), (h, w), background=jnp.asarray(bg))
    _close(rc, jrc, what="oracle color")
    _close(rd, jrd, atol=DEPTH_ATOL, what="oracle depth")
    np.testing.assert_allclose(color.numpy(), rc.numpy(), atol=5e-3)
    np.testing.assert_allclose(alpha.numpy(), ra.numpy(), atol=5e-3)
    np.testing.assert_allclose(depth.numpy(), rd.numpy(), atol=6e-2)


def test_rasterize_multi_camera_chunked_channels():
    rng = np.random.RandomState(1)
    h, w = 32, 128
    means, covs, opac = _scene(rng, 100)
    colors = rng.rand(100, 10).astype(np.float32)
    vms, intr = _cameras(rng, 2, h, w)
    args = (means, covs, opac, colors, vms, intr)
    # the port composites all 10 channels in one pass; JAX in chunks of 4
    color, depth, alpha = rasterize(*(T(a) for a in args), (h, w), max_per_tile=256)
    jc, jd, ja = JR.rasterize(*(jnp.asarray(a) for a in args), (h, w), max_per_tile=256, channel_chunk=4)
    assert color.shape == (2, h, w, 10)
    _close(color, jc)
    _close(alpha, ja)
    _close(depth, jd, atol=DEPTH_ATOL)
    rc, _, _ = rasterize_reference(*(T(a) for a in args), (h, w))
    np.testing.assert_allclose(color.numpy(), rc.numpy(), atol=2e-3)


# ---------------------------------------------------------------- renderer


def _gaussians(rng, b, g, sh_degree=2):
    means = np.concatenate([rng.uniform(-1, 1, (b, g, 2)), rng.uniform(2, 6, (b, g, 1))], -1).astype(np.float32)
    scales = rng.uniform(0.02, 0.08, (b, g, 3)).astype(np.float32)
    quats = rng.standard_normal((b, g, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    covs = build_covariance(T(scales), T(quats)).numpy()
    harm = (rng.standard_normal((b, g, 3, (sh_degree + 1) ** 2)) * 0.5).astype(np.float32)
    opac = rng.uniform(0.2, 0.9, (b, g)).astype(np.float32)
    fields = dict(means=means, covariances=covs, harmonics=harm, opacities=opac, scales=scales, rotations=quats)
    return (Gaussians(**{k: T(v) for k, v in fields.items()}),
            JaxGaussians(**{k: jnp.asarray(v) for k, v in fields.items()}))


def _views(rng, b, v):
    ext = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    ext[..., :3, 3] = rng.uniform(-0.1, 0.1, (b, v, 3))
    intr = np.tile(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]], np.float32), (b, v, 1, 1))
    return ext, intr


def _render_close(port, ref):
    _close(port.color, ref.color, what="color")
    _close(port.alpha, ref.alpha, what="alpha")
    _close(port.depth, ref.depth, atol=DEPTH_ATOL, what="depth")


@pytest.mark.parametrize("with_delta", [False, True])
def test_render_gaussians_matches_jax(with_delta):
    rng = np.random.RandomState(2)
    tg, jg = _gaussians(rng, 2, 400)
    ext, intr = _views(rng, 2, 3)
    kw, jkw = {}, {}
    if with_delta:
        rot = (rng.standard_normal((2, 3, 3)) * 0.05).astype(np.float32)
        trans = (rng.standard_normal((2, 3, 3)) * 0.2).astype(np.float32)
        kw = dict(cam_rot_delta=T(rot), cam_trans_delta=T(trans))
        jkw = dict(cam_rot_delta=jnp.asarray(rot), cam_trans_delta=jnp.asarray(trans))
    port = TRen.render_gaussians(tg, T(ext), T(intr), (32, 128), max_per_tile=256, **kw)
    ref = JRen.render_gaussians(jg, jnp.asarray(ext), jnp.asarray(intr), (32, 128), max_per_tile=256, **jkw)
    assert port.color.shape == (2, 3, 32, 128, 3)
    assert float(port.alpha.max()) > 0.5
    _render_close(port, ref)


def test_apply_pose_delta_matches_jax():
    rng = np.random.RandomState(3)
    vm = np.tile(np.eye(4, dtype=np.float32), (2, 3, 1, 1))
    vm[..., :3, 3] = rng.standard_normal((2, 3, 3))
    rot = (rng.standard_normal((2, 3, 3)) * 0.3).astype(np.float32)
    rot[0, 0] = 0.0  # the Taylor branch at theta = 0
    trans = rng.standard_normal((2, 3, 3)).astype(np.float32)
    for r, t in ((rot, trans), (rot, None), (None, trans), (None, None)):
        port = TRen.apply_pose_delta(T(vm), None if r is None else T(r), None if t is None else T(t))
        ref = JRen.apply_pose_delta(jnp.asarray(vm), None if r is None else jnp.asarray(r),
                                    None if t is None else jnp.asarray(t))
        _close(port, ref)


def test_render_color_and_qc_and_factored_qc_match_jax():
    rng = np.random.RandomState(4)
    b, g, s, c1, v = 2, 400, 3, 5, 2
    tg, jg = _gaussians(rng, b, g)
    ext, intr = _views(rng, b, v)
    class_probs = rng.rand(b, s, c1).astype(np.float32)
    mask_cols = rng.rand(b, g, s).astype(np.float32)
    bg = np.array([0.2, 0.1, 0.0], np.float32)
    shape = (32, 128)
    render, qc = TRen.render_color_and_qc(tg, T(class_probs), T(mask_cols), T(ext), T(intr), shape,
                                          background=T(bg), max_per_tile=256)
    jrender, jqc = JRen.render_color_and_qc(jg, jnp.asarray(class_probs), jnp.asarray(mask_cols),
                                            jnp.asarray(ext), jnp.asarray(intr), shape,
                                            background=jnp.asarray(bg), max_per_tile=256)
    assert qc.shape == (b, v, s, c1, *shape)
    _render_close(render, jrender)
    _close(qc, jqc, what="qc")
    factored = TRen.render_qc_factored(tg, T(class_probs), T(mask_cols), T(ext), T(intr), shape, max_per_tile=256)
    _close(factored, qc, atol=1e-6, what="factored qc against the fused render")
    jfactored = JRen.render_qc_factored(jg, jnp.asarray(class_probs), jnp.asarray(mask_cols),
                                        jnp.asarray(ext), jnp.asarray(intr), shape, max_per_tile=256)
    _close(factored, jfactored, what="factored qc")


def test_render_gaussians_orthographic_matches_jax():
    rng = np.random.RandomState(5)
    tg, jg = _gaussians(rng, 1, 300)
    ext, _ = _views(rng, 1, 2)
    bv = dict(width=np.full((1, 2), 2.5, np.float32), height=np.full((1, 2), 1.0, np.float32),
              near=np.full((1, 2), 0.1, np.float32), far=np.array([[100.0, 50.0]], np.float32))
    port = TRen.render_gaussians_orthographic(T(ext), **{k: T(x) for k, x in bv.items()}, gaussians=tg,
                                              image_shape=(32, 128), max_per_tile=256)
    ref = JRen.render_gaussians_orthographic(jnp.asarray(ext), **{k: jnp.asarray(x) for k, x in bv.items()},
                                             gaussians=jg, image_shape=(32, 128), max_per_tile=256)
    assert float(port.alpha.max()) > 0.5
    _close(port.color, ref.color, what="color")
    _close(port.alpha, ref.alpha, what="alpha")
    # depth here is camera z after a pull-back of ~1400 world units: fp32 ulp ~1e-4
    np.testing.assert_allclose(port.depth.numpy(), np.asarray(ref.depth), rtol=1e-6, atol=1e-4)
