"""siu3r_tpu_torch's eval step and viewer against the JAX package.

The eval step runs on the tiny config of tests/test_model.py with the port's
seeded weights carried into JAX (as tests/test_torch_model.py does, with the
class predictor scaled up and the BatchNorm statistics randomised so that
queries are kept and lifted). Inputs are made from a seed with numpy.

Tolerances: the model's floats rtol 1e-3 / atol 1e-4 (tests/test_torch_model.py);
the renders rtol 1e-3 / atol 1e-3 on colour, alpha and qc in [0, 1], and
rtol 1e-3 / atol 1e-2 on depth in the 10x rescaled scene: the Gaussians
differ by ~1e-5 between the two sides, and the render amplifies that where a
footprint radius or tile range rounds the other way (a ceil or floor at a
boundary); lifted ids equal on >= 99.9% of pixels. Viewer frames: uint8
images within 1 level on >= 99.9% of pixels.
"""

import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siu3r_tpu.checkpoint import convert_siu3r_state_dict
from siu3r_tpu.cli import viewer as jax_viewer
from siu3r_tpu.config import PipelineCfg as JaxPipelineCfg
from siu3r_tpu.config import RootCfg as JaxRootCfg
from siu3r_tpu.io import export_ply
from siu3r_tpu.pipeline import Pipeline as JaxPipeline
from siu3r_tpu.pipeline import TrainState
from siu3r_tpu.pipeline import lift_rendered_qc as jax_lift
from siu3r_tpu_torch.cli import viewer
from siu3r_tpu_torch.config import PipelineCfg, RootCfg
from siu3r_tpu_torch.pipeline import Pipeline, lift_rendered_qc
from test_model import tiny_model_cfg
from test_torch_weights import port_cfg, port_state_numpy

H = W = 64
N_TARGET = 4


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_model_cfg()
    pipe = Pipeline(RootCfg(pipeline=PipelineCfg(model=port_cfg(jcfg))), device="cpu", seed=0)
    rng = np.random.RandomState(0)
    with torch.no_grad():
        pipe.model.mask2former.class_predictor.weight.mul_(8.0)
        for mod in pipe.model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(torch.from_numpy(rng.standard_normal(mod.num_features).astype(np.float32) * 0.1))
                mod.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, mod.num_features).astype(np.float32)))
    variables = convert_siu3r_state_dict(port_state_numpy(pipe.model), jcfg)
    ext = np.tile(np.eye(4, dtype=np.float32), (1, N_TARGET, 1, 1))
    # the random-init Gaussians sit within ~0.1 of the origin: the targets
    # look at them from 0.15 behind, past the near plane of the 10x rescale
    ext[..., :3, 3] = rng.uniform(-0.02, 0.02, (1, N_TARGET, 3)) + np.array([0.0, 0.0, -0.15], np.float32)
    intr = np.tile(np.array([[1.24, 0, 0.5], [0, 1.24, 0.5], [0, 0, 1]], np.float32), (1, 2, 1, 1))
    batch = {
        "context_views_images": rng.rand(1, 2, H, W, 3).astype(np.float32),
        "context_views_intrinsics": intr,
        "target_views_extrinsics": ext,
        "target_views_intrinsics": np.tile(intr[:, :1], (1, N_TARGET, 1, 1)),
    }
    jpipe = JaxPipeline(JaxRootCfg(pipeline=JaxPipelineCfg(model=jcfg)), lpips_enabled=False)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"], opt_state=None, step=None)
    ref = jax.jit(jpipe.eval_step)(state, {k: jnp.asarray(v) for k, v in batch.items()})
    out = pipe.eval_step({k: torch.from_numpy(v) for k, v in batch.items()})
    return jcfg, out, ref


def _close(port, ref, rtol, atol, what):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol, atol=atol, err_msg=what)


def test_eval_step_matches_jax(tiny):
    _, (out, render, qc), (jout, jrender, jqc) = tiny
    for f in ("means", "covariances", "harmonics", "opacities", "seg_query_class_logits"):
        _close(getattr(out.gaussians, f), getattr(jout.gaussians, f), 1e-3, 1e-4, f)
    assert render.color.shape == (1, N_TARGET, H, W, 3)
    assert qc.shape == jqc.shape == (1, N_TARGET, 4, 6, H, W)
    assert float(render.alpha.mean()) > 0.02  # the views see the scene
    _close(render.color, jrender.color, 1e-3, 1e-3, "color")
    _close(render.alpha, jrender.alpha, 1e-3, 1e-3, "alpha")
    _close(render.depth, jrender.depth, 1e-3, 1e-2, "depth")
    _close(qc, jqc, 1e-3, 1e-3, "qc")


def test_lift_rendered_qc_matches_jax(tiny):
    jcfg, (out, _, qc), (_, _, jqc) = tiny
    kw = dict(num_queries=jcfg.mask2former.num_queries)
    sem, ins = lift_rendered_qc(qc, out.gaussians.seg_query_scores, **kw)
    jsem, jins = jax_lift(jqc, None, **kw)
    assert int((sem > 0).sum()) > 0  # some pixels are labelled
    assert (sem.numpy() == np.asarray(jsem)).mean() >= 0.999
    assert (ins.numpy() == np.asarray(jins)).mean() >= 0.999
    # on the same input the two lifts are equal
    jsem2, jins2 = jax_lift(jnp.asarray(qc.numpy()), None, **kw)
    np.testing.assert_array_equal(sem.numpy(), np.asarray(jsem2))
    np.testing.assert_array_equal(ins.numpy(), np.asarray(jins2))


# ---------------------------------------------------------------- viewer


@pytest.fixture(scope="module")
def scene_ply(tmp_path_factory):
    path = tmp_path_factory.mktemp("viewer") / "output.ply"
    rng = np.random.RandomState(0)
    g, q, c = 64, 4, 21
    rot = np.zeros((g, 4), np.float32)
    rot[:, 0] = 1.0
    harmonics = np.zeros((g, 3, 25), np.float32)
    harmonics[:, :, 0] = rng.rand(g, 3)
    export_ply(
        means=rng.randn(g, 3).astype(np.float32) * 0.3, scales=np.full((g, 3), 0.05, np.float32),
        rotations=np.roll(rot, -1, axis=-1), harmonics=harmonics, opacities=rng.rand(g).astype(np.float32),
        semantic_labels=rng.randint(0, 20, g), instance_labels=rng.randint(0, 5, g),
        seg_query_class_logits=rng.rand(g, q, c).astype(np.float32), path=path,
    )
    return path


def test_viewer_loads_the_ply_as_the_jax_viewer(scene_ply):
    scene = viewer.load_gaussian_ply(scene_ply)
    ref = jax_viewer.load_gaussian_ply(scene_ply)
    assert scene.keys() == ref.keys()
    assert scene["qc"].shape == (64, 4, 21)
    for key, value in ref.items():
        np.testing.assert_array_equal(scene[key], value, err_msg=key)


@pytest.mark.parametrize("mode", ["rgb", "semantic", "instance", "depth"])
def test_viewer_render_modes_match_jax(scene_ply, mode):
    scene = viewer.load_gaussian_ply(scene_ply)
    vm, intr = viewer.camera_from_spherical(np.zeros(3), yaw=0.3, pitch=0.2, radius=2.0, image_size=(64, 64))
    jvm, jintr = jax_viewer.camera_from_spherical(np.zeros(3), yaw=0.3, pitch=0.2, radius=2.0, image_size=(64, 64))
    np.testing.assert_allclose(vm, jvm, atol=1e-6)
    img = viewer.render_views(scene, vm[None], intr[None], (64, 64), mode=mode, device="cpu")[0]
    ref = jax_viewer.render_views(scene, jvm[None], jintr[None], (64, 64), mode=mode)[0]
    assert img.shape == (64, 64, 3) and img.dtype == np.uint8
    assert img.max() > 0
    near = np.abs(img.astype(np.int32) - ref.astype(np.int32)).max(-1) <= 1
    assert near.mean() >= 0.999


def test_viewer_orbit_writes_frames(scene_ply, tmp_path):
    viewer.main(["--ply", str(scene_ply), "--orbit", "--frames", "2", "--mode", "depth",
                 "--output_path", str(tmp_path), "--device", "cpu"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["depth_000.png", "depth_001.png"]


def test_viewer_http_serves_page_and_frames(scene_ply):
    scene = viewer.load_gaussian_ply(scene_ply)
    server = viewer.serve(scene, port=0, image_size=(64, 64), block=False, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_port}"
        assert b"siu3r_tpu_torch viewer" in urllib.request.urlopen(f"{base}/", timeout=30).read()
        for mode in ("rgb", "semantic", "instance", "depth"):
            png = urllib.request.urlopen(
                f"{base}/render?yaw=0.5&pitch=0.1&radius=1.2&mode={mode}", timeout=120
            ).read()
            assert png[:8] == b"\x89PNG\r\n\x1a\n", mode
        for path, code in (("/nope", 404), ("/render?mode=nope", 400)):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(f"{base}{path}", timeout=30)
            assert err.value.code == code
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_viewer_and_pipeline_raise_without_a_gpu(monkeypatch, scene_ply, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Pipeline(RootCfg(pipeline=PipelineCfg(model=port_cfg(tiny_model_cfg()))))
    with pytest.raises(RuntimeError, match="CUDA"):
        viewer.main(["--ply", str(scene_ply), "--orbit", "--output_path", str(tmp_path)])
    scene = viewer.load_gaussian_ply(scene_ply)
    vm, intr = viewer.camera_from_spherical(np.zeros(3), 0.0, 0.0, 2.0, (64, 64))
    with pytest.raises(RuntimeError, match="CUDA"):
        viewer.render_views(scene, vm[None], intr[None], (64, 64))
    with pytest.raises(RuntimeError, match="CUDA"):
        viewer.serve(scene, port=0, block=False)
    assert not list(tmp_path.iterdir())
