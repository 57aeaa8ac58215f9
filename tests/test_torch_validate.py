"""siu3r_tpu_torch's validation sweep (cli/validate) and cli/evaluate against
the JAX package's, on the CPU at the tiny config of tests/test_cli_smoke.py.

The port's seeded weights go to the port's CLI as ``--ckpt`` and
into the JAX package's own CLI, whose checkpoint reader returns them carried
across by ``convert_siu3r_state_dict``. Both sweeps run the eval step,
``segments_info``, the lift at 0.3, the Visualizer and the Evaluator on the
same val pair with the fixed-seed random LPIPS VGG. The weights are
adjusted so that the sweep measures something: the BatchNorm statistics
randomised (as tests/test_torch_pipeline.py does), the point heads' depth
bias raised (the Gaussians at about 0.65 units, past the near plane, not at
0.003), the Gaussian heads' scale and opacity biases raised (renders about
half covered) and the class bias of the scene's object class (5, "chair")
raised, so that a query is kept and lifted with the ground truth's class.

Tolerances: the rendered RGB PNGs within one level on >= 99.9% of pixels,
the depth PNGs within 1 mm on >= 99% of pixels (the renders differ by ~1e-5
and the PNGs truncate); the packed label maps equal on >= 99.9% of pixels;
PSNR within 1e-2 dB, SSIM, LPIPS and depth errors within 1e-3; where the
label maps are equal, the segments equal (their scores within 1e-5) and
mIoU, PQ and mAP within 1e-6. cli/evaluate on the sweep's directory gives its results.json
value for value.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import siu3r_tpu.checkpoint_io
from siu3r_tpu.checkpoint import convert_siu3r_state_dict
from siu3r_tpu.cli import validate as jax_validate
from siu3r_tpu.config import bind_scannet_classes as jax_bind
from siu3r_tpu.config import load_config as jax_load_config
from siu3r_tpu_torch.cli import evaluate, validate
from siu3r_tpu_torch.config import bind_scannet_classes, load_config
from siu3r_tpu_torch.pipeline import Pipeline
from test_cli_smoke import TINY_OVERRIDES, fake_root  # noqa: F401
from test_torch_train_cli import two_torch_threads  # noqa: F401


def _overrides(root):
    return [f"datamodule.dataset_cfg.root={root}", *TINY_OVERRIDES]


@pytest.fixture(scope="module")
def sweeps(fake_root, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("sweeps")
    cfg = bind_scannet_classes(load_config(None, _overrides(fake_root)))
    pipe = Pipeline(cfg, device="cpu", seed=3)
    rng = np.random.RandomState(0)
    with torch.no_grad():
        pipe.model.mask2former.class_predictor.bias[4] += 4.0
        for head in (pipe.model.downstream_head1, pipe.model.downstream_head2):
            head.dpt.head[4].bias[2] += 0.5
        for head in (pipe.model.gaussian_param_head1, pipe.model.gaussian_param_head2):
            head.dpt.head[4].bias[0] += 2.0
            head.dpt.head[4].bias[1:4] += 60.0
        for mod in pipe.model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(torch.from_numpy(rng.standard_normal(mod.num_features).astype(np.float32) * 0.1))
                mod.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, mod.num_features).astype(np.float32)))
    torch.save(pipe.model.state_dict(), tmp / "weights.pt")
    port = validate.main(["--config", os.devnull, "--device", "cpu", "--ckpt", str(tmp / "weights.pt"),
                          "--output_path", str(tmp / "port"), "--limit", "1", *_overrides(fake_root)])

    jcfg = jax_bind(jax_load_config(None, _overrides(fake_root)))
    variables = convert_siu3r_state_dict({k: v.numpy() for k, v in pipe.model.state_dict().items()},
                                         jcfg.pipeline.model)
    restore = siu3r_tpu.checkpoint_io.restore_checkpoint
    siu3r_tpu.checkpoint_io.restore_checkpoint = lambda path: jax.tree.map(np.asarray, variables)
    try:
        ref = jax_validate.main(["--config", os.devnull, "--ckpt", "carried-across", "--output_path",
                                 str(tmp / "jax"), "--limit", "1", *_overrides(fake_root)])
    finally:
        siu3r_tpu.checkpoint_io.restore_checkpoint = restore
    return tmp, port, ref


def _pngs(root, sub):
    return {p.relative_to(root): np.asarray(Image.open(p)).astype(np.int64) for p in sorted(root.rglob(f"{sub}/*.png"))}


def test_sweep_writes_what_the_jax_sweep_writes(sweeps):
    tmp, port, ref = sweeps
    assert port["n_scenes"] == ref["n_scenes"] == 1 and len(port["step_seconds"]) == 1
    files = lambda root: sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())
    assert files(tmp / "port") == sorted(files(tmp / "jax") + ["sweep.json"])  # the port also writes its timings
    for sub, level, share in (("rgb", 1, 0.999), ("depth", 1, 0.99)):
        got, want = _pngs(tmp / "port", sub), _pngs(tmp / "jax", sub)
        assert got.keys() == want.keys() and len(got) == 3
        for rel, w in want.items():
            assert (np.abs(got[rel] - w) <= level).mean() >= share, (rel, (np.abs(got[rel] - w) <= level).mean())
    for which in ("context", "target"):
        got, want = _pngs(tmp / "port", f"{which}_seg_pred"), _pngs(tmp / "jax", f"{which}_seg_pred")
        assert got.keys() == want.keys() and got
        agree = np.mean([(got[k] == want[k]).all(-1).mean() for k in want])
        assert agree >= 0.999, (which, agree)
        assert any((w[..., 0] + 256 * w[..., 1]).max() > 0 for w in want.values())  # some pixel is labelled


def test_sweep_results_match_the_jax_sweeps(sweeps):
    tmp, port, ref = sweeps
    got, want = port["results"], ref["results"]
    assert got.keys() == want.keys()
    for key in ("psnr", "ssim", "lpips", "lpips_pretrained", "absrel", "rmse", "context_miou", "target_miou",
                "context_pq", "target_pq", "context_map", "target_map"):
        assert key in want, key
    assert got["lpips_pretrained"] is False and got["context_miou"] > 0 and got["target_miou"] > 0
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=0, atol=1e-2)
    for key in ("ssim", "lpips", "absrel", "rmse"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-3, err_msg=key)
    compared = 0
    for which in ("context", "target"):
        seg_equal = all(np.array_equal(g, w) for g, w in zip(_pngs(tmp / "port", f"{which}_seg_pred").values(),
                                                             _pngs(tmp / "jax", f"{which}_seg_pred").values()))
        if not seg_equal:
            continue
        pred = lambda root: json.loads(next(root.rglob(f"{which}_seg_pred/pred.json")).read_text())
        got_infos, want_infos = pred(tmp / "port"), pred(tmp / "jax")
        assert [{**i, "score": 0} for i in got_infos] == [{**i, "score": 0} for i in want_infos] and want_infos
        np.testing.assert_allclose([i["score"] for i in got_infos], [i["score"] for i in want_infos], atol=1e-5)
        for key in (f"{which}_miou", f"{which}_pq", f"{which}_ious_per_class", f"{which}_pqs_per_class"):
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6, err_msg=key)
        assert got[f"{which}_map"].keys() == want[f"{which}_map"].keys()
        np.testing.assert_allclose(list(got[f"{which}_map"].values()), list(want[f"{which}_map"].values()),
                                   rtol=0, atol=1e-6, err_msg=f"{which}_map")
        compared += 1
    assert compared > 0  # on this config and seed the two sides' label maps are equal
    assert json.loads((tmp / "port" / "results.json").read_text()) == got


def test_evaluate_cli_reproduces_the_sweeps_results(sweeps, capsys):
    tmp, port, _ = sweeps
    capsys.readouterr()
    result = evaluate.main(["--eval_path", str(tmp / "port"), "--device", "cpu"])
    assert result == port["results"]
    assert json.loads(capsys.readouterr().out) == port["results"]
