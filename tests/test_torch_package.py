"""siu3r_tpu_torch stands alone: it imports neither JAX nor the JAX package,
and its entry points run on the GPU unless the caller asks for the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from siu3r_tpu_torch.config import RootCfg, bind_scannet_classes
from siu3r_tpu_torch.device import resolve_device
from siu3r_tpu_torch.kernels.flash_attention import flash_attn
from siu3r_tpu_torch.kernels.binning import bin_gaussians
from siu3r_tpu_torch.kernels.msda import msda
from siu3r_tpu_torch.kernels.raster import raster, raster_backward
from siu3r_tpu_torch.render.projection import ProjectedGaussians
from siu3r_tpu_torch.cli import evaluate, inference, train, validate, validate_refer
from siu3r_tpu_torch.eval.evaluator import Evaluator
from siu3r_tpu_torch.models.model import SIU3RModel, build_model

ROOT = Path(__file__).resolve().parent.parent


def test_package_imports_no_jax():
    modules = sorted(
        "siu3r_tpu_torch." + ".".join(p.relative_to(ROOT / "siu3r_tpu_torch").with_suffix("").parts)
        for p in (ROOT / "siu3r_tpu_torch").rglob("*.py")
    )
    modules = [m.removesuffix(".__init__") for m in modules]
    for m in ("render.projection", "render.rasterizer", "renderer", "pipeline", "cli.viewer",
              "kernels.binning", "kernels.raster", "ops.sh", "ops.lap", "train.losses", "train.matcher",
              "train.lpips", "train.optimizer", "checkpoint_io", "data", "data.datasets", "data.loader",
              "data.native_io", "data.seg_labels", "eval.metrics", "cli.train", "cli.validate_refer",
              "utils.logging", "utils.profiling", "utils.visualize", "visualizer", "eval.evaluator",
              "cli.validate", "cli.evaluate"):
        assert "siu3r_tpu_torch." + m in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'siu3r_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert len(modules) > 25


def test_no_module_imports_the_jax_package_anywhere():
    """A static scan: no ``import siu3r_tpu`` or ``from siu3r_tpu`` (the JAX
    package, not ``siu3r_tpu_torch``) in any file of the port or in
    chip_smoke.py, function bodies included, where the import test above
    cannot see them."""
    pattern = re.compile(r"^\s*(import|from)\s+(siu3r_tpu|jax|jaxlib|flax)(\.|\s|$)", re.MULTILINE)
    files = sorted((ROOT / "siu3r_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    found = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}" for p in files for m in pattern.finditer(p.read_text())]
    assert not found, found
    assert len(files) > 40
    # the scan sees function-local imports (the JAX package's data modules have them)
    jax_data = (ROOT / "siu3r_tpu" / "data" / "datasets.py").read_text()
    assert pattern.search(jax_data)


def test_default_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    cfg = bind_scannet_classes(RootCfg()).pipeline.model
    with pytest.raises(RuntimeError, match="CUDA"):
        SIU3RModel(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.main(["--image_path1", "a.png", "--image_path2", "b.png"])
    with pytest.raises(RuntimeError, match="CUDA"):
        validate_refer.main(["--config", "configs/scanrefer.yaml", "datamodule.dataset_cfg.root=/nonexistent"])
    for cli in (validate, train):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--config", "configs/scannet.yaml", "datamodule.dataset_cfg.root=/nonexistent"])
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(["--eval_path", "/nonexistent"])
    with pytest.raises(RuntimeError, match="CUDA"):
        Evaluator(bind_scannet_classes(RootCfg()).pipeline.evaluator)
    assert resolve_device("cpu") == torch.device("cpu")


def test_cuda_device_turns_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device() == torch.device("cuda")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_kernel_wrappers_refuse_other_devices():
    meta = torch.empty((1, 1, 4, 32), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attn(meta, meta, meta, 1.0)
    value = torch.empty((1, 4, 1, 32), device="meta")
    loc = torch.empty((1, 2, 1, 1, 1, 2), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        msda(value, [(2, 2)], loc, loc[..., 0])
    proj = ProjectedGaussians(*(torch.empty(s, device="meta") for s in ((1, 8, 2), (1, 8, 3), (1, 8), (1, 8))))
    with pytest.raises(ValueError, match="cuda or cpu"):
        bin_gaussians(proj, (16, 128), 128, 4, 2)
    table = torch.empty((1, 1, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        raster(table, table[..., 0], torch.empty((1, 8, 8), device="meta"), torch.empty((8, 3), device="meta"), (16, 128))
    image = torch.empty((1, 16, 128), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        raster_backward(table, table[..., 0], torch.empty((1, 8, 8), device="meta"),
                        torch.empty((8, 3), device="meta"), (16, 128), image[..., None].expand(-1, -1, -1, 3),
                        image, image)


def test_labeled_overlays_need_no_opencv():
    """The Visualizer's labeled overlays draw with numpy and PIL: they run
    with ``cv2`` unimportable."""
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None\n"
        "import numpy as np\n"
        "from siu3r_tpu_torch.utils.visualize import labeled_gt_overlay, labeled_instance_overlay\n"
        "seg = np.zeros((1, 32, 32), int); seg[0, 4:20, 6:30] = 1\n"
        "img = np.random.RandomState(0).rand(1, 32, 32, 3)\n"
        "a = labeled_instance_overlay(img, seg, [{'id': 1, 'label_id': 4, 'score': 0.9}])\n"
        "b = labeled_gt_overlay(img, (seg == 1)[None].astype(float), np.array([4]))\n"
        "assert a.shape == b.shape == (32, 32, 3)\n"
        "assert (a != (img[0] * 255).astype(np.uint8)).any()\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_step_timer_and_metrics_history(tmp_path):
    from siu3r_tpu_torch.utils.logging import MetricsHistory, RankedLogger
    from siu3r_tpu_torch.utils.profiling import StepTimer, sync

    timer = StepTimer()
    out = timer.timed("ones", torch.ones, 4)
    with timer.section("add", result=out):
        out = out + 1
    sync({"x": [out]})  # nothing to wait for on the CPU
    assert set(timer.summary()) == {"add", "ones"} and "ones:" in timer.report()
    history = MetricsHistory(tmp_path)
    history.log(3, loss=torch.tensor(0.5), note="text")
    RankedLogger("siu3r_tpu_torch.test").info("logged")
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1 and '"loss": 0.5' in lines[0] and '"note": "text"' in lines[0]
