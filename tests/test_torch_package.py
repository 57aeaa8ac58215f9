"""siu3r_tpu_torch stands alone: it imports neither JAX nor the JAX package,
and its entry points run on the GPU unless the caller asks for the CPU."""

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
from siu3r_tpu_torch.cli import inference
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
              "train.lpips", "train.optimizer", "checkpoint_io"):
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
