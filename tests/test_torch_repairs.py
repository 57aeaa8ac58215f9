"""siu3r_tpu_torch's checkpoint loading and the auction's non-convergence
contract, against the JAX package.

* A training state written by ``checkpoint_io.save_train_state`` loads
  through ``weights.load_checkpoint``, the loader behind
  ``cli/inference.py --model_path``: the loaded model's forward equals the
  saved one's exactly (tiny config, CPU).
* On tie-heavy cost matrices with a small iteration budget the auction
  leaves valid rows unassigned: the port returns -1 for them exactly where
  ``siu3r_tpu/ops/lap.py:auction_lap`` does, in both regimes, and the
  criterion on such an assignment stays finite.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siu3r_tpu.ops.lap import auction_lap as jax_auction_lap
from siu3r_tpu_torch import config as port_config
from siu3r_tpu_torch.checkpoint_io import save_train_state
from siu3r_tpu_torch.models.model import build_model
from siu3r_tpu_torch.ops import lap
from siu3r_tpu_torch.pipeline import Pipeline
from siu3r_tpu_torch.train import losses
from test_train import tiny_root_cfg


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_load_checkpoint_reads_a_saved_train_state(tmp_path):
    cfg = port_config._from_dict(port_config.RootCfg, dataclasses.asdict(tiny_root_cfg()))
    pipe = Pipeline(cfg, device="cpu", seed=2).init_train(steps_per_epoch=10, lpips_enabled=False)
    with torch.no_grad():  # away from the seeded init, so that a skipped load shows
        for p in pipe.model.parameters():
            p.add_(0.01)
    save_train_state(tmp_path / "state.pt", pipe, epoch=1, global_step=7)

    from siu3r_tpu_torch.weights import load_checkpoint

    model = build_model(cfg.pipeline.model, device="cpu", seed=3)
    load_checkpoint(model, str(tmp_path / "state.pt"))
    for key, value in pipe.model.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key
    rng = np.random.RandomState(0)
    h, w = cfg.pipeline.model.image_size
    images = _t(rng.rand(1, 2, h, w, 3).astype(np.float32))
    intr = _t(np.tile(np.array([[1.2, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32), (1, 2, 1, 1)))
    pipe.model.eval()
    model.eval()
    with torch.no_grad():
        want = pipe.model(images, intr).gaussians
        got = model(images, intr).gaussians
    for name in ("means", "covariances", "harmonics", "opacities"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def _tie_heavy(kind, seed):
    """After tests/test_lap.py's degenerate cases: duplicated rows in the
    rectangular regime (2R <= C), quantized costs in the near-square one."""
    rng = np.random.RandomState(seed)
    if kind == "dup_rows":
        cost = rng.rand(4, 16, 40).astype(np.float32) * 10
        cost[:, 1::2] = cost[:, 0::2]
    else:
        cost = np.round(rng.rand(4, 20, 24) * 3).astype(np.float32)
    return cost, rng.rand(*cost.shape[:2]) > 0.15


@pytest.mark.parametrize("kind,max_iters", [("dup_rows", 2), ("dup_rows", 5), ("quantized", 3)])
def test_auction_lap_returns_minus_one_where_jax_does(kind, max_iters):
    cost, valid = _tie_heavy(kind, 5)
    got = lap.auction_lap(_t(cost), _t(valid), max_iters=max_iters).numpy()
    ref = np.stack([np.asarray(jax_auction_lap(jnp.asarray(c), jnp.asarray(v), max_iters=max_iters))
                    for c, v in zip(cost, valid)])
    np.testing.assert_array_equal(got, ref)
    assert ((got == -1) & valid).any(), "the budget left no valid row unassigned: the case tests nothing"
    for a, v in zip(got, valid):
        assigned = a[v & (a >= 0)]
        assert len(np.unique(assigned)) == len(assigned)


def test_segmentation_loss_finite_with_unassigned_rows(monkeypatch):
    rng = np.random.RandomState(7)
    b, q, v, h, w, n_labels, o, n_layers, n_points = 2, 8, 2, 16, 16, 5, 6, 2, 32
    cls = [_t((rng.randn(b, q, n_labels + 1) * 2).astype(np.float32)).requires_grad_(True) for _ in range(n_layers)]
    msk = [_t((rng.randn(b, q, v, h, w) * 2).astype(np.float32)).requires_grad_(True) for _ in range(n_layers)]
    gt_masks = (rng.rand(b, o, v, h, w) > 0.6).astype(np.float32)
    gt_masks[:, 1::2] = gt_masks[:, 0::2]  # duplicated objects: ties in the matching cost
    gt_classes = np.tile(rng.randint(0, n_labels, (b, o // 2)).astype(np.int32), (1, 2))
    gt_valid = np.ones((b, o), bool)
    injected = [{
        "match": _t(rng.rand(b, n_points, 2).astype(np.float32)),
        "pre": _t(rng.rand(b, o * v, 2 * n_points, 2).astype(np.float32)),
        "extra": _t(rng.rand(b, o * v, n_points // 4, 2).astype(np.float32)),
    } for _ in range(n_layers)]
    seen = []

    def one_iteration(*args, **kw):
        out = lap.auction_lap(*args, **kw, max_iters=1)
        seen.append(out)
        return out

    monkeypatch.setattr(losses, "auction_lap", one_iteration)
    got = losses.segmentation_loss(cls, msk, _t(gt_masks), _t(gt_classes), _t(gt_valid), None,
                                   num_labels=n_labels, num_points=n_points, oversample=2.0, importance=0.75,
                                   match_points=n_points, injected_coords=injected)
    assert seen and (seen[0] == -1).any(), "one iteration assigned every row: the case tests nothing"
    for key, value in got.items():
        assert torch.isfinite(value).all(), key
    got["seg_total"].backward()
    for t in cls + msk:
        assert torch.isfinite(t.grad).all()
