"""siu3r_tpu_torch's post-process extras, visualisation, Visualizer and
Evaluator against the JAX package's, on the CPU.

Tolerances: segment lists, instance labels, queries, ids and masks equal,
probabilities and segment scores within 1e-5 (instance scores within 2e-5
relative: the JAX package's fp32 mean over 131,072 pixels is that far from
float64); depth colour maps and plain overlays equal byte for byte; the
labeled overlays (drawn without OpenCV in the port) equal outside a 3-pixel
band around each region's boundary and outside each side's tag rectangle; the Visualizer's file tree equal, its packed-segment,
RGB, depth and colour-map PNGs equal byte for byte; the Evaluator's
results.json on one directory within 1e-5, LPIPS within 1e-4, with the JAX
package's LPIPS parameters carried across.
"""

import json
import shutil

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siu3r_tpu.config import RootCfg as JaxRootCfg
from siu3r_tpu.config import VisualizerCfg as JaxVisualizerCfg
from siu3r_tpu.config import bind_scannet_classes as jax_bind
from siu3r_tpu.eval.evaluator import Evaluator as JaxEvaluator
from siu3r_tpu.models.mask2former import postprocess as jpost
from siu3r_tpu.train import lpips as jax_lpips
from siu3r_tpu.utils import visualize as jviz
from siu3r_tpu.visualizer import Visualizer as JaxVisualizer
from siu3r_tpu_torch.config import RootCfg, VisualizerCfg, bind_scannet_classes
from siu3r_tpu_torch.eval.evaluator import Evaluator
from siu3r_tpu_torch.models.mask2former import postprocess as post
from siu3r_tpu_torch.utils import visualize as viz
from siu3r_tpu_torch.visualizer import Visualizer
from siu3r_tpu_torch.weights import lpips_params_from_jax

# ---------------------------------------------------------------- post-process


@pytest.mark.parametrize("scale,seed", [(4.0, 0), (8.0, 2)])
def test_segments_info_matches_jax(scale, seed):
    rng = np.random.RandomState(10 + seed)
    b, q, v, num_labels = 2, 12, 2, 5
    class_logits = (rng.standard_normal((b, q, num_labels + 1)) * scale).astype(np.float32)
    owner = rng.randint(0, q, (b, 1, v, 4, 4)).repeat(4, axis=3).repeat(4, axis=4)
    own = owner == np.arange(q)[None, :, None, None, None]
    mask_logits = (np.where(own, 4.0, -4.0) + rng.standard_normal((b, q, v, 16, 16))).astype(np.float32)
    kw = dict(target_size=(32, 32), label_ids_to_fuse=(0, 1), num_labels=num_labels, max_lift_queries=4)
    got = post.segments_info(post.panoptic_segmentation(torch.from_numpy(class_logits),
                                                        torch.from_numpy(mask_logits), **kw), (0, 1))
    want = jpost.segments_info(jpost.panoptic_segmentation(jnp.asarray(class_logits), jnp.asarray(mask_logits),
                                                           **kw), (0, 1))
    assert len(got) == len(want) == b and sum(map(len, want)) > 2
    assert any(i["was_fused"] for infos in want for i in infos)
    for g_infos, w_infos in zip(got, want):
        assert [(i["id"], i["label_id"], i["was_fused"]) for i in g_infos] == [
            (i["id"], i["label_id"], i["was_fused"]) for i in w_infos]
        np.testing.assert_allclose([i["score"] for i in g_infos], [i["score"] for i in w_infos], atol=1e-5)


def _instance_inputs(case):
    rng = np.random.RandomState(case)
    b, q, v, mh, mw = 2, 6, 2, 16, 16
    cl = rng.randn(b, q, 5 + 1).astype(np.float32) * 3
    ml = rng.randn(b, q, v, mh, mw).astype(np.float32) - 3
    # tests/test_heads_extra.py:75: one very confident query with a big mask
    ml[0, 2] = 5.0
    cl[0, 2, 1] = 10.0
    ml[1, :, :, 2:12, 3:14] += 5.0  # overlapping instances: later ones overwrite
    if case == 1:  # tied class scores: the lower index comes first, as lax.top_k
        cl[1, 4] = cl[1, 1]
        cl[0, 5] = cl[0, 3]
    return cl, ml


@pytest.mark.parametrize("case", [0, 1])
def test_instance_segmentation_matches_jax(case):
    cl, ml = _instance_inputs(case)
    kw = dict(target_size=(32, 32), num_labels=5, num_topk=4, threshold=0.3)
    got = post.instance_segmentation(torch.from_numpy(cl), torch.from_numpy(ml), **kw)
    want = jpost.instance_segmentation(jnp.asarray(cl), jnp.asarray(ml), **kw)
    assert got.keys() == want.keys()
    for key in ("segmentation", "labels", "queries", "valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    for key in ("class_probs", "mask_probs"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-5, err_msg=key)
    # the scores' mask quality is a mean over 2 x 256 x 256 pixels, which the
    # JAX package sums in fp32 to 1.5e-5 of float64 on the CPU (the port to 1e-7)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=2e-5, atol=1e-6)
    assert bool(got["valid"].any()) and int(got["segmentation"].max()) >= 1
    assert 1 in got["labels"][got["valid"]].tolist()


# ---------------------------------------------------------------- visualize


def test_colour_maps_and_overlays_equal_the_jax_packages():
    rng = np.random.RandomState(1)
    depth = rng.rand(32, 40).astype(np.float32) * 4 + 0.2
    depth[:3, :5] = 0.0  # invalid pixels
    for fn, kw in ((viz.colorize_depth, {}), (viz.colorize_depth_jet, dict(log_scale=True)),
                   (viz.colorize_depth_jet, dict(log_scale=False))):
        got, want = fn(depth, **kw), getattr(jviz, fn.__name__)(depth, **kw)
        assert got.dtype == np.uint8 and np.array_equal(got, want), fn.__name__
    assert np.array_equal(viz.colorize_depth_jet(np.zeros((8, 8))), jviz.colorize_depth_jet(np.zeros((8, 8))))
    image = rng.rand(32, 40, 3).astype(np.float32)
    sem = rng.randint(0, 22, (32, 40))
    ins = rng.randint(0, 40, (32, 40))
    for ids in (None, ins):
        assert np.array_equal(viz.overlay_segmentation(image, sem, ids, 0.4),
                              jviz.overlay_segmentation(image, sem, ids, 0.4))


def _regions():
    """Segments of two views: a square, an L whose box corner lies far from
    it, a region on the image's edge, and one in two pieces."""
    n, h, w = 2, 96, 128
    seg = np.zeros((n, h, w), int)
    seg[:, 8:30, 8:30] = 1
    seg[:, 34:60, 34:50] = 2
    seg[:, 34:44, 50:72] = 2
    seg[1, 0:6, 100:128] = 3
    seg[0, 50:60, 2:10] = 4
    seg[0, 2:8, 40:46] = 4
    infos = [{"id": 1, "label_id": 4, "was_fused": False, "score": 0.91},
             {"id": 2, "label_id": 7, "was_fused": False, "score": 0.55},
             {"id": 3, "label_id": 0, "was_fused": True, "score": 0.3},
             {"id": 4, "label_id": 12, "was_fused": False, "score": 0.72}]
    return np.random.RandomState(0).rand(n, h, w, 3).astype(np.float32), seg, infos


def _cv2_tag(text, box):
    (tw, th), _ = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
    x0, y0, x1, y1 = box
    tx, ty = x0 + (x1 - x0 - tw) // 2, y0 + (y1 - y0 + th) // 2
    return tx - 3, ty - th - 2, tx + tw + 3, ty + 2


def _excluded(regions, tags, n, h, w):
    """[H, N*W]: within 3 pixels of a region's boundary, or in a tag
    rectangle of either side."""
    out = np.zeros((h, n * w), bool)
    for vi, region, tag in ((vi, r, t) for vi, items in enumerate(zip(regions, tags)) for r, t in zip(*items)):
        if not region.any():
            continue
        band = viz._boundary(region)
        for _ in range(3):
            band = viz._cross(band)
        out[:, vi * w:(vi + 1) * w] |= band
        ys, xs = np.nonzero(region)
        box = (xs.min(), ys.min(), xs.max() + 1, ys.max() + 1)
        for left, top, right, bottom in (viz.tag_box(tag, box), _cv2_tag(tag, box)):
            out[max(top, 0):max(bottom + 1, 0), vi * w + max(left, 0):vi * w + min(max(right + 1, 0), w)] = True
    return out


def test_labeled_overlays_match_outside_contours_and_tags():
    images, seg, infos = _regions()
    n, h, w, _ = images.shape
    names = viz.PANOPTIC_SEMANTIC2NAME
    got = viz.labeled_instance_overlay(images, seg, infos, alpha=0.5)
    want = jviz.labeled_instance_overlay(images, seg, infos, alpha=0.5)
    tags = [[f"{i['id']}|{names.get(i['label_id'] + 1)}|{i['score']:.2f}" for i in infos]] * n
    excl = _excluded([[seg[vi] == i["id"] for i in infos] for vi in range(n)], tags, n, h, w)
    assert got.shape == want.shape == (h, n * w, 3) and excl.mean() < 0.5
    assert np.array_equal(got[~excl], want[~excl])
    assert not np.array_equal(got, images.transpose(1, 0, 2, 3).reshape(h, n * w, 3))

    masks = np.stack([seg == k for k in (1, 2, 4)]).astype(np.float32)  # [O, N, H, W]
    classes, valid = np.array([4, 7, 12]), np.array([True, True, False])
    got = viz.labeled_gt_overlay(images, masks, classes, valid, alpha=0.5)
    want = jviz.labeled_gt_overlay(images, masks, classes, valid, alpha=0.5)
    tags = [[names.get(c + 1) for c in classes[valid]]] * n
    excl = _excluded([[m[vi] > 0.5 for m in masks[valid]] for vi in range(n)], tags, n, h, w)
    assert np.array_equal(got[~excl], want[~excl])


# ---------------------------------------------------------------- Visualizer


def _scene_kwargs(seed):
    images, seg, infos = _regions()
    n, h, w, _ = images.shape
    rng = np.random.RandomState(seed)
    depth = rng.rand(3, h, w).astype(np.float32) * 3 + 0.3
    sem = np.where(seg > 0, seg + 4, 0)
    return dict(
        render_color=rng.rand(3, h, w, 3).astype(np.float32), target_images=rng.rand(3, h, w, 3).astype(np.float32),
        render_depth=depth, target_depths=depth * 1.1,
        context_sem_pred=sem, context_ins_pred=seg, context_sem_gt=np.roll(sem, 3, axis=-1),
        context_ins_gt=np.roll(seg, 3, axis=-1),
        target_sem_pred=np.concatenate([sem, sem[:1]]), target_ins_pred=np.concatenate([seg, seg[:1]]),
        target_sem_gt=np.concatenate([sem, sem[:1]]), target_ins_gt=np.concatenate([seg, seg[:1]]),
        seg_infos=infos, context_images=images, context_seg_map=seg,
        gt_masks=np.stack([(seg == 1), (seg == 2)]).astype(np.float32), gt_classes=np.array([4, 7]),
        gt_valid=np.array([True, True]),
    )


def _write_scenes(vis, root):
    for scene, seed in (("scene0000_00", 2), ("scene0001_00", 3)):
        vis.add_scene(str(root), scene, [0, 5], [0, 3, 5], **_scene_kwargs(seed))
    vis.write_files()


def test_visualizer_writes_the_jax_file_tree(tmp_path):
    _write_scenes(Visualizer(VisualizerCfg(log_colored_depth=True)), tmp_path / "port")
    _write_scenes(JaxVisualizer(JaxVisualizerCfg(log_colored_depth=True)), tmp_path / "jax")
    files = lambda root: sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())
    got, want = files(tmp_path / "port"), files(tmp_path / "jax")
    assert got == want and len(want) > 40
    compared = 0
    for rel in want:
        if rel.endswith("seg_overlay_labeled.png"):  # tests above
            continue
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel
        compared += 1
    assert compared == len(want) - 2


# ---------------------------------------------------------------- Evaluator


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    """Two scenes written by the JAX Visualizer, copied twice."""
    root = tmp_path_factory.mktemp("eval")
    _write_scenes(JaxVisualizer(JaxVisualizerCfg()), root / "src")
    for name in ("port", "jax"):
        shutil.copytree(root / "src", root / name)
    return root


def _close_results(got, want, lpips_atol):
    assert got.keys() == want.keys()
    for key, ref in want.items():
        if isinstance(ref, bool):
            assert got[key] == ref, key
        elif isinstance(ref, dict):
            assert got[key].keys() == ref.keys(), key
            np.testing.assert_allclose(list(got[key].values()), list(ref.values()), rtol=0, atol=1e-5, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], ref, rtol=0, atol=lpips_atol if key == "lpips" else 1e-5,
                                       err_msg=key)


def test_evaluator_matches_jax(eval_dirs):
    jcfg = jax_bind(JaxRootCfg()).pipeline.evaluator
    want = JaxEvaluator(jcfg).evaluate(str(eval_dirs / "jax"))
    jparams = jax_lpips.init_lpips_params(None)
    cfg = bind_scannet_classes(RootCfg()).pipeline.evaluator
    port = Evaluator(cfg, device="cpu", lpips_params=lpips_params_from_jax(jparams))
    got = port.evaluate(str(eval_dirs / "port"))
    for key in ("psnr", "ssim", "lpips", "absrel", "rmse", "context_miou", "target_miou", "context_pq",
                "target_pq", "context_map", "target_map"):
        assert key in want, key
    assert want["lpips_pretrained"] is False and want["context_miou"] > 0
    _close_results(got, want, 1e-4)
    assert json.loads((eval_dirs / "port" / "results.json").read_text()).keys() == want.keys()
    for scene in ("scene0000_00_context0_5", "scene0001_00_context0_5"):
        for name in ("render_scores.json", "depth_scores.json"):
            g = json.loads((eval_dirs / "port" / scene / name).read_text())
            w = json.loads((eval_dirs / "jax" / scene / name).read_text())
            assert [x["item"] for x in g] == [x["item"] for x in w]
    # the in-memory API: the same numbers without the files
    mem = Evaluator(cfg, device="cpu", lpips_params=lpips_params_from_jax(jparams))
    kw = _scene_kwargs(2)
    q = mem.update_image_quality(kw["render_color"][0], kw["target_images"][0])
    jq = JaxEvaluator(jcfg).update_image_quality(kw["render_color"][0], kw["target_images"][0])
    np.testing.assert_allclose([q["psnr"], q["ssim"]], [jq["psnr"], jq["ssim"]], rtol=0, atol=1e-5)
    np.testing.assert_allclose(q["lpips"], jq["lpips"], rtol=0, atol=1e-4)


def test_evaluator_default_lpips_is_the_jax_packages_random_vgg(eval_dirs, tmp_path):
    """Without weights the port's VGG is the JAX package's fixed-seed one:
    the same LPIPS, reported as not pretrained."""
    shutil.copytree(eval_dirs / "src", tmp_path / "port")
    shutil.copytree(eval_dirs / "src", tmp_path / "jax")
    got = Evaluator(bind_scannet_classes(RootCfg()).pipeline.evaluator, device="cpu").evaluate(
        str(tmp_path / "port"), eval_scan_num=1)
    want = JaxEvaluator(jax_bind(JaxRootCfg()).pipeline.evaluator).evaluate(str(tmp_path / "jax"), eval_scan_num=1)
    assert got["lpips_pretrained"] is False
    _close_results(got, want, 1e-4)
