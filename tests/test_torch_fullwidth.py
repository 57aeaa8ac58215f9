"""siu3r_tpu_torch against the JAX package at the shipped model's widths.

Config, weights and inputs come from tests/torch_fullwidth_common.py:
``configs/scannet.yaml``'s model (ViT-L CroCo, Mask2Former with 100 queries
and the ScanNet label set, 16 lift slots, SH degree 4, 256x256, two views,
fp32) with weights drawn from numpy, cut to 4 encoder and 4 + 4 decoder
blocks and 4 + 1 Mask2Former layers. The tests marked slow add the eval step
and the bf16 forward at that depth and at the shipped one (``-k cut`` keeps
to the cut depth: the shipped one holds two copies of a 650M-parameter model
in memory), the forward at the shipped depth, and the JAX package's
Mask2Former against itself under last-bit noise. The port's state_dict goes
through
``siu3r_tpu.checkpoint.convert_siu3r_state_dict`` into the JAX model. The
port runs its plain versions on the CPU, the JAX package its XLA path (the
count binning, the jnp compositing).

Module by module, each of the port's modules takes the JAX module's own
inputs (every top-level module's output of the JAX forward), so that a fault
names its module; then the whole forward from the images.

Tolerances (tests/test_torch_model.py's): floats rtol 1e-3 with an absolute
floor of 1e-4 times the field's largest magnitude (the Gaussian means span
about 0.01, so a fixed 1e-4 would hide their errors); integers exact. Two
discrete decisions are held exactly only where the reference decides them
by more than its own rounding (``torch_fullwidth_common.MASK_TIE`` and
``LABEL_TIE``): Mask2Former's masked attention takes the reference's
decision at the bits whose resized logit lies within 1e-4 of 0, and label
maps are exact outside the pixels whose two best queries lie within 1e-4.
Binning tables and counts exact at G = 131,072 with tiles at the cap. The
eval step's render (slow): colour, depth and alpha within 2e-4 on at least
99.9% of the pixels, lifted maps equal on 99.9%. bf16 (slow):
tests/test_torch_bf16.py's model bounds (means 1e-3 mean relative error,
labels 99%), the JAX side compiled with excess precision off.

The JAX package's numbers that the GPU run of chip_smoke.py (phase
``fullwidth``) is held against are in tests/torch_fullwidth_ref.npz:

    PYTHONPATH=. python tests/test_torch_fullwidth.py    # rewrites it (about a minute)

and ``test_fixture_is_current`` holds the committed file against a fresh
computation (rtol 1e-5).
"""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_fullwidth_common as C
from siu3r_tpu import config as jconfig
from siu3r_tpu.checkpoint import convert_siu3r_state_dict
from siu3r_tpu.config import PipelineCfg as JaxPipelineCfg
from siu3r_tpu.config import RootCfg as JaxRootCfg
from siu3r_tpu.models.layers import bilinear_resize_torch
from siu3r_tpu.models.mask2former.postprocess import panoptic_segmentation as jax_panoptic
from siu3r_tpu.models.mask2former.postprocess import qc_logits_per_pixel as jax_qc_logits
from siu3r_tpu.models.model import SIU3RModel as JaxModel
from siu3r_tpu.pipeline import Pipeline as JaxPipeline
from siu3r_tpu.pipeline import TrainState
from siu3r_tpu.pipeline import lift_rendered_qc as jax_lift
from siu3r_tpu.render.projection import project_gaussians
from siu3r_tpu.render.rasterizer import bin_gaussians_count
from siu3r_tpu.renderer import FAR, SCALE_FACTOR
from siu3r_tpu.renderer import render_gaussians as jax_render_gaussians
from siu3r_tpu_torch.config import PipelineCfg, RootCfg
from siu3r_tpu_torch.kernels.binning import bin_gaussians_plain
from siu3r_tpu_torch.models.gaussian_adapter import adapt_gaussians
from siu3r_tpu_torch.models.heads.dpt import dpt_hooks, postprocess_pts3d
from siu3r_tpu_torch.models.mask2former.postprocess import panoptic_segmentation, qc_logits_per_pixel
from siu3r_tpu_torch.models.model import set_compute_dtype
from siu3r_tpu_torch.pipeline import Pipeline, lift_rendered_qc
from siu3r_tpu_torch.render.projection import ProjectedGaussians
from siu3r_tpu_torch.render.tiles import SLOTS_X, SLOTS_Y
from test_torch_train_cli import two_torch_threads  # noqa: F401  (fixture)

LABEL_MAPS = ("segmentation", "semantic")
QUERY_FLAGS = ("keep", "exists", "seg_ids", "pred_labels", "lift_slot", "lifted", "qc_valid")
QUERY_FLOATS = ("pred_scores", "qc_class_probs", "qc_mask_probs", "query_scores")
# the eval step's target views (siu3r_tpu/cli/validate.py:77)
N_EVAL_TARGETS = 6
# tests/test_torch_bf16.py's bounds on the bf16 model against the JAX package's
BF16_MEANS_REL, BF16_LABELS = 1e-3, 0.99


@dataclasses.dataclass
class Run:
    model: torch.nn.Module  # the port on the CPU, numpy weights
    jcfg: jconfig.ModelCfg
    variables: dict  # the same weights for the JAX model
    images: np.ndarray
    intr: np.ndarray
    ref: object  # the JAX forward's ModelOutput, as numpy
    inter: dict  # every top-level JAX module's output, as numpy

    @property
    def cfg(self):
        return self.model.cfg

    @functools.cached_property
    def ties(self) -> tuple:
        """(the masked attention's ties, the label maps' ties) of the
        reference forward."""
        seg = self.ref.seg
        return (jax_mask_ties(seg.aux_mask_logits, self.cfg.image_size),
                C.label_ties(seg.class_queries_logits, seg.masks_queries_logits, self.cfg))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def run_reference(depth: str) -> Run:
    """The port at ``depth`` with the numpy weights, and the JAX forward (with
    the query-class lift) on the same weights and inputs, every top-level
    module's output captured."""
    model = C.build_fullwidth_model(depth)
    jcfg = jconfig._from_dict(jconfig.ModelCfg, dataclasses.asdict(model.cfg))
    variables = convert_siu3r_state_dict({k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    images, intr = C.fullwidth_inputs(model.cfg)
    jm = JaxModel(jcfg)
    top = lambda mdl, method: method == "__call__" and len(mdl.scope.path) == 1
    ref, inter = jax.jit(lambda v, a, b: jm.apply(
        v, a, b, enable_query_class_logit_lift=True, capture_intermediates=top, mutable=["intermediates"],
    ))(variables, images, intr)
    inter = {k: v["__call__"][0] for k, v in inter["intermediates"].items()}
    return Run(model, jcfg, variables, images, intr, _np_tree(ref), _np_tree(inter))


@functools.partial(jax.jit, static_argnums=1)
def _attention_masks(aux_mask_logits, sizes):
    """Each mask predictor call's resized logits and exclusions, flat, as
    ``siu3r_tpu/models/mask2former/decoder.py:MaskPredictor`` makes them."""
    out = []
    for layer, ml in enumerate(aux_mask_logits):
        b, q, v, mh, mw = ml.shape
        att = bilinear_resize_torch(ml.reshape(b * q * v, mh, mw, 1), sizes[layer % 3], align_corners=False)
        out.append((att.reshape(-1), jax.nn.sigmoid(att).reshape(-1) < 0.5))
    return out


def jax_mask_ties(aux_mask_logits, image_size) -> list:
    """Per call of the mask predictor: the flat indices of its exclude mask
    whose resized logit lies within MASK_TIE of 0, and the JAX package's
    exclusions there. Call l resizes to the level l mod 3 of (1/32, 1/16,
    1/8)."""
    h, w = image_size
    sizes = ((h // 32, w // 32), (h // 16, w // 16), (h // 8, w // 8))
    ties = []
    for att, excl in _attention_masks([jnp.asarray(x) for x in aux_mask_logits], sizes):
        idx = np.flatnonzero(np.abs(np.asarray(att)) < C.MASK_TIE)
        ties.append((idx, np.asarray(excl)[idx]))
    return ties


def _close(port, ref, what):
    excess = C.excess(port, ref)
    assert excess <= 0, f"{what}: beyond rtol {C.RTOL} / atol {C.ATOL_SCALE} x max by {excess}"


def _labels(port, ref, ties, what):
    differ, outside = C.label_misses(port, ref, ties)
    assert outside == 0, f"{what}: {outside} pixels differ outside the reference's {len(ties)} ties"
    return differ


def _largest(pairs: dict) -> str:
    return ", ".join(f"{k} {float(np.abs(np.asarray(a) - b).max()):.3g}" for k, (a, b) in pairs.items())


def _forward_matches(out, ref, label_ties, what=""):
    """The whole forward's outputs against the JAX package's; prints the
    largest abs error of each float field (``pytest -s`` shows it)."""
    floats = {"pts3d": (out.pts3d, ref.pts3d),
              **{f: (getattr(out.gaussians, f), getattr(ref.gaussians, f)) for f in C.GAUSSIAN_FIELDS},
              "class logits": (out.seg.class_queries_logits, ref.seg.class_queries_logits),
              "mask logits": (out.seg.masks_queries_logits, ref.seg.masks_queries_logits)}
    for name, (a, b) in floats.items():
        _close(a, b, f"{what}{name}")
    np.testing.assert_array_equal(out.gaussians.seg_query_valid.numpy(), ref.gaussians.seg_query_valid)
    for f in ("semantic_labels", "instance_labels"):
        _labels(getattr(out.gaussians, f), getattr(ref.gaussians, f), label_ties, f"{what}{f}")
    differ = {key: _labels(out.post[key], ref.post[key], label_ties, f"{what}{key}") for key in LABEL_MAPS}
    largest = _largest({k: (a.numpy(), b) for k, (a, b) in floats.items()})
    print(f"\n[fullwidth, CPU] {what}largest abs errors: {largest}; labels differing at the reference's "
          f"{len(label_ties)} ties: {differ}")
    for key in QUERY_FLAGS:
        np.testing.assert_array_equal(out.post[key].numpy(), ref.post[key], err_msg=f"{what}{key}")
    for key in QUERY_FLOATS:
        _close(out.post[key], ref.post[key], f"{what}{key}")
    # the scaled class predictor keeps queries, so the labels are not all background
    assert int(out.post["keep"].sum()) > 0
    assert int(out.gaussians.semantic_labels.max()) > 0


def _scaled_cameras(ext, intr, image_size):
    """The renderer's 1/near rescale of the target cameras: (world-to-camera
    [N, 4, 4], pixel intrinsics [N, 3, 3])."""
    h, w = image_size
    ext = np.array(ext[0], np.float32)
    ext[:, :3, 3] *= SCALE_FACTOR
    intr_px = np.array(intr[0], np.float32)
    intr_px[:, 0] *= w
    intr_px[:, 1] *= h
    return np.linalg.inv(ext).astype(np.float32), intr_px


def jax_projection(gaussians, ext, intr, image_size):
    """The JAX package's projection of the (batch 1) Gaussians into the
    target views, as its renderer projects them: ProjectedGaussians [N, G]."""
    viewmats, intr_px = _scaled_cameras(ext, intr, image_size)
    means = jnp.asarray(gaussians.means[0]) * SCALE_FACTOR
    covs = jnp.asarray(gaussians.covariances[0]) * SCALE_FACTOR**2
    return jax.jit(jax.vmap(lambda vm, k: project_gaussians(means, covs, vm, k, image_size, 1.0, FAR * SCALE_FACTOR)))(
        viewmats, intr_px)


def fixture_arrays(run: Run) -> dict:
    """The JAX package's numbers that phase ``fullwidth`` of chip_smoke.py
    holds the GPU run against: a seeded subset of the Gaussians' fields (and
    each field's largest magnitude), the label maps and the reference's
    label ties, the class logits and kept queries, the masked attention's
    ties, and N_TARGETS framed target cameras with the render of each."""
    g, post = run.ref.gaussians, run.ref.post
    sub = C.subset_indices(g.means.shape[1])
    mask_ties, label_ties = run.ties
    ext, tintr = C.framed_targets(g.means, C.N_TARGETS)
    render = jax.jit(lambda gs, e, k: jax_render_gaussians(gs, e, k, run.cfg.image_size))(g, ext, tintr)
    arrays = {"subset": sub, "target_ext": ext, "target_intr": tintr, "label_ties": label_ties,
              "class_logits": run.ref.seg.class_queries_logits, "keep": post["keep"],
              "color": render.color, "depth": render.depth, "alpha": render.alpha}
    for f in C.GAUSSIAN_FIELDS:
        field = getattr(g, f)
        arrays[f"scale_{f}"] = np.abs(field).max()
        arrays[f"g_{f}"] = field if f == "seg_query_scores" else field[:, sub]
    for key in LABEL_MAPS:
        arrays[key] = post[key].astype(np.int16)
    for layer, (idx, excl) in enumerate(mask_ties):
        arrays[f"mask_ties_{layer}"] = idx
        arrays[f"mask_excl_{layer}"] = excl
    return {k: np.asarray(v) for k, v in arrays.items()}


def write_fixture(path=C.FIXTURE) -> None:
    np.savez_compressed(path, **fixture_arrays(run_reference("cut")))


# ---------------------------------------------------------------- the cut depth, module by module


@pytest.fixture(scope="module")
def cut(two_torch_threads):
    return run_reference("cut")


def test_backbone_matches_jax(cut):
    with torch.inference_mode():
        out = cut.model.backbone(_t(cut.images), _t(cut.intr))
    ref = cut.inter["backbone"]
    _close(out.feat1, ref.feat1, "feat1")
    _close(out.feat2, ref.feat2, "feat2")
    assert len(out.dec1) == len(ref.dec1) == cut.cfg.croco.dec_depth + 1
    for name in ("all_feat1", "all_feat2", "dec1", "dec2"):
        for i, (a, b) in enumerate(zip(getattr(out, name), getattr(ref, name))):
            _close(a, b, f"{name}[{i}]")


def test_adapter_matches_jax(cut):
    bb = cut.inter["backbone"]
    feats = [_t(np.concatenate([f1, f2], axis=0)) for f1, f2 in zip(bb.all_feat1, bb.all_feat2)]
    assert cut.model.adapter.interaction_indexes == (0, 1, 2, 3)
    with torch.inference_mode():
        out = cut.model.adapter(_t(np.concatenate([cut.images[:, 0], cut.images[:, 1]], axis=0)), feats)
    assert len(out) == len(cut.inter["adapter"]) == 4
    for i, (a, b) in enumerate(zip(out, cut.inter["adapter"])):
        _close(a, b, f"level {i}")


@pytest.mark.parametrize("head", ["downstream_head1", "downstream_head2", "gaussian_param_head1",
                                  "gaussian_param_head2"])
def test_dpt_head_matches_jax(cut, head):
    view = int(head[-1]) - 1
    bb = cut.inter["backbone"]
    hooks = dpt_hooks(cut.cfg.croco.dec_depth)
    assert hooks == [0, 2, 3, 4]
    tokens = [_t(d) for i, d in enumerate((bb.dec1, bb.dec2)[view]) if i in hooks]
    image = None if head.startswith("downstream") else _t(cut.images[:, view])
    with torch.inference_mode():
        out = getattr(cut.model, head)(tokens, image, cut.cfg.image_size)
    _close(out, cut.inter[head], "raw head output")
    if image is None:
        _close(postprocess_pts3d(out), cut.ref.pts3d[:, view], "pts3d")


def test_gaussian_adapter_matches_jax(cut):
    """SH degree 4 (25 coefficients a colour) on the JAX heads' outputs."""
    b, v, h, w, _ = cut.ref.pts3d.shape
    raw = np.stack([cut.inter["gaussian_param_head1"], cut.inter["gaussian_param_head2"]], axis=1)
    g = adapt_gaussians(_t(cut.ref.pts3d.reshape(b, v, h * w, 3)), _t(raw.reshape(b, v, h * w, -1)),
                        cut.cfg.gaussian_head.sh_degree).flatten_views()
    assert g.harmonics.shape == (1, v * h * w, 3, 25)
    for f in ("means", "covariances", "harmonics", "opacities", "scales", "rotations"):
        _close(getattr(g, f), getattr(cut.ref.gaussians, f), f)


def test_mask2former_matches_jax(cut):
    """Every level of the masked decoder, its aux logits layer by layer, on
    the JAX adapter's levels, the masked attention given the JAX decisions
    at its ties (at most a few bits a layer change)."""
    levels = [_t(np.stack([f[:1], f[1:]], axis=1)) for f in cut.inter["adapter"]]
    ref = cut.inter["mask2former"]
    ties = jax_mask_ties(ref.aux_mask_logits, cut.cfg.image_size)
    with torch.inference_mode(), C.reference_ties(cut.model, ties) as changed:
        out = cut.model.mask2former(levels)
    assert len(changed) == len(ties) == cut.cfg.mask2former.decoder_layers
    assert sum(int(c) for c in changed) <= sum(len(i) for i, _ in ties) <= 64
    _close(out.last_hidden_state, ref.last_hidden_state, "last hidden state")
    assert len(out.aux_class_logits) == len(ref.aux_class_logits) == cut.cfg.mask2former.decoder_layers
    for i, (a, b) in enumerate(zip(out.aux_class_logits, ref.aux_class_logits)):
        _close(a, b, f"class logits {i}")
    for i, (a, b) in enumerate(zip(out.aux_mask_logits, ref.aux_mask_logits)):
        _close(a, b, f"mask logits {i}")


def test_postprocess_matches_jax(cut):
    """100 queries, 21 classes, 16 lift slots, on the JAX logits: exact."""
    m2f = cut.cfg.mask2former
    seg = cut.ref.seg
    out = panoptic_segmentation(
        _t(seg.class_queries_logits), _t(seg.masks_queries_logits), target_size=cut.cfg.image_size,
        label_ids_to_fuse=tuple(m2f.label_ids_to_fuse), num_labels=m2f.num_labels,
        max_lift_queries=m2f.max_lift_queries, threshold=m2f.seg_threshold,
    )
    for key in LABEL_MAPS + QUERY_FLAGS:
        np.testing.assert_array_equal(out[key].numpy(), cut.ref.post[key], err_msg=key)
    for key in QUERY_FLOATS:
        _close(out[key], cut.ref.post[key], key)
    assert int(out["exists"].sum()) > 0


_jax_panoptic = jax.jit(jax_panoptic, static_argnames=("target_size", "label_ids_to_fuse", "num_labels",
                                                       "max_lift_queries", "threshold"))


@pytest.mark.parametrize("scale", [4.0, 8.0])
def test_postprocess_lifts_16_of_100_queries_like_jax(scale):
    """Synthetic logits at the shipped sizes (100 queries, 21 classes, 16
    lift slots, two views, 256x256 from 64x64 masks): each query owns blocks
    of a random region map, so more queries pass the area-ratio check than
    there are slots and the packing drops the rest; random floats leave no
    argmax or threshold ties."""
    cfg = C.fullwidth_cfg()
    m2f = cfg.mask2former
    rng = np.random.default_rng(10)
    q, v, n_cls = m2f.num_queries, cfg.num_views, m2f.num_labels + 1
    class_logits = (rng.standard_normal((1, q, n_cls)) * scale).astype(np.float32)
    owner = rng.integers(0, q, (1, 1, v, 16, 16)).repeat(4, axis=3).repeat(4, axis=4)
    own = owner == np.arange(q)[None, :, None, None, None]
    mask_logits = (np.where(own, 4.0, -4.0) + rng.standard_normal((1, q, v, 64, 64))).astype(np.float32)
    kw = dict(target_size=cfg.image_size, label_ids_to_fuse=tuple(m2f.label_ids_to_fuse), num_labels=m2f.num_labels,
              max_lift_queries=m2f.max_lift_queries, threshold=m2f.seg_threshold)
    ref = _np_tree(_jax_panoptic(jnp.asarray(class_logits), jnp.asarray(mask_logits), **kw))
    out = panoptic_segmentation(_t(class_logits), _t(mask_logits), **kw)
    assert out.keys() == ref.keys()
    for key in LABEL_MAPS + QUERY_FLAGS:
        np.testing.assert_array_equal(out[key].numpy(), ref[key], err_msg=key)
    for key in QUERY_FLOATS:
        _close(out[key], ref[key], key)
    np.testing.assert_allclose(qc_logits_per_pixel(out).numpy(), np.asarray(jax_qc_logits(ref)), rtol=C.RTOL,
                               atol=C.ATOL_SCALE)
    assert int(out["exists"].sum()) > m2f.max_lift_queries
    assert int(out["lifted"].sum()) == m2f.max_lift_queries


def test_forward_matches_jax(cut):
    """The whole two-view forward from the images."""
    mask_ties, label_ties = cut.ties
    with torch.inference_mode(), C.reference_ties(cut.model, mask_ties):
        out = cut.model(_t(cut.images), _t(cut.intr), enable_query_class_logit_lift=True)
    _forward_matches(out, cut.ref, label_ties)
    assert len(label_ties) < 5e-3 * cut.ref.post["semantic"].size


def test_binning_matches_jax_at_the_cap(cut):
    """Kernel 4's plain version against the JAX count path on the JAX
    projection of the forward's 131,072 Gaussians into the framed targets:
    tables (up to each count) and counts equal, with tiles at the cap of
    4096, where the stable depth order decides which Gaussians a tile
    keeps."""
    ext, tintr = C.framed_targets(cut.ref.gaussians.means, C.N_TARGETS)
    proj = jax_projection(cut.ref.gaussians, ext, tintr, cut.cfg.image_size)
    size, k = cut.cfg.image_size, C.MAX_PER_TILE
    table, counts = jax.jit(jax.vmap(lambda p: bin_gaussians_count(p, size, k, SLOTS_Y, SLOTS_X)))(proj)
    table, counts = np.asarray(table), np.asarray(counts)
    got_table, got_counts = bin_gaussians_plain(ProjectedGaussians(*(_t(x) for x in proj)), size, k, SLOTS_Y, SLOTS_X)
    assert proj.depth.shape == (C.N_TARGETS, 131072)
    np.testing.assert_array_equal(got_counts.numpy(), counts)
    live = np.arange(k) < counts[..., None]
    np.testing.assert_array_equal(np.where(live, got_table.numpy(), -1), np.where(live, table, -1))
    # the framed targets reach the cap as they are: no narrower field of view is needed
    at_cap = int((counts == k).sum())
    print(f"\n[fullwidth, CPU] binning: {at_cap} of {counts.size} tiles at K = {k}, mean count {counts.mean():.1f}")
    assert at_cap > 0, f"no tile reaches the cap (largest count {counts.max()})"


def test_fixture_is_current(cut):
    """tests/torch_fullwidth_ref.npz against the JAX package's numbers now."""
    want = fixture_arrays(cut)
    with np.load(C.FIXTURE) as got:
        assert sorted(got.files) == sorted(want)
        for key, w in want.items():
            g = got[key]
            assert g.shape == w.shape, key
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()), err_msg=key)
            else:
                np.testing.assert_array_equal(g, w, err_msg=key)
    assert C.FIXTURE.stat().st_size <= 4 * 2**20


# ---------------------------------------------------------------- the shipped depth


@pytest.fixture(scope="module")
def full(two_torch_threads):
    return run_reference("full")


@pytest.fixture(scope="module", params=["cut", "full"])
def deep(request):
    """The slow tests' model at each depth (the cut one shared with the tests
    above)."""
    return request.getfixturevalue(request.param)


@pytest.mark.slow
def test_full_depth_forward_matches_jax(full):
    mask_ties, label_ties = full.ties
    with torch.inference_mode(), C.reference_ties(full.model, mask_ties):
        out = full.model(_t(full.images), _t(full.intr), enable_query_class_logit_lift=True)
    _forward_matches(out, full.ref, label_ties)


@pytest.mark.slow
def test_eval_step_matches_jax(deep):
    """``Pipeline.eval_step`` with N_EVAL_TARGETS framed targets against the
    JAX pipeline's: the render of colour, depth and alpha, the query-class
    maps and their lift."""
    ext, tintr = C.framed_targets(deep.ref.gaussians.means, N_EVAL_TARGETS)
    batch = {"context_views_images": deep.images, "context_views_intrinsics": deep.intr,
             "target_views_extrinsics": ext, "target_views_intrinsics": tintr}
    jpipe = JaxPipeline(JaxRootCfg(pipeline=JaxPipelineCfg(model=deep.jcfg)), lpips_enabled=False)
    state = TrainState(params=deep.variables["params"], batch_stats=deep.variables["batch_stats"], opt_state=None,
                       step=None)
    jout, jrender, jqc = _np_tree(jax.jit(jpipe.eval_step)(state, {k: jnp.asarray(v) for k, v in batch.items()}))
    pipe = Pipeline(RootCfg(pipeline=PipelineCfg(model=deep.cfg)), device="cpu", seed=0)
    pipe.model.load_state_dict(deep.model.state_dict())
    mask_ties, label_ties = deep.ties
    with C.reference_ties(pipe.model, mask_ties):
        out, render, qc = pipe.eval_step({k: _t(v) for k, v in batch.items()})
    _forward_matches(out, jout, label_ties, "eval step ")
    assert float(render.alpha.mean()) > 0.1  # the views see the scene
    pairs = {**{k: (getattr(render, k), getattr(jrender, k)) for k in ("color", "depth", "alpha")}, "qc": (qc, jqc)}
    shares = {k: C.render_share(a, b) for k, (a, b) in pairs.items()}
    print(f"\n[fullwidth, CPU] eval step render: share within {C.RENDER_ATOL} {shares}, largest abs errors "
          + _largest({k: (a.numpy(), b) for k, (a, b) in pairs.items()}))
    for what, share in shares.items():
        assert share >= C.RENDER_SHARE, f"{what}: {share} of the pixels within {C.RENDER_ATOL}"
    num_queries = deep.cfg.mask2former.num_queries
    sem, ins = lift_rendered_qc(qc, out.gaussians.seg_query_scores, num_queries=num_queries)
    jsem, jins = jax_lift(jnp.asarray(jqc), None, num_queries=num_queries)
    assert int((sem > 0).sum()) > 0
    assert (sem.numpy() == np.asarray(jsem)).mean() >= C.RENDER_SHARE
    assert (ins.numpy() == np.asarray(jins)).mean() >= C.RENDER_SHARE


@pytest.mark.slow
def test_bf16_forward_matches_jax(deep):
    """The bf16 forward against the JAX package's, within
    tests/test_torch_bf16.py's bounds; printed beside the JAX package's own
    bf16 forward against itself on images moved by at most one ulp (a
    seeded sign a value): at full width last-bit noise, amplified by bf16
    roundings through 1024-wide products, is of the size of those bounds."""
    jm = JaxModel(dataclasses.replace(deep.jcfg, dtype="bfloat16"))
    forward = lambda v, a, b: jm.apply(v, a, b, enable_query_class_logit_lift=True)
    compiled = jax.jit(forward).lower(deep.variables, deep.images, deep.intr).compile(
        compiler_options={"xla_allow_excess_precision": False})
    ref = _np_tree(compiled(deep.variables, deep.images, deep.intr))
    rng = np.random.default_rng(0)
    moved = deep.images * (1 + np.float32(2**-23) * rng.integers(-1, 2, deep.images.shape).astype(np.float32))
    ref_moved = _np_tree(compiled(deep.variables, moved, deep.intr))
    model = set_compute_dtype(deep.model, "bfloat16")
    try:
        with torch.inference_mode():
            out = model(_t(deep.images), _t(deep.intr), enable_query_class_logit_lift=True)
    finally:
        set_compute_dtype(deep.model, "float32")
    rel = lambda a, b: float(np.abs(a - b).mean() / (np.abs(b).mean() + 1e-6))
    agree = lambda a, b: float((np.asarray(a) == b).mean())
    jmeans, jseg = ref.gaussians.means, ref.post["segmentation"]
    means_rel, seg_agree = rel(out.gaussians.means.numpy(), jmeans), agree(out.post["segmentation"].numpy(), jseg)
    print(f"\n[fullwidth, CPU] bf16 forward against the JAX package's: means mean relative error {means_rel:.3g}, "
          f"segment ids equal on {seg_agree:.6f}; the JAX package's against itself under one-ulp input noise: "
          f"{rel(ref_moved.gaussians.means, jmeans):.3g}, {agree(ref_moved.post['segmentation'], jseg):.6f}; "
          f"its bf16 against fp32: {rel(jmeans, deep.ref.gaussians.means):.3g}")
    assert means_rel <= BF16_MEANS_REL, means_rel
    assert seg_agree >= BF16_LABELS, seg_agree
    assert int(out.post["keep"].sum()) > 0


@pytest.mark.slow
def test_jax_mask2former_moves_under_last_bit_noise(cut):
    """Why the masked attention's ties are given to the port: the JAX
    package's Mask2Former against itself, on its adapter levels and on the
    same levels moved by at most one ulp (a seeded sign a value), differs past
    the tolerance once a masked layer has read a flipped bit."""
    from siu3r_tpu.models.mask2former.model import VideoMask2Former as JaxMask2Former

    apply = jax.jit(JaxMask2Former(cut.jcfg.mask2former).apply)
    params = {"params": cut.variables["params"]["mask2former"]}
    levels = [np.stack([f[:1], f[1:]], axis=1) for f in cut.inter["adapter"]]
    rng = np.random.default_rng(0)
    moved = [f * (1 + np.float32(2**-23) * rng.integers(-1, 2, f.shape).astype(np.float32)) for f in levels]
    a, b = apply(params, levels), apply(params, moved)
    cls = [float(jnp.abs(x - y).max()) for x, y in zip(a.aux_class_logits, b.aux_class_logits)]
    masks = [float(jnp.abs(x - y).max()) for x, y in zip(a.aux_mask_logits, b.aux_mask_logits)]
    print(f"\n[fullwidth, CPU] the JAX Mask2Former against itself under one-ulp input noise, largest abs "
          f"difference by layer: class logits {cls}, mask logits {masks}")
    assert max(C.excess(x, y) for x, y in zip(b.aux_class_logits, a.aux_class_logits)) > 0


if __name__ == "__main__":
    import conftest  # noqa: F401  (JAX on the CPU at the tests' matmul precision)

    torch.set_num_threads(2)
    write_fixture()
    print(f"wrote {C.FIXTURE} ({C.FIXTURE.stat().st_size} bytes)", file=sys.stderr)
