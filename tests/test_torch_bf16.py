"""The bf16 compute path of siu3r_tpu_torch (``model.dtype: bfloat16``)
against the JAX package with ``dtype=jnp.bfloat16``, on the CPU.

The port's modules are built with a seeded random init; their fp32
``state_dict`` goes through ``convert_siu3r_state_dict`` into the JAX
modules, so both sides hold the same fp32 parameters and cast them to bf16
the same way. Inputs are made from numpy seeds. Config: the tiny config of
tests/test_model.py (two views, and three for the multi-view backbone), the
class predictor scaled up and the BatchNorm statistics randomised as in
tests/test_torch_multiview.py.

The JAX side's bf16 modules are compiled with XLA's excess precision off
(``xla_allow_excess_precision=False``), so each bf16 op rounds as it is
written, as it does op by op outside ``jit``; XLA's default keeps values in
fp32 inside a fusion, which moves roundings with the compiler's fusion
choices (the two-view backbone then differs from the same function run op by
op by about 0.75 of its bf16-vs-fp32 error). The Pallas kernel runs in
interpret mode.

Tolerances:
- kernel 1b's plain version against ``flash_attention_rope`` on bf16 inputs
  (the Pallas kernel in interpret mode), the plain attention against
  ``xla_attention`` on bf16, and the MSDA boundary against
  ``multi_scale_deformable_attention`` on a bf16 value: elementwise within
  one bf16 ulp of the JAX value and at least 2^-8, the ulp of [1/2, 1)
  (2^-8 * max(1, |o|) falls short of an ulp above 1; a value rounds to
  its neighbour where the two sides' fp32 sums straddle a rounding point,
  and the rotation may round at one place more or less: XLA keeps the
  products in fp32 before the add); at least
  99% of the attention outputs bit-equal (measured: 99.94% at [1, 4, 257,
  64], 100% at [2, 3, 17, 32]); the port's bf16-vs-fp32 error within 1.5x
  of the JAX kernel's own;
- each module (``Block``, ``DecoderBlock``, ``AsymmetricCroCo``,
  ``AsymmetricCroCoMulti`` at 3 views, ``CroCoViTAdapter``), each output
  tensor: the dtype equal to the JAX module's, and the L2 norm of port -
  JAX in bf16 at most MODULE_FRACTION = 0.5 of the L2 norm of the JAX
  module's own bf16 - fp32 difference. Measured: 0 for the blocks, below
  0.002 for the backbones, 0.03 to 0.32 for the adapter's four levels (the
  fp32 statistics of its LayerNorms and its deformable sampling sum in
  another order than XLA's, and a last-bit difference there moves a later
  bf16 rounding). A port computing in fp32 scores 1;
- the model in bf16 against the JAX model in bf16: Gaussian means within a
  mean relative error of MODEL_MEANS_REL = 1e-3 (measured below 1e-4),
  labels equal on at least MODEL_LABELS = 0.99 of the pixels; the port's
  bf16 model against its fp32 model within the JAX package's own bounds
  (tests/test_model.py: means 5%, labels 90%);
- the eval step in bf16 against JAX's: the model's bounds on the Gaussians,
  renders within rtol 1e-3 / atol 1e-3 (depth 1e-2), as
  tests/test_torch_multiview.py holds the fp32 ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siu3r_tpu.ops.attention as JA
import siu3r_tpu.ops.deformable as JD
import siu3r_tpu.ops.flash_attention as JF
from siu3r_tpu.checkpoint import convert_siu3r_state_dict
from siu3r_tpu.config import PipelineCfg as JaxPipelineCfg
from siu3r_tpu.config import RootCfg as JaxRootCfg
from siu3r_tpu.models.adapter import CroCoViTAdapter as JaxAdapter
from siu3r_tpu.models.backbone import AsymmetricCroCo as JaxBackbone
from siu3r_tpu.models.backbone import AsymmetricCroCoMulti as JaxMultiBackbone
from siu3r_tpu.models.layers import Block as JaxBlock
from siu3r_tpu.models.layers import DecoderBlock as JaxDecoderBlock
from siu3r_tpu.pipeline import Pipeline as JaxPipeline
from siu3r_tpu.pipeline import TrainState
from siu3r_tpu_torch.config import PipelineCfg, RootCfg
from siu3r_tpu_torch.kernels import flash_attention as FA
from siu3r_tpu_torch.kernels.msda import msda
from siu3r_tpu_torch.models.backbone import AsymmetricCroCoMulti, bank_masks
from siu3r_tpu_torch.models.layers import Block, DecoderBlock
from siu3r_tpu_torch.models.model import SIU3RModel, set_compute_dtype
from siu3r_tpu_torch.ops import attention as TA
from siu3r_tpu_torch.ops.rope import rope2d, rope2d_cos_sin
from siu3r_tpu_torch.pipeline import Pipeline
from test_model import tiny_model_cfg
from test_torch_multiview import INTR, _randomise
from test_torch_ops import interpret_mode  # noqa: F401  (fixture)
from test_torch_train_cli import two_torch_threads  # noqa: F401  (fixture)
from test_torch_weights import port_cfg, port_state_numpy

BF16 = jnp.bfloat16
H = W = 64
ULP = 2.0**-8
BIT_EQUAL = 0.99
JAX_ERROR_FACTOR = 1.5
MODULE_FRACTION = 0.5
MODEL_MEANS_REL, MODEL_LABELS = 1e-3, 0.99
ORACLE_MEANS_REL, ORACLE_LABELS = 0.05, 0.9
N_TARGET = 2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _strict(fn, *args):
    """``fn(*args)`` compiled with XLA's excess precision off (see the module
    docstring)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})(*args)


def _ulp(ref: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at ``ref`` (bf16 values held in fp32), at
    least ULP."""
    a = np.abs(ref).astype(np.float32)
    up = ((a.view(np.uint32) >> 16) + 1) << 16
    return np.maximum(up.astype(np.uint32).view(np.float32) - a, ULP)


def _within_ulp(port, ref, what=""):
    port, ref = _np(port), _np(ref)
    excess = np.abs(port - ref) - _ulp(ref)
    assert excess.max() <= 0, f"{what}: beyond one bf16 ulp by {excess.max()}"
    return (port == ref).mean()


def _same_dtype(port: torch.Tensor, ref) -> bool:
    return str(port.dtype).removeprefix("torch.") == str(ref.dtype)


def _rel_mean(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).mean() / (np.abs(b).mean() + 1e-6))


# ---------------------------------------------------------------- kernel 1b and the ops


def _qkv(rng, b, h, nq, nk, d):
    return [rng.standard_normal((b, h, n, d)).astype(np.float32) for n in (nq, nk, nk)]


@pytest.mark.parametrize("shape", [(1, 4, 257, 257, 64), (2, 3, 17, 40, 32)])
def test_kernel_1b_plain_matches_the_pallas_kernel(interpret_mode, shape):
    b, h, nq, nk, d = shape
    rng = np.random.RandomState(0)
    q, k, v = _qkv(rng, b, h, nq, nk, d)
    qpos = rng.randint(0, 17, (b, nq, 2))
    kpos = rng.randint(0, 17, (b, nk, 2))
    scale = d**-0.5
    jpos = (jnp.asarray(qpos), jnp.asarray(kpos))
    ref16 = JF.flash_attention_rope(*(jnp.asarray(x, BF16) for x in (q, k, v)), *jpos, scale)
    ref32 = JF.flash_attention_rope(*(jnp.asarray(x) for x in (q, k, v)), *jpos, scale)

    tables = lambda pos, dt: rope2d_cos_sin(torch.from_numpy(pos), d, dtype=dt)
    out16 = FA.flash_attn(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)), scale,
                          qrope=tables(qpos, torch.bfloat16), krope=tables(kpos, torch.bfloat16))
    out32 = FA.flash_attn(*(torch.from_numpy(x) for x in (q, k, v)), scale,
                          qrope=tables(qpos, torch.float32), krope=tables(kpos, torch.float32))
    assert out16.dtype == torch.bfloat16 and ref16.dtype == BF16
    assert _within_ulp(out16, ref16, "kernel 1b") >= BIT_EQUAL
    jax_err = np.abs(_np(ref16) - _np(ref32)).max()
    port_err = np.abs(_np(out16) - _np(out32)).max()
    assert port_err <= JAX_ERROR_FACTOR * jax_err, (port_err, jax_err)


@pytest.mark.parametrize("masked", [False, True])
def test_attention_matches_xla_in_bf16(masked):
    """Without a mask, and with the multi-view bank's mask (views 1..2 of 3
    against the bank of all three): the probabilities are rounded to bf16
    before p v on both sides."""
    rng = np.random.RandomState(1)
    lp1, h, d = 17, 4, 16
    q, k, v = _qkv(rng, 1, h, 2 * lp1, 3 * lp1, d)
    mask = bank_masks(3, lp1, "cpu")[1] if masked else None
    out = TA.attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)), d**-0.5, mask=mask)
    ref = JA.xla_attention(*(jnp.asarray(x, BF16) for x in (q, k, v)), d**-0.5,
                           mask=None if mask is None else jnp.asarray(mask.numpy()))
    assert out.dtype == torch.bfloat16
    assert _within_ulp(out, ref, "attention") >= BIT_EQUAL


def test_msda_boundary_matches_jax_in_bf16():
    """A bf16 value over the three levels of 32x32, 16x16 and 8x8 tokens
    (1344 in all: the JAX package's matmul form): sampled in fp32, the
    output rounded to bf16 once."""
    rng = np.random.RandomState(2)
    shapes = ((32, 32), (16, 16), (8, 8))
    b, lq, nh, d, p = 1, 20, 4, 32, 4
    value = rng.standard_normal((b, 1344, nh, d)).astype(np.float32)
    loc = rng.uniform(-0.05, 1.05, (b, lq, nh, 3, p, 2)).astype(np.float32)
    logits = rng.standard_normal((b, lq, nh, 3 * p)).astype(np.float32)
    aw = torch.softmax(torch.from_numpy(logits).bfloat16(), -1).view(b, lq, nh, 3, p)
    out = msda(torch.from_numpy(value).bfloat16(), shapes, torch.from_numpy(loc), aw)
    ref = JD.multi_scale_deformable_attention(jnp.asarray(value, BF16), shapes, jnp.asarray(loc),
                                              jnp.asarray(aw.float().numpy(), BF16))
    assert out.dtype == torch.bfloat16 and ref.dtype == BF16
    _within_ulp(out, ref, "msda")


def test_kernel_1b_backward_in_bf16():
    """``flash_attn``'s backward (the plain version's VJP) on bf16 inputs:
    bf16 gradients within bf16 accuracy of the fp32 ones."""
    rng = np.random.RandomState(3)
    q, k, v = _qkv(rng, 1, 2, 9, 12, 32)
    pos = [torch.from_numpy(rng.randint(0, 5, (1, n, 2))) for n in (9, 12)]
    cot = torch.from_numpy(rng.standard_normal((1, 2, 9, 32)).astype(np.float32))
    grads = {}
    for dt in (torch.float32, torch.bfloat16):
        leaves = [torch.from_numpy(x).to(dt).requires_grad_(True) for x in (q, k, v)]
        out = FA.flash_attn(*leaves, 32**-0.5, qrope=rope2d_cos_sin(pos[0], 32, dtype=dt),
                            krope=rope2d_cos_sin(pos[1], 32, dtype=dt))
        grads[dt] = torch.autograd.grad(out, leaves, cot.to(dt))
    for g16, g32 in zip(grads[torch.bfloat16], grads[torch.float32]):
        assert g16.dtype == torch.bfloat16 and torch.isfinite(g16).all()
        assert (g16.float() - g32).norm() <= 2e-2 * g32.norm()


@pytest.mark.parametrize("case", ["kv_mask", "no_rope", "head_dim_16", "row_stride_4"])
def test_kernel_1b_checks_refuse(case):
    """What kernel 1b does not take raises in the wrapper's checks (run here
    on CPU tensors; on the card they stand before the launch)."""
    b, h, n, d = 1, 2, 24, 16 if case == "head_dim_16" else 32
    q, k, v = (torch.zeros(b, h, n, d, dtype=torch.bfloat16) for _ in range(3))
    if case == "row_stride_4":  # rows 4 elements apart: 8 bytes, not a 16-byte piece
        q = torch.zeros(b, h, n, d + 4, dtype=torch.bfloat16)[..., :d]
    rope = rope2d_cos_sin(torch.zeros(b, n, 2, dtype=torch.long), d, dtype=torch.bfloat16)
    qrope = krope = None if case == "no_rope" else rope
    kv_mask = torch.ones(b, n, dtype=torch.bool) if case == "kv_mask" else None
    with pytest.raises(ValueError):
        FA._check(q, k, v, qrope, krope, kv_mask)
    # the same call in fp32 where kernel 2 or kernel 1 takes it
    if case in ("kv_mask", "no_rope"):
        rope32 = None if qrope is None else tuple(t.float() for t in rope)
        FA._check(q.float(), k.float(), v.float(), rope32, rope32, kv_mask)


# ---------------------------------------------------------------- modules


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_model_cfg()
    jcfg16 = dataclasses.replace(jcfg, dtype="bfloat16")
    rng = np.random.RandomState(0)
    m32 = SIU3RModel(port_cfg(jcfg), device="cpu", seed=0).eval()
    _randomise(m32, rng)
    m16 = SIU3RModel(port_cfg(jcfg16), device="cpu", seed=0).eval()
    m16.load_state_dict(m32.state_dict())
    variables = convert_siu3r_state_dict(port_state_numpy(m32), jcfg)
    images = rng.rand(1, 3, H, W, 3).astype(np.float32)
    intr = np.tile(INTR, (1, 3, 1, 1))
    return jcfg, m32, m16, variables, images, intr


def _first(tree):
    return jax.tree.map(lambda x: x[0], tree)


def _module_case(name, tiny):
    """(the port's bf16 outputs, the JAX module's bf16 outputs, its fp32
    outputs), each a flat list."""
    jcfg, m32, m16, variables, images, intr = tiny
    c = jcfg.croco
    bb = variables["params"]["backbone"]
    rng = np.random.RandomState(4)
    grid = np.stack(np.meshgrid(np.arange(4), np.arange(4), indexing="ij"), -1).reshape(16, 2)
    pos = np.concatenate([grid, [[4, 0]]])[None].repeat(2, 0)
    tpos = torch.from_numpy(pos)
    if name == "Block":
        x = rng.standard_normal((2, 17, c.enc_embed_dim)).astype(np.float32)
        p = {"params": _first(bb["enc_blocks"]["block"])}
        blk = Block(c.enc_embed_dim, c.enc_num_heads, dtype=torch.bfloat16)
        blk.load_state_dict(m32.backbone.enc_blocks[0].state_dict())
        port = blk(torch.from_numpy(x).bfloat16(), tpos)
        ref16 = _strict(JaxBlock(c.enc_num_heads, dtype=BF16).apply, p, jnp.asarray(x, BF16), pos)
        ref32 = jax.jit(JaxBlock(c.enc_num_heads).apply)(p, x, pos)
        return [port], [ref16], [ref32]
    if name == "DecoderBlock":
        x, y = (rng.standard_normal((1, 17, c.dec_embed_dim)).astype(np.float32) for _ in range(2))
        p = {"params": _first(bb["dec_blocks"])["block1"]}
        blk = DecoderBlock(c.dec_embed_dim, c.dec_num_heads, dtype=torch.bfloat16)
        blk.load_state_dict(m32.backbone.dec_blocks[0].state_dict())
        port = blk(torch.from_numpy(x), torch.from_numpy(y), tpos[:1], tpos[:1])
        ref16 = _strict(JaxDecoderBlock(c.dec_num_heads, dtype=BF16).apply, p, x, y, pos[:1], pos[:1])[0]
        ref32 = jax.jit(JaxDecoderBlock(c.dec_num_heads).apply)(p, x, y, pos[:1], pos[:1])[0]
        return [port], [ref16], [ref32]
    if name in ("AsymmetricCroCo", "AsymmetricCroCoMulti"):
        two = name == "AsymmetricCroCo"
        v = 2 if two else 3
        jm = JaxBackbone if two else JaxMultiBackbone
        port_bb = m16.backbone
        if not two:
            port_bb = AsymmetricCroCoMulti(m32.backbone.cfg, torch.bfloat16)
            port_bb.load_state_dict(m32.backbone.state_dict())
        p = {"params": bb}
        im, k = images[:, :v], intr[:, :v]
        port = port_bb(torch.from_numpy(im), torch.from_numpy(k))
        ref16 = _strict(jm(c, dtype=BF16).apply, p, im, k)
        ref32 = jax.jit(jm(c).apply)(p, im, k)
        keys = (("feat1", "feat2", "all_feat1", "all_feat2", "dec1", "dec2") if two
                else ("feat", "all_feat", "dec_feat"))
        flat = lambda o: [t for key in keys for t in (getattr(o, key) if isinstance(getattr(o, key), list)
                                                      else [getattr(o, key)])]
        return flat(port), flat(ref16), flat(ref32)
    assert name == "CroCoViTAdapter"
    feats = [rng.standard_normal((2, 16, c.enc_embed_dim)).astype(np.float32) for _ in range(c.enc_depth)]
    image = rng.rand(2, H, W, 3).astype(np.float32)
    av = {"params": variables["params"]["adapter"], "batch_stats": variables["batch_stats"]["adapter"]}
    jad = lambda dt: JaxAdapter(num_block=c.enc_depth, embed_dim=c.enc_embed_dim, patch_size=c.patch_size,
                                interaction_indexes=m16.adapter.interaction_indexes, dtype=dt)
    port = m16.adapter(torch.from_numpy(image), [torch.from_numpy(f).bfloat16() for f in feats])
    ref16 = _strict(jad(BF16).apply, av, image, [jnp.asarray(f, BF16) for f in feats])
    ref32 = jax.jit(jad(jnp.float32).apply)(av, image, feats)
    return port, ref16, ref32


@pytest.mark.parametrize("name", ["Block", "DecoderBlock", "AsymmetricCroCo", "AsymmetricCroCoMulti",
                                  "CroCoViTAdapter"])
def test_module_matches_jax_in_bf16(tiny, name):
    with torch.inference_mode():
        port, ref16, ref32 = _module_case(name, tiny)
    assert len(port) == len(ref16) == len(ref32)
    for i, (a, b16, b32) in enumerate(zip(port, ref16, ref32)):
        assert _same_dtype(a, b16), f"{name} output {i}: {a.dtype} against JAX's {b16.dtype}"
        b16, b32 = _np(b16), _np(b32)
        ref_err = np.linalg.norm(b16 - b32)
        assert ref_err > 0, f"{name} output {i}: bf16 and fp32 agree exactly in JAX"
        ratio = np.linalg.norm(_np(a) - b16) / ref_err
        assert ratio <= MODULE_FRACTION, f"{name} output {i}: port - JAX is {ratio:.3f} of JAX's bf16 - fp32"


# ---------------------------------------------------------------- the slice


def _framing(means: np.ndarray):
    """N_TARGET cameras looking down +z at the median of the first view's
    Gaussians (a seeded init puts them in a blob about 0.01 across) from
    0.15 behind the nearest, a little apart, with a field of view that holds
    98% of them: (extrinsics [1, N, 4, 4], intrinsics [1, N, 3, 3])."""
    m = means[: len(means) // 2]
    center = np.median(m, axis=0)
    rel = m - center
    dist = max(-np.quantile(rel[:, 2], 0.02), 0.0) + 0.15
    tan_half = np.quantile(np.abs(rel[:, :2]).max(-1) / np.maximum(rel[:, 2] + dist, 1e-3), 0.98)
    ext = np.tile(np.eye(4, dtype=np.float32), (1, N_TARGET, 1, 1))
    for i in range(N_TARGET):
        ext[0, i, :3, 3] = center + np.array([0.1 * dist * tan_half * (-1) ** i, 0.0, -dist])
    k = np.array([[0.5 / tan_half, 0, 0.5], [0, 0.5 / tan_half, 0.5], [0, 0, 1]], np.float32)
    return ext, np.tile(k, (1, N_TARGET, 1, 1))


@pytest.fixture(scope="module")
def eval_run(tiny):
    """The bf16 eval step (the forward with the query-class lift, then the
    render of N_TARGET views) on both sides, and the port's fp32 forward."""
    jcfg, m32, m16, variables, images, intr = tiny
    with torch.inference_mode():
        out32 = m32(torch.from_numpy(images[:, :2]), torch.from_numpy(intr[:, :2]))
    ext, target_intr = _framing(out32.gaussians.means[0].numpy())
    batch = {
        "context_views_images": images[:, :2],
        "context_views_intrinsics": intr[:, :2],
        "target_views_extrinsics": ext,
        "target_views_intrinsics": target_intr,
    }
    jcfg16 = dataclasses.replace(jcfg, dtype="bfloat16")
    jpipe = JaxPipeline(JaxRootCfg(pipeline=JaxPipelineCfg(model=jcfg16)), lpips_enabled=False)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"], opt_state=None, step=None)
    ref = _strict(jpipe.eval_step, state, {k: jnp.asarray(x) for k, x in batch.items()})
    pipe = Pipeline(RootCfg(pipeline=PipelineCfg(model=port_cfg(jcfg16))), device="cpu", seed=0)
    pipe.model.load_state_dict(m16.state_dict())
    out = pipe.eval_step({k: torch.from_numpy(x) for k, x in batch.items()})
    return out, ref, out32


def test_model_matches_jax_in_bf16(eval_run):
    (out, _, _), (jout, _, _), _ = eval_run
    g, jg = out.gaussians, jout.gaussians
    assert g.means.dtype == torch.float32 and torch.isfinite(g.means).all()
    means_rel = _rel_mean(g.means, jg.means)
    assert means_rel <= MODEL_MEANS_REL, means_rel
    agree = (out.post["segmentation"].numpy() == np.asarray(jout.post["segmentation"])).mean()
    assert agree >= MODEL_LABELS, agree
    assert int(out.post["keep"].sum()) > 0  # queries are kept: the labels are not all background


def test_bf16_model_within_the_oracle_bounds_of_fp32(eval_run):
    """The JAX package's own test of its bf16 path (tests/test_model.py),
    on the port: bf16 against fp32 on the same weights."""
    (out, _, _), _, out32 = eval_run
    means_rel = _rel_mean(out.gaussians.means, out32.gaussians.means)
    assert 0 < means_rel < ORACLE_MEANS_REL, means_rel
    agree = (out.post["segmentation"] == out32.post["segmentation"]).float().mean().item()
    assert agree > ORACLE_LABELS, agree


def test_eval_step_matches_jax_in_bf16(eval_run):
    (_, render, qc), (_, jrender, jqc), _ = eval_run
    assert render.color.shape == (1, N_TARGET, H, W, 3) and qc.shape == jqc.shape
    assert torch.isfinite(render.color).all() and torch.isfinite(qc).all()
    assert float(render.alpha.mean()) > 0.1  # the views see the scene
    for what, a, b, atol in (("color", render.color, jrender.color, 1e-3), ("alpha", render.alpha, jrender.alpha, 1e-3),
                             ("depth", render.depth, jrender.depth, 1e-2), ("qc", qc, jqc, 1e-3)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-3, atol=atol, err_msg=what)


def test_set_compute_dtype_switches_a_built_model(tiny):
    """An fp32 model switched to bf16 in place computes what a model built
    with ``model.dtype: bfloat16`` computes on the same weights, and back."""
    _, m32, m16, _, images, intr = tiny
    x, k = torch.from_numpy(images[:, :2]), torch.from_numpy(intr[:, :2])
    with torch.inference_mode():
        want16 = m16.backbone(x, k).dec1[-1]
        want32 = m32.backbone(x, k).dec1[-1]
        set_compute_dtype(m32, "bfloat16")
        got16 = m32.backbone(x, k).dec1[-1]
        set_compute_dtype(m32, "float32")
        got32 = m32.backbone(x, k).dec1[-1]
    assert torch.equal(got16, want16) and torch.equal(got32, want32)
    assert not torch.equal(got16, got32)
    assert m32.cfg.dtype == "float32"


# ---------------------------------------------------------------- ops


def test_rope2d_in_bf16_rounds_as_the_jax_package():
    """The rotation on bf16 tokens with bf16 tables, each product and the sum
    rounded (``rope2d``), against the JAX package's ``rope2d`` run op by op."""
    rng = np.random.RandomState(6)
    tok = rng.standard_normal((2, 3, 21, 16)).astype(np.float32)
    pos = rng.randint(0, 17, (2, 21, 2))
    from siu3r_tpu.ops.rope import rope2d as jax_rope2d

    with jax.disable_jit():
        ref = jax_rope2d(jnp.asarray(tok, BF16), jnp.asarray(pos))
    out = rope2d(torch.from_numpy(tok).bfloat16(), torch.from_numpy(pos))
    assert out.dtype == torch.bfloat16
    assert _within_ulp(out, ref, "rope2d") >= BIT_EQUAL
