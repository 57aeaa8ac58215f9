"""Chip smoke run of siu3r_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--report PATH]

Phases, in order; any failure raises and the script exits non-zero:
  1. environment: versions, the card's name and power limit, TF32 off;
  2. build: nvcc builds the CUDA kernels from siu3r_tpu_torch/csrc;
  3. kernels: each kernel against its plain PyTorch version at the main
     path's shapes and at edge cases, with times, bounds and, for attention,
     one PyTorch call computing the same function as a yardstick;
  4. slice check: a small config run on the GPU (kernels) against the same
     weights on the CPU (plain versions);
  5. forward: the full-width ViT-L two-view forward at 256x256 from a seeded
     random init, with the launch counts of one forward checked against the
     model's attention and deformable-attention call sites and no host sync
     inside it, then timed;
  6. CLI: two synthetic images through ``python -m siu3r_tpu_torch.cli.inference``
     (its own process, under its own settings) to ``output.ply``, read back and
     checked against the reference schema and this process's forward.
It then prints the kernels' JSON line and, last, the device line.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

import siu3r_tpu_torch  # noqa: F401  (outside a checkout of the repo, fail before printing anything)

# H100 SXM peaks (NVIDIA data sheet) at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
ATTN_ATOL = 2e-5
MSDA_ATOL = 1e-5
SLICE_RTOL, SLICE_ATOL = 1e-3, 1e-4
LABEL_AGREEMENT = 0.999


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, iters: int) -> tuple[float, float]:
    """(device ms, elapsed ms) per call over ``iters`` back-to-back calls.

    Device ms is the card's busy time summed over every kernel, copy and
    memset the calls ran, from the profiler's CUDA trace; elapsed ms comes
    from CUDA events around the loop and includes the gaps where the card
    waits for the host to launch (for a small kernel, the wrapper's cost)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    elapsed = start.elapsed_time(end) / iters
    # a short trace can come back empty (CUPTI delivers its records late):
    # profile again, at most three times, before giving up
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        device_us = sum(e.self_device_time_total for e in prof.key_averages())
        if device_us > 0:
            return device_us / 1e3 / iters, elapsed
    raise RuntimeError("the profiler recorded no device time")


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 1, 2


def phase_environment() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("env", f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
               f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} tf32 off")
    return smi


def phase_build() -> None:
    from siu3r_tpu_torch.kernels import _build

    lib, seconds = _build.build()
    _build.load_library()
    log("build", f"nvcc sm_90a -> {lib.relative_to(Path(__file__).resolve().parent)} in {seconds:.1f} s")


# ---------------------------------------------------------------- phase 3


def _positions(b: int, n: int, gen) -> torch.Tensor:
    if n == 257:  # the backbone's 16x16 patch grid plus the intrinsic token at (16, 0)
        yy, xx = torch.meshgrid(torch.arange(16), torch.arange(16), indexing="ij")
        pos = torch.cat([torch.stack([yy.flatten(), xx.flatten()], -1), torch.tensor([[16, 0]])])
        return pos.to("cuda")[None].expand(b, -1, -1).contiguous()
    return torch.randint(0, 17, (b, n, 2), device="cuda", generator=gen)


def _attn_inputs(case, gen, cross: bool):
    """q/k/v in the model's layouts: self-attention takes strided views of one
    packed projection; cross-attention (``cross``, or Nq != Nk) takes three
    separate projections, each a [B, N, H, D] transposed view, with key
    positions in a tensor of their own."""
    b, h, nq, nk, d, rope, mask_kind = case
    dev = "cuda"
    if nq == nk and not cross:
        qkv = torch.randn(b, nq, 3, h, d, device=dev, generator=gen).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
    else:
        q = torch.randn(b, nq, h, d, device=dev, generator=gen).transpose(1, 2)
        k = torch.randn(b, nk, h, d, device=dev, generator=gen).transpose(1, 2)
        v = torch.randn(b, nk, h, d, device=dev, generator=gen).transpose(1, 2)
    qrope = krope = kv_mask = None
    if rope:
        from siu3r_tpu_torch.ops.rope import rope2d_cos_sin

        qrope = rope2d_cos_sin(_positions(b, nq, gen), d)
        krope = rope2d_cos_sin(_positions(b, nk, gen), d)
    if mask_kind == "one_live_key":
        kv_mask = torch.rand(b, nk, device=dev, generator=gen) > 0.5
        kv_mask[0] = False
        kv_mask[0, nk // 2] = True
    return q, k, v, qrope, krope, kv_mask


def _attn_cost(case) -> tuple[float, float]:
    b, h, nq, nk, d, rope, mask_kind = case
    nbytes = 4 * b * h * d * (2 * nq + 2 * nk)  # q, k, v in; out
    if rope:
        nbytes += 4 * 2 * b * d * (nq + nk)  # cos/sin tables
    if mask_kind:
        nbytes += b * nk
    flops = 4 * b * h * nq * nk * d + (6 * b * h * (nq + nk) * d if rope else 0)
    return nbytes, flops


def check_attention(name, case, iters, gen, cross=False):
    from siu3r_tpu_torch.kernels.flash_attention import flash_attn, flash_attn_plain
    from siu3r_tpu_torch.ops.rope import rope2d_from_cos_sin

    q, k, v, qrope, krope, kv_mask = _attn_inputs(case, gen, cross)
    scale = case[4] ** -0.5
    kern = lambda: flash_attn(q, k, v, scale, qrope=qrope, krope=krope, kv_mask=kv_mask)
    plain = lambda: flash_attn_plain(q, k, v, scale, qrope, krope, kv_mask)
    out = kern()
    ref = plain()
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if not math.isfinite(err) or err > ATTN_ATOL:
        raise AssertionError(f"attention {name} {case}: max_abs_err {err} > {ATTN_ATOL}")
    ms, elapsed = time_ms(kern, iters)
    plain_ms, _ = time_ms(plain, max(3, iters // 4))
    lib_ms = None
    if kv_mask is None:
        qr = rope2d_from_cos_sin(q, *qrope) if qrope is not None else q
        kr = rope2d_from_cos_sin(k, *krope) if krope is not None else k
        lib_ms, _ = time_ms(lambda: F.scaled_dot_product_attention(qr, kr, v, scale=scale), iters)
    nbytes, flops = _attn_cost(case)
    b_ms, b_by = bound(nbytes, flops)
    log("kernel", f"{name} {case[:5]} rope={case[5]} mask={case[6]}: max_abs_err {err:.3g} "
                  f"ms {ms:.5f} (elapsed {elapsed:.5f}) plain_ms {plain_ms:.5f} library_ms {lib_ms} "
                  f"bound_ms {b_ms:.5f} ({b_by})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                nbytes=nbytes, flops=flops)


def _msda_inputs(case, gen):
    b, lq, h, d, p, shapes, lo, hi, integer = case
    dev = "cuda"
    nl = len(shapes)
    len_in = sum(hh * ww for hh, ww in shapes)
    value = torch.randn(b, len_in, h, d, device=dev, generator=gen)
    loc = torch.rand(b, lq, h, nl, p, 2, device=dev, generator=gen) * (hi - lo) + lo
    if integer:  # sample points exactly on pixel centres: x * W - 0.5 is an integer
        wh = torch.tensor([[ww, hh] for hh, ww in shapes], dtype=torch.float32, device=dev)
        wh = wh[None, None, None, :, None, :]
        loc = (torch.floor(loc * wh) + 0.5) / wh
    aw = torch.softmax(torch.randn(b, lq, h, nl * p, device=dev, generator=gen), -1).view(b, lq, h, nl, p)
    return value, loc.contiguous(), aw


def _msda_cost(case, loc) -> tuple[float, float]:
    """Bytes: value, locations, weights in; out. Operations: per in-range tap,
    one multiply-add per channel plus the tap's weight (3 multiplies)."""
    b, lq, h, d, p, shapes, *_ = case
    len_in = sum(hh * ww for hh, ww in shapes)
    nl = len(shapes)
    nbytes = 4 * (b * len_in * h * d + b * lq * h * nl * p * 3 + b * lq * h * d)
    taps = 0
    for lvl, (hh, ww) in enumerate(shapes):
        gx = loc[:, :, :, lvl, :, 0] * ww - 0.5
        gy = loc[:, :, :, lvl, :, 1] * hh - 0.5
        x0, y0 = torch.floor(gx), torch.floor(gy)
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi = x0 + dx, y0 + dy
                taps += int(((xi >= 0) & (xi < ww) & (yi >= 0) & (yi < hh)).sum().item())
    return nbytes, taps * (2 * d + 3)


def check_msda(name, case, iters, gen):
    from siu3r_tpu_torch.kernels.msda import msda, msda_plain

    value, loc, aw = _msda_inputs(case, gen)
    shapes = case[5]
    kern = lambda: msda(value, shapes, loc, aw)
    plain = lambda: msda_plain(value, shapes, loc, aw)
    out = kern()
    ref = plain()
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if not math.isfinite(err) or err > MSDA_ATOL:
        raise AssertionError(f"msda {name}: max_abs_err {err} > {MSDA_ATOL}")
    ms, elapsed = time_ms(kern, iters)
    plain_ms, _ = time_ms(plain, max(3, iters // 4))
    nbytes, flops = _msda_cost(case, loc)
    b_ms, b_by = bound(nbytes, flops)
    log("kernel", f"msda {name} B={case[0]} Lq={case[1]} H={case[2]} D={case[3]} P={case[4]} "
                  f"levels={shapes}: max_abs_err {err:.3g} ms {ms:.5f} (elapsed {elapsed:.5f}) "
                  f"plain_ms {plain_ms:.5f} bound_ms {b_ms:.5f} ({b_by})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                nbytes=nbytes, flops=flops)


# (B, H, Nq, Nk, D, rope, mask), the kernel, the calls one forward makes at
# that shape, and whether q and k/v come from separate projections
ATTN_MAIN = {
    "encoder": ((2, 16, 257, 257, 64, True, None), "flash_attn_rope", 24, False),
    "decoder_self": ((1, 12, 257, 257, 64, True, None), "flash_attn_rope", 24, False),
    "decoder_cross": ((1, 12, 257, 257, 64, True, None), "flash_attn_rope", 24, True),
    "m2f_query_self": ((1, 8, 100, 100, 32, False, None), "flash_attn", 9, False),
}
ATTN_EDGE = {
    "rope_nq_ne_nk": (1, 4, 100, 257, 64, True, None),
    "one_key": (2, 3, 70, 1, 32, False, None),
    "one_live_key_row": (2, 4, 65, 130, 32, False, "one_live_key"),
    "one_query_d64": (1, 2, 1, 300, 64, False, None),
}
# (B, Lq, H, D, P, levels, loc lo, loc hi, integer points)
MSDA_MAIN = {
    "adapter": ((2, 1344, 16, 64, 4, ((16, 16),), -0.05, 1.05, False), 6),
    "pixel_decoder": ((2, 1344, 8, 32, 4, ((8, 8), (16, 16), (32, 32)), -0.05, 1.05, False), 6),
}
MSDA_EDGE = {
    "integer_points": (2, 300, 8, 32, 4, ((8, 8), (16, 16)), 0.0, 1.0, True),
    "outside_unit_square": (1, 200, 4, 64, 4, ((16, 16),), -0.5, 1.5, False),
    "one_by_one_level": (2, 100, 8, 32, 2, ((1, 1), (4, 4)), -0.2, 1.2, False),
}


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1234)
    per_kernel = {
        "flash_attn_rope": dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, nbytes=0.0, flops=0.0),
        "flash_attn": dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, nbytes=0.0, flops=0.0),
        "msda": dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0, nbytes=0.0, flops=0.0),
    }

    def add(kernel, res, calls):
        acc = per_kernel[kernel]
        acc["err"] = max(acc["err"], res["err"])
        for key in ("ms", "plain_ms", "bound_ms", "nbytes", "flops"):
            acc[key] += calls * res[key]
        if acc["library_ms"] is not None:
            acc["library_ms"] += calls * res["library_ms"]

    for name, (case, kernel, calls, cross) in ATTN_MAIN.items():
        add(kernel, check_attention(name, case, 50, gen, cross), calls)
    for name, case in ATTN_EDGE.items():
        res = check_attention(name, case, 20, gen)
        kernel = "flash_attn_rope" if case[5] else "flash_attn"
        per_kernel[kernel]["err"] = max(per_kernel[kernel]["err"], res["err"])
    for name, (case, calls) in MSDA_MAIN.items():
        add("msda", check_msda(name, case, 50, gen), calls)
    for name, case in MSDA_EDGE.items():
        per_kernel["msda"]["err"] = max(per_kernel["msda"]["err"], check_msda(name, case, 20, gen)["err"])
    for kernel, acc in per_kernel.items():
        acc["bound_by"] = bound(acc["nbytes"], acc["flops"])[1]
    log("kernels", "all kernels agree with their plain versions "
                   f"(attention atol {ATTN_ATOL}, msda atol {MSDA_ATOL}); per-forward times follow")
    return per_kernel


# ---------------------------------------------------------------- phase 4


def _small_cfg():
    """A small config whose head dims the kernels take: encoder 512/8 (D=64),
    decoder 256/4 (D=64), adapter 512/16 (D=32), Mask2Former 64/2 (D=32)."""
    from siu3r_tpu_torch.config import CrocoCfg, GaussianHeadCfg, Mask2formerCfg, ModelCfg

    return ModelCfg(
        croco=CrocoCfg(enc_depth=4, dec_depth=4, enc_embed_dim=512, dec_embed_dim=256,
                       enc_num_heads=8, dec_num_heads=4),
        mask2former=Mask2formerCfg(
            id2label={i: str(i) for i in range(1, 6)}, label_ids_to_fuse=[0, 1], num_queries=16,
            hidden_dim=64, num_attention_heads=2, dim_feedforward=128, decoder_layers=4,
            encoder_layers=2, encoder_feedforward_dim=128, feature_size=64, mask_feature_size=64,
            max_lift_queries=4,
        ),
        gaussian_head=GaussianHeadCfg(sh_degree=2),
        image_size=(64, 64),
    )


def _floats(out) -> dict:
    g = out.gaussians
    res = {f: getattr(g, f) for f in ("means", "covariances", "harmonics", "opacities", "scales",
                                      "rotations", "seg_query_class_logits")}
    res["class_logits"] = out.seg.class_queries_logits
    res["mask_logits"] = out.seg.masks_queries_logits
    return res


def phase_slice_check() -> None:
    from siu3r_tpu_torch.models.model import build_model

    cfg = _small_cfg()
    gpu = build_model(cfg, device="cuda", seed=7)
    cpu = build_model(cfg, device="cpu", seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(1, 2, 64, 64, 3).astype(np.float32))
    intr = torch.tensor([[1.24, 0, 0.5], [0, 1.24, 0.5], [0, 0, 1]]).expand(1, 2, 3, 3).contiguous()
    with torch.inference_mode():
        og = gpu(images.cuda(), intr.cuda(), enable_query_class_logit_lift=True)
        oc = cpu(images, intr, enable_query_class_logit_lift=True)
    worst = 0.0
    for key, a in _floats(og).items():
        b = _floats(oc)[key]
        a = a.cpu().double()
        b = b.double()
        if not torch.isfinite(a).all():
            raise AssertionError(f"slice check: {key} not finite")
        excess = ((a - b).abs() - SLICE_RTOL * b.abs()).max().item()
        worst = max(worst, excess)
        if excess > SLICE_ATOL:
            raise AssertionError(f"slice check: {key} differs by {excess} beyond rtol {SLICE_RTOL}")
    agree = min(
        (og.gaussians.semantic_labels.cpu() == oc.gaussians.semantic_labels).float().mean().item(),
        (og.gaussians.instance_labels.cpu() == oc.gaussians.instance_labels).float().mean().item(),
    )
    if agree < LABEL_AGREEMENT:
        raise AssertionError(f"slice check: labels agree on {agree:.5f} < {LABEL_AGREEMENT}")
    log("slice", f"small config on cuda (kernels) vs cpu (plain): floats within rtol {SLICE_RTOL} "
                 f"atol {SLICE_ATOL} (worst excess {worst:.3g}), labels agree {agree:.5f}")


# ---------------------------------------------------------------- phase 5


def expected_launches(cfg) -> dict:
    c, m = cfg.croco, cfg.mask2former
    return {
        # encoder self-attention per block; decoder self + cross per block, two decoders
        "flash_attn_rope": c.enc_depth + 4 * c.dec_depth,
        # Mask2Former query self-attention per decoder layer
        "flash_attn": m.decoder_layers - 1,
        # adapter: 4 interactions + 2 extra extractors; pixel decoder: one per encoder layer
        "msda": 4 + 2 + m.encoder_layers,
    }


def _device_breakdown(run, iters: int) -> tuple[float, list]:
    """Device time per forward from the profiler's CUDA trace: the total and
    the 20 largest entries by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / iters) for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    total = sum(ms for _, ms in rows)
    if total <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return total, rows[:20]


def phase_forward() -> dict:
    from siu3r_tpu_torch.config import RootCfg, bind_scannet_classes
    from siu3r_tpu_torch.kernels import _build
    from siu3r_tpu_torch.models.model import build_model

    cfg = bind_scannet_classes(RootCfg()).pipeline.model
    model = build_model(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.rand(1, 2, 256, 256, 3, device="cuda", generator=gen)
    k = torch.tensor([[318 / 256, 0, 0.5], [0, 318 / 256, 0.5], [0, 0, 1]], device="cuda")
    intr = k.expand(1, 2, 3, 3).contiguous()
    run = lambda: model(images, intr, enable_query_class_logit_lift=True)

    with torch.inference_mode():
        run()  # warm-up: cuDNN algorithm choice, allocator
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        # a host sync inside the forward (a copy to or from the host) raises
        torch.cuda.set_sync_debug_mode("error")
        out = run()
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
        expected = expected_launches(cfg)
        if launches != expected:
            raise AssertionError(f"launches {launches} != expected {expected}")
        g = out.gaussians
        hw = 2 * 256 * 256
        shapes = {"means": (1, hw, 3), "covariances": (1, hw, 3, 3), "harmonics": (1, hw, 3, 25),
                  "opacities": (1, hw), "seg_query_class_logits": (1, hw, 16, 21)}
        for f, shape in shapes.items():
            if tuple(getattr(g, f).shape) != shape:
                raise AssertionError(f"{f} shape {tuple(getattr(g, f).shape)} != {shape}")
        for name, t in {**_floats(out), "pts3d": out.pts3d, "qc_mask": out.post["qc_mask_probs"]}.items():
            if not torch.isfinite(t).all():
                raise AssertionError(f"forward output {name} is not finite")
        labels = g.semantic_labels
        if int(labels.min()) < 0 or int(labels.max()) > cfg.mask2former.num_labels:
            raise AssertionError("semantic labels out of range")

        times = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        device_ms, top = _device_breakdown(run, 3)
    med = statistics.median(times)
    res = dict(params=n_params, launches=launches, median_s=med, min_s=min(times), max_s=max(times),
               passes_per_s=1.0 / med, peak_gib=peak / 2**30, device_ms=device_ms,
               idle_share=1.0 - device_ms / (med * 1e3), top_device_ms=top)
    log("forward", f"ViT-L two-view 256x256 B=1 fp32, {n_params} params: launches {launches} "
                   f"(expected {expected}), no host sync, outputs finite; median of {len(times)} warm forwards "
                   f"{med * 1e3:.2f} ms (min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) = "
                   f"{1.0 / med:.3f} passes/s, peak memory {peak / 2**30:.3f} GiB; device busy "
                   f"{device_ms:.2f} ms per forward, idle share {res['idle_share']:.3f}")
    for name, ms in top[:8]:
        log("forward", f"  device {ms:8.3f} ms  {name[:100]}")
    del model, out
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- phase 6


def _cli_forward(images: np.ndarray):
    """The CLI's forward rebuilt here (same seed, default intrinsics) -> host Gaussians."""
    from siu3r_tpu_torch.config import RootCfg, bind_scannet_classes
    from siu3r_tpu_torch.models.model import build_model

    model = build_model(bind_scannet_classes(RootCfg()).pipeline.model, device="cuda", seed=0)
    k = torch.tensor([[318 / 256, 0, 0.5], [0, 318 / 256, 0.5], [0, 0, 1]], device="cuda")
    with torch.inference_mode():
        out = model(torch.from_numpy(images).cuda(), k.expand(1, 2, 3, 3).contiguous(),
                    enable_query_class_logit_lift=True)
    return out.gaussians.to_host()


def check_ply(ply: dict, g) -> float:
    """``output.ply`` against the reference schema and against the host
    Gaussians ``g`` it was written from: xyz, log scales, wxyz rotations,
    SH, query-class confidences, labels. Returns the label agreement."""
    n, _, d_sh = g.harmonics[0].shape
    _, n_slots, n_cls = g.seg_query_class_logits[0].shape
    want = (["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
            + [f"f_rest_{i}" for i in range(3 * (d_sh - 1))] + ["opacity"]
            + [f"scale_{i}" for i in range(3)] + [f"rot_{i}" for i in range(4)]
            + ["semantic_label", "instance_label"]
            + [f"seg_query_class_logits_{i}" for i in range(n_slots * n_cls)])
    if list(ply) != want:
        raise AssertionError(f"ply properties {list(ply)[:20]}... differ from the reference schema")
    for name, col in ply.items():
        if len(col) != n or not np.isfinite(col).all():
            raise AssertionError(f"ply column {name}: {len(col)} rows or non-finite values")
    if ply["semantic_label"].dtype != np.int32 or ply["instance_label"].min() < 0:
        raise AssertionError("ply labels are not non-negative int32")
    expect = {
        **{c: g.means[0][:, i] for i, c in enumerate("xyz")},
        **{f"scale_{i}": np.log(g.scales[0][:, i]) for i in range(3)},
        **{f"rot_{i}": g.rotations[0][:, j] for i, j in enumerate((3, 0, 1, 2))},
        "f_dc_0": g.harmonics[0][:, 0, 0],
        "opacity": g.opacities[0],
        "seg_query_class_logits_1": g.seg_query_class_logits[0][:, 0, 1],
    }
    for name, col in expect.items():
        np.testing.assert_allclose(ply[name], col, rtol=1e-5, atol=1e-6, err_msg=f"ply {name}")
    agree = min((ply["semantic_label"] == g.semantic_labels[0]).mean(),
                (ply["instance_label"] == g.instance_labels[0]).mean())
    if agree < LABEL_AGREEMENT:
        raise AssertionError(f"ply labels agree with the model on {agree:.5f} < {LABEL_AGREEMENT}")
    return float(agree)


def phase_cli() -> None:
    from PIL import Image

    from siu3r_tpu_torch.cli import inference
    from siu3r_tpu_torch.io import read_ply

    rng = np.random.RandomState(3)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i in range(2):
            img = (rng.rand(240, 320, 3) * 255).astype(np.uint8)
            paths.append(Path(tmp) / f"view{i}.png")
            Image.fromarray(img).save(paths[-1])
        out_dir = Path(tmp) / "out"
        cli = subprocess.run(
            [sys.executable, "-m", "siu3r_tpu_torch.cli.inference", "--image_path1", str(paths[0]),
             "--image_path2", str(paths[1]), "--output_path", str(out_dir)],
            cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600,
        )
        for line in cli.stdout.splitlines():
            log("cli", line)
        if cli.returncode != 0:
            raise RuntimeError(f"the CLI exited {cli.returncode}:\n{cli.stderr[-4000:]}")
        ply = read_ply(out_dir / "output.ply")
        images = np.stack([inference.preprocess_image(p) for p in paths])[None]
    agree = check_ply(ply, _cli_forward(images))
    log("cli", f"siu3r_tpu_torch.cli.inference wrote output.ply: {len(ply['x'])} vertices, "
               f"{len(ply)} properties in the reference schema, equal to the model's outputs "
               f"(labels agree {agree:.5f})")


# ---------------------------------------------------------------- main


SOURCES = {
    "flash_attn_rope": ("siu3r_tpu_torch/csrc/flash_attention.cu", "siu3r_tpu/ops/flash_attention.py:67"),
    "flash_attn": ("siu3r_tpu_torch/csrc/flash_attention.cu", "siu3r_tpu/ops/flash_attention.py:33"),
    "msda": ("siu3r_tpu_torch/csrc/msda.cu", "siu3r_tpu/ops/msda_pallas.py:44"),
}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--report", type=str, default=None, help="also write every number as JSON here")
    args = parser.parse_args(argv)

    smi = phase_environment()
    phase_build()
    per_kernel = phase_kernels()
    phase_slice_check()
    fwd = phase_forward()
    phase_cli()

    kernels = []
    for name, acc in per_kernel.items():
        source, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": fwd["launches"][name], "max_abs_err": acc["err"],
            "ms": acc["ms"], "plain_ms": acc["plain_ms"], "bound_ms": acc["bound_ms"],
            "bound_by": acc["bound_by"], "library_ms": acc["library_ms"],
        })
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(
            {"card": smi, "kernels": kernels, "forward": fwd}, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
