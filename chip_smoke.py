"""Chip smoke run of siu3r_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--report PATH] [--phases a,b,...]

Phases, in order; any failure raises and the script exits non-zero:
  1. environment: versions, the card's name and power limit, TF32 off;
  2. build: nvcc builds the CUDA kernels from siu3r_tpu_torch/csrc;
  3. kernels: the attention kernel's registers (ptxas) and, in its SASS,
     tensor-core TF32 products and asynchronous copies; each kernel against
     its plain PyTorch version at the main path's shapes and at edge cases,
     with times, bounds (attention at the 3xTF32 tensor-core rate, with the
     fp32 figure beside it), blocks per launch and, for attention, one
     PyTorch call computing the same function as a yardstick; the raster
     kernels' registers (ptxas) and launch configuration (more than one
     block a 16x128 tile, the forward's blocks a cluster of more than one);
     the binning and raster kernels on a synthetic scene at the eval shapes
     (6 views x 32 tiles, K = 4096, C = 3 and 16) and at edge cases; the
     raster backward (kernel 6) against the plain VJP at the training shapes
     (4 views x 32 tiles, K = 4096, C = 3) and at edge cases; the autograd
     of the attention, MSDA and raster wrappers against the plain versions';
  4. slice check: a small config run on the GPU (kernels) against the same
     weights on the CPU (plain versions): the forward, then the eval step's
     render against the CPU render of the step's own Gaussians, with target
     cameras framing the scene;
  5. forward: the full-width ViT-L two-view forward at 256x256 from a seeded
     random init, with the launch counts of one forward checked against the
     model's attention and deformable-attention call sites and no host sync
     inside it, then timed;
  6. eval step: ``Pipeline.eval_step`` at full width (the forward, then RGB,
     depth and query-class rendering of 6 target views), with its launch
     counts checked, no host sync inside it, then timed; the binning and
     raster kernels held against their plain versions on the step's own
     inputs, with times, bounds and tile occupancy;
  8. train step (run before the CLIs): the small config's loss terms and
     render-loss gradient on the GPU against the CPU, then
     ``Pipeline.train_step`` at full width (B = 1, 2 + 4 views, 48 objects),
     its launch counts, finite losses, the frozen encoder unchanged and the
     trained parts moved, then timed with its host syncs, each timed step's
     target cameras framing the Gaussians it renders (every step covered and
     sweeping at least 4 chunks per live tile); the raster kernels held
     against their plain versions on a step's own inputs, timed side by
     side, with how the kept pairs spread over the tiles and sub-tiles;
  7. CLI: two synthetic images through ``python -m siu3r_tpu_torch.cli.inference``
     (its own process, under its own settings) to ``output.ply``, read back and
     checked against the reference schema and this process's forward; then
     ``python -m siu3r_tpu_torch.cli.viewer --orbit`` on a room-scale copy of
     that file (its own process), its frames held against this process's
     render of the same cameras, and the viewer's HTTP server on loopback, in
     every mode, with no blank RGB or depth frame.
It then prints the kernels' JSON line and, last, the device line.
``--phases`` runs the named phases only (after 1 and 2) and prints neither.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
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
from siu3r_tpu_torch.render.tiles import SLOTS_X, SLOTS_Y

IMAGE = (256, 256)
SLOTS = (SLOTS_Y, SLOTS_X)  # the rasterizer's slot grid; 256x256 has 16 x 2 tiles

# H100 SXM peaks (NVIDIA data sheet) at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# dense TF32 on the tensor cores; the attention kernel's 3xTF32 takes three
# products for each fp32 product
PEAK_TF32_FLOPS = 495e12
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
# int32 ALU: 64 lanes per SM, half the fp32 lanes, and one operation a lane
# and cycle where the fp32 peak counts an FMA as two (Hopper architecture
# white paper): 132 SMs x 64 x 1.98 GHz
PEAK_INT32_OPS = PEAK_FP32_FLOPS / 4
ATTN_ATOL = 2e-5
MSDA_ATOL = 1e-5
# raster: the kernel's whole-tile exit leaves out contributions below
# transmittance 1e-4, and it sums in another order; scaled by the largest
# colour (at least 1) and, for depth, the largest depth of the inputs
RASTER_ATOL = 2e-4
# raster backward (the JAX package's own, tests/test_rasterizer_kernel.py):
# rtol 1e-4 and atol 1e-5 against the plain VJP of what the kernel
# composites, the atol scaled for each parameter slot by its largest
# gradient (at least 1); against the plain VJP of a saturating tile's whole
# list (its tail behind T <= 1e-4 is left out by the kernel) atol 2e-4 x 2048
RASTER_BWD_RTOL, RASTER_BWD_ATOL = 1e-4, 1e-5
RASTER_BWD_SAT_ATOL = 2e-4 * 2048
RENDER_RTOL, RENDER_ATOL, RENDER_DEPTH_ATOL = 1e-3, 1e-3, 1e-2
SLICE_RTOL, SLICE_ATOL = 1e-3, 1e-4
# a render is compared only where its target views see the scene: mean alpha
# at least this
MIN_COVERAGE = 0.1
# and a timed train step's render composites at least this many chunks of 128
# gaussians per live tile before the tile's exit (of 32 at K = 4096), so that
# the render's backward, kernel 6, does real work
MIN_SWEPT = 4.0
LABEL_AGREEMENT = 0.999


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, iters: int, part: str | None = None) -> tuple[float, float, float | None]:
    """(device ms, elapsed ms, part ms) per call over ``iters`` back-to-back
    calls.

    Device ms is the card's busy time summed over every kernel, copy and
    memset the calls ran, from the profiler's CUDA trace; part ms is the
    share of the device entries whose name contains ``part`` (None without
    ``part``); elapsed ms comes from CUDA events around the loop and includes
    the gaps where the card waits for the host to launch (for a small
    kernel, the wrapper's cost)."""
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
        rows = prof.key_averages()
        device_us = sum(e.self_device_time_total for e in rows)
        if device_us > 0:
            part_ms = (None if part is None else
                       sum(e.self_device_time_total for e in rows if part in e.key) / 1e3 / iters)
            return device_us / 1e3 / iters, elapsed, part_ms
    raise RuntimeError("the profiler recorded no device time")


def larger(bytes_ms: float, ops_ms: float) -> tuple[float, str]:
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def bound(nbytes: float, flops: float, peak_ops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    return larger(nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak_ops * 1e3)


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
    elif mask_kind == "first_tile_masked":  # the kernel's first 64-key tile wholly masked, later keys live
        kv_mask = torch.rand(b, nk, device=dev, generator=gen) > 0.5
        kv_mask[:, :64] = False
        kv_mask[:, 64] = True
    return q, k, v, qrope, krope, kv_mask


def _attn_cost(case) -> tuple[float, float, float]:
    """Bytes (q, k, v, the tables and the mask in; out), the two products'
    flops and the rotation's."""
    b, h, nq, nk, d, rope, mask_kind = case
    nbytes = 4 * b * h * d * (2 * nq + 2 * nk)
    if rope:
        nbytes += 4 * 2 * b * d * (nq + nk)  # cos/sin tables
    if mask_kind:
        nbytes += b * nk
    return nbytes, 4 * b * h * nq * nk * d, 6 * b * h * (nq + nk) * d if rope else 0


def _attn_bound(case) -> dict:
    """The least time for the function, the products at the 3xTF32 tensor-core
    rate (what the kernel's arithmetic needs) and the rotation at the fp32
    rate; beside it the same with the products at the fp32 rate."""
    nbytes, products, rotation = _attn_cost(case)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = (products / PEAK_3XTF32_FLOPS + rotation / PEAK_FP32_FLOPS) * 1e3
    b_ms, b_by = larger(bytes_ms, ops_ms)
    return dict(bound_ms=b_ms, bound_by=b_by, bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_fp32_ms=bound(nbytes, products + rotation)[0])


def check_attention(name, case, iters, gen, cross=False):
    from siu3r_tpu_torch.kernels.flash_attention import flash_attn, flash_attn_plain, launch_config
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
    ms, elapsed, _ = time_ms(kern, iters)
    plain_ms = time_ms(plain, max(3, iters // 4))[0]
    lib_ms = None
    if kv_mask is None:
        qr = rope2d_from_cos_sin(q, *qrope) if qrope is not None else q
        kr = rope2d_from_cos_sin(k, *krope) if krope is not None else k
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qr, kr, v, scale=scale), iters)[0]
    bnd = _attn_bound(case)
    blocks, threads, smem = launch_config(*case[:3], case[4], case[5])
    log("kernel", f"{name} {case[:5]} rope={case[5]} mask={case[6]}: max_abs_err {err:.3g} "
                  f"ms {ms:.5f} (elapsed {elapsed:.5f}) plain_ms {plain_ms:.5f} library_ms {lib_ms} "
                  f"bound_ms {bnd['bound_ms']:.5f} ({bnd['bound_by']}, 3xTF32; fp32 SIMT "
                  f"{bnd['bound_fp32_ms']:.5f}); {blocks} blocks of {threads} threads, {smem} B shared")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, blocks=blocks, **bnd)


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
    ms, elapsed, _ = time_ms(kern, iters)
    plain_ms = time_ms(plain, max(3, iters // 4))[0]
    nbytes, flops = _msda_cost(case, loc)
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    b_ms, b_by = larger(bytes_ms, ops_ms)
    log("kernel", f"msda {name} B={case[0]} Lq={case[1]} H={case[2]} D={case[3]} P={case[4]} "
                  f"levels={shapes}: max_abs_err {err:.3g} ms {ms:.5f} (elapsed {elapsed:.5f}) "
                  f"plain_ms {plain_ms:.5f} bound_ms {b_ms:.5f} ({b_by})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                bytes_ms=bytes_ms, ops_ms=ops_ms)


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
    # the kernel's tiling: key tails of 8, 9, 63 and 65 (8-key column tiles,
    # 64-key shared-memory tiles), a 17-row query set (one full 16-row warp
    # tile and one row), a first key tile wholly masked with later keys live
    "nk8_rope": (1, 4, 33, 8, 64, True, None),
    "nk9": (2, 2, 40, 9, 32, False, None),
    "nk63": (1, 3, 20, 63, 64, False, None),
    "nk65_rope": (1, 3, 70, 65, 32, True, None),
    "nq17_d32_rope": (2, 4, 17, 100, 32, True, None),
    "first_tile_masked": (2, 4, 65, 200, 32, False, "first_tile_masked"),
    "first_tile_masked_rope": (2, 3, 40, 130, 64, True, "first_tile_masked"),
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


ATTN_KERNEL = "flash_attn_fwd_kernel"


def log_ptxas(phase: str, kernel: str) -> None:
    """ptxas' registers, stack and spills of each instantiation of
    ``kernel`` (a substring of its mangled name), from ``build.log``."""
    from siu3r_tpu_torch.kernels import _build

    lines = (_build.BUILD_DIR / "build.log").read_text().splitlines()
    found = 0
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            props = [x.strip().removeprefix("ptxas info    : ") for x in lines[i + 1:i + 4]
                     if "registers" in x or "stack frame" in x]
            log(phase, f"ptxas {line.split(chr(39))[1][:70]}: {'; '.join(props)}")
            found += 1
    if not found:
        raise AssertionError(f"build.log holds no ptxas report of {kernel}")


def check_attention_build() -> None:
    """The attention kernel's instantiations in the built library: ptxas'
    registers, stack and spills from ``build.log``, and in their SASS the
    tensor-core TF32 products (HMMA ... TF32, or HGMMA) and the asynchronous
    copies (LDGSTS, or UTMALDG); fails where either is missing."""
    from siu3r_tpu_torch.kernels import _build

    log_ptxas("kernels", ATTN_KERNEL)
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    functions = [f for f in sass.split("Function : ")[1:] if f.startswith("_Z") and ATTN_KERNEL in f.split()[0]]
    if not functions:
        raise AssertionError(f"cuobjdump -sass shows no {ATTN_KERNEL} in the library")
    for f in functions:
        body = f.splitlines()
        mma = sum(("HMMA" in x and "TF32" in x) or "HGMMA" in x for x in body)
        copies = sum("LDGSTS" in x or "UTMALDG" in x for x in body)
        log("kernels", f"SASS {body[0][:70]}: {mma} tensor-core TF32 instructions, {copies} async copies")
        if not mma or not copies:
            raise AssertionError(f"{body[0]}: no tensor-core TF32 product ({mma}) or async copy ({copies}) in the SASS")


def phase_kernels() -> dict:
    check_attention_build()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    zero = dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
    per_kernel = {"flash_attn_rope": dict(zero, bound_fp32_ms=0.0), "flash_attn": dict(zero, bound_fp32_ms=0.0),
                  "msda": dict(zero, library_ms=None)}

    def add(kernel, res, calls):
        acc = per_kernel[kernel]
        acc["err"] = max(acc["err"], res["err"])
        for key in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms", "bound_fp32_ms"):
            if key in acc:
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
        acc["bound_by"] = larger(acc["bytes_ms"], acc["ops_ms"])[1]
    log("kernels", "all kernels agree with their plain versions "
                   f"(attention atol {ATTN_ATOL}, msda atol {MSDA_ATOL}); per forward: "
                   + ", ".join(f"{k} ms {a['ms']:.5f} bound_ms {a['bound_ms']:.5f}"
                               + (f" (fp32 SIMT {a['bound_fp32_ms']:.5f})" if "bound_fp32_ms" in a else "")
                               + f" library_ms {a['library_ms']}" for k, a in per_kernel.items()))
    return per_kernel


# ---------------------------------------------------------------- phase 3: render kernels


def _same_table(got, want) -> bool:
    """Binning results equal: the counts, and the table up to each count."""
    (tg, cg), (tw, cw) = got, want
    if not torch.equal(cg, cw):
        return False
    live = torch.arange(tg.shape[-1], device=tg.device) < cw[..., None]
    return torch.equal(torch.where(live, tg, -1), torch.where(live, tw, -1))


def _bin_cost(proj, table, counts) -> tuple[float, float]:
    """Bytes: mean2d, depth and radius in (16 bytes a gaussian and view); the
    table and counts out. Operations: four int32 compares per (gaussian,
    tile) that the tile's list depends on, counted at the int32 rate: every
    gaussian for a tile with fewer than K members, and those up to its K-th
    member in depth order for a tile at K."""
    n, g = proj.depth.shape
    t, k = table.shape[-2:]
    order = torch.sort(proj.depth, dim=-1, stable=True).indices
    rank = torch.empty_like(order).scatter_(1, order, torch.arange(g, device=order.device).expand(n, -1))
    kth = rank.gather(1, table[..., k - 1].reshape(n, t).long()) + 1
    needed = torch.where(counts.reshape(n, t) >= k, kth, torch.full_like(kth, g))
    return 16.0 * n * g + 4.0 * n * t * (k + 1), 4.0 * float(needed.sum().item())


def check_bin(name, proj, k, iters) -> dict:
    from siu3r_tpu_torch.kernels.binning import _flat, bin_gaussians, bin_gaussians_plain

    proj = _flat(proj)  # views flattened: [N, G]
    kern = lambda: bin_gaussians(proj, IMAGE, k, *SLOTS)
    plain = lambda: bin_gaussians_plain(proj, IMAGE, k, *SLOTS)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    if not _same_table(got, want):
        raise AssertionError(f"bin {name}: table or counts differ from the plain version")
    counts = got[1].float()
    res = dict(err=0.0, mean_count=counts.mean().item(), at_k=(got[1] == k).float().mean().item())
    if iters:
        nbytes, ops = _bin_cost(proj, *got)
        # the wrapper's device time (the depth sort and range gather in
        # torch, then the compaction kernel) and the compaction kernel's own
        res["ms"], res["elapsed"], res["kernel_ms"] = time_ms(kern, iters, part="bin_kernel")
        if not res["kernel_ms"] > 0:
            raise RuntimeError("the profiler's trace holds no bin_kernel entry")
        res["plain_ms"] = time_ms(plain, max(3, iters // 4))[0]
        res["bound_ms"], res["bound_by"] = bound(nbytes, ops, PEAK_INT32_OPS)
    log("kernel", f"bin {name} views={proj.depth.shape[0]} G={proj.depth.shape[1]} K={k}: exact, "
                  f"mean count {res['mean_count']:.1f}, share at K {res['at_k']:.3f}"
                  + (f", ms {res['ms']:.5f} (bin_kernel {res['kernel_ms']:.5f}, elapsed {res['elapsed']:.5f}) "
                     f"plain_ms {res['plain_ms']:.5f} bound_ms {res['bound_ms']:.5f} ({res['bound_by']})"
                     if iters else ""))
    return res


# the raster kernels' warps: 16x4 pixel rectangles, 8 a row of a 16x128 tile
WARP_W, WARP_H = 16, 4


def _warp_skips(prm, x0, y0) -> torch.Tensor:
    """The kernels' per-warp skip test (skip_test in csrc/raster_common.cuh,
    in fp32): prm [NT, J, 8], x0 and y0 [NT, 1, R] the warp rectangles'
    first columns and rows -> [NT, J, R], True where the warp skips the
    gaussian."""
    a, b, c = prm[..., 2:3], prm[..., 3:4], prm[..., 4:5]
    lam = 0.5 * (a + c) - torch.sqrt(0.25 * (a - c) * (a - c) + b * b) - 4e-6 * (a.abs() + c.abs() + 2 * b.abs())
    h = torch.where(lam > 0, 0.5 * lam * (1 - 1e-5), torch.full_like(lam, -math.inf))
    t = torch.log(255.0 * prm[..., 5:6]) + 1e-4
    mx, my = prm[..., 0:1], prm[..., 1:2]
    ex = torch.clamp(torch.maximum(x0 - mx, mx - (x0 + WARP_W - 1)), min=0.0)
    ey = torch.clamp(torch.maximum(y0 - my, my - (y0 + WARP_H - 1)), min=0.0)
    return h * (ex * ex + ey * ey) > t


def _pair_work(table, counts, params, swept) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(done [NT], kept [NT, 2048], evaluated [NT]): the gaussians each tile
    composites before its exit; per pixel of each tile the (gaussian, pixel)
    pairs among them whose alpha passes 1/255; per tile the pairs that the
    kernels' warps evaluate, those their skip test does not leave out."""
    from siu3r_tpu_torch.render.tiles import _ALPHA_MAX, _ALPHA_MIN, _CHUNK, TILE_H, TILE_W, tile_grid

    n, t, k = table.shape
    _, n_tx = tile_grid(IMAGE)
    done = torch.minimum(counts, swept * _CHUNK).reshape(-1, 1, 1)  # [NT, 1, 1]
    gp = params.gather(1, table.reshape(n, -1, 1).long().expand(-1, -1, 8)).reshape(n * t, k, 8)
    tiles = torch.arange(t, device=table.device).repeat(n)
    p = torch.arange(TILE_H * TILE_W, device=table.device)
    px = ((tiles % n_tx) * TILE_W)[:, None, None] + (p % TILE_W)
    py = ((tiles // n_tx) * TILE_H)[:, None, None] + (p // TILE_W)
    rects = torch.arange((TILE_W // WARP_W) * (TILE_H // WARP_H), device=table.device)
    wx0 = (((tiles % n_tx) * TILE_W)[:, None] + rects % (TILE_W // WARP_W) * WARP_W).float()[:, None, :]
    wy0 = (((tiles // n_tx) * TILE_H)[:, None] + rects // (TILE_W // WARP_W) * WARP_H).float()[:, None, :]
    kept = torch.zeros((n * t, TILE_H * TILE_W), dtype=torch.int64, device=table.device)
    evaluated = torch.zeros((n * t,), dtype=torch.int64, device=table.device)
    for base in range(0, k, _CHUNK):
        prm = gp[:, base:base + _CHUNK]
        dx, dy = px - prm[..., 0:1], py - prm[..., 1:2]
        power = -0.5 * (prm[..., 2:3] * dx * dx + prm[..., 4:5] * dy * dy) - prm[..., 3:4] * dx * dy
        alpha = torch.clamp(prm[..., 5:6] * torch.exp(power), max=_ALPHA_MAX)
        idx = base + torch.arange(_CHUNK, device=table.device)[None, :, None]
        kept += ((alpha >= _ALPHA_MIN) & (idx < done)).sum(dim=1)
        evaluated += (~_warp_skips(prm, wx0, wy0) & (idx < done)).sum(dim=(1, 2)) * (WARP_W * WARP_H)
    return done.reshape(-1), kept, evaluated


def _raster_work(work) -> tuple[float, float]:
    """(pairs, kept) of ``_pair_work``'s result: the (gaussian, pixel) pairs
    the kernel composites before each tile's exit, and those whose alpha
    passes 1/255."""
    done, kept, _ = work
    return float(done.sum().item()) * kept.shape[1], float(kept.sum().item())


def _tile_spread(work, counts) -> dict:
    """How the kept pairs spread over the tiles and over the 16x16 sub-tiles
    (one block each in the raster kernels): the pairs composited, the
    shares kept and evaluated by the kernels' warps, the longest tile's
    share of all kept pairs, its chunks, the longest tile's and sub-tile's
    kept pairs over the mean of the live ones, and the mean chunks of a live
    tile."""
    done, kept, evaluated = work
    live = counts.reshape(-1) > 0
    pairs, n_kept = _raster_work(work)
    if not bool(live.any()) or n_kept == 0:
        return dict(pairs=pairs, kept_share=0.0, evaluated_share=0.0, longest_share=0.0, longest_chunks=0,
                    tile_max_over_mean=0.0, sub_max_over_mean=0.0, mean_chunks=0.0)
    per_tile = kept.sum(dim=1).double()
    per_sub = kept.reshape(-1, 16, 8, 16).sum(dim=(1, 3)).double()  # [NT, 8]
    chunks = (done + 127) // 128
    i = int(per_tile.argmax())
    return dict(pairs=pairs, kept_share=n_kept / pairs, evaluated_share=float(evaluated.sum().item()) / pairs,
                longest_share=(per_tile[i] / per_tile.sum()).item(), longest_chunks=int(chunks[i]),
                tile_max_over_mean=(per_tile[i] / per_tile[live].mean()).item(),
                sub_max_over_mean=(per_sub.max() / per_sub[live].mean()).item(),
                mean_chunks=chunks[live].double().mean().item())


def _spread_text(sp: dict) -> str:
    return (f"{sp['pairs']:.4g} pairs composited, {sp['kept_share']:.4f} of them kept, "
            f"{sp['evaluated_share']:.4f} evaluated by the kernels' warps (the rest skipped); "
            f"longest tile {sp['longest_share']:.4f} of the kept pairs over {sp['longest_chunks']} chunks "
            f"(live tiles {sp['mean_chunks']:.2f} chunks on average), longest tile / mean "
            f"{sp['tile_max_over_mean']:.2f}, longest 16x16 sub-tile / mean {sp['sub_max_over_mean']:.2f}")


def _listed_bytes(table, counts, colors, swept) -> float:
    """The bytes of the inputs that the tiles need up to each tile's exit:
    the counts, the table's entries, and once each the params (8 floats) of
    every (view, gaussian) and the colours of every (colour set, gaussian)
    those entries name."""
    n, t, k = table.shape
    g, c = colors.shape[-2:]
    done = torch.minimum(counts, swept * 128)
    listed = torch.arange(k, device=table.device) < done[..., None]  # [N, T, K]
    view = torch.arange(n, device=table.device)[:, None, None]
    ids = table.long()
    n_params = torch.unique((view * g + ids)[listed]).numel()
    n_colors = torch.unique((view // (n // colors.shape[0]) * g + ids)[listed]).numel()
    return 4.0 * (counts.numel() + float(listed.sum().item()) + 8 * n_params + c * n_colors)


def _raster_cost(table, counts, colors, swept, work) -> tuple[float, float]:
    """Bytes: the inputs up to each tile's exit (``_listed_bytes``) in;
    colour, depth, alpha and the swept counts out. Operations (fp32): 15 for
    the alpha of each pair composited before the exit (the exp counted as
    one), and 5 + 2C for each pair whose alpha is kept (``_pair_work``)."""
    n, t, k = table.shape
    c = colors.shape[-1]
    pairs, kept = _raster_work(work)
    nbytes = _listed_bytes(table, counts, colors, swept) + 4.0 * (n * IMAGE[0] * IMAGE[1] * (c + 2) + n * t)
    return nbytes, 15.0 * pairs + (5.0 + 2.0 * c) * kept


def check_raster(name, table, counts, params, colors, iters) -> dict:
    from siu3r_tpu_torch.kernels.raster import _flatten, raster, raster_plain

    _, table, counts, params, colors = _flatten(table, counts, params, colors)  # views flattened
    kern = lambda: raster(table, counts, params, colors, IMAGE)
    plain = lambda: raster_plain(table, counts, params, colors, IMAGE)
    (c, d, a, s), (rc, rd, ra, rs) = kern(), plain()
    torch.cuda.synchronize()
    err = max((c - rc).abs().max().item(), (a - ra).abs().max().item())
    depth_err = (d - rd).abs().max().item()
    c_scale = max(1.0, colors.abs().max().item())
    d_scale = max(1.0, params[..., 6].abs().max().item())
    finite = all(bool(torch.isfinite(x).all()) for x in (c, d, a))
    if not finite or err > RASTER_ATOL * c_scale or depth_err > RASTER_ATOL * d_scale:
        raise AssertionError(f"raster {name}: max_abs_err {err} (depth {depth_err}) beyond "
                             f"{RASTER_ATOL} x ({c_scale}, {d_scale})")
    live = counts > 0
    res = dict(err=err, depth_err=depth_err, swept_differ=int((s != rs).sum().item()),
               mean_swept=s[live].float().mean().item() if bool(live.any()) else 0.0,
               full_sweeps=(s * 128 >= counts)[live].float().mean().item() if bool(live.any()) else 1.0)
    if iters:
        work = _pair_work(table, counts, params, s)
        nbytes, ops = _raster_cost(table, counts, colors, s, work)
        res["spread"] = _tile_spread(work, counts)
        res["ms"], res["elapsed"], _ = time_ms(kern, iters)
        res["plain_ms"] = time_ms(plain, max(3, iters // 4))[0]
        res["bound_ms"], res["bound_by"] = bound(nbytes, ops)
    log("kernel", f"raster {name} views={table.shape[0]} K={table.shape[-1]} C={colors.shape[-1]}: max_abs_err "
                  f"{err:.3g} (depth {depth_err:.3g}), chunks swept per live tile {res['mean_swept']:.2f}, "
                  f"share of live tiles swept to their count {res['full_sweeps']:.3f}, tiles whose sweep "
                  f"differs from the plain version's {res['swept_differ']}"
                  + (f", ms {res['ms']:.5f} (elapsed {res['elapsed']:.5f}) plain_ms {res['plain_ms']:.5f} "
                     f"bound_ms {res['bound_ms']:.5f} ({res['bound_by']}); {_spread_text(res['spread'])}"
                     if iters else ""))
    return res


def _synthetic_scene(gen, g: int, n_views: int, opaque: bool = False):
    """A scene at the eval shapes: g gaussians 2 to 6 units in front of
    n_views cameras near the identity (focal 1.2 x width). ``opaque``: large,
    opaque splats, so tiles saturate after a few chunks."""
    from siu3r_tpu_torch.gaussians import build_covariance
    from siu3r_tpu_torch.render.projection import project_gaussians
    from siu3r_tpu_torch.render.rasterizer import pack_params

    dev = "cuda"
    means = torch.cat([torch.rand(g, 2, device=dev, generator=gen) * 2.4 - 1.2,
                       torch.rand(g, 1, device=dev, generator=gen) * 4 + 2], dim=-1)
    lo, span = (0.05, 0.1) if opaque else (0.005, 0.025)
    scales = torch.rand(g, 3, device=dev, generator=gen) * span + lo
    quats = torch.randn(g, 4, device=dev, generator=gen)
    covs = build_covariance(scales, quats / quats.norm(dim=-1, keepdim=True))
    opac = (torch.full((g,), 0.95, device=dev) if opaque
            else torch.rand(g, device=dev, generator=gen) * 0.9 + 0.05)
    vm = torch.eye(4, device=dev).repeat(n_views, 1, 1)
    vm[:, :3, 3] = (torch.rand(n_views, 3, device=dev, generator=gen) - 0.5) * 0.4
    h, w = IMAGE
    f = 1.2 * w
    intr = torch.tensor([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]], device=dev).expand(n_views, 3, 3)
    proj = project_gaussians(means, covs, vm, intr, IMAGE, 0.2, 1000.0)
    return proj, pack_params(proj, opac)


def check_raster_launch() -> None:
    """The raster kernels' registers (ptxas) and launches at the eval and
    training shapes: fails unless more than one block covers a 16x128 tile
    in both, and the forward's blocks form clusters of more than one."""
    from siu3r_tpu_torch.kernels.raster import launch_config

    log_ptxas("render_kernels", "raster_kernel")
    log_ptxas("render_kernels", "raster_bwd_kernel")
    for backward, views, c in ((False, 6, 3), (False, 6, 16), (False, 4, 3), (True, 4, 3), (True, 4, 16)):
        lc = launch_config(backward, views, IMAGE, c)
        log("render_kernels", f"{'raster_bwd' if backward else 'raster'} launch, {views} views C={c}: {lc}")
        if lc["blocks_per_tile"] < 2 or (not backward and lc["cluster"] < 2):
            raise AssertionError(f"{'raster_bwd' if backward else 'raster'}: a tile is one block or the "
                                 f"forward's cluster is one block: {lc}")
        if not backward and lc["max_active_clusters"] < 1:
            raise AssertionError(f"raster: no cluster of {lc['cluster']} blocks can be resident: {lc}")


def phase_render_kernels() -> dict:
    """The raster kernels' launch configuration, then binning exact and
    raster within RASTER_ATOL against their plain versions: the eval shapes,
    then the edge cases."""
    from siu3r_tpu_torch.kernels.binning import bin_gaussians
    from siu3r_tpu_torch.render.projection import ProjectedGaussians
    from siu3r_tpu_torch.render.rasterizer import pack_params

    check_raster_launch()

    gen = torch.Generator(device="cuda").manual_seed(4321)
    g, views, k = 2 * 256 * 256, 6, 4096
    proj, params = _synthetic_scene(gen, g, views)
    worst = dict(bin=0.0, raster=0.0)
    check_bin("eval_shapes", proj, k, 20)
    table, counts = bin_gaussians(proj, IMAGE, k, *SLOTS)
    rgb = torch.rand(views, g, 3, device="cuda", generator=gen)  # per view, as SH colours are
    qc = torch.rand(1, g, 16, device="cuda", generator=gen)  # shared by the views, as the qc channels are
    for name, colors in (("eval_rgb_C3", rgb), ("eval_qc_C16", qc)):
        worst["raster"] = max(worst["raster"], check_raster(name, table, counts, params, colors, 20)["err"])
    for c in (1, 64):
        cols = torch.rand(1, g, c, device="cuda", generator=gen)
        worst["raster"] = max(worst["raster"], check_raster(f"C{c}", table, counts, params, cols, 0)["err"])

    dead = proj._replace(radius=torch.zeros_like(proj.radius))
    check_bin("all_dead", dead, k, 0)
    check_bin("truncated_K128", proj, 128, 0)
    tied = proj._replace(depth=torch.round(proj.depth * 2) / 2)
    check_bin("tied_depths", tied, k, 0)
    tt, tc = bin_gaussians(tied, IMAGE, k, *SLOTS)
    worst["raster"] = max(worst["raster"], check_raster("tied_depths", tt, tc, params, rgb, 0)["err"])
    one = ProjectedGaussians(*(x[:, :1].contiguous() for x in proj))
    one = one._replace(mean2d=torch.full_like(one.mean2d, 100.0), radius=torch.full_like(one.radius, 9.0))
    check_bin("one_gaussian", one, k, 0)
    ot, oc = bin_gaussians(one, IMAGE, k, *SLOTS)
    oparams = pack_params(one, torch.full((1,), 0.9, device="cuda"))
    worst["raster"] = max(worst["raster"], check_raster(
        "one_gaussian", ot, oc, oparams, rgb[:, :1].contiguous(), 0)["err"])
    dt, dc = bin_gaussians(dead, IMAGE, k, *SLOTS)
    res = check_raster("all_dead", dt, dc, params, rgb, 0)
    worst["raster"] = max(worst["raster"], res["err"])
    sproj, sparams = _synthetic_scene(gen, g, views, opaque=True)
    st, sc = bin_gaussians(sproj, IMAGE, k, *SLOTS)
    res = check_raster("saturated", st, sc, sparams, rgb, 0)
    worst["raster"] = max(worst["raster"], res["err"])
    if res["full_sweeps"] >= 1.0:
        raise AssertionError("raster saturated: no tile stopped before the end of its list")
    log("kernels", f"binning equal to its plain version, raster within {RASTER_ATOL} of its plain version "
                   "on the eval shapes and every edge case")
    return worst


# ---------------------------------------------------------------- phase 3: raster backward, autograd


def _raster_bwd_cost(table, counts, params, colors, swept, work) -> tuple[float, float]:
    """The least work of the function, not of the kernel's design. Bytes: the
    inputs up to each tile's exit (``_listed_bytes``) and the three image
    cotangents in; the parameter and colour gradients out, whole. Operations
    (fp32): 15 for the alpha of each pair composited before the exit, once,
    and 36 + 4C for each pair whose alpha is kept (w, r, the transmittance,
    the suffix, dalpha with its division counted as one, the seven parameter
    terms and C colour terms). The kernel sweeps every pair twice."""
    n = table.shape[0]
    c = colors.shape[-1]
    pairs, kept = _raster_work(work)
    n_pix = n * IMAGE[0] * IMAGE[1]
    nbytes = (_listed_bytes(table, counts, colors, swept)
              + 4.0 * (n_pix * (c + 2) + params.numel() + colors.numel()))
    return nbytes, 15.0 * pairs + (36.0 + 4.0 * c) * kept


PARAM_SLOTS = ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "opacity", "depth")


def _bwd_excess(got, want, rtol, atol) -> tuple[float, float]:
    """(max abs err, worst excess over |err| <= rtol |want| + atol)."""
    diff = (got - want).abs()
    return diff.max().item(), (diff - rtol * want.abs() - atol).max().item()


def _bwd_errors(got, want) -> dict:
    """Kernel 6's gradients against the plain VJP's, per parameter slot and
    for the colours: {part: (max abs err, atol, worst excess)}, each within
    rtol RASTER_BWD_RTOL and an atol of RASTER_BWD_ATOL x max(the slot's own
    largest |gradient|, 1) for a parameter slot (the conic's gradients grow
    with dx^2 and would set one shared scale) and RASTER_BWD_ATOL for the
    colours, as the JAX package's test holds them."""
    (dp, dc), (wp, wc) = got, want
    parts = {name: (dp[..., i], wp[..., i]) for i, name in enumerate(PARAM_SLOTS)}
    parts["colors"] = (dc, wc)
    out = {}
    for name, (a, b) in parts.items():
        atol = RASTER_BWD_ATOL * (max(1.0, b.abs().max().item()) if name != "colors" else 1.0)
        err, excess = _bwd_excess(a, b, RASTER_BWD_RTOL, atol)
        if not bool(torch.isfinite(a).all()):
            excess = math.inf
        out[name] = (err, atol, excess)
    if dp[..., 7].abs().max().item() != 0.0:
        out["unused_slot"] = (dp[..., 7].abs().max().item(), 0.0, math.inf)
    return out


def check_raster_bwd(name, table, counts, params, colors, iters, gen) -> dict:
    """Kernel 6 against the plain VJP on the same inputs and random
    cotangents, per parameter slot and for the colours (``_bwd_errors``).
    The kernel, like the forward,
    stops a tile at the chunk boundary where every pixel has T <= 1e-4, which
    is the plain compositing of the tile's first swept x 128 gaussians: the
    plain VJP takes the counts cut there, so a saturating tile is held to the
    same tolerance as the others."""
    from siu3r_tpu_torch.kernels.raster import (_flatten, _raster_cuda, raster_backward,
                                                raster_backward_plain)

    _, table, counts, params, colors = _flatten(table, counts, params, colors)  # views flattened
    n, t, k = table.shape
    c = colors.shape[-1]
    swept = _raster_cuda(table, counts, params, colors, IMAGE)[3]
    cut = torch.minimum(counts, swept * 128)
    gcolor = torch.randn(n, *IMAGE, c, device="cuda", generator=gen)
    gdepth = torch.randn(n, *IMAGE, device="cuda", generator=gen) * 0.1
    galpha = torch.randn(n, *IMAGE, device="cuda", generator=gen)
    grads = (gcolor, gdepth, galpha)
    kern = lambda: raster_backward(table, counts, params, colors, IMAGE, *grads, swept=swept)
    plain = lambda: raster_backward_plain(table, cut, params, colors, IMAGE, *grads)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    res = dict(saturating_tiles=int((cut < counts).sum().item()))
    errs = _bwd_errors(got, want)
    bad = {part: e for part, e in errs.items() if not e[2] <= 0}
    if bad:
        raise AssertionError(f"raster_bwd {name}: (max_abs_err, atol, excess) {bad} beyond rtol "
                             f"{RASTER_BWD_RTOL}, or not finite")
    res["err"] = max(e[0] for e in errs.values())
    if iters:
        work = _pair_work(table, counts, params, swept)
        nbytes, ops = _raster_bwd_cost(table, counts, params, colors, swept, work)
        res["spread"] = _tile_spread(work, counts)
        res["ms"], res["elapsed"], _ = time_ms(kern, iters)
        res["plain_ms"] = time_ms(plain, max(2, iters // 10))[0]
        res["bound_ms"], res["bound_by"] = bound(nbytes, ops)
    log("kernel", f"raster_bwd {name} views={n} K={k} C={c}: max_abs_err, atol and worst excess per part "
                  + ", ".join(f"{part} {e[0]:.3g}/{e[1]:.3g}/{e[2]:.3g}" for part, e in errs.items())
                  + f"; saturating tiles {res['saturating_tiles']} of {n * t}"
                  + (f", ms {res['ms']:.5f} (elapsed {res['elapsed']:.5f}) plain_ms {res['plain_ms']:.5f} "
                     f"bound_ms {res['bound_ms']:.5f} ({res['bound_by']}); {_spread_text(res['spread'])}"
                     if iters else ""))
    return res


def check_raster_bwd_saturating_tile(gen) -> float:
    """The JAX package's saturated-tile test (tests/test_rasterizer_kernel.py)
    on the card: one tile listing 512 fat opaque splats, unit cotangents, the
    kernel against the plain VJP of the whole list (no cut) within atol
    RASTER_BWD_SAT_ATOL: what the kernel leaves out lies behind T <= 1e-4."""
    from siu3r_tpu_torch.kernels.raster import _raster_cuda, raster_backward, raster_backward_plain

    k, g = 512, 512
    n_tiles = (IMAGE[0] // 16) * (IMAGE[1] // 128)
    table = torch.arange(g, dtype=torch.int32, device="cuda").expand(1, n_tiles, k).contiguous()
    counts = torch.zeros(1, n_tiles, dtype=torch.int32, device="cuda")
    counts[0, 0] = k
    params = torch.zeros(1, g, 8, device="cuda")
    params[..., 0] = torch.rand(1, g, device="cuda", generator=gen) * 128
    params[..., 1] = torch.rand(1, g, device="cuda", generator=gen) * 16
    params[..., 2] = params[..., 4] = 0.002
    params[..., 5] = 0.9
    params[..., 6] = torch.rand(1, g, device="cuda", generator=gen) * 9 + 1
    colors = torch.rand(1, g, 3, device="cuda", generator=gen)
    grads = (torch.ones(1, *IMAGE, 3, device="cuda"), torch.ones(1, *IMAGE, device="cuda"),
             torch.ones(1, *IMAGE, device="cuda"))
    swept = _raster_cuda(table, counts, params, colors, IMAGE)[3]
    if int(swept[0, 0]) * 128 >= k:
        raise AssertionError("raster_bwd saturating tile: the tile did not stop before the end of its list")
    got = raster_backward(table, counts, params, colors, IMAGE, *grads, swept=swept)
    want = raster_backward_plain(table, counts, params, colors, IMAGE, *grads)
    worst = 0.0
    for key, a, b in zip(("dparams", "dcolors"), got, want):
        err, excess = _bwd_excess(a, b, 0.0, RASTER_BWD_SAT_ATOL)
        if not excess <= 0:
            raise AssertionError(f"raster_bwd saturating tile: {key} max_abs_err {err} > {RASTER_BWD_SAT_ATOL}")
        worst = max(worst, err)
    log("kernel", f"raster_bwd saturating tile (stopped after {int(swept[0, 0])} of {k // 128} chunks) against "
                  f"the uncut plain VJP: max_abs_err {worst:.3g} <= {RASTER_BWD_SAT_ATOL}")
    return worst


def phase_raster_bwd() -> float:
    """Kernel 6 against the plain VJP: the training shapes (4 target views x
    32 tiles, K = 4096, C = 3), then the edge cases. Returns the worst error."""
    from siu3r_tpu_torch.kernels.binning import bin_gaussians
    from siu3r_tpu_torch.render.projection import ProjectedGaussians
    from siu3r_tpu_torch.render.rasterizer import pack_params

    gen = torch.Generator(device="cuda").manual_seed(2718)
    g, views, k = 2 * 256 * 256, 4, 4096
    proj, params = _synthetic_scene(gen, g, views)
    table, counts = bin_gaussians(proj, IMAGE, k, *SLOTS)
    rgb = torch.rand(views, g, 3, device="cuda", generator=gen)
    worst = check_raster_bwd("train_shapes_C3", table, counts, params, rgb, 10, gen)["err"]
    for c in (1, 16):
        cols = torch.rand(1, g, c, device="cuda", generator=gen)
        worst = max(worst, check_raster_bwd(f"C{c}", table, counts, params, cols, 0, gen)["err"])
    tt, tc = bin_gaussians(proj, IMAGE, 128, *SLOTS)
    worst = max(worst, check_raster_bwd("truncated_K128", tt, tc, params, rgb, 0, gen)["err"])
    tied = proj._replace(depth=torch.round(proj.depth * 2) / 2)
    tt, tc = bin_gaussians(tied, IMAGE, k, *SLOTS)
    worst = max(worst, check_raster_bwd("tied_depths", tt, tc, params, rgb, 0, gen)["err"])
    one = ProjectedGaussians(*(x[:, :1].contiguous() for x in proj))
    one = one._replace(mean2d=torch.full_like(one.mean2d, 100.0), radius=torch.full_like(one.radius, 9.0))
    ot, oc = bin_gaussians(one, IMAGE, k, *SLOTS)  # counts 0 and 1
    oparams = pack_params(one, torch.full((1,), 0.9, device="cuda"))
    worst = max(worst, check_raster_bwd("one_gaussian", ot, oc, oparams, rgb[:, :1].contiguous(), 0, gen)["err"])
    dead = proj._replace(radius=torch.zeros_like(proj.radius))
    dt, dc = bin_gaussians(dead, IMAGE, k, *SLOTS)
    worst = max(worst, check_raster_bwd("all_dead", dt, dc, params, rgb, 0, gen)["err"])
    sproj, sparams = _synthetic_scene(gen, g, views, opaque=True)
    st, sc = bin_gaussians(sproj, IMAGE, k, *SLOTS)
    res = check_raster_bwd("saturated", st, sc, sparams, rgb, 0, gen)
    if res["saturating_tiles"] == 0:
        raise AssertionError("raster_bwd saturated: no tile stopped before the end of its list")
    worst = max(worst, res["err"])
    check_raster_bwd_saturating_tile(gen)
    log("kernels", f"raster_bwd within rtol {RASTER_BWD_RTOL} and atol {RASTER_BWD_ATOL} (x each parameter "
                   "slot's scale) of the plain VJP (counts cut where the kernel stops) at the training shapes "
                   "and every edge case; the "
                   f"saturating tile within {RASTER_BWD_SAT_ATOL} of the uncut plain VJP")
    return worst


def phase_autograd() -> None:
    """Every wrapped forward kernel on CUDA inputs that require grad: the
    output has a grad_fn, and the gradients equal those of the plain
    version's autograd on the same inputs."""
    from siu3r_tpu_torch.kernels.flash_attention import flash_attn, flash_attn_plain
    from siu3r_tpu_torch.kernels.msda import msda, msda_plain
    from siu3r_tpu_torch.kernels.raster import raster, raster_plain
    from siu3r_tpu_torch.kernels.binning import bin_gaussians

    gen = torch.Generator(device="cuda").manual_seed(99)

    def compare(name, kern, plain, inputs, tol):
        inputs = [x.detach().requires_grad_(True) for x in inputs]
        out = kern(*inputs)
        outs = out if isinstance(out, tuple) else (out,)
        if outs[0].grad_fn is None:
            raise AssertionError(f"autograd {name}: the kernel's output has no grad_fn")
        ref = plain(*inputs)
        refs = ref if isinstance(ref, tuple) else (ref,)
        cots = [torch.randn(o.shape, device="cuda", generator=gen) for o in outs if o.is_floating_point()]
        got = torch.autograd.grad([o for o in outs if o.is_floating_point()], inputs, cots)
        want = torch.autograd.grad([o for o in refs if o.is_floating_point()], inputs, cots)
        worst = 0.0
        for i, (a, b) in enumerate(zip(got, want)):
            scale = max(1.0, b.abs().max().item())
            err = (a - b).abs().max().item()
            if not math.isfinite(err) or err > tol * scale or b.abs().max().item() == 0.0:
                raise AssertionError(f"autograd {name}: input {i} gradient err {err} (scale {scale}) > {tol} "
                                     "x scale, or zero")
            worst = max(worst, err / scale)
        log("autograd", f"{name}: grad_fn {type(outs[0].grad_fn).__name__}, gradients of every input equal "
                        f"the plain version's autograd within {tol} x scale (worst {worst:.3g})")

    q, k, v, qrope, krope, _ = _attn_inputs(ATTN_MAIN["encoder"][0], gen, False)
    compare("flash_attn_rope", lambda q, k, v: flash_attn(q, k, v, 0.125, qrope, krope),
            lambda q, k, v: flash_attn_plain(q, k, v, 0.125, qrope, krope), (q, k, v), 1e-4)
    q, k, v, _, _, _ = _attn_inputs(ATTN_MAIN["m2f_query_self"][0], gen, False)
    compare("flash_attn", lambda q, k, v: flash_attn(q, k, v, 32 ** -0.5),
            lambda q, k, v: flash_attn_plain(q, k, v, 32 ** -0.5), (q, k, v), 1e-4)
    case = MSDA_MAIN["adapter"][0]
    value, loc, aw = _msda_inputs(case, gen)
    compare("msda", lambda a, b, c: msda(a, case[5], b, c), lambda a, b, c: msda_plain(a, case[5], b, c),
            (value, loc, aw), 1e-4)
    proj, params = _synthetic_scene(gen, 4096, 2)
    table, counts = bin_gaussians(proj, IMAGE, 512, *SLOTS)
    rgb = torch.rand(2, 4096, 3, device="cuda", generator=gen)
    # a sparse scene: no tile stops before the end of its list
    compare("raster", lambda p, c: raster(table, counts, p, c, IMAGE),
            lambda p, c: raster_plain(table, counts, p, c, IMAGE), (params, rgb), 1e-4)


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


def _target_views(means: torch.Tensor, n_views: int) -> tuple[torch.Tensor, torch.Tensor]:
    """n_views target cameras framing the first context view's Gaussians:
    camera-to-world poses [1, n_views, 4, 4] looking down +z from 0.15 units
    behind the nearest of them (clear of the renderer's 0.1 near plane), on a
    small circle about their median, and normalised intrinsics
    [1, n_views, 3, 3] whose field of view holds 98% of them. (Seeded random
    weights give each context view a compact blob about 0.01 units across,
    next to the first context camera's origin; a camera at the context
    views' field of view sees a few percent of its pixels covered.)
    Set-up: syncs with the host."""
    m = means.reshape(-1, 3).float()
    m = m[: m.shape[0] // 2]  # the first context view's pixels
    center = m.median(dim=0).values
    rel = m - center
    dist = max(float(-rel[:, 2].quantile(0.02)), 0.0) + 0.15
    tan_half = float((rel[:, :2].abs().amax(dim=-1) / (rel[:, 2] + dist).clamp(min=1e-3)).quantile(0.98))
    angles = torch.arange(n_views, device=m.device) * (2 * math.pi / n_views)
    offsets = torch.stack([torch.cos(angles), torch.sin(angles), torch.zeros_like(angles)], dim=-1)
    ext = torch.eye(4, device=m.device).repeat(1, n_views, 1, 1)
    ext[0, :, :3, 3] = center + 0.1 * dist * tan_half * offsets
    ext[0, :, 2, 3] -= dist
    k = torch.eye(3, device=m.device)
    k[0, 0] = k[1, 1] = 0.5 / tan_half
    k[:2, 2] = 0.5
    return ext, k.expand(1, n_views, 3, 3).contiguous()


def _eval_batch(images, intr, targets) -> dict:
    ext, target_intr = targets
    return {
        "context_views_images": images,
        "context_views_intrinsics": intr,
        "target_views_extrinsics": ext,
        "target_views_intrinsics": target_intr,
    }


def phase_slice_check() -> None:
    from siu3r_tpu_torch.config import PipelineCfg, RootCfg
    from siu3r_tpu_torch.models.model import SIU3RModel
    from siu3r_tpu_torch.pipeline import Pipeline
    from siu3r_tpu_torch.renderer import render_color_and_qc

    root = RootCfg(pipeline=PipelineCfg(model=_small_cfg()))
    gpu_pipe = Pipeline(root, device="cuda", seed=7)
    gpu = gpu_pipe.model
    cpu = SIU3RModel(root.pipeline.model, device="cpu", seed=0).eval()
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

    # the eval step: the same forward, then the render of 4 target views,
    # held against the CPU plain render of the step's own Gaussians. (Not
    # against the CPU forward's Gaussians: the 1/255 alpha cut is a step, and
    # across a covered view the forward's rounding moves some pairs over it,
    # each moving a pixel by up to T/255.)
    batch = _eval_batch(images, intr, _target_views(oc.gaussians.means, 4))
    out, rg, qg = gpu_pipe.eval_step({k: v.cuda() for k, v in batch.items()})
    g = out.gaussians
    s = out.post["qc_mask_probs"].shape[1]
    with torch.inference_mode():
        rc, qc = render_color_and_qc(
            g.replace(**{f: getattr(g, f).cpu() for f in ("means", "covariances", "harmonics", "opacities")}),
            out.post["qc_class_probs"].cpu(), out.post["qc_mask_probs"].reshape(1, s, -1).transpose(1, 2).cpu(),
            batch["target_views_extrinsics"], batch["target_views_intrinsics"], images.shape[2:4],
        )
    coverage = rc.alpha.mean().item()
    if coverage < MIN_COVERAGE:
        raise AssertionError(f"slice check: the target views see almost nothing (mean alpha {coverage})")
    excesses = {}
    for key, a, b, atol in (("color", rg.color, rc.color, RENDER_ATOL), ("alpha", rg.alpha, rc.alpha, RENDER_ATOL),
                            ("depth", rg.depth, rc.depth, RENDER_DEPTH_ATOL), ("qc", qg, qc, RENDER_ATOL)):
        a, b = a.cpu().double(), b.double()
        excesses[key] = ((a - b).abs() - RENDER_RTOL * b.abs()).max().item()
        if not torch.isfinite(a).all() or excesses[key] > atol:
            raise AssertionError(f"slice check: eval step {key} differs by {excesses[key]} beyond rtol "
                                 f"{RENDER_RTOL} atol {atol}")
    log("slice", f"small config eval step on cuda (kernels) vs the cpu render (plain) of its Gaussians, "
                 f"4 target views, mean alpha "
                 f"{coverage:.3f}: within rtol {RENDER_RTOL} atol {RENDER_ATOL} (depth {RENDER_DEPTH_ATOL}), "
                 f"worst excess {excesses}")


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

N_TARGET = 6  # 2 context + 4 extra target views, as the validation CLI sets


@contextlib.contextmanager
def _render_calls():
    """Record the rasterizer's binning and raster calls inside the block:
    {"bin": [args], "raster": [args], "raster_out": [detached outputs]}."""
    import siu3r_tpu_torch.render.rasterizer as R

    calls = {"bin": [], "raster": [], "raster_out": []}
    orig = R.bin_gaussians, R.raster

    def bin_rec(*args):
        calls["bin"].append(args)
        return orig[0](*args)

    def raster_rec(*args):
        calls["raster"].append(args)
        out = orig[1](*args)
        calls["raster_out"].append(tuple(x.detach() for x in out))
        return out

    R.bin_gaussians, R.raster = bin_rec, raster_rec
    try:
        yield calls
    finally:
        R.bin_gaussians, R.raster = orig


def phase_eval() -> dict:
    from siu3r_tpu_torch.config import RootCfg, bind_scannet_classes
    from siu3r_tpu_torch.kernels import _build
    from siu3r_tpu_torch.pipeline import Pipeline, lift_rendered_qc

    cfg = bind_scannet_classes(RootCfg())
    pipe = Pipeline(cfg, device="cuda", seed=0)
    mcfg = cfg.pipeline.model
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.rand(1, 2, 256, 256, 3, device="cuda", generator=gen)
    k = torch.tensor([[318 / 256, 0, 0.5], [0, 318 / 256, 0.5], [0, 0, 1]], device="cuda")
    intr = k.expand(1, 2, 3, 3).contiguous()
    with torch.inference_mode():
        means = pipe.model(images, intr).gaussians.means
    batch = _eval_batch(images, intr, _target_views(means, N_TARGET))
    run = lambda: pipe.eval_step(batch)

    run()  # warm-up
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")  # a host sync inside the step raises
    out, render, qc = run()
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    # one binning for the 6 views; one raster launch for the RGB set (C = 3)
    # and one for the 16 query-class channels
    expected = {**expected_launches(mcfg), "bin": 1, "raster": 2}
    if launches != expected:
        raise AssertionError(f"eval step launches {launches} != expected {expected}")
    n_slots, n_cls = mcfg.mask2former.max_lift_queries, mcfg.mask2former.num_labels + 1
    shapes = {"color": (render.color, (1, N_TARGET, 256, 256, 3)), "depth": (render.depth, (1, N_TARGET, 256, 256)),
              "alpha": (render.alpha, (1, N_TARGET, 256, 256)),
              "qc": (qc, (1, N_TARGET, n_slots, n_cls, 256, 256))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"eval step {name}: shape {tuple(t.shape)} (expected {shape}) or not finite")
    coverage = render.alpha.mean().item()
    if coverage < MIN_COVERAGE:
        raise AssertionError(f"eval step: the target views see almost nothing (mean alpha {coverage})")
    sem, ins = lift_rendered_qc(qc, out.gaussians.seg_query_scores, num_queries=mcfg.mask2former.num_queries)
    if tuple(sem.shape) != (1, N_TARGET, 256, 256) or int(sem.min()) < 0 or int(sem.max()) >= n_cls:
        raise AssertionError("lifted semantic ids out of shape or range")
    del out, render, qc, sem, ins

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
    res = dict(launches=launches, median_s=med, min_s=min(times), max_s=max(times), steps_per_s=1.0 / med,
               peak_gib=peak / 2**30, device_ms=device_ms, idle_share=1.0 - device_ms / (med * 1e3),
               top_device_ms=top, mean_alpha=coverage)
    log("eval", f"Pipeline.eval_step, ViT-L two-view 256x256 B=1 fp32 + {N_TARGET} target views: launches "
                f"{launches} (expected), no host sync, outputs finite, mean alpha {coverage:.3f}; median of "
                f"{len(times)} warm steps {med * 1e3:.2f} ms (min {min(times) * 1e3:.2f}, max "
                f"{max(times) * 1e3:.2f}) = {1.0 / med:.3f} steps/s, peak memory {peak / 2**30:.3f} GiB; "
                f"device busy {device_ms:.2f} ms per step, idle share {res['idle_share']:.3f}")
    for name, ms in top[:12]:
        log("eval", f"  device {ms:8.3f} ms  {name[:100]}")

    # the binning and raster kernels on the step's own inputs
    with _render_calls() as calls:
        run()
    if len(calls["bin"]) != 1 or len(calls["raster"]) != 2:
        raise AssertionError(f"recorded {len(calls['bin'])} binning and {len(calls['raster'])} raster calls")
    proj, _, kcap, _, _ = calls["bin"][0]
    res["bin"] = check_bin("eval_step", proj, kcap, 20)
    res["raster"] = [check_raster(f"eval_step_C{a[3].shape[-1]}", *a[:4], 20) for a in calls["raster"]]
    occ = res["bin"]
    log("eval", f"tile occupancy: mean count {occ['mean_count']:.1f} of K={kcap}, share of tiles at K "
                f"{occ['at_k']:.3f}, chunks swept per live tile {res['raster'][0]['mean_swept']:.2f} "
                f"of {kcap // 128}, share of live tiles swept to their count {res['raster'][0]['full_sweeps']:.3f}")
    del pipe, calls, proj
    torch.cuda.empty_cache()
    return res



# ---------------------------------------------------------------- phase 8: train step

N_OBJECTS, N_VALID = 48, 15  # bench.py --train's ground truth: 48 padded objects, 15 valid
TRAIN_TARGETS = 4
GRAD_REL_L2 = 1e-3


def _train_batch(images, intr, targets, n_objects, n_valid, n_classes, seed) -> dict:
    """The JAX bench.py --train convention: seeded images and binary masks,
    ``n_objects`` padded objects of which the first ``n_valid`` are valid,
    and view ids that put the context views between the target views (the
    first and the last of them). Target cameras frame the scene."""
    b, v, h, w, _ = images.shape
    ext, target_intr = targets
    n = ext.shape[1]
    gen = torch.Generator(device=images.device).manual_seed(seed)
    tgt_ids = torch.arange(n, device=images.device, dtype=torch.int32)[None] * 10
    ctx_pos = torch.linspace(0, n - 1, v, device=images.device).round().long()
    return {
        "context_views_images": images,
        "context_views_intrinsics": intr,
        "context_views_id": tgt_ids[:, ctx_pos].contiguous(),
        "target_views_id": tgt_ids,
        "target_views_images": torch.rand(b, n, h, w, 3, device=images.device, generator=gen),
        "target_views_extrinsics": ext,
        "target_views_intrinsics": target_intr,
        "gt_masks": (torch.rand(b, n_objects, v, h, w, device=images.device, generator=gen) > 0.7).float(),
        "gt_classes": torch.randint(0, n_classes, (b, n_objects), device=images.device, generator=gen, dtype=torch.int32),
        "gt_valid": (torch.arange(n_objects, device=images.device) < n_valid)[None].expand(b, -1).contiguous(),
    }


def _injected_coords(cfg, b, n_objects, v, device, seed) -> list:
    m2f = cfg.mask2former
    n_sampled = int(m2f.train_num_points * m2f.oversample_ratio)
    n_random = m2f.train_num_points - int(m2f.importance_sample_ratio * m2f.train_num_points)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return [{
        "match": torch.rand(b, 1024, 2, generator=gen).to(device),
        "pre": torch.rand(b, n_objects * v, n_sampled, 2, generator=gen).to(device),
        "extra": torch.rand(b, n_objects * v, n_random, 2, generator=gen).to(device),
    } for _ in range(m2f.decoder_layers)]


def _render_grads(gaussians, batch, hw) -> dict:
    """The gradient of mean((color - target)^2) + mean(depth x weights) in
    the Gaussians' means, covariances, opacities and harmonics."""
    from siu3r_tpu_torch.renderer import render_gaussians

    inputs = {f: getattr(gaussians, f).detach().clone().requires_grad_(True)
              for f in ("means", "covariances", "opacities", "harmonics")}
    r = render_gaussians(gaussians.replace(**inputs), batch["target_views_extrinsics"],
                         batch["target_views_intrinsics"], hw)
    weights = torch.linspace(-1.0, 1.0, hw[1], device=r.depth.device)
    loss = ((r.color - batch["target_views_images"]) ** 2).mean() + (r.depth * weights).mean()
    grads = torch.autograd.grad(loss, list(inputs.values()))
    return {k: g for k, g in zip(inputs, grads)}, float(r.alpha.detach().mean())


def phase_train_small() -> None:
    """(a) The small config's train step on the GPU (kernels) against the CPU
    (plain versions) with the same weights and sample points: every loss
    term, then the render loss's gradient on the step's own Gaussians."""
    from siu3r_tpu_torch.config import PipelineCfg, RootCfg
    from siu3r_tpu_torch.pipeline import Pipeline

    root = RootCfg(pipeline=PipelineCfg(model=_small_cfg()))
    gpu = Pipeline(root, device="cuda", seed=7).init_train(steps_per_epoch=10)
    cpu = Pipeline(root, device="cpu", seed=0).init_train(steps_per_epoch=10)
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(1, 2, 64, 64, 3).astype(np.float32))
    intr = torch.tensor([[1.24, 0, 0.5], [0, 1.24, 0.5], [0, 0, 1]]).expand(1, 2, 3, 3).contiguous()
    with torch.no_grad():
        means = cpu.model.train()(images, intr).gaussians.means
    batch = _train_batch(images, intr, _target_views(means, TRAIN_TARGETS), 6, 4,
                         root.pipeline.model.mask2former.num_labels, seed=1)
    inj = _injected_coords(root.pipeline.model, 1, 6, 2, "cpu", seed=2)
    _, lg = gpu.loss_fn({k: x.cuda() for k, x in batch.items()}, None,
                        injected_coords=[{k: x.cuda() for k, x in d.items()} for d in inj])
    _, lc = cpu.loss_fn(batch, None, injected_coords=inj)
    worst = 0.0
    for key, ref in lc.items():
        a, b = float(lg[key].detach()), float(ref.detach())
        excess = abs(a - b) - SLICE_RTOL * abs(b)
        worst = max(worst, excess)
        if not math.isfinite(a) or excess > SLICE_ATOL:
            raise AssertionError(f"train slice: loss {key} {a} on cuda vs {b} on cpu beyond rtol {SLICE_RTOL} "
                                 f"atol {SLICE_ATOL}")
    # the render loss's gradient on the GPU step's own Gaussians, copied to the CPU
    with torch.no_grad():
        g = gpu.model(*(batch[k].cuda() for k in ("context_views_images", "context_views_intrinsics"))).gaussians
    gg, coverage = _render_grads(g, {k: x.cuda() for k, x in batch.items()}, (64, 64))
    gc, _ = _render_grads(g.replace(**{f: getattr(g, f).cpu() for f in ("means", "covariances", "harmonics",
                                                                         "opacities")}), batch, (64, 64))
    if coverage < MIN_COVERAGE:
        raise AssertionError(f"train slice: the target views see almost nothing (mean alpha {coverage})")
    errs = {}
    for key, a in gg.items():
        b = gc[key].double()
        errs[key] = ((a.cpu().double() - b).norm() / b.norm().clamp(min=1e-30)).item()
        if not bool(torch.isfinite(a).all()) or errs[key] > GRAD_REL_L2 or b.abs().max().item() == 0.0:
            raise AssertionError(f"train slice: render gradient {key} relative L2 error {errs[key]} > "
                                 f"{GRAD_REL_L2} (cuda kernels vs cpu plain), or zero")
    log("train", f"small config loss terms on cuda (kernels) vs cpu (plain) within rtol {SLICE_RTOL} atol "
                 f"{SLICE_ATOL} (worst excess {worst:.3g}): total {float(lg['total'].detach()):.5f}; render-loss gradient "
                 f"on the step's Gaussians (mean alpha {coverage:.3f}) relative L2 errors "
                 + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))


def _count_syncs(run) -> tuple[int, dict]:
    """Run ``run`` with every synchronising CUDA call reported: (count,
    {source: count}), the source being the innermost line of the port's
    code on the call's Python stack."""
    import collections
    import threading
    import traceback
    import warnings

    sources = collections.Counter()
    inside = False  # warnings from switching the debug mode itself are not the run's

    def record(message, category, filename, lineno, file=None, line=None):
        if not inside or "synchronizing" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        frames = [f for f in stack if "siu3r_tpu_torch" in f.filename]
        where = (f"{Path(frames[-1].filename).name}:{frames[-1].lineno}" if frames else
                 "; ".join(f"{Path(f.filename).name}:{f.lineno} {f.name}" for f in stack[-3:]))
        sources[f"{threading.current_thread().name}: {where}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            inside = True
            run()
        finally:
            inside = False
            torch.cuda.set_sync_debug_mode("default")
    return sum(sources.values()), dict(sources)


def _occupancy(calls) -> tuple[float, float]:
    """(mean alpha, chunks swept per live tile) of the first recorded raster
    call."""
    counts = calls["raster"][0][1]
    _, _, alpha, swept = calls["raster_out"][0]
    live = counts > 0
    return alpha.mean().item(), swept[live].float().mean().item() if bool(live.any()) else 0.0


def phase_train() -> dict:
    """(b) ``Pipeline.train_step`` at full width: launches per step, finite
    losses, the frozen encoder untouched and the trained parts moved; then
    timed, each step's target cameras framing the Gaussians that step
    renders, with kernel 6 held against its plain version on a step's own
    inputs."""
    from siu3r_tpu_torch.config import RootCfg, bind_scannet_classes
    from siu3r_tpu_torch.kernels import _build
    from siu3r_tpu_torch.pipeline import Pipeline
    from siu3r_tpu_torch.train.optimizer import group_of

    phase_train_small()
    cfg = bind_scannet_classes(RootCfg())
    pipe = Pipeline(cfg, device="cuda", seed=0).init_train(steps_per_epoch=1000)
    mcfg = cfg.pipeline.model
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.rand(1, 2, 256, 256, 3, device="cuda", generator=gen)
    k = torch.tensor([[318 / 256, 0, 0.5], [0, 318 / 256, 0.5], [0, 0, 1]], device="cuda")
    intr = k.expand(1, 2, 3, 3).contiguous()

    def targets():
        # cameras framing the Gaussians of a train-mode forward of the current
        # weights, which the next step renders (each step moves them: the
        # heads start from a random init). Set-up: it syncs with the host and
        # updates the BatchNorms' running statistics.
        with torch.no_grad():
            return _target_views(pipe.model.train()(images, intr).gaussians.means, TRAIN_TARGETS)

    batch = _train_batch(images, intr, targets(), N_OBJECTS, N_VALID, mcfg.mask2former.num_labels, seed=3)

    def frame():
        batch.update(zip(("target_views_extrinsics", "target_views_intrinsics"), targets()))

    step_gen = torch.Generator(device="cuda").manual_seed(1)
    run = lambda: pipe.train_step(batch, step_gen)
    params = dict(pipe.model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}

    for _ in range(2):  # warm-up: cuDNN algorithm choice, allocator
        losses = run()
    torch.cuda.synchronize()
    frame()
    _build.reset_launch_counts()
    n_syncs, sync_sources = _count_syncs(run)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    lap_syncs = sum(n for where, n in sync_sources.items() if "lap.py:" in where)
    expected = {**expected_launches(mcfg), "bin": 1, "raster": 1, "raster_bwd": 1}
    if launches != expected:
        raise AssertionError(f"train step launches {launches} != expected {expected}")
    losses = run()
    values = {key: float(x) for key, x in losses.items()}
    if not all(math.isfinite(x) for x in values.values()):
        raise AssertionError(f"train step losses not finite: {values}")
    moved = {}
    for n, p in params.items():
        d = (p.detach() - before[n]).abs().max().item()
        group = "frozen" if group_of(n, True) == "frozen" else n.split(".")[0]
        moved[group] = max(moved.get(group, 0.0), d)
    if moved["frozen"] != 0.0:
        raise AssertionError(f"the frozen encoder moved by {moved['frozen']}")
    for part in ("mask2former", "adapter", "gaussian_param_head1", "gaussian_param_head2"):
        if not moved.get(part, 0.0) > 0.0:
            raise AssertionError(f"{part} did not move: {moved}")
    del before

    # timed steps, each framed before its clock starts; every one must see
    # the scene and composite real work (MIN_COVERAGE, MIN_SWEPT)
    times, occupancy = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(8):
        frame()
        with _render_calls() as calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        occupancy.append(_occupancy(calls))
        del calls
    peak = torch.cuda.max_memory_allocated()
    alphas, swepts = zip(*occupancy)
    if min(alphas) < MIN_COVERAGE or min(swepts) < MIN_SWEPT:
        raise AssertionError(f"timed train steps: mean alpha {alphas}, chunks swept per live tile {swepts}: "
                             f"below {MIN_COVERAGE} or {MIN_SWEPT}")
    frame()
    device_ms, top = _device_breakdown(run, 1)
    med = statistics.median(times)
    res = dict(launches=launches, median_s=med, min_s=min(times), max_s=max(times), steps_per_s=1.0 / med,
               peak_gib=peak / 2**30, device_ms=device_ms, idle_share=1.0 - device_ms / (med * 1e3),
               top_device_ms=top, host_syncs=n_syncs, sync_sources=sync_sources, lap_syncs=lap_syncs,
               losses=values, moved=moved, step=pipe.optimizer.count, mean_alpha=list(alphas),
               swept_per_live_tile=list(swepts))
    log("train", f"Pipeline.train_step, ViT-L two-view 256x256 B=1 fp32, {TRAIN_TARGETS} target views, "
                 f"{N_OBJECTS} objects ({N_VALID} valid): launches {launches} (expected), losses finite "
                 f"({', '.join(f'{k} {values[k]:.4f}' for k in ('seg', 'depth_smoothness', 'render_mse', 'lpips', 'total'))}), "
                 f"frozen encoder unchanged, moved {({k: round(v, 8) for k, v in moved.items()})}")
    log("train", f"median of {len(times)} warm steps {med * 1e3:.2f} ms (min {min(times) * 1e3:.2f}, max "
                 f"{max(times) * 1e3:.2f}) = {1.0 / med:.3f} steps/s, peak memory {peak / 2**30:.3f} GiB; device "
                 f"busy {device_ms:.2f} ms per step, idle share {res['idle_share']:.3f}; host syncs per step "
                 f"{n_syncs} (the LAP's convergence tests {lap_syncs}; sources {sync_sources}); per timed step "
                 f"mean alpha {[round(a, 3) for a in alphas]}, chunks swept per live tile "
                 f"{[round(x, 2) for x in swepts]}")
    for name, ms in top[:12]:
        log("train", f"  device {ms:8.3f} ms  {name[:100]}")

    # the render kernels on a framed step's own inputs
    frame()
    with _render_calls() as calls:
        run()
    if len(calls["bin"]) != 1 or len(calls["raster"]) != 1:
        raise AssertionError(f"recorded {len(calls['bin'])} binning and {len(calls['raster'])} raster calls")
    table, counts, rparams, colors, _ = (x.detach() if isinstance(x, torch.Tensor) else x
                                         for x in calls["raster"][0])
    coverage, swept = _occupancy(calls)
    if coverage < MIN_COVERAGE or swept < MIN_SWEPT:
        raise AssertionError(f"train step: mean alpha {coverage}, chunks swept per live tile {swept}")
    res["raster"] = check_raster("train_step_C3", table, counts, rparams, colors, 20)
    res["raster_bwd"] = check_raster_bwd("train_step_C3", table, counts, rparams, colors, 10,
                                         torch.Generator(device="cuda").manual_seed(5))
    log("train", f"render of the checked step: mean alpha {coverage:.3f}, chunks swept per live tile "
                 f"{swept:.2f}, saturating tiles {res['raster_bwd']['saturating_tiles']}; "
                 f"{_spread_text(res['raster_bwd']['spread'])}; the step's render kernels: raster "
                 f"{res['raster']['ms']:.5f} ms (bound {res['raster']['bound_ms']:.5f}), raster_bwd "
                 f"{res['raster_bwd']['ms']:.5f} ms (bound {res['raster_bwd']['bound_ms']:.5f})")
    del pipe, calls, batch
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- phase 7


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
        room = Path(tmp) / "room.ply"
        factor = _room_scale(out_dir / "output.ply", room)
        log("viewer", f"output.ply scaled by {factor:.3f} to room size: 70% of its Gaussians within 2 units")
        check_viewer(room, Path(tmp) / "orbit")


VIEWER_MODES = ("rgb", "depth", "semantic", "instance")


def _room_scale(ply_path: Path, out_path: Path) -> float:
    """Write a copy of ``ply_path`` scaled about the origin so that 70% of the
    Gaussians lie within 2 units of their median: the room-scale scenes the
    viewer's cameras are set for (its near plane is 0.2 units, and seeded
    random weights put the whole scene within about 0.1 of the origin, where
    every viewer camera would cull it). Returns the factor."""
    from siu3r_tpu_torch.io import read_ply
    from siu3r_tpu_torch.io.ply import _write_binary_ply

    cols = read_ply(ply_path)
    xyz = np.stack([cols[c] for c in "xyz"], -1)
    factor = np.float32(2.0 / np.percentile(np.linalg.norm(xyz - np.median(xyz, axis=0), axis=-1), 70))
    for c in "xyz":
        cols[c] = cols[c] * factor
    for i in range(3):
        cols[f"scale_{i}"] = cols[f"scale_{i}"] + np.log(factor)
    elements = np.empty(len(xyz), dtype=[(k, v.dtype) for k, v in cols.items()])
    for k, v in cols.items():
        elements[k] = v
    _write_binary_ply(out_path, elements)
    return float(factor)


def _png(data: bytes, what: str) -> np.ndarray:
    import io

    from PIL import Image

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{what} is not a PNG")
    img = np.asarray(Image.open(io.BytesIO(data)))
    if img.shape != (256, 256, 3) or img.dtype != np.uint8:
        raise AssertionError(f"{what}: image {img.shape} {img.dtype}, expected (256, 256, 3) uint8")
    return img


def check_viewer(ply_path: Path, orbit_dir: Path) -> None:
    """The viewer CLI's orbit in its own process, then its HTTP server on
    loopback in this process, every mode, with the launches of those renders."""
    import threading
    import urllib.request

    from siu3r_tpu_torch.cli import viewer
    from siu3r_tpu_torch.kernels import _build

    frames = 8
    cli = subprocess.run(
        [sys.executable, "-m", "siu3r_tpu_torch.cli.viewer", "--ply", str(ply_path), "--orbit",
         "--frames", str(frames), "--output_path", str(orbit_dir)],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600,
    )
    for line in cli.stdout.splitlines():
        log("viewer", line)
    if cli.returncode != 0:
        raise RuntimeError(f"the viewer CLI exited {cli.returncode}:\n{cli.stderr[-4000:]}")
    names = sorted(p.name for p in orbit_dir.iterdir())
    if names != [f"rgb_{i:03d}.png" for i in range(frames)]:
        raise AssertionError(f"the orbit wrote {names}")
    got = np.stack([_png((orbit_dir / n).read_bytes(), n) for n in names]).astype(np.int32)
    # the same cameras rendered in this process; seeded random weights give
    # two compact blobs (one per context view), which an orbit around their
    # median sees from some angles only, so one frame at least must show them
    scene = viewer.load_gaussian_ply(ply_path)
    want = viewer.render_views(scene, *viewer.orbit_cameras(scene, frames), IMAGE, device="cuda")
    same = (np.abs(got - want.astype(np.int32)).max(-1) <= 1).mean()
    means = got.mean(axis=(1, 2, 3))
    if same < LABEL_AGREEMENT or means.max() <= 0.0:
        raise AssertionError(f"orbit frames: {same:.5f} of pixels within 1 level of this process's render, "
                             f"mean pixel values {means.tolist()}")
    log("viewer", f"--orbit wrote {frames} 256x256 RGB frames, {same:.5f} of pixels within 1 level of this "
                  f"process's render of the same cameras, mean pixel values {means.round(2).tolist()}")

    server = viewer.serve(scene, port=0, block=False, device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    _build.reset_launch_counts()
    try:
        base = f"http://127.0.0.1:{server.server_port}"
        if b"viewer" not in urllib.request.urlopen(f"{base}/", timeout=60).read():
            raise AssertionError("the viewer page is missing")
        served = {}
        for mode in VIEWER_MODES:
            t0 = time.perf_counter()
            data = urllib.request.urlopen(f"{base}/render?yaw=0.4&pitch=0.2&radius=3&mode={mode}",
                                          timeout=300).read()
            served[mode] = (float(_png(data, f"/render {mode}").mean()), time.perf_counter() - t0)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    launches = dict(_build.launch_counts)
    if min(served["rgb"][0], served["depth"][0]) <= 0.0:
        raise AssertionError(f"a served frame is blank: {served}")
    # one binning and one raster launch per frame (semantic and instance
    # composite all 16 x 21 = 336 query-class channels in one launch)
    expected = {"bin": len(VIEWER_MODES), "raster": len(VIEWER_MODES)}
    if launches != expected:
        raise AssertionError(f"viewer launches {launches} != expected {expected}")
    log("viewer", "HTTP /render on loopback, every mode a 256x256 PNG through the kernels (launches "
                  f"{launches}): " + ", ".join(f"{m} mean {v:.2f} in {t * 1e3:.1f} ms" for m, (v, t) in served.items()))


# ---------------------------------------------------------------- main


SOURCES = {
    "flash_attn_rope": ("siu3r_tpu_torch/csrc/flash_attention.cu", "siu3r_tpu/ops/flash_attention.py:67"),
    "flash_attn": ("siu3r_tpu_torch/csrc/flash_attention.cu", "siu3r_tpu/ops/flash_attention.py:33"),
    "msda": ("siu3r_tpu_torch/csrc/msda.cu", "siu3r_tpu/ops/msda_pallas.py:44"),
    "bin": ("siu3r_tpu_torch/csrc/binning.cu", "siu3r_tpu/render/rasterizer.py:189"),
    "raster": ("siu3r_tpu_torch/csrc/raster.cu", "siu3r_tpu/render/rasterizer.py:379"),
    "raster_bwd": ("siu3r_tpu_torch/csrc/raster_bwd.cu", "siu3r_tpu/render/rasterizer.py:527"),
}
PHASES = {"kernels": phase_kernels, "render_kernels": phase_render_kernels, "raster_bwd": phase_raster_bwd,
          "autograd": phase_autograd, "slice": phase_slice_check, "forward": phase_forward, "eval": phase_eval,
          "train": phase_train, "cli": phase_cli}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--report", type=str, default=None, help="also write every number as JSON here")
    parser.add_argument("--phases", type=str, default=",".join(PHASES),
                        help="comma-separated phases to run after the environment and the build "
                             f"(default: all of {','.join(PHASES)}); the JSON lines need all of them")
    args = parser.parse_args(argv)
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        parser.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")

    smi = phase_environment()
    phase_build()
    if set(phases) != set(PHASES):
        for name, phase in PHASES.items():
            if name in phases:
                phase()
        log("done", f"phases {phases} passed; no JSON lines (they need every phase)")
        return
    per_kernel = phase_kernels()
    render_err = phase_render_kernels()
    bwd_err = phase_raster_bwd()
    phase_autograd()
    phase_slice_check()
    fwd = phase_forward()
    ev = phase_eval()
    tr = phase_train()
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
    # the render kernels: per eval step, on the step's own inputs
    raster_sum = {key: sum(r[key] for r in ev["raster"]) for key in ("ms", "plain_ms", "bound_ms")}
    raster_by = max(ev["raster"], key=lambda r: r["bound_ms"])["bound_by"]
    for name, acc, by in (("bin", ev["bin"], ev["bin"]["bound_by"]), ("raster", raster_sum, raster_by)):
        source, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": ev["launches"][name],
            "max_abs_err": max([render_err[name]] + [r["err"] for r in ev["raster"]] * (name == "raster")),
            "ms": acc["ms"], "plain_ms": acc["plain_ms"], "bound_ms": acc["bound_ms"],
            "bound_by": by, "library_ms": None,
        })
    # the raster backward: per train step, on the step's own inputs
    bwd = tr["raster_bwd"]
    source, replaces = SOURCES["raster_bwd"]
    kernels.append({
        "name": "raster_bwd", "route": "cuda", "source": source, "replaces": replaces,
        "launches": tr["launches"]["raster_bwd"], "max_abs_err": max(bwd_err, bwd["err"]),
        "ms": bwd["ms"], "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"], "library_ms": None,
    })
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(
            {"card": smi, "kernels": kernels, "forward": fwd, "eval": ev, "train": tr}, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
