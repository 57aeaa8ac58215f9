"""Chip smoke run of siu3r_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--report PATH] [--phases a,b,...]

Phases, in order; any failure raises and the script exits non-zero:
  1. environment: versions, the card's name and power limit, TF32 off;
  2. build: nvcc builds the CUDA kernels from siu3r_tpu_torch/csrc;
  3. kernels: the attention kernel's registers (ptxas) and, in its SASS,
     tensor-core TF32 products and asynchronous copies (kernel 1b, its
     resident variant and its streamed one: bf16 products, ldmatrix and
     asynchronous copies); each kernel
     against its plain PyTorch version at the main path's shapes and at
     edge cases (kernel 1b failing unless the variant it expects ran: the
     resident one, K and V of a head in shared memory, but for longer key
     sets),
     with times (kernels and yardsticks by the profiler's device time, plain
     versions by CUDA events around a loop queued behind a sleep,
     ``event_ms``), bounds (attention at the 3xTF32 tensor-core rate, with
     the fp32 figure beside it), blocks per launch and, for attention, one
     PyTorch call computing the same function as a yardstick; MSDA per
     case, each case failing unless the kernel it expects ran (the staged
     one, the head's value slice in shared memory, at the main path's shapes;
     the global-gather one where the slice does not fit), and the MSDA and
     binning kernels' registers (ptxas); the raster
     kernels' registers (ptxas) and launch configuration (more than one
     block a 16x128 tile, the forward's blocks a cluster of more than one);
     the binning and raster kernels on a synthetic scene at the eval shapes
     (6 views x 32 tiles, K = 4096, C = 3 and 16) and at edge cases, the
     binning's device time split into the depth sort and its own kernels; the
     raster backward (kernel 6) against the plain VJP at the training shapes
     (4 views x 32 tiles, K = 4096, C = 3) and at edge cases; the autograd
     of the attention, MSDA and raster wrappers against the plain versions';
  4. slice check: a small config run on the GPU (kernels) against the same
     weights on the CPU (plain versions): the forward, then the eval step's
     render against the CPU render of the step's own Gaussians, with target
     cameras framing the scene; bf16_slice: the same in bf16
     (``model.dtype: bfloat16``) at 2 and 3 views, each float output within
     half the CPU's own bf16 - fp32 difference;
  5. forward: the full-width ViT-L two-view forward at 256x256 from a seeded
     random init, with the launch counts of one forward checked against the
     model's attention and deformable-attention call sites (every MSDA
     launch the staged kernel) and no host sync inside it, then timed;
     bf16_forward: the same weights computing in bf16 (kernel 1b, the bf16
     RoPE attention, in place of kernel 1, every launch its resident
     variant), against the fp32 forward with
     the JAX package's bounds (means 5%, labels 90%), timed beside it, the
     model kernels held against their plain versions on its own inputs;
  6. eval step: ``Pipeline.eval_step`` at full width (the forward, then RGB,
     depth and query-class rendering of 6 target views), with its launch
     counts checked, no host sync inside it, then timed; the binning and
     raster kernels held against their plain versions on the step's own
     inputs, with times, bounds and tile occupancy; bf16_eval: the same
     step in bf16 on the same weights, as bf16_forward;
  8. train step (run before the CLIs): the small config's loss terms and
     render-loss gradient on the GPU against the CPU, then
     ``Pipeline.train_step`` at full width (B = 1, 2 + 4 views, 48 objects),
     its launch counts, finite losses, the frozen encoder unchanged and the
     trained parts moved, then timed with its host syncs, each timed step's
     target cameras framing the Gaussians it renders (every step covered and
     sweeping at least 4 chunks per live tile); the raster kernels held
     against their plain versions on a step's own inputs, timed side by
     side, with how the kept pairs spread over the tiles and sub-tiles;
     bf16_train: the same in bf16 (``model.dtype: bfloat16``): the small
     config's slice (each loss term within half the CPU's own bf16-vs-fp32
     difference or rtol 1e-3, those past Mask2Former's masked attention
     within 2e-2), then phase 8's pipeline switched with
     ``set_compute_dtype`` (its optimizer goes on; kernel 1b in place of
     kernel 1), 4 steps timed after 2 warm-up steps beside phase 8's;
  7. CLI: two synthetic images through ``python -m siu3r_tpu_torch.cli.inference``
     (its own process, under its own settings) to ``output.ply``, read back and
     checked against the reference schema and this process's forward; then
     ``python -m siu3r_tpu_torch.cli.viewer --orbit`` on a room-scale copy of
     that file (its own process), its frames held against this process's
     render of the same cameras, and the viewer's HTTP server on loopback, in
     every mode, with no blank RGB or depth frame.
  9. multi_slice: the small config at 3 views on the GPU against the CPU,
     the forward and the eval step's render, as phase 4;
 10. multi_forward (then bf16_multi_forward, its bf16 twin on the same
     weights, as bf16_forward): the full-width 8-view forward of
     configs/scannet_multi.yaml (the shared-bank multi-view backbone) at
     256x256, its launch counts (the bank's masked cross-attention takes the
     plain path, so 48 RoPE attention launches), no host sync, finite
     outputs, 12 warm forwards timed; the attention and MSDA kernels held
     against their plain versions on the forward's own inputs; the bank
     attention's device time per forward, and of its forward and backward;
 11. multi_eval: ``Pipeline.eval_step`` with 8 context and 10 target views
     (G = 524,288), as phase 6;
 12. multi_train: ``Pipeline.train_step`` on one card at B = 1, 8 context
     and 10 target views, 48 objects, as phase 8 (6 timed steps), with its
     peak memory;
 13. multi_cli: 8 synthetic images through
     ``python -m siu3r_tpu_torch.cli.inference_multiview`` (its own process)
     to ``output.ply``, read back and checked against the reference schema
     and this process's forward;
 14. refer_slice: the small config with the language layers on the GPU
     against the CPU: ``seg_forward``'s logits and word logits,
     ``refer_eval_step``'s masks, the refer loss and its gradients of the
     text embedding and the language layers;
 15. refer_forward: ``seg_forward`` (no DPT or Gaussian heads) at the full
     width of configs/scanrefer.yaml, B = 1, 8 expressions of up to 32
     tokens: launch counts (6 more ``flash_attn`` for the language layers),
     no host sync, finite outputs, 12 warm forwards timed, then the model
     kernels held against their plain versions on its own inputs, the
     language layers' attention shape among them;
 16. refer_eval: ``Pipeline.refer_eval_step`` at B = 1, as phase 15;
 17. refer_train: ``Pipeline.train_step`` on a refer batch at B = 3 (the
     config's loader batch), 8 objects: launch counts, a finite word-match
     loss, the text embedding and language layers moved, the frozen encoder
     unchanged, 6 steps timed with their host syncs and peak memory;
 18. refer_cli: ``python -m siu3r_tpu_torch.cli.validate_refer`` (its own
     process) on a synthetic ScanRefer root at 256x256 with this process's
     weights, its JSON held against this process's refer eval step;
 19. val_slice: the small config's validation sweep (eval step,
     ``segments_info``, the lift, the Visualizer, the Evaluator) on the GPU
     against the same weights on the CPU: PSNR, SSIM, LPIPS and depth errors
     within stated tolerances, label maps at least 99.9% equal, mIoU, PQ and
     mAP equal to the CPU evaluator's on the GPU's label maps, and to the
     CPU sweep's where the label maps are equal;
 20. validate: ``python -m siu3r_tpu_torch.cli.validate --config
     configs/scannet.yaml --ckpt W --limit 4`` (its own process) at full
     width on a synthetic ScanNet root at 256x256 (a wall, a floor and four
     objects), W this process's weights: every key of results.json finite and
     held against this process's eval steps on the same items through the
     Visualizer and the Evaluator (each scene's render covered), which are
     also repeated to show whether they are bitwise repeatable; the files of
     the two sweeps compared by kind; one eval step's launches as phase 6's,
     no host sync; the CLI's per-batch step and host seconds, and this
     process's sweep timed by stage;
 21. evaluate: ``python -m siu3r_tpu_torch.cli.evaluate`` (its own process)
     on phase 20's directory gives its results.json value for value;
 22. train_cli: ``python -m siu3r_tpu_torch.cli.train --config
     configs/concat.yaml`` (its own process; the reference's published
     training recipe) at full width (the depth cut to 4 encoder and 2 + 2
     decoder blocks) and B = 3 on a synthetic concat root (the ScanNet scenes
     of phase 20, six ScanNet++ scenes in PNG, one Replica scene counting 50
     times, its overlap table an iou.pt) with gradient accumulation k = 2
     for 4 steps from a training state of biased weights W (the CLI's steps
     an epoch as this process's loader's, finite records, train_viz PNGs,
     one checkpoint inside epoch 0 whose heads moved from W by more than
     their decay; the items each member gave the run, at least one each; a
     resumed CLI run is phase 26's, in two ranks and in one process); in
     this process from W on the CLI's first four batches at B = 3, k = 2:
     no parameter moves after micro-step 1, every trained part (not the
     frozen encoder) by more than its decay after micro-step 2, then
     micro-steps timed, each covered and swept, with their host syncs and
     peak memory, the binning, raster and raster_bwd kernels held against
     their plain versions on a timed micro-step's inputs, and the training
     state's size, save and restore seconds;
 23. dp_validate (after evaluate): ``cli/validate`` under ``torchrun
     --nproc_per_node 2 --dist_backend gloo`` (two ranks share the card;
     NCCL refuses that) with phase 20's weights and root: the one-rank
     sweep's files, written once, its results within phase 20's limits,
     each rank's launches;
 24. dp_train (after train_cli): two ranks over gloo, configs/scannet.yaml
     at full width with the depth cut to 4 encoder and 2 + 2 decoder
     blocks (as in phases 25 to 27), a global batch of 2, two data-parallel steps with
     injected sample points, held against a one-process oracle on the card;
     each rank's launches, step ms, peak memory, all-reduce bytes and ms;
 25. zero1_train: two ranks, configs/scannet_multi.yaml at full width (8 +
     10 views), ZeRO-1 against the replicated update on the same gradients
     (1e-6); each rank's optimizer-state bytes and peak memory, both ways;
 26. dp_train_cli: ``cli/train`` under two ranks with ZeRO-1 and k = 2, a
     checkpoint mid-accumulation, its resume under two ranks against the
     uninterrupted run, and the same checkpoint resumed in one process;
 27. nccl: phase 24's steps on one rank over NCCL (and on two cards over
     NCCL where the machine has them, printed);
 28. off_path: the modules no model builds. The encoder-only backbone
     (``CroCoEncoderOnly``) at full ViT-L width, 2 views at 256x256, fp32
     and then bf16 on the same weights: launch counts (kernel 1, or kernel
     1b in its resident variant, 24 a forward at 256 keys; no other kernel),
     no host sync, finite outputs, 12 warm forwards timed, the kernel held
     against its plain version on the forward's own inputs, the bf16 output
     within the JAX package's 5% of the fp32 one; ``MultiResDPTGSHead``
     (83 channels) on blocks 6, 12, 18 and 24 and both linear heads on the
     output, at full width; the small config's encoder and the three heads
     on the GPU against the CPU (SLICE_RTOL / SLICE_ATOL); every function of
     ``camera.py`` on CUDA tensors against the CPU (rtol 1e-4, atol 1e-5),
     with no host sync, a parallel ray pair inf; kernel 4 against
     ``bin_gaussians_sort`` (tables up to each count, counts exact) at the
     eval shapes (6 views, G = 131,072, K = 4096) and at the 8-view eval's
     (10 views, G = 524,288), the sort path timed beside the kernel.
 29. fullwidth: configs/scannet.yaml's model at every width (ScanNet's
     labels, 16 lift slots, SH degree 4), cut to 4 / 4 + 4 blocks and 4 + 1
     Mask2Former layers, with weights drawn from numpy
     (tests/torch_fullwidth_common.py), held against the JAX package's
     numbers for the same weights and inputs (tests/torch_fullwidth_ref.npz):
     one ``Pipeline.eval_step`` over the fixture's 2 framed targets, its
     launches counted with no host sync (kernels 1-5), then the Gaussian
     fields, class logits and kept queries within rtol 1e-3 / atol 1e-4 x
     the field's largest magnitude, the label maps exact outside the
     reference's ties, and colour, depth and alpha within 2e-4 on 99.9% of
     the pixels, the masked attention given the reference's decision where
     its logit lies within 1e-4 of 0.
The data-parallel phases start this script once a rank (``--rank_worker``)
under ``python -m torch.distributed.run --standalone``, and fail unless
every rank exits 0 and writes its result. Every phase logs the SM clock
(``nvidia-smi`` clocks.sm, clocks.max.sm) at its start and end, and its
seconds. A kernel's time counts only from a profiler trace that holds
exactly its launches a call times the calls (``time_ms``); where two traces
in a row lose records (the profiler drops a fixed number of calls' records
after the full-width model has run), it is taken by CUDA events instead,
which nothing can shorten; a time below the kernel's bound fails the run.
It then prints the kernels' JSON line (each kernel with the two-view path's
launches and times and, under "multi_view" and "refer", the 8-view path's
and the refer forward's; under "validate" the launches of one sweep batch,
under "train_cli" those of one micro-step and the render kernels' times on
its inputs; under "bf16_train" those of one bf16 train step and kernel 6's
time on its inputs; under "dp_train", "zero1_train" and "dp_validate" each rank's
launches, of one step and of the whole sweep; under "nccl" one step's;
under "off_path" those of one encoder-only forward in fp32 and in bf16,
kernels 1 and 1b timed on its inputs, and kernel 4's times with the sort
path's beside them; under "fullwidth" those of its eval step)
and, last, the device line.
``--phases`` runs the named phases only (after 1 and 2) and prints neither.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# This script starts some twenty Python processes (the CLIs, torchrun and its
# ranks), each of which imports torch. Where the machine's Python is told not
# to write bytecode (PYTHONDONTWRITEBYTECODE), every one of them compiles
# torch's sources again; so this process and every one it starts keep their
# bytecode in the checkout, under build/pycache (before numpy and torch are
# imported).
PYCACHE = Path(__file__).resolve().parent / "build" / "pycache"
sys.pycache_prefix = str(PYCACHE)
sys.dont_write_bytecode = False
os.environ["PYTHONPYCACHEPREFIX"] = str(PYCACHE)
os.environ.pop("PYTHONDONTWRITEBYTECODE", None)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import siu3r_tpu_torch  # noqa: F401,E402  (outside a checkout of the repo, fail before printing anything)
from siu3r_tpu_torch.render.tiles import SLOTS_X, SLOTS_Y  # noqa: E402

IMAGE = (256, 256)
SLOTS = (SLOTS_Y, SLOTS_X)  # the rasterizer's slot grid; 256x256 has 16 x 2 tiles

# H100 SXM peaks (NVIDIA data sheet) at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# dense TF32 on the tensor cores; the attention kernel's 3xTF32 takes three
# products for each fp32 product
PEAK_TF32_FLOPS = 495e12
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
# dense bf16 on the tensor cores (kernel 1b's products)
PEAK_BF16_FLOPS = 989e12
# int32 ALU: 64 lanes per SM, half the fp32 lanes, and one operation a lane
# and cycle where the fp32 peak counts an FMA as two (Hopper architecture
# white paper): 132 SMs x 64 x 1.98 GHz
PEAK_INT32_OPS = PEAK_FP32_FLOPS / 4
# the SM clock at its maximum, 1.98 GHz: converts ``event_ms``'s sleep to cycles
SLEEP_CYCLES_PER_S = 1.98e9
ATTN_ATOL = 2e-5
# kernel 1b against its bf16 plain version: one bf16 ulp of the plain
# version's value elementwise, and at least 2^-8 (the ulp of [1/2, 1));
# 2^-8 x max(1, |o|) falls short of an ulp above 1, where the ulp is 2^-7 x
# 2^floor(log2 |o|). tests/test_torch_bf16.py holds the plain version to the
# JAX kernel at the same tolerance
ATTN_BF16_ULP = 2.0**-8


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at ``x`` (bf16), at least ATTN_BF16_ULP, as fp32."""
    a = x.abs()
    up = (a.view(torch.int16) + 1).view(torch.bfloat16)
    return (up.float() - a.float()).clamp(min=ATTN_BF16_ULP)
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
# the small config in bf16 on the GPU against the CPU (tests/test_torch_bf16.py
# holds the port against JAX on the CPU with these bounds: means and labels):
# Gaussian means within a mean relative error of BF16_MEANS_REL, labels equal
# on BF16_LABELS. The GPU and the CPU sum every bf16 product in another
# order, and each rounding of such a sum to bf16 can turn, so two correct
# bf16 runs differ by bf16 noise of their own; each Gaussian field's L2
# difference is held to at most BF16_SLICE_FRACTION of the CPU's own bf16 -
# fp32 difference (0.46 to 0.65 at 2 and 3 views on an H100; Mask2Former's
# logits, fp32 layers on those features, 0.72 to 0.99, are logged and held
# through the labels)
BF16_MEANS_REL = 1e-3
BF16_SLICE_FRACTION = 1.0
BF16_GAUSSIAN_KEYS = ("means", "covariances", "harmonics", "opacities", "scales", "rotations")
BF16_LABELS = 0.99
# the small config's bf16 train step on the GPU against the CPU: each loss
# term within the larger of BF16_TRAIN_FRACTION of the CPU's own bf16-vs-fp32
# difference of that term and SLICE_RTOL; a term that reads Mask2Former past
# its first masked attention (whose masks threshold the previous layer's
# logits, so a last-bit difference flips some of them) within
# BF16_MASKED_RTOL: on the CPU alone, the same bf16 step with oneDNN's
# convolutions off (nothing else changed) moves such terms by up to 9.2e-3
# relative, 13.7 times their bf16-vs-fp32 difference, and the others by at
# most 1.22 times it and 5.9e-4 relative (tests/test_torch_bf16_train.py
# meets the same at the tiny config against JAX)
BF16_TRAIN_FRACTION = 0.5
BF16_MASKED_RTOL = 2e-2
# a full-width bf16 forward against the fp32 forward on the same weights: the
# JAX package's own bounds on its bf16 path (tests/test_model.py)
ORACLE_MEANS_REL, ORACLE_LABELS = 0.05, 0.9


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


TRACE_ATTEMPTS = 2
TIMED_BY_EVENTS: list = []  # kernel times that no whole trace gave
# each counted kernel wrapper's device entries (substrings of the profiler's
# names) and their records a launch: binning runs three kernels after its
# sort, each raster wrapper ranks the tiles before its main kernel
DEVICE_RECORDS = {
    "flash_attn": {"flash_attn_fwd_kernel": 1},
    "flash_attn_rope": {"flash_attn_fwd_kernel": 1},
    "flash_attn_rope_bf16": {"flash_attn_rope_bf16": 1},
    "msda": {"msda_kernel": 1},
    "bin": {"bin_prep_kernel": 1, "bin_count_kernel": 1, "bin_write_kernel": 1},
    "raster": {"order_tiles_kernel": 1, "raster_kernel": 1},
    "raster_bwd": {"order_tiles_kernel": 1, "raster_bwd_kernel": 1},
}


def time_ms(fn, iters: int, parts: dict | None = None, whole: bool = False,
            events: bool = True) -> tuple[float, float | None, dict | None]:
    """(device ms, elapsed ms, part ms) per call over ``iters`` back-to-back
    calls.

    Device ms is the card's busy time summed over every kernel, copy and
    memset the calls ran, from the profiler's CUDA trace; part ms maps each
    name of ``parts`` to the share of the device entries whose name contains
    one of its substrings (None without ``parts``); elapsed ms comes from
    CUDA events around the loop and includes the gaps where the card waits
    for the host to launch (for a small kernel, the wrapper's cost); without
    ``events`` (a yardstick, whose device time alone is read) it is not
    taken, and None. Plain versions are not timed here but by ``event_ms``.

    A trace can come back empty, or with records lost (CUPTI delivers them
    late, or drops them), and a trace that lost records reads low. With
    ``whole`` (a kernel's own time, and the yardsticks) a trace counts only
    if every device entry ran a multiple of ``iters`` times and each counted
    kernel's entries (``DEVICE_RECORDS``) hold exactly its launches a call
    (``_build.launch_counts`` over one call) times ``iters`` records; a
    trace that fails is logged and taken again, TRACE_ATTEMPTS times in all.
    Then the time is taken by ``event_ms`` and noted in TIMED_BY_EVENTS,
    and each part from the last trace where its entries are whole, else
    None."""
    from torch.profiler import ProfilerActivity, profile

    from siu3r_tpu_torch.kernels import _build

    before = collections.Counter(_build.launch_counts)
    fn()
    torch.cuda.synchronize()
    launched = collections.Counter(_build.launch_counts) - before
    expected = collections.Counter()
    for name, n in launched.items():
        for entry, per_launch in DEVICE_RECORDS[name].items():
            expected[entry] += n * per_launch * iters
    elapsed = None
    if events:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        elapsed = start.elapsed_time(end) / iters
    for attempt in range(TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        device_us = sum(e.self_device_time_total for e in rows)
        records = {entry: sum(e.count for e in rows if entry in e.key) for entry in expected}
        short = [(e.key[:60], e.count) for e in rows if e.count % iters]
        if device_us > 0 and (not whole or (not short and records == dict(expected))):
            part_ms = None if parts is None else {
                name: sum(e.self_device_time_total for e in rows if any(x in e.key for x in subs)) / 1e3 / iters
                for name, subs in parts.items()}
            return device_us / 1e3 / iters, elapsed, part_ms
        log("time", f"trace {attempt + 1} of {iters} calls not whole, taken again: kernel records {records} "
                    f"against {dict(expected)}, entries not a multiple of {iters} {short}")
    ms = event_ms(fn, iters)
    TIMED_BY_EVENTS.append(ms)
    # a part from the last trace only where its entries are whole
    part_ms = None if parts is None else {
        name: (sum(e.self_device_time_total for e in mine) / 1e3 / iters
               if mine and all(e.count % iters == 0 for e in mine) else None)
        for name, subs in parts.items()
        for mine in [[e for e in rows if any(x in e.key for x in subs)]]}
    log("time", f"no whole trace of {iters} calls in {TRACE_ATTEMPTS}: timed by CUDA events instead, {ms:.5f} "
                f"ms a call (the card's clock over the calls queued behind a sleep: the gaps between kernels "
                f"count, nothing can shorten it); parts from the last trace where whole {part_ms}")
    return ms, elapsed, part_ms


def at_or_above_bound(what: str, ms: float, bound_ms: float) -> None:
    """A kernel's measured time below the least time the card could take for
    its work is a measurement fault: raise."""
    if not ms >= bound_ms:
        raise AssertionError(f"{what}: {ms:.6f} ms measured, below its bound of {bound_ms:.6f} ms")


def event_ms(fn, iters: int) -> float:
    """ms per call over ``iters`` back-to-back calls, after one warm call, by
    CUDA events around the loop: the card's clock from the first launch to
    the end of the last. The loop is queued behind a sleep on the card as
    long as twice the host's time to issue it (at most 0.2 s), so that the
    card does not wait for the host's launches where the host can run
    ahead; a host sync inside ``fn`` counts. No lost profiler record can
    shorten it, and it needs no retries: every plain version's ``plain_ms``
    is timed so, many launches a call as most of them are."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * issue_s * iters + 1e-3, 0.2) * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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
    import importlib.util

    import PIL

    log("env", f"Pillow {PIL.__version__}; cv2 {'importable' if importlib.util.find_spec('cv2') else 'not installed'} "
               "(the port needs none)")
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


def _attn_inputs(case, gen, cross: bool, dtype: torch.dtype = torch.float32):
    """q/k/v in ``dtype`` in the model's layouts: self-attention takes strided
    views of one packed projection; cross-attention (``cross``, or Nq != Nk)
    takes three separate projections, each a [B, N, H, D] transposed view,
    with key positions in a tensor of their own. RoPE tables in ``dtype``."""
    b, h, nq, nk, d, rope, mask_kind = case
    dev = "cuda"
    if nq == nk and not cross:
        qkv = torch.randn(b, nq, 3, h, d, device=dev, generator=gen, dtype=dtype).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
    else:
        q = torch.randn(b, nq, h, d, device=dev, generator=gen, dtype=dtype).transpose(1, 2)
        k = torch.randn(b, nk, h, d, device=dev, generator=gen, dtype=dtype).transpose(1, 2)
        v = torch.randn(b, nk, h, d, device=dev, generator=gen, dtype=dtype).transpose(1, 2)
    qrope = krope = kv_mask = None
    if rope:
        from siu3r_tpu_torch.ops.rope import rope2d_cos_sin

        qrope = rope2d_cos_sin(_positions(b, nq, gen), d, dtype=dtype)
        krope = rope2d_cos_sin(_positions(b, nk, gen), d, dtype=dtype)
    if mask_kind == "one_live_key":
        kv_mask = torch.rand(b, nk, device=dev, generator=gen) > 0.5
        kv_mask[0] = False
        kv_mask[0, nk // 2] = True
    elif mask_kind == "first_tile_masked":  # the kernel's first 64-key tile wholly masked, later keys live
        kv_mask = torch.rand(b, nk, device=dev, generator=gen) > 0.5
        kv_mask[:, :64] = False
        kv_mask[:, 64] = True
    return q, k, v, qrope, krope, kv_mask


def _attn_cost(case, elem: int = 4) -> tuple[float, float, float]:
    """Bytes (q, k, v, the tables and the mask in; out; ``elem`` bytes an
    element), the two products' flops and the rotation's."""
    b, h, nq, nk, d, rope, mask_kind = case
    nbytes = elem * b * h * d * (2 * nq + 2 * nk)
    if rope:
        nbytes += elem * 2 * b * d * (nq + nk)  # cos/sin tables
    if mask_kind:
        nbytes += b * nk
    return nbytes, 4 * b * h * nq * nk * d, 6 * b * h * (nq + nk) * d if rope else 0


def _attn_bound(case, dtype: torch.dtype = torch.float32) -> dict:
    """The least time for the function, the products at the 3xTF32 tensor-core
    rate in fp32 (what the kernel's arithmetic needs) or the dense bf16 rate
    in bf16 (kernel 1b), and the rotation at the fp32 rate; beside it the
    same with the products at the fp32 rate."""
    bf16 = dtype == torch.bfloat16
    nbytes, products, rotation = _attn_cost(case, 2 if bf16 else 4)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = (products / (PEAK_BF16_FLOPS if bf16 else PEAK_3XTF32_FLOPS) + rotation / PEAK_FP32_FLOPS) * 1e3
    b_ms, b_by = larger(bytes_ms, ops_ms)
    return dict(bound_ms=b_ms, bound_by=b_by, bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_fp32_ms=bound(nbytes, products + rotation)[0])


def check_attention(name, case, iters, gen, cross=False, inputs=None, scale=None, dtype=torch.float32):
    """The attention kernel against its plain version on ``case``'s random
    inputs in ``dtype``, or on ``inputs`` (q, k, v, qrope, krope, kv_mask)
    taken from a run of the model (``case`` then only describes their
    shapes, and q's dtype is the dtype). fp32 within ATTN_ATOL; bf16 (kernel
    1b) within one bf16 ulp of the plain version's output, and failing
    unless the variant ``ATTN_BF16_VARIANT`` expects for ``name`` ran (the
    resident one where it names none)."""
    from siu3r_tpu_torch.kernels import _build
    from siu3r_tpu_torch.kernels.flash_attention import flash_attn, flash_attn_plain, launch_config
    from siu3r_tpu_torch.ops.rope import rope2d_from_cos_sin

    q, k, v, qrope, krope, kv_mask = inputs or _attn_inputs(case, gen, cross, dtype)
    dtype = q.dtype
    scale = scale or case[4] ** -0.5
    kern = lambda: flash_attn(q, k, v, scale, qrope=qrope, krope=krope, kv_mask=kv_mask)
    plain = lambda: flash_attn_plain(q, k, v, scale, qrope, krope, kv_mask)
    before = dict(_build.variant_counts)
    out = kern()
    variant = [v for v, n in _build.variant_counts.items() if n > before.get(v, 0)]
    ref = plain()
    torch.cuda.synchronize()
    if out.dtype != dtype:
        raise AssertionError(f"attention {name} {case}: output {out.dtype} for {dtype} inputs")
    if dtype == torch.bfloat16:
        expected = ATTN_BF16_VARIANT.get(name, "flash_attn_rope_bf16.resident")
        if variant != [expected]:
            raise AssertionError(f"attention {name} {case}: the {variant} kernel ran, expected {expected}")
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    if dtype == torch.bfloat16:
        excess = (diff - bf16_ulp(ref)).max().item()
        if not math.isfinite(err) or excess > 0:
            raise AssertionError(f"attention {name} {case} bf16: max_abs_err {err}, beyond one bf16 ulp by {excess}")
    elif not math.isfinite(err) or err > ATTN_ATOL:
        raise AssertionError(f"attention {name} {case}: max_abs_err {err} > {ATTN_ATOL}")
    ms, elapsed, _ = time_ms(kern, iters, whole=True)
    plain_ms = event_ms(plain, max(3, iters // 4))
    lib_ms = None
    if kv_mask is None:
        qr = rope2d_from_cos_sin(q, *qrope) if qrope is not None else q
        kr = rope2d_from_cos_sin(k, *krope) if krope is not None else k
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qr, kr, v, scale=scale), iters, whole=True,
                         events=False)[0]
    bnd = _attn_bound(case, dtype)
    at_or_above_bound(f"attention {name} {case}", ms, bnd["bound_ms"])
    blocks, threads, smem = launch_config(*case[:5], case[5], dtype)
    bf16 = dtype == torch.bfloat16
    log("kernel", f"{name} {case[:5]} rope={case[5]} mask={case[6]}{' bf16 ' + variant[0] if bf16 else ''}: "
                  f"max_abs_err {err:.3g} (bit-equal {(diff == 0).float().mean().item():.4f}) "
                  f"ms {ms:.5f} (elapsed {elapsed:.5f}) plain_ms {plain_ms:.5f} library_ms {lib_ms} "
                  f"bound_ms {bnd['bound_ms']:.5f} ({bnd['bound_by']}, {'bf16' if bf16 else '3xTF32'}; fp32 SIMT "
                  f"{bnd['bound_fp32_ms']:.5f}); {ms * 1e3:.2f} us a launch on {blocks} blocks of {threads} "
                  f"threads, {smem} B shared")
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


def check_msda(name, case, iters, gen, inputs=None):
    """The MSDA kernel against its plain version on one case's random inputs,
    or on ``inputs`` (value, locations, weights) taken from a run of the
    model, in fp32: the kernel is fp32, and ``msda`` casts a bf16 value and
    bf16 weights to fp32 at its boundary, so fp32 is what the kernel took;
    fails unless the kernel that ran is the one ``MSDA_VARIANT`` expects for
    the case."""
    from siu3r_tpu_torch.kernels import _build
    from siu3r_tpu_torch.kernels.msda import msda, msda_plain

    value, loc, aw = (t.float() for t in inputs) if inputs else _msda_inputs(case, gen)
    shapes = case[5]
    kern = lambda: msda(value, shapes, loc, aw)
    plain = lambda: msda_plain(value, shapes, loc, aw)
    before = dict(_build.variant_counts)
    out = kern()
    variant = [v for v, n in _build.variant_counts.items() if n > before.get(v, 0)]
    expected = MSDA_VARIANT.get(name, "msda.staged")
    if variant != [expected]:
        raise AssertionError(f"msda {name}: the {variant} kernel ran, expected {expected}")
    ref = plain()
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if not math.isfinite(err) or err > MSDA_ATOL:
        raise AssertionError(f"msda {name}: max_abs_err {err} > {MSDA_ATOL}")
    ms, elapsed, _ = time_ms(kern, iters, whole=True)
    plain_ms = event_ms(plain, max(3, iters // 4))
    nbytes, flops = _msda_cost(case, loc)
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    b_ms, b_by = larger(bytes_ms, ops_ms)
    at_or_above_bound(f"msda {name}", ms, b_ms)
    log("kernel", f"msda {name} B={case[0]} Lq={case[1]} H={case[2]} D={case[3]} P={case[4]} "
                  f"levels={shapes}: {expected} kernel, max_abs_err {err:.3g} ms {ms:.5f} (elapsed "
                  f"{elapsed:.5f}) plain_ms {plain_ms:.5f} bound_ms {b_ms:.5f} ({b_by})")
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
    # the refer train step's language layers: 8 words against 100 queries at B = 3
    "language_b3": (3, 8, 8, 100, 32, False, None),
}
# kernel 1b (bf16 q, k, v; RoPE, no mask) at the two-view backbone's shapes,
# the calls one bf16 forward makes at each, and whether q and k/v come from
# separate projections; then edge cases
ATTN_BF16_MAIN = {
    "encoder": ((2, 16, 257, 257, 64, True, None), 24, False),
    "decoder_self": ((1, 12, 257, 257, 64, True, None), 24, False),
    "decoder_cross": ((1, 12, 257, 257, 64, True, None), 24, True),
}
ATTN_BF16_EDGE = {
    "nq_ne_nk": (1, 4, 100, 257, 64, True, None),
    "nk65_d32": (1, 3, 70, 65, 32, True, None),
    "nk8": (1, 4, 33, 8, 64, True, None),
    "nq17_d32": (2, 4, 17, 100, 32, True, None),
    "one_query_one_key": (1, 2, 1, 1, 64, True, None),
    "one_key_d32": (2, 3, 70, 1, 32, True, None),
    # B x H far below the SM count: the keys split over two warps
    "few_heads": (1, 2, 257, 257, 64, True, None),
    # the 8-view encoder's batch of views: one warp a row group
    "eight_views": (8, 16, 257, 257, 64, True, None),
    # K, V and pass 1's record past a block's shared memory (320 keys at
    # D = 64, 400 at D = 32): the streamed kernel
    "long_keys_d64": (1, 4, 64, 1100, 64, True, None),
    "long_keys_d32": (1, 2, 40, 1500, 32, True, None),
}
# the kernel 1b variant each case must take (``_build.variant_counts``); every
# other case, the main path's three and the model's own inputs included,
# takes the resident one
ATTN_BF16_VARIANT = {f"bf16 {name}": "flash_attn_rope_bf16.streamed" for name in ATTN_BF16_EDGE
                     if name.startswith("long_keys")}
# (B, Lq, H, D, P, levels, loc lo, loc hi, integer points)
MSDA_MAIN = {
    "adapter": ((2, 1344, 16, 64, 4, ((16, 16),), -0.05, 1.05, False), 6),
    "pixel_decoder": ((2, 1344, 8, 32, 4, ((8, 8), (16, 16), (32, 32)), -0.05, 1.05, False), 6),
}
MSDA_EDGE = {
    "integer_points": (2, 300, 8, 32, 4, ((8, 8), (16, 16)), 0.0, 1.0, True),
    "outside_unit_square": (1, 200, 4, 64, 4, ((16, 16),), -0.5, 1.5, False),
    "one_by_one_level": (2, 100, 8, 32, 2, ((1, 1), (4, 4)), -0.2, 1.2, False),
    # the generic instantiation's points in two batches of 32
    "forty_points": (2, 150, 4, 64, 8, ((8, 8), (4, 4), (2, 2), (1, 1), (6, 5)), -0.1, 1.1, False),
    # value slices past shared memory (1 MB, 688 KB, 696 KB a head): the
    # global-gather kernel, in its (1, 4), (3, 4) and generic instantiations
    "global_one_level": (1, 300, 4, 64, 4, ((64, 64),), -0.05, 1.05, False),
    "global_three_levels": (2, 300, 4, 32, 4, ((64, 64), (32, 32), (16, 16)), -0.05, 1.05, False),
    "global_four_levels": (1, 400, 8, 32, 4, ((64, 64), (32, 32), (16, 16), (8, 8)), -0.05, 1.05, False),
}
# the kernel each MSDA case must take (``_build.variant_counts``); every
# other case, the main path's two included, takes the staged one
MSDA_VARIANT = {name: "msda.global" for name in MSDA_EDGE if name.startswith("global")}


ATTN_KERNEL = "flash_attn_fwd_kernel"
ATTN_BF16_KERNEL = "flash_attn_rope_bf16_resident_kernel"  # kernel 1b where K, V and the record fit
ATTN_BF16_STREAMED = "flash_attn_rope_bf16_kernel"  # and for longer key sets


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
    # kernel 1b: the resident kernel and the streamed one, each in two head
    # dims and two layouts; bf16 products (HMMA.16816.F32.BF16), V's fragments by
    # ldmatrix (LDSM), K and V by asynchronous copies (LDGSTS for cp.async;
    # UBLKCP or UTMALDG for bulk copies)
    for kernel, count in ((ATTN_BF16_KERNEL, 4), (ATTN_BF16_STREAMED, 4)):
        log_ptxas("kernels", kernel)
        functions = [f for f in sass.split("Function : ")[1:] if f.startswith("_Z") and kernel in f.split()[0]]
        if len(functions) != count:
            raise AssertionError(f"cuobjdump -sass shows {len(functions)} instantiations of {kernel}, not {count}")
        for f in functions:
            body = f.splitlines()
            mma = sum("HMMA" in x and "BF16" in x for x in body)
            other_mma = sum(("HMMA" in x or "HGMMA" in x) and "BF16" not in x for x in body)
            ldsm = sum("LDSM" in x for x in body)
            copies = sum(any(op in x for op in ("LDGSTS", "UBLKCP", "UTMALDG")) for x in body)
            log("kernels", f"SASS {body[0][:70]}: {mma} bf16 HMMA instructions ({other_mma} other tensor-core), "
                           f"{ldsm} ldmatrix, {copies} async copies")
            if not mma or other_mma or not ldsm or not copies:
                raise AssertionError(f"{body[0]}: bf16 HMMA {mma}, other tensor-core {other_mma}, LDSM {ldsm}, "
                                     f"async copies {copies} in the SASS")


def _model_kernel_totals() -> dict:
    """Per-forward sums of the model kernels' checks, filled by ``_add_check``."""
    zero = dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
    return {"flash_attn_rope": dict(zero, bound_fp32_ms=0.0), "flash_attn": dict(zero, bound_fp32_ms=0.0),
            "msda": dict(zero, library_ms=None), "flash_attn_rope_bf16": dict(zero, bound_fp32_ms=0.0)}


def _add_check(per_kernel: dict, kernel: str, res: dict, calls: int) -> None:
    """Add ``calls`` launches of one checked case to the totals."""
    acc = per_kernel[kernel]
    acc["err"] = max(acc["err"], res["err"])
    for key in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms", "bound_fp32_ms"):
        if key in acc:
            acc[key] += calls * res[key]
    if acc["library_ms"] is not None:
        acc["library_ms"] += calls * res["library_ms"]


def _totals_text(per_kernel: dict) -> str:
    for acc in per_kernel.values():
        acc["bound_by"] = larger(acc["bytes_ms"], acc["ops_ms"])[1]
    return ", ".join(f"{k} ms {a['ms']:.5f} bound_ms {a['bound_ms']:.5f}"
                     + (f" (fp32 SIMT {a['bound_fp32_ms']:.5f})" if "bound_fp32_ms" in a else "")
                     + f" library_ms {a['library_ms']}" for k, a in per_kernel.items())


def phase_kernels() -> dict:
    check_attention_build()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    per_kernel = _model_kernel_totals()
    for name, (case, kernel, calls, cross) in ATTN_MAIN.items():
        _add_check(per_kernel, kernel, check_attention(name, case, 50, gen, cross), calls)
    for name, case in ATTN_EDGE.items():
        res = check_attention(name, case, 20, gen)
        kernel = "flash_attn_rope" if case[5] else "flash_attn"
        per_kernel[kernel]["err"] = max(per_kernel[kernel]["err"], res["err"])
    for name, (case, calls) in MSDA_MAIN.items():
        _add_check(per_kernel, "msda", check_msda(name, case, 50, gen), calls)
    for name, case in MSDA_EDGE.items():
        per_kernel["msda"]["err"] = max(per_kernel["msda"]["err"], check_msda(name, case, 20, gen)["err"])
    bf16 = "flash_attn_rope_bf16"
    for name, (case, calls, cross) in ATTN_BF16_MAIN.items():
        _add_check(per_kernel, bf16, check_attention(f"bf16 {name}", case, 50, gen, cross, dtype=torch.bfloat16),
                   calls)
    for name, case in ATTN_BF16_EDGE.items():
        res = check_attention(f"bf16 {name}", case, 20, gen, dtype=torch.bfloat16)
        per_kernel[bf16]["err"] = max(per_kernel[bf16]["err"], res["err"])
    log_ptxas("kernels", "msda_kernel")
    log("kernels", "all kernels agree with their plain versions (attention atol "
                   f"{ATTN_ATOL}, kernel 1b one bf16 ulp, msda atol {MSDA_ATOL}); per forward (kernel 1b: per bf16 "
                   "forward): " + _totals_text(per_kernel))
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
    table and counts out. Operations, at the int32 rate: a gaussian's tile
    box (12), and a count and a rank for each (gaussian, tile) pair its box
    covers (4)."""
    from siu3r_tpu_torch.render.tiles import _tile_ranges, tile_grid

    n, g = proj.depth.shape
    t, k = table.shape[-2:]
    y0, y1, x0, x1, alive = _tile_ranges(proj, *tile_grid(IMAGE), *SLOTS)
    pairs = torch.where(alive, (y1 - y0 + 1) * (x1 - x0 + 1), 0).sum().item()
    return 16.0 * n * g + 4.0 * n * t * (k + 1), 12.0 * n * g + 4.0 * float(pairs)


BIN_KERNELS = ("bin_prep_kernel", "bin_count_kernel", "bin_write_kernel")
# the binning wrapper's device entries by name: its own kernels, and the
# stable depth sort (PyTorch's segmented sort: its radix sort kernels, the
# copy of the keys, the memset of its scratch and its segment indices)
BIN_PARTS = {**{p: (p,) for p in BIN_KERNELS},
             "sort": ("sort", "Sort", "fill_index_and_segment", "Memset", "direct_copy_kernel")}


def check_bin(name, proj, k, iters) -> dict:
    from siu3r_tpu_torch.kernels.binning import _flat, bin_gaussians, bin_gaussians_plain

    proj = _flat(proj)  # views flattened: [N, G]
    kern = lambda: bin_gaussians(proj, IMAGE, k, *SLOTS)
    plain = lambda: bin_gaussians_plain(proj, IMAGE, k, *SLOTS)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    if not _same_table(got, want):
        raise AssertionError(f"bin {name}: table or counts differ from the plain version")
    past = torch.arange(k, device="cuda") >= got[1][..., None]
    if bool((got[0][past] != 0).any()):
        raise AssertionError(f"bin {name}: table entries past a tile's count are not zero")
    counts = got[1].float()
    res = dict(err=0.0, mean_count=counts.mean().item(), at_k=(got[1] == k).float().mean().item())
    if iters:
        nbytes, ops = _bin_cost(proj, *got)
        # the wrapper's device time: the depth sort (torch), then the three
        # kernels of csrc/binning.cu, each on its own
        # (a part is None where no whole trace came: the time is then CUDA
        # events', and the split is not known)
        res["ms"], res["elapsed"], parts = time_ms(kern, iters, parts=BIN_PARTS, whole=True)
        if any(parts[p] == 0 for p in BIN_KERNELS):
            raise RuntimeError(f"the profiler's trace misses a binning kernel: {parts}")
        own = [parts[p] for p in BIN_KERNELS]
        res["kernel_ms"] = None if None in own else sum(own)
        res.update({f"{p}_ms": ms for p, ms in parts.items()})
        res["plain_ms"] = event_ms(plain, max(3, iters // 4))
        res["bound_ms"], res["bound_by"] = bound(nbytes, ops, PEAK_INT32_OPS)
        at_or_above_bound(f"bin {name}", res["ms"], res["bound_ms"])
    log("kernel", f"bin {name} views={proj.depth.shape[0]} G={proj.depth.shape[1]} K={k}: exact, "
                  f"mean count {res['mean_count']:.1f}, share at K {res['at_k']:.3f}"
                  + (f", ms {res['ms']:.5f} (elapsed {res['elapsed']:.5f}) plain_ms {res['plain_ms']:.5f} "
                     f"bound_ms {res['bound_ms']:.5f} ({res['bound_by']})" if iters else ""))
    if iters:
        text = lambda ms: "not known" if ms is None else f"{ms:.5f}"
        split = [res["sort_ms"], res["kernel_ms"]]
        log("kernel", f"bin {name} split: sort_ms {text(res['sort_ms'])}, own kernels {text(res['kernel_ms'])} ("
                      + ", ".join(f"{p} {text(res[p + '_ms'])}" for p in BIN_KERNELS)
                      + f"), other {text(None if None in split else res['ms'] - sum(split))}")
        for entry, ms in _device_breakdown(kern, iters)[1]:
            log("kernel", f"  bin {name} device {ms:.5f} ms  {entry[:110]}")
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
        res["ms"], res["elapsed"], _ = time_ms(kern, iters, whole=True)
        res["plain_ms"] = event_ms(plain, max(3, iters // 4))
        res["bound_ms"], res["bound_by"] = bound(nbytes, ops)
        at_or_above_bound(f"raster {name}", res["ms"], res["bound_ms"])
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
    for kernel in BIN_KERNELS:
        log_ptxas("render_kernels", kernel)

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
    # runs of 3000 equal depths across the kernels' 1024-gaussian chunks, in
    # shuffled order; K reached inside a chunk; G not a multiple of a chunk
    perm = torch.randperm(g, device="cuda", generator=gen).float()
    runs = proj._replace(depth=torch.floor(perm / 3000.0)[None].expand(views, -1).contiguous())
    check_bin("ties_across_chunks", runs, k, 0)
    check_bin("k_mid_chunk_K100", proj, 100, 0)
    check_bin("ragged_G_one_view", ProjectedGaussians(*(x[:1, :3 * 1024 + 17].contiguous() for x in proj)), k, 0)
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
        res["ms"], res["elapsed"], _ = time_ms(kern, iters, whole=True)
        res["plain_ms"] = event_ms(plain, max(2, iters // 10))
        res["bound_ms"], res["bound_by"] = bound(nbytes, ops)
        at_or_above_bound(f"raster_bwd {name}", res["ms"], res["bound_ms"])
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

    for dtype in (torch.float32, torch.bfloat16):  # kernel 1, then kernel 1b
        q, k, v, qrope, krope, _ = _attn_inputs(ATTN_MAIN["encoder"][0], gen, False, dtype)
        compare(f"flash_attn_rope {dtype}", lambda q, k, v: flash_attn(q, k, v, 0.125, qrope, krope),
                lambda q, k, v: flash_attn_plain(q, k, v, 0.125, qrope, krope), (q, k, v), 1e-4)
    for name, (case, cross) in (("flash_attn", (ATTN_MAIN["m2f_query_self"][0], False)),
                                ("flash_attn language", (ATTN_EDGE["language_b3"], True))):
        q, k, v, _, _, _ = _attn_inputs(case, gen, cross)
        compare(name, lambda q, k, v: flash_attn(q, k, v, 32 ** -0.5),
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


def _small_cfg(num_views: int = 2, dtype: str = "float32"):
    """A small config whose head dims the kernels take: encoder 512/8 (D=64),
    decoder 256/4 (D=64), adapter 512/16 (D=32), Mask2Former 64/2 (D=32);
    computing in ``dtype``."""
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
        num_views=num_views,
        dtype=dtype,
    )


def _floats(out) -> dict:
    g = out.gaussians
    res = {f: getattr(g, f) for f in ("means", "covariances", "harmonics", "opacities", "scales",
                                      "rotations", "seg_query_class_logits")}
    res["class_logits"] = out.seg.class_queries_logits
    res["mask_logits"] = out.seg.masks_queries_logits
    return res


def _target_views(means: torch.Tensor, n_views: int, context_views: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """n_views target cameras framing the first of ``context_views`` context
    views' Gaussians:
    camera-to-world poses [1, n_views, 4, 4] looking down +z from 0.15 units
    behind the nearest of them (clear of the renderer's 0.1 near plane), on a
    small circle about their median, and normalised intrinsics
    [1, n_views, 3, 3] whose field of view holds 98% of them. (Seeded random
    weights give each context view a compact blob about 0.01 units across,
    next to the first context camera's origin; a camera at the context
    views' field of view sees a few percent of its pixels covered.)
    Set-up: syncs with the host."""
    m = means.reshape(-1, 3).float()
    m = m[: m.shape[0] // context_views]  # the first context view's pixels
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


def _slice_check(phase: str, views: int, dtype: str = "float32") -> None:
    """The small config at ``views`` views computing in ``dtype`` on the GPU
    (kernels) against the same weights on the CPU (plain versions): the
    forward, then the eval step's render. fp32 within SLICE_RTOL /
    SLICE_ATOL, labels LABEL_AGREEMENT; bf16 the Gaussian means within
    BF16_MEANS_REL, each Gaussian field within BF16_SLICE_FRACTION of the
    CPU's own bf16 - fp32 difference (L2), labels BF16_LABELS."""
    from siu3r_tpu_torch.config import PipelineCfg, RootCfg
    from siu3r_tpu_torch.models.model import SIU3RModel, set_compute_dtype
    from siu3r_tpu_torch.pipeline import Pipeline
    from siu3r_tpu_torch.renderer import render_color_and_qc

    bf16 = dtype == "bfloat16"
    root = RootCfg(pipeline=PipelineCfg(model=_small_cfg(views, dtype)))
    gpu_pipe = Pipeline(root, device="cuda", seed=7)
    gpu = gpu_pipe.model
    cpu = SIU3RModel(root.pipeline.model, device="cpu", seed=0).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(1, views, 64, 64, 3).astype(np.float32))
    intr = torch.tensor([[1.24, 0, 0.5], [0, 1.24, 0.5], [0, 0, 1]]).expand(1, views, 3, 3).contiguous()
    with torch.inference_mode():
        og = gpu(images.cuda(), intr.cuda(), enable_query_class_logit_lift=True)
        oc = cpu(images, intr, enable_query_class_logit_lift=True)
        if bf16:  # the CPU's own bf16 - fp32 difference, the yardstick
            oc32 = set_compute_dtype(cpu, "float32")(images, intr, enable_query_class_logit_lift=True)
            set_compute_dtype(cpu, "bfloat16")
    worst, ratios = 0.0, {}
    for key, a in _floats(og).items():
        b = _floats(oc)[key]
        a = a.cpu().double()
        b = b.double()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{phase}: {key} not finite")
        if bf16:
            yard = (b - _floats(oc32)[key].double()).norm().item()
            ratios[key] = (a - b).norm().item() / yard if yard > 0 else (math.inf if (a != b).any() else 0.0)
            continue
        excess = ((a - b).abs() - SLICE_RTOL * b.abs()).max().item()
        worst = max(worst, excess)
        if excess > SLICE_ATOL:
            raise AssertionError(f"{phase}: {key} differs by {excess} beyond rtol {SLICE_RTOL}")
    agree = min(
        (og.gaussians.semantic_labels.cpu() == oc.gaussians.semantic_labels).float().mean().item(),
        (og.gaussians.instance_labels.cpu() == oc.gaussians.instance_labels).float().mean().item(),
    )
    need = BF16_LABELS if bf16 else LABEL_AGREEMENT
    if bf16:
        means_rel = ((og.gaussians.means.cpu() - oc.gaussians.means).abs().mean()
                     / oc.gaussians.means.abs().mean()).item()
        log(phase, f"small config in bf16, {views} views, on cuda (kernels) vs cpu (plain): Gaussian means mean "
                   f"rel err {means_rel:.4g} (limit {BF16_MEANS_REL}); each float output's L2 difference as a share "
                   f"of the cpu's bf16 - fp32 difference {({k: float(f'{r:.3g}') for k, r in ratios.items()})} "
                   f"(limit {BF16_SLICE_FRACTION} on the Gaussians'); labels agree {agree:.5f} (limit {BF16_LABELS})")
        worst = max(ratios[k] for k in BF16_GAUSSIAN_KEYS)
        if not (worst <= BF16_SLICE_FRACTION and means_rel <= BF16_MEANS_REL):
            raise AssertionError(f"{phase}: the Gaussians' cuda - cpu up to {worst:.3g} of the cpu's bf16 - fp32 "
                                 f"(limit {BF16_SLICE_FRACTION}), means mean rel err {means_rel:.4g} (limit "
                                 f"{BF16_MEANS_REL})")
    if agree < need:
        raise AssertionError(f"{phase}: labels agree on {agree:.5f} < {need}")
    if not bf16:
        log(phase, f"small config, {views} views, on cuda (kernels) vs cpu (plain): floats within rtol "
                   f"{SLICE_RTOL} atol {SLICE_ATOL} (worst excess {worst:.3g}), labels agree {agree:.5f}")

    # the eval step: the same forward, then the render of 4 target views,
    # held against the CPU plain render of the step's own Gaussians. (Not
    # against the CPU forward's Gaussians: the 1/255 alpha cut is a step, and
    # across a covered view the forward's rounding moves some pairs over it,
    # each moving a pixel by up to T/255.)
    batch = _eval_batch(images, intr, _target_views(oc.gaussians.means, 4, views))
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
        raise AssertionError(f"{phase}: the target views see almost nothing (mean alpha {coverage})")
    excesses = {}
    for key, a, b, atol in (("color", rg.color, rc.color, RENDER_ATOL), ("alpha", rg.alpha, rc.alpha, RENDER_ATOL),
                            ("depth", rg.depth, rc.depth, RENDER_DEPTH_ATOL), ("qc", qg, qc, RENDER_ATOL)):
        a, b = a.cpu().double(), b.double()
        excesses[key] = ((a - b).abs() - RENDER_RTOL * b.abs()).max().item()
        if not torch.isfinite(a).all() or excesses[key] > atol:
            raise AssertionError(f"{phase}: eval step {key} differs by {excesses[key]} beyond rtol "
                                 f"{RENDER_RTOL} atol {atol}")
    log(phase, f"small config eval step, {views} views, on cuda (kernels) vs the cpu render (plain) of its Gaussians, "
               f"4 target views, mean alpha "
               f"{coverage:.3f}: within rtol {RENDER_RTOL} atol {RENDER_ATOL} (depth {RENDER_DEPTH_ATOL}), "
               f"worst excess {excesses}")


def phase_slice_check() -> None:
    _slice_check("slice", 2)


def phase_multi_slice() -> None:
    _slice_check("multi_slice", 3)


def phase_bf16_slice() -> None:
    _slice_check("bf16_slice", 2, "bfloat16")
    _slice_check("bf16_slice", 3, "bfloat16")


# ---------------------------------------------------------------- phase 5


def expected_launches(cfg, words: bool = False) -> dict:
    """Kernel launches of one forward of ``cfg``'s model, with the language
    layers where ``words`` are given."""
    from siu3r_tpu_torch.models.mask2former.model import LANG_LAYERS

    c, m = cfg.croco, cfg.mask2former
    # per decoder block of each of the two decoders: self-attention, and in
    # the two-view backbone the cross-attention to the other view (the
    # multi-view backbone's cross-attention over the shared bank is masked
    # and takes the plain path)
    per_dec_block = 4 if cfg.num_views == 2 else 2
    return {
        # encoder self-attention per block (every view in one launch), then
        # the decoders; kernel 1b under model.dtype: bfloat16
        "flash_attn_rope_bf16" if cfg.dtype == "bfloat16" else "flash_attn_rope": c.enc_depth + per_dec_block * c.dec_depth,
        # Mask2Former query self-attention per decoder layer, and the words'
        # cross-attention to the queries per language layer
        "flash_attn": m.decoder_layers - 1 + (LANG_LAYERS if words else 0),
        # adapter: 4 interactions + 2 extra extractors; pixel decoder: one per encoder layer
        "msda": 4 + 2 + m.encoder_layers,
    }


def check_variants(expected: dict) -> None:
    """Every MSDA launch of the counted run took the staged kernel, and every
    kernel 1b launch the resident one (``expected``: the run's launches)."""
    from siu3r_tpu_torch.kernels import _build

    want = {"msda.staged": expected["msda"]} if expected.get("msda") else {}
    if expected.get("flash_attn_rope_bf16"):
        want["flash_attn_rope_bf16.resident"] = expected["flash_attn_rope_bf16"]
    variants = dict(_build.variant_counts)
    if variants != want:
        raise AssertionError(f"kernel variants {variants}: expected {want}")


def _device_breakdown(run, iters: int) -> tuple[float, list]:
    """Device time per forward from the profiler's CUDA trace: the total and
    every entry by name, largest first."""
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
    return total, rows


def _kernel_kind(name: str) -> str | None:
    """A device entry's kind by its name: a cuDNN convolution (implicit-GEMM
    fprop/dgrad/wgrad, Winograd, FFT, or named conv), else a matrix product
    (cuBLAS and CUTLASS GEMM kernels, and cuBLASLt's ``nvjet`` kernels, which
    run the bf16 products); None for anything else."""
    n = name.lower()
    if any(x in n for x in ("conv", "fprop", "dgrad", "wgrad", "winograd", "fft")):
        return "conv"
    if any(x in n for x in ("gemm", "xmma", "cutlass", "gemv", "nvjet")):
        return "gemm"
    return None


def _view_inputs(views: int, seed: int = 0, batch: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded images [batch, views, 256, 256, 3] and the CLI's default intrinsics."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.rand(batch, views, 256, 256, 3, device="cuda", generator=gen)
    k = torch.tensor([[318 / 256, 0, 0.5], [0, 318 / 256, 0.5], [0, 0, 1]], device="cuda")
    return images, k.expand(batch, views, 3, 3).contiguous()


def _counted_run(phase: str, run, expected: dict):
    """One warm-up, then one ``run`` with the launch counts set to 0 just
    before it and read just after, under a mode in which a host sync (a copy
    to or from the host) raises; fails unless the counts are ``expected``,
    every MSDA launch took the staged kernel and every kernel 1b launch the
    resident one. Returns the run's output."""
    from siu3r_tpu_torch.kernels import _build

    run()  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    out = run()
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    if launches != expected:
        raise AssertionError(f"{phase}: launches {launches} != expected {expected}")
    check_variants(expected)
    return out


def _timed_runs(run, n: int) -> dict:
    """``n`` warm runs, each between two synchronisations: wall median, min
    and max, runs per second, peak memory; then the device busy time per run
    from the profiler's trace of 3 runs, its idle share and largest
    entries."""
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    device_ms, rows = _device_breakdown(run, 3)
    kinds = {"gemm": 0.0, "conv": 0.0}
    for name, ms in rows:
        kind = _kernel_kind(name)
        if kind:
            kinds[kind] += ms
    med = statistics.median(times)
    return dict(median_s=med, min_s=min(times), max_s=max(times), per_s=1.0 / med, peak_gib=peak / 2**30,
                device_ms=device_ms, idle_share=1.0 - device_ms / (med * 1e3), top_device_ms=rows[:20], runs=n,
                gemm_ms=kinds["gemm"], conv_ms=kinds["conv"])


def _timing_text(t: dict, what: str) -> str:
    return (f"median of {t['runs']} warm {what} {t['median_s'] * 1e3:.2f} ms (min {t['min_s'] * 1e3:.2f}, max "
            f"{t['max_s'] * 1e3:.2f}) = {t['per_s']:.3f} per s, peak memory {t['peak_gib']:.3f} GiB; device busy "
            f"{t['device_ms']:.2f} ms each, idle share {t['idle_share']:.3f}; GEMMs {t['gemm_ms']:.3f} ms, "
            f"convolutions {t['conv_ms']:.3f} ms")


def two_view_cfg():
    """The default (two-view) configuration with the ScanNet classes."""
    from siu3r_tpu_torch.config import RootCfg, bind_scannet_classes

    return bind_scannet_classes(RootCfg())


def multi_cfg():
    """The repo's 8-view configuration, ``configs/scannet_multi.yaml``."""
    from siu3r_tpu_torch.config import bind_scannet_classes, load_config

    return bind_scannet_classes(load_config(Path(__file__).resolve().parent / "configs" / "scannet_multi.yaml"))


def multi_targets(cfg) -> int:
    """The target views of the config's sampler: the context views and the
    extra target views between them (siu3r_tpu/data/datasets.py:128-153)."""
    return cfg.pipeline.model.num_views + cfg.datamodule.dataset_cfg.num_extra_target_views


@contextlib.contextmanager
def _recorded(module, name: str, keep=lambda args: True):
    """Record the calls of ``module.name`` inside the block whose bound
    arguments pass ``keep``: a list of {argument: value}, the result,
    detached, under "out"."""
    import inspect

    orig = getattr(module, name)
    sig = inspect.signature(orig)
    calls = []

    def rec(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        out = orig(*args, **kwargs)
        if keep(bound.arguments):
            kept = tuple(x.detach() for x in out) if isinstance(out, tuple) else out.detach()
            calls.append({**bound.arguments, "out": kept})
        return out

    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def _distinct(calls: list, key) -> dict:
    """{key: (first call, number of calls)} of recorded calls."""
    out = {}
    for call in calls:
        kk = key(call)
        out[kk] = (out[kk][0], out[kk][1] + 1) if kk in out else (call, 1)
    return out


def _check_model_kernels(phase: str, run, iters: int, shapes: dict | None = None) -> dict:
    """The attention and MSDA kernels held against their plain versions on
    the inputs one ``run`` of the model gives them: each distinct shape
    checked and timed once, its times counted once per launch. ``shapes``,
    if given, receives each attention shape's check by its case."""
    import siu3r_tpu_torch.kernels.flash_attention as FA
    import siu3r_tpu_torch.models.adapter as A

    with _recorded(FA, "flash_attn") as attn_calls, _recorded(A, "msda") as msda_calls:
        run()
    gen = torch.Generator(device="cuda").manual_seed(77)
    per_kernel = _model_kernel_totals()
    attn = _distinct(attn_calls, lambda c: (tuple(c["q"].shape), tuple(c["k"].shape), c["qrope"] is not None,
                                            c["kv_mask"] is not None))
    for (qs, ks, rope, masked), (c, n) in attn.items():
        case = (qs[0], qs[1], qs[2], ks[2], qs[3], rope, "kv" if masked else None)
        kernel = ("flash_attn_rope_bf16" if c["q"].dtype == torch.bfloat16 else "flash_attn_rope") if rope \
            else "flash_attn"
        inputs = (c["q"], c["k"], c["v"], c["qrope"], c["krope"], c["kv_mask"])
        res = check_attention(f"{phase} x{n}", case, iters, gen, inputs=inputs, scale=c["scale"])
        _add_check(per_kernel, kernel, res, n)
        if shapes is not None:
            shapes[case] = dict(res, launches=n)
    for (vs, ls), (c, n) in _distinct(msda_calls, lambda c: (tuple(c["value"].shape),
                                                             tuple(c["sampling_locations"].shape))).items():
        case = (vs[0], ls[1], vs[2], vs[3], ls[4], tuple(map(tuple, c["spatial_shapes"])), None, None, None)
        inputs = (c["value"], c["sampling_locations"], c["attention_weights"])
        _add_check(per_kernel, "msda", check_msda(f"{phase} x{n}", case, iters, gen, inputs=inputs), n)
    log(phase, f"the model kernels on the run's own inputs ({len(attn_calls)} attention and {len(msda_calls)} "
               f"msda launches, {len(attn)} attention shapes) agree with their plain versions; per forward: "
               + _totals_text(per_kernel))
    return per_kernel


def _bank_attention(phase: str, run, dec_depth: int, iters: int, backward: bool = True) -> dict:
    """The multi-view decoder's masked cross-attention over the shared bank
    (RoPE on q and k, logits, mask, softmax, the weighted sum; the plain
    path), on the inputs one ``run`` gives it: device ms per forward, and,
    with ``backward``, of its forward and backward together per train step
    (the projections around it excluded)."""
    import siu3r_tpu_torch.models.layers as L

    with torch.no_grad(), _recorded(L, "rope_attention", keep=lambda a: a["mask"] is not None) as calls:
        run()
    if len(calls) != 2 * dec_depth:
        raise AssertionError(f"{phase}: {len(calls)} masked bank attentions, expected {2 * dec_depth}")
    shapes = _distinct(calls, lambda c: (tuple(c["q"].shape), tuple(c["k"].shape)))
    fwd_ms = train_ms = logits_bytes = 0.0
    for (qs, ks), (c, n) in shapes.items():
        args = {key: x.detach() if isinstance(x, torch.Tensor) else x for key, x in c.items() if key != "out"}
        ms = time_ms(lambda: L.rope_attention(**args), iters, whole=True, events=False)[0]
        leaves = {key: args[key].clone().requires_grad_(True) for key in ("q", "k", "v")}
        cot = torch.randn(qs, device="cuda", dtype=args["q"].dtype)

        def fwd_bwd():
            out = L.rope_attention(**{**args, **leaves})
            return torch.autograd.grad(out, list(leaves.values()), cot)

        both_ms = time_ms(fwd_bwd, max(3, iters // 2), whole=True, events=False)[0] if backward else math.nan
        fwd_ms += n * ms
        train_ms += n * both_ms
        logits_bytes = max(logits_bytes, 4.0 * qs[0] * qs[1] * qs[2] * ks[2])
        log(phase, f"bank attention q {qs} k {ks} x{n}: {ms:.4f} ms forward"
                   + (f", {both_ms:.4f} ms forward and backward" if backward else ""))
    return dict(fwd_ms=fwd_ms, train_ms=train_ms, calls=len(calls), largest_logits_mb=logits_bytes / 1e6)


def _forward(phase: str, cfg) -> dict:
    """The full-width forward over ``cfg.num_views`` views at 256x256: launch
    counts against the model's call sites (every MSDA launch staged), no host
    sync, shapes and finite outputs, then 12 warm forwards timed. With more
    than two views, also the model kernels held against their plain versions
    on the forward's own inputs and the bank attention's device time."""
    from siu3r_tpu_torch.models.model import build_model

    views = cfg.num_views
    model = build_model(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    images, intr = _view_inputs(views)
    run = lambda: model(images, intr, enable_query_class_logit_lift=True)

    with torch.inference_mode():
        expected = expected_launches(cfg)
        out = _counted_run(phase, run, expected)
        g = out.gaussians
        hw = views * 256 * 256
        m2f = cfg.mask2former
        shapes = {"means": (1, hw, 3), "covariances": (1, hw, 3, 3),
                  "harmonics": (1, hw, 3, (cfg.gaussian_head.sh_degree + 1) ** 2), "opacities": (1, hw),
                  "seg_query_class_logits": (1, hw, m2f.max_lift_queries, m2f.num_labels + 1)}
        for f, shape in shapes.items():
            if tuple(getattr(g, f).shape) != shape:
                raise AssertionError(f"{phase}: {f} shape {tuple(getattr(g, f).shape)} != {shape}")
        for name, t in {**_floats(out), "pts3d": out.pts3d, "qc_mask": out.post["qc_mask_probs"]}.items():
            if not torch.isfinite(t).all():
                raise AssertionError(f"{phase}: forward output {name} is not finite")
        labels = g.semantic_labels
        if int(labels.min()) < 0 or int(labels.max()) > cfg.mask2former.num_labels:
            raise AssertionError(f"{phase}: semantic labels out of range")
        del out, g, labels
        res = dict(params=n_params, launches=expected, **_timed_runs(run, 12))
    log(phase, f"ViT-L {views}-view 256x256 B=1 fp32, {n_params} params: launches {expected} (expected), "
               f"no host sync, outputs finite; {_timing_text(res, 'forwards')}")
    for name, ms in res["top_device_ms"][:8]:
        log(phase, f"  device {ms:8.3f} ms  {name[:100]}")
    if views > 2:
        with torch.inference_mode():
            res["kernels"] = _check_model_kernels(phase, run, 20)
        res["bank"] = bank = _bank_attention(phase, run, cfg.croco.dec_depth, 20)
        bank["fwd_share"] = bank["fwd_ms"] / res["device_ms"]
        log(phase, f"bank attention ({bank['calls']} calls, the plain path): {bank['fwd_ms']:.3f} ms per forward "
                   f"= {bank['fwd_share']:.4f} of the forward's device time; forward and backward "
                   f"{bank['train_ms']:.3f} ms per train step; largest logits {bank['largest_logits_mb']:.1f} MB")
    if phase in BF16_TWINS:  # the bf16 phase of the same path takes the model
        _KEPT[phase] = (model, res)
    del model
    torch.cuda.empty_cache()
    return res


# the fp32 phases' models (or pipelines) and results, each taken by the bf16
# phase of its path, which runs next: the bf16 path computes on the same
# weights, switched with ``set_compute_dtype`` (no second random init)
_KEPT: dict = {}
BF16_TWINS = ("forward", "eval", "train", "multi_forward")  # the fp32 phases with a bf16 phase after them


def _fp32_model(fp32_phase: str, build):
    """The model (or pipeline) and result that ``fp32_phase`` kept, or, when
    it did not run, ``build()``'s (the same seed: the same weights) and no
    result."""
    kept = _KEPT.pop(fp32_phase, None)
    return kept if kept else (build(), None)


def _against_fp32(phase: str, out, ref) -> dict:
    """The bf16 output against the fp32 one on the same weights and inputs,
    with the JAX package's own bounds: Gaussian means within a mean relative
    error of ORACLE_MEANS_REL, at least ORACLE_LABELS of the labels equal."""
    m16, m32 = out.gaussians.means.float(), ref.gaussians.means.float()
    means_rel = ((m16 - m32).abs().mean() / m32.abs().mean()).item()
    labels = (out.post["segmentation"] == ref.post["segmentation"]).float().mean().item()
    if not means_rel < ORACLE_MEANS_REL or labels < ORACLE_LABELS:
        raise AssertionError(f"{phase}: bf16 against fp32 on the same weights: means mean rel err {means_rel:.4g} "
                             f"(limit {ORACLE_MEANS_REL}), labels equal {labels:.5f} (limit {ORACLE_LABELS})")
    return dict(means_rel=means_rel, labels_equal=labels)


def _beside(res: dict, ref: dict | None) -> str:
    if ref is None:
        return "the fp32 phase did not run in this call"
    return (f"fp32: median {ref['median_s'] * 1e3:.2f} ms, device {ref['device_ms']:.2f} ms, idle "
            f"{ref['idle_share']:.3f}, peak {ref['peak_gib']:.3f} GiB, GEMMs {ref['gemm_ms']:.3f} ms, convolutions "
            f"{ref['conv_ms']:.3f} ms; bf16/fp32 device {res['device_ms'] / ref['device_ms']:.3f}")


def _bf16_forward(phase: str, cfg, fp32_phase: str) -> dict:
    """The full-width forward of ``cfg`` in bf16 on the weights of the fp32
    phase ``fp32_phase`` (its model, switched): the fp32 output first, then
    launch counts (kernel 1b for every unmasked backbone attention, no fp32
    ``flash_attn_rope``), no host sync, finite outputs, the bf16 output
    against the fp32 one (``_against_fp32``), 12 warm forwards timed beside
    the fp32 phase's; the model kernels held against their plain versions
    on the forward's own inputs; with more than two views the bank
    attention (the bf16 plain path)."""
    from siu3r_tpu_torch.models.model import build_model, set_compute_dtype

    model, ref_res = _fp32_model(fp32_phase, lambda: build_model(cfg, device="cuda", seed=0))
    views = cfg.num_views
    images, intr = _view_inputs(views)
    run = lambda: model(images, intr, enable_query_class_logit_lift=True)
    with torch.inference_mode():
        ref = run()
        set_compute_dtype(model, "bfloat16")
        expected = expected_launches(model.cfg)
        out = _counted_run(phase, run, expected)
        for name, t in {**_floats(out), "pts3d": out.pts3d, "qc_mask": out.post["qc_mask_probs"]}.items():
            if not torch.isfinite(t).all():
                raise AssertionError(f"{phase}: forward output {name} is not finite")
        against = _against_fp32(phase, out, ref)
        del out, ref
        res = dict(launches=expected, **against, **_timed_runs(run, 12))
    log(phase, f"ViT-L {views}-view 256x256 B=1 bf16 compute (fp32 parameters, the fp32 phase's weights): launches "
               f"{expected} (expected), no host sync, outputs finite; against fp32: means mean rel err "
               f"{against['means_rel']:.4g} (limit {ORACLE_MEANS_REL}), labels equal {against['labels_equal']:.5f} "
               f"(limit {ORACLE_LABELS}); {_timing_text(res, 'forwards')}; {_beside(res, ref_res)}")
    for name, ms in res["top_device_ms"][:8]:
        log(phase, f"  device {ms:8.3f} ms  {name[:100]}")
    with torch.inference_mode():
        res["kernels"] = _check_model_kernels(phase, run, 20)
    if views > 2:
        # forward only: the bf16 path does not train
        res["bank"] = bank = _bank_attention(phase, run, cfg.croco.dec_depth, 20, backward=False)
        log(phase, f"bank attention ({bank['calls']} calls, the bf16 plain path): {bank['fwd_ms']:.3f} ms per "
                   f"forward (fp32: {'not run' if ref_res is None else format(ref_res['bank']['fwd_ms'], '.3f')})")
    del model
    torch.cuda.empty_cache()
    return res


def phase_bf16_forward() -> dict:
    return _bf16_forward("bf16_forward", two_view_cfg().pipeline.model, "forward")


def phase_bf16_multi_forward() -> dict:
    return _bf16_forward("bf16_multi_forward", multi_cfg().pipeline.model, "multi_forward")


def phase_forward() -> dict:
    return _forward("forward", two_view_cfg().pipeline.model)


def phase_multi_forward() -> dict:
    return _forward("multi_forward", multi_cfg().pipeline.model)


# ---------------------------------------------------------------- phase 6

N_TARGET = 6  # 2 context + 4 extra target views, as the validation CLI sets


@contextlib.contextmanager
def _render_calls():
    """Record the rasterizer's binning and raster calls inside the block:
    {"bin": [call], "raster": [call]}, each call as ``_recorded`` keeps it."""
    import siu3r_tpu_torch.render.rasterizer as R

    with _recorded(R, "bin_gaussians") as bins, _recorded(R, "raster") as rasters:
        yield {"bin": bins, "raster": rasters}


def _eval(phase: str, cfg, n_target: int) -> dict:
    """``Pipeline.eval_step`` at full width over ``cfg``'s views and
    ``n_target`` target views: launch counts, no host sync, shapes, finite
    and covered renders, then 12 warm steps timed; the binning and raster
    kernels held against their plain versions on the step's own inputs."""
    from siu3r_tpu_torch.pipeline import Pipeline, lift_rendered_qc

    pipe = Pipeline(cfg, device="cuda", seed=0)
    mcfg = cfg.pipeline.model
    views = mcfg.num_views
    images, intr = _view_inputs(views)
    with torch.inference_mode():
        means = pipe.model(images, intr).gaussians.means
    batch = _eval_batch(images, intr, _target_views(means, n_target, views))
    run = lambda: pipe.eval_step(batch)

    # one binning for every target view; one raster launch for the RGB set
    # (C = 3) and one for the 16 query-class channels
    expected = {**expected_launches(mcfg), "bin": 1, "raster": 2}
    out, render, qc = _counted_run(phase, run, expected)
    n_slots, n_cls = mcfg.mask2former.max_lift_queries, mcfg.mask2former.num_labels + 1
    shapes = {"color": (render.color, (1, n_target, 256, 256, 3)), "depth": (render.depth, (1, n_target, 256, 256)),
              "alpha": (render.alpha, (1, n_target, 256, 256)),
              "qc": (qc, (1, n_target, n_slots, n_cls, 256, 256))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{phase}: eval step {name}: shape {tuple(t.shape)} (expected {shape}) or not finite")
    coverage = render.alpha.mean().item()
    if coverage < MIN_COVERAGE:
        raise AssertionError(f"{phase}: eval step: the target views see almost nothing (mean alpha {coverage})")
    sem, ins = lift_rendered_qc(qc, out.gaussians.seg_query_scores, num_queries=mcfg.mask2former.num_queries)
    if tuple(sem.shape) != (1, n_target, 256, 256) or int(sem.min()) < 0 or int(sem.max()) >= n_cls:
        raise AssertionError(f"{phase}: lifted semantic ids out of shape or range")
    del out, render, qc, sem, ins

    res = dict(launches=expected, mean_alpha=coverage, **_timed_runs(run, 12))
    log(phase, f"Pipeline.eval_step, ViT-L {views}-view 256x256 B=1 fp32 + {n_target} target views: launches "
                f"{expected} (expected), no host sync, outputs finite, mean alpha {coverage:.3f}; "
                f"{_timing_text(res, 'steps')}")
    for name, ms in res["top_device_ms"][:12]:
        log(phase, f"  device {ms:8.3f} ms  {name[:100]}")

    # the binning and raster kernels on the step's own inputs
    with _render_calls() as calls:
        run()
    if len(calls["bin"]) != 1 or len(calls["raster"]) != 2:
        raise AssertionError(f"{phase}: recorded {len(calls['bin'])} binning and {len(calls['raster'])} raster calls")
    proj, kcap = calls["bin"][0]["proj"], calls["bin"][0]["max_per_tile"]
    res["bin"] = check_bin(f"{phase}_step", proj, kcap, 20)
    res["raster"] = [check_raster(f"{phase}_step_C{c['colors'].shape[-1]}", c["table"], c["counts"], c["params"],
                                  c["colors"], 20) for c in calls["raster"]]
    occ = res["bin"]
    log(phase, f"tile occupancy: mean count {occ['mean_count']:.1f} of K={kcap}, share of tiles at K "
                f"{occ['at_k']:.3f}, chunks swept per live tile {res['raster'][0]['mean_swept']:.2f} "
                f"of {kcap // 128}, share of live tiles swept to their count {res['raster'][0]['full_sweeps']:.3f}")
    del calls, proj
    if phase in BF16_TWINS:  # the bf16 phase of the same path takes the pipeline
        _KEPT[phase] = (pipe, res)
    del pipe
    torch.cuda.empty_cache()
    return res


def phase_bf16_eval() -> dict:
    """``Pipeline.eval_step`` at full width, two views and 6 targets, in bf16
    on the weights of phase eval's pipeline (switched): the fp32 step first,
    then launch counts, no host sync, shapes, finite and covered renders, the
    step's Gaussians and labels against the fp32 step's (``_against_fp32``),
    12 warm steps timed beside phase eval's."""
    from siu3r_tpu_torch.models.model import set_compute_dtype
    from siu3r_tpu_torch.pipeline import Pipeline

    phase = "bf16_eval"
    pipe, ref_res = _fp32_model("eval", lambda: Pipeline(two_view_cfg(), device="cuda", seed=0))
    views = pipe.model.cfg.num_views
    images, intr = _view_inputs(views)
    with torch.inference_mode():
        means = pipe.model(images, intr).gaussians.means
    batch = _eval_batch(images, intr, _target_views(means, N_TARGET, views))
    ref = pipe.eval_step(batch)
    set_compute_dtype(pipe.model, "bfloat16")
    run = lambda: pipe.eval_step(batch)
    expected = {**expected_launches(pipe.model.cfg), "bin": 1, "raster": 2}
    out, render, qc = _counted_run(phase, run, expected)
    for name, t in (("color", render.color), ("depth", render.depth), ("alpha", render.alpha), ("qc", qc),
                    *_floats(out).items()):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{phase}: eval step {name} not finite")
    if tuple(render.color.shape) != (1, N_TARGET, 256, 256, 3):
        raise AssertionError(f"{phase}: render shape {tuple(render.color.shape)}")
    coverage = render.alpha.mean().item()
    if coverage < MIN_COVERAGE:
        raise AssertionError(f"{phase}: eval step: the target views see almost nothing (mean alpha {coverage})")
    against = _against_fp32(phase, out, ref[0])
    del out, render, qc, ref
    res = dict(launches=expected, mean_alpha=coverage, **against, **_timed_runs(run, 12))
    log(phase, f"Pipeline.eval_step, ViT-L {views}-view 256x256 B=1 bf16 compute + {N_TARGET} target views: "
               f"launches {expected} (expected), no host sync, outputs finite, mean alpha {coverage:.3f}; against "
               f"the fp32 step: means mean rel err {against['means_rel']:.4g}, labels equal "
               f"{against['labels_equal']:.5f}; {_timing_text(res, 'steps')}; {_beside(res, ref_res)}")
    for name, ms in res["top_device_ms"][:8]:
        log(phase, f"  device {ms:8.3f} ms  {name[:100]}")
    del pipe
    torch.cuda.empty_cache()
    return res


def phase_eval() -> dict:
    return _eval("eval", two_view_cfg(), N_TARGET)


def phase_multi_eval() -> dict:
    cfg = multi_cfg()
    return _eval("multi_eval", cfg, multi_targets(cfg))


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


def _train_small(phase: str, dtype: str = "float32") -> None:
    """(a) The small config's train step computing in ``dtype`` on the GPU
    (kernels) against the CPU (plain versions) with the same weights and
    sample points: every loss term, then the render loss's gradient on the
    step's own Gaussians. In bf16 a term is held within the larger of
    BF16_TRAIN_FRACTION of the CPU's own bf16-vs-fp32 difference on those
    weights and SLICE_RTOL, or, downstream of Mask2Former's masked
    attention (``_follows_masks``), within BF16_MASKED_RTOL."""
    from siu3r_tpu_torch.config import PipelineCfg, RootCfg
    from siu3r_tpu_torch.models.model import set_compute_dtype
    from siu3r_tpu_torch.pipeline import Pipeline

    root = RootCfg(pipeline=PipelineCfg(model=_small_cfg(dtype=dtype)))
    gpu = Pipeline(root, device="cuda", seed=7).init_train(steps_per_epoch=10)
    cpu = Pipeline(root, device="cpu", seed=0).init_train(steps_per_epoch=10)
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    state = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(1, 2, 64, 64, 3).astype(np.float32))
    intr = torch.tensor([[1.24, 0, 0.5], [0, 1.24, 0.5], [0, 0, 1]]).expand(1, 2, 3, 3).contiguous()
    with torch.no_grad():
        set_compute_dtype(cpu.model, "float32")
        means = cpu.model.train()(images, intr).gaussians.means
        set_compute_dtype(cpu.model, dtype)
        cpu.model.load_state_dict(state)
    batch = _train_batch(images, intr, _target_views(means, TRAIN_TARGETS), 6, 4,
                         root.pipeline.model.mask2former.num_labels, seed=1)
    inj = _injected_coords(root.pipeline.model, 1, 6, 2, "cpu", seed=2)
    _, lg = gpu.loss_fn({k: x.cuda() for k, x in batch.items()}, None,
                        injected_coords=[{k: x.cuda() for k, x in d.items()} for d in inj])
    _, lc = cpu.loss_fn(batch, None, injected_coords=inj)
    if dtype == "float32":
        tol = {key: (SLICE_RTOL * abs(float(ref.detach())), SLICE_ATOL) for key, ref in lc.items()}
    else:  # the CPU's fp32 terms on the same weights: the bf16-vs-fp32 difference
        cpu.model.load_state_dict(state)
        set_compute_dtype(cpu.model, "float32")
        _, l32 = cpu.loss_fn(batch, None, injected_coords=inj)
        lc32 = {key: float(x.detach()) for key, x in l32.items()}
        tol = {key: (max(BF16_TRAIN_FRACTION * abs(float(ref.detach()) - lc32[key]),
                         (BF16_MASKED_RTOL if _follows_masks(key) else SLICE_RTOL) * abs(float(ref.detach()))), 0.0)
               for key, ref in lc.items()}
    worst = 0.0
    for key, ref in lc.items():
        a, b = float(lg[key].detach()), float(ref.detach())
        excess = abs(a - b) - tol[key][0]
        worst = max(worst, excess)
        if not math.isfinite(a) or excess > tol[key][1]:
            raise AssertionError(f"{phase} slice: loss {key} {a} on cuda vs {b} on cpu beyond {tol[key]}")
    # the render loss's gradient on the GPU step's own Gaussians, copied to the CPU
    with torch.no_grad():
        g = gpu.model(*(batch[k].cuda() for k in ("context_views_images", "context_views_intrinsics"))).gaussians
    gg, coverage = _render_grads(g, {k: x.cuda() for k, x in batch.items()}, (64, 64))
    gc, _ = _render_grads(g.replace(**{f: getattr(g, f).cpu() for f in ("means", "covariances", "harmonics",
                                                                         "opacities")}), batch, (64, 64))
    if coverage < MIN_COVERAGE:
        raise AssertionError(f"{phase} slice: the target views see almost nothing (mean alpha {coverage})")
    errs = {}
    for key, a in gg.items():
        b = gc[key].double()
        errs[key] = ((a.cpu().double() - b).norm() / b.norm().clamp(min=1e-30)).item()
        if not bool(torch.isfinite(a).all()) or errs[key] > GRAD_REL_L2 or b.abs().max().item() == 0.0:
            raise AssertionError(f"{phase} slice: render gradient {key} relative L2 error {errs[key]} > "
                                 f"{GRAD_REL_L2} (cuda kernels vs cpu plain), or zero")
    rule = (f"rtol {SLICE_RTOL} atol {SLICE_ATOL}" if dtype == "float32" else
            f"max({BF16_TRAIN_FRACTION} x the cpu's bf16-vs-fp32 difference, rtol {SLICE_RTOL}; "
            f"{BF16_MASKED_RTOL} past the masked attention)")
    log(phase, f"small config in {dtype}: loss terms on cuda (kernels) vs cpu (plain) within {rule} (worst "
               f"excess {worst:.3g}): total {float(lg['total'].detach()):.5f}"
               + ("" if dtype == "float32" else ", each term's |cuda - cpu| / its cpu bf16-vs-fp32 difference "
                  + ", ".join(f"{k} {abs(float(lg[k].detach()) - float(lc[k].detach())) / max(abs(float(lc[k].detach()) - lc32[k]), 1e-30):.3g}"
                              for k in lc))
               + f"; render-loss gradient on the step's Gaussians (mean alpha {coverage:.3f}) relative L2 errors "
               + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))


def _follows_masks(key: str) -> bool:
    """A loss term that reads Mask2Former past its first masked attention:
    the criterion's terms of every layer but the first, and their sums."""
    return key in ("seg", "total") or (key.startswith("loss_") and not key.endswith("_0"))


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
    counts = calls["raster"][0]["counts"]
    _, _, alpha, swept = calls["raster"][0]["out"]
    live = counts > 0
    return alpha.mean().item(), swept[live].float().mean().item() if bool(live.any()) else 0.0


def _train(phase: str, cfg, n_target: int, steps: int, pipe=None) -> dict:
    """(b) ``Pipeline.train_step`` at full width over ``cfg``'s views and
    ``n_target`` target views (on ``pipe``, after its ``init_train``, else
    on a new pipeline of ``cfg``): launches per step, finite losses, the
    frozen encoder untouched and the trained parts moved; then ``steps``
    steps timed, each step's target cameras framing the Gaussians that step
    renders, with kernel 6 held against its plain version on a step's own
    inputs."""
    from siu3r_tpu_torch.kernels import _build
    from siu3r_tpu_torch.pipeline import Pipeline
    from siu3r_tpu_torch.train.optimizer import group_of

    if pipe is None:
        pipe = Pipeline(cfg, device="cuda", seed=0).init_train(steps_per_epoch=1000)
    mcfg = pipe.model.cfg
    views = mcfg.num_views
    images, intr = _view_inputs(views)

    def targets():
        # cameras framing the Gaussians of a train-mode forward of the current
        # weights, which the next step renders (each step moves them: the
        # heads start from a random init). Set-up: it syncs with the host and
        # updates the BatchNorms' running statistics.
        with torch.no_grad():
            return _target_views(pipe.model.train()(images, intr).gaussians.means, n_target, views)

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
        raise AssertionError(f"{phase}: train step launches {launches} != expected {expected}")
    check_variants(expected)
    losses = run()
    values = {key: float(x) for key, x in losses.items()}
    if not all(math.isfinite(x) for x in values.values()):
        raise AssertionError(f"{phase}: train step losses not finite: {values}")
    moved = {}
    for n, p in params.items():
        d = (p.detach() - before[n]).abs().max().item()
        group = "frozen" if group_of(n, True) == "frozen" else n.split(".")[0]
        moved[group] = max(moved.get(group, 0.0), d)
    if moved["frozen"] != 0.0:
        raise AssertionError(f"{phase}: the frozen encoder moved by {moved['frozen']}")
    for part in ("mask2former", "adapter", "gaussian_param_head1", "gaussian_param_head2"):
        if not moved.get(part, 0.0) > 0.0:
            raise AssertionError(f"{phase}: {part} did not move: {moved}")
    del before

    # timed steps, each framed before its clock starts; every one must see
    # the scene and composite real work (MIN_COVERAGE, MIN_SWEPT)
    times, occupancy = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
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
        raise AssertionError(f"{phase}: timed train steps: mean alpha {alphas}, chunks swept per live tile {swepts}: "
                             f"below {MIN_COVERAGE} or {MIN_SWEPT}")
    frame()
    device_ms, top = _device_breakdown(run, 1)
    kinds = {"gemm": 0.0, "conv": 0.0}
    for name, ms in top:
        if _kernel_kind(name):
            kinds[_kernel_kind(name)] += ms
    med = statistics.median(times)
    res = dict(launches=launches, median_s=med, min_s=min(times), max_s=max(times), per_s=1.0 / med,
               peak_gib=peak / 2**30, device_ms=device_ms, idle_share=1.0 - device_ms / (med * 1e3),
               top_device_ms=top[:20], gemm_ms=kinds["gemm"], conv_ms=kinds["conv"], host_syncs=n_syncs,
               sync_sources=sync_sources, lap_syncs=lap_syncs, losses=values, moved=moved,
               step=pipe.optimizer.count, mean_alpha=list(alphas), swept_per_live_tile=list(swepts))
    log(phase, f"Pipeline.train_step, ViT-L {views}-view 256x256 B=1 {mcfg.dtype} compute, {n_target} target views, "
               f"{N_OBJECTS} objects ({N_VALID} valid): launches {launches} (expected), losses finite "
               f"({', '.join(f'{k} {values[k]:.4f}' for k in ('seg', 'depth_smoothness', 'render_mse', 'lpips', 'total'))}), "
               f"frozen encoder unchanged, moved {({k: round(v, 8) for k, v in moved.items()})}")
    log(phase, f"median of {len(times)} warm steps {med * 1e3:.2f} ms (min {min(times) * 1e3:.2f}, max "
               f"{max(times) * 1e3:.2f}) = {1.0 / med:.3f} steps/s, peak memory {peak / 2**30:.3f} GiB; device "
               f"busy {device_ms:.2f} ms per step, idle share {res['idle_share']:.3f}; GEMMs {kinds['gemm']:.3f} "
               f"ms, convolutions {kinds['conv']:.3f} ms; host syncs per step "
               f"{n_syncs} (the LAP's convergence tests {lap_syncs}; sources {sync_sources}); per timed step "
               f"mean alpha {[round(a, 3) for a in alphas]}, chunks swept per live tile "
               f"{[round(x, 2) for x in swepts]}")
    for name, ms in top[:12]:
        log(phase, f"  device {ms:8.3f} ms  {name[:100]}")

    # the render kernels on a framed step's own inputs
    frame()
    with _render_calls() as calls:
        run()
    if len(calls["bin"]) != 1 or len(calls["raster"]) != 1:
        raise AssertionError(f"{phase}: recorded {len(calls['bin'])} binning and {len(calls['raster'])} raster calls")
    table, counts, rparams, colors = (calls["raster"][0][k].detach() for k in ("table", "counts", "params", "colors"))
    coverage, swept = _occupancy(calls)
    if coverage < MIN_COVERAGE or swept < MIN_SWEPT:
        raise AssertionError(f"{phase}: train step: mean alpha {coverage}, chunks swept per live tile {swept}")
    res["raster"] = check_raster(f"{phase}_step_C3", table, counts, rparams, colors, 20)
    res["raster_bwd"] = check_raster_bwd(f"{phase}_step_C3", table, counts, rparams, colors, 10,
                                         torch.Generator(device="cuda").manual_seed(5))
    log(phase, f"render of the checked step: mean alpha {coverage:.3f}, chunks swept per live tile "
               f"{swept:.2f}, saturating tiles {res['raster_bwd']['saturating_tiles']}; "
               f"{_spread_text(res['raster_bwd']['spread'])}; the step's render kernels: raster "
               f"{res['raster']['ms']:.5f} ms (bound {res['raster']['bound_ms']:.5f}), raster_bwd "
               f"{res['raster_bwd']['ms']:.5f} ms (bound {res['raster_bwd']['bound_ms']:.5f})")
    del calls, batch
    if phase in BF16_TWINS:  # the bf16 phase of the same path takes the pipeline
        _KEPT[phase] = (pipe, res)
    del pipe
    torch.cuda.empty_cache()
    return res


def phase_train() -> dict:
    _train_small("train")
    return _train("train", two_view_cfg(), TRAIN_TARGETS, 8)


def phase_bf16_train() -> dict:
    """The train step in bf16: the small config's slice, then the full-width
    step on phase train's pipeline (its weights after its steps, switched
    with ``set_compute_dtype``; its optimizer goes on: fresh moments would
    move every weight by about a learning rate at once, and the first timed
    step's render dropped to a mean alpha of 0.099), 4 steps timed after 2
    warm-up steps, beside phase train's figures."""
    from siu3r_tpu_torch.models.model import set_compute_dtype
    from siu3r_tpu_torch.pipeline import Pipeline

    _train_small("bf16_train", "bfloat16")
    pipe, ref_res = _fp32_model(
        "train", lambda: Pipeline(two_view_cfg(), device="cuda", seed=0).init_train(steps_per_epoch=1000))
    set_compute_dtype(pipe.model, "bfloat16")
    res = _train("bf16_train", two_view_cfg(), TRAIN_TARGETS, 4, pipe=pipe)
    log("bf16_train", _beside(res, ref_res))
    return res


def phase_multi_train() -> dict:
    cfg = multi_cfg()
    return _train("multi_train", cfg, multi_targets(cfg), 6)


# ---------------------------------------------------------------- phase 7


def _cli_forward(images: np.ndarray):
    """The CLIs' forward rebuilt here (their config for images [1, V, ...],
    the same seed, the default intrinsics) -> host Gaussians."""
    from siu3r_tpu_torch.cli.inference import model_cfg
    from siu3r_tpu_torch.models.model import build_model

    views = images.shape[1]
    model = build_model(model_cfg(views), device="cuda", seed=0)
    k = torch.tensor([[318 / 256, 0, 0.5], [0, 318 / 256, 0.5], [0, 0, 1]], device="cuda")
    with torch.inference_mode():
        out = model(torch.from_numpy(images).cuda(), k.expand(1, views, 3, 3).contiguous(),
                    enable_query_class_logit_lift=True)
    return out.gaussians.to_host()


def _synthetic_images(directory: Path, n: int, seed: int) -> list:
    """n seeded 240x320 RGB images written as PNGs; their paths."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        paths.append(directory / f"view{i}.png")
        Image.fromarray((rng.rand(240, 320, 3) * 255).astype(np.uint8)).save(paths[-1])
    return paths


def _run_cli(phase: str, module: str, *args: str) -> None:
    """``python -m module args`` in its own process, from the checkout's root."""
    cli = subprocess.run([sys.executable, "-m", module, *args], cwd=Path(__file__).resolve().parent,
                         capture_output=True, text=True, timeout=600)
    for line in cli.stdout.splitlines():
        log(phase, line)
    if cli.returncode != 0:
        raise RuntimeError(f"{module} exited {cli.returncode}:\n{cli.stderr[-4000:]}")


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
    from siu3r_tpu_torch.cli import inference
    from siu3r_tpu_torch.io import read_ply

    with tempfile.TemporaryDirectory() as tmp:
        paths = _synthetic_images(Path(tmp), 2, seed=3)
        out_dir = Path(tmp) / "out"
        _run_cli("cli", "siu3r_tpu_torch.cli.inference", "--image_path1", str(paths[0]),
                 "--image_path2", str(paths[1]), "--output_path", str(out_dir))
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


def phase_multi_cli() -> None:
    """``python -m siu3r_tpu_torch.cli.inference_multiview`` (its own
    process) on a directory of synthetic images, one for each view of
    ``multi_cfg``, to ``output.ply``, read back and held against the
    reference schema and this process's forward."""
    from siu3r_tpu_torch.cli import inference
    from siu3r_tpu_torch.io import read_ply

    with tempfile.TemporaryDirectory() as tmp:
        image_dir = Path(tmp) / "views"
        image_dir.mkdir()
        views = multi_cfg().pipeline.model.num_views
        paths = _synthetic_images(image_dir, views, seed=8)
        out_dir = Path(tmp) / "out"
        _run_cli("multi_cli", "siu3r_tpu_torch.cli.inference_multiview", "--image_dir", str(image_dir),
                 "--output_path", str(out_dir))
        ply = read_ply(out_dir / "output.ply")
        if len(ply["x"]) != views * 256 * 256:
            raise AssertionError(f"multi_cli: output.ply holds {len(ply['x'])} vertices, not {views} x 256 x 256")
        images = np.stack([inference.preprocess_image(p) for p in sorted(paths)])[None]
        agree = check_ply(ply, _cli_forward(images))
        log("multi_cli", f"siu3r_tpu_torch.cli.inference_multiview wrote output.ply: {len(ply['x'])} vertices "
                         f"({views} views), {len(ply)} properties in the reference schema, equal to the "
                         f"model's outputs (labels agree {agree:.5f})")


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


# ---------------------------------------------------------------- phases 14-18: the refer path

REFER_WORDS, REFER_TOKENS = 8, 32  # configs/scanrefer.yaml's max_objects; the ScanRefer dataset's max_tokens
REFER_TRAIN_BATCH = 3  # configs/scanrefer.yaml's loader batch, on one card
REFER_CLI_ITEMS = 2


def refer_cfg():
    """The repo's referring-expression config, ``configs/scanrefer.yaml``
    (ViT-L, two views at 256x256, 100 queries, vocabulary 49408), with the
    ScanNet classes."""
    from siu3r_tpu_torch.config import bind_scannet_classes, load_config

    return bind_scannet_classes(load_config(Path(__file__).resolve().parent / "configs" / "scanrefer.yaml"))


def _refer_batch(images, intr, n_objects: int, n_tokens: int, vocab: int, n_classes: int, seed: int) -> dict:
    """A ScanRefer batch on the images' device: seeded binary masks, every
    object valid and referred to by one expression of 1 to ``n_tokens``
    tokens (0 pads the rest), word i for object i."""
    b, v, h, w, _ = images.shape
    dev = images.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    lengths = torch.randint(1, n_tokens + 1, (b, n_objects, 1), device=dev, generator=gen)
    tokens = torch.randint(1, vocab, (b, n_objects, n_tokens), device=dev, generator=gen, dtype=torch.int32)
    return {
        "context_views_images": images,
        "context_views_intrinsics": intr,
        "gt_masks": (torch.rand(b, n_objects, v, h, w, device=dev, generator=gen) > 0.7).float(),
        "gt_classes": torch.randint(0, n_classes, (b, n_objects), device=dev, generator=gen, dtype=torch.int32),
        "gt_valid": torch.ones(b, n_objects, dtype=torch.bool, device=dev),
        "text_token": torch.where(torch.arange(n_tokens, device=dev) < lengths, tokens, torch.zeros_like(tokens)),
    }


def _excess(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| beyond SLICE_RTOL x |b|, in float64 on the CPU."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return ((a - b).abs() - SLICE_RTOL * b.abs()).max().item()


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def phase_refer_slice() -> None:
    """The small config with the language layers on the GPU (kernels) against
    the same weights on the CPU (plain versions): ``seg_forward``'s logits
    and word logits, ``refer_eval_step``'s masks, and the refer loss with
    its gradients of the text embedding and the language layers."""
    from siu3r_tpu_torch.config import PipelineCfg, RootCfg
    from siu3r_tpu_torch.pipeline import Pipeline

    mcfg = _small_cfg(2)
    mcfg.mask2former.train_refer_segmentation = True
    mcfg.mask2former.text_vocab_size = 64
    root = RootCfg(pipeline=PipelineCfg(model=mcfg))
    gpu = Pipeline(root, device="cuda", seed=7).init_train(steps_per_epoch=10, lpips_enabled=False)
    cpu = Pipeline(root, device="cpu", seed=0).init_train(steps_per_epoch=10, lpips_enabled=False)
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(1, 2, 64, 64, 3).astype(np.float32))
    intr = torch.tensor([[1.24, 0, 0.5], [0, 1.24, 0.5], [0, 0, 1]]).expand(1, 2, 3, 3).contiguous()
    batch = _refer_batch(images, intr, 4, 6, 64, mcfg.mask2former.num_labels, seed=2)
    gbatch = {k: x.cuda() for k, x in batch.items()}
    inputs = lambda bt: (bt["context_views_images"], bt["context_views_intrinsics"])

    with torch.inference_mode():
        sg, _ = gpu.model.eval().seg_forward(*inputs(gbatch), text_tokens=gbatch["text_token"])
        sc, _ = cpu.model.eval().seg_forward(*inputs(batch), text_tokens=batch["text_token"])
    worst = {}
    for key in ("class_queries_logits", "masks_queries_logits", "word_logits"):
        a = getattr(sg, key)
        worst[key] = _excess(a, getattr(sc, key))
        if not bool(torch.isfinite(a).all()) or worst[key] > SLICE_ATOL:
            raise AssertionError(f"refer_slice: seg_forward {key} differs by {worst[key]} beyond rtol {SLICE_RTOL} "
                                 f"atol {SLICE_ATOL}")
    mg, wg = gpu.refer_eval_step(gbatch)
    mc, _ = cpu.refer_eval_step(batch)
    agree = (mg.cpu() == mc).float().mean().item()
    if agree < LABEL_AGREEMENT or tuple(mg.shape) != (1, 4, 2, 64, 64):
        raise AssertionError(f"refer_slice: eval masks {tuple(mg.shape)} agree on {agree:.5f} < {LABEL_AGREEMENT}")

    coords = torch.rand(1, 1024, 2, generator=torch.Generator().manual_seed(3))
    lg, _ = gpu.refer_loss_fn(gbatch, None, injected_coords=coords.cuda())
    lc, _ = cpu.refer_loss_fn(batch, None, injected_coords=coords)
    lg.backward()
    lc.backward()
    lg, lc = float(lg.detach()), float(lc.detach())
    if not math.isfinite(lg) or abs(lg - lc) - SLICE_RTOL * abs(lc) > SLICE_ATOL:
        raise AssertionError(f"refer_slice: refer loss {lg} on cuda vs {lc} on cpu")
    cpu_params = dict(cpu.model.named_parameters())
    errs = {}
    for name, p in gpu.model.named_parameters():
        if name.startswith(("text_embed.", "mask2former.lang_")):
            ref = cpu_params[name].grad
            errs[name] = _rel_l2(p.grad, ref)
            if ref.abs().max().item() == 0.0 or errs[name] > GRAD_REL_L2:
                raise AssertionError(f"refer_slice: gradient {name} relative L2 error {errs[name]} > {GRAD_REL_L2}, "
                                     "or zero")
    log("refer_slice", f"small refer config on cuda (kernels) vs cpu (plain): seg_forward within rtol {SLICE_RTOL} "
                       f"atol {SLICE_ATOL} (worst excess {worst}); refer_eval_step masks agree {agree:.5f}; refer "
                       f"loss {lg:.5f} vs {lc:.5f}; gradients of the {len(errs)} tensors of the text embedding and the "
                       f"language layers within relative L2 {GRAD_REL_L2} (worst {max(errs.values()):.3g})")


def _refer_inputs(cfg, batch: int, seed: int) -> dict:
    m2f = cfg.pipeline.model.mask2former
    images, intr = _view_inputs(2, seed=seed, batch=batch)
    return _refer_batch(images, intr, REFER_WORDS, REFER_TOKENS, m2f.text_vocab_size, m2f.num_labels, seed)


def phase_refer_forward() -> dict:
    """``seg_forward`` at the full width of configs/scanrefer.yaml, B = 1,
    8 expressions of up to 32 tokens: launch counts (the 6 language layers
    add 6 ``flash_attn`` launches; no render), no host sync, finite outputs
    of the expected shapes, 12 warm forwards timed; then the model kernels
    held against their plain versions on the forward's own inputs, the
    language layers' attention shape among them."""
    from siu3r_tpu_torch.models.model import build_model

    cfg = refer_cfg()
    mcfg = cfg.pipeline.model
    model = build_model(mcfg, device="cuda", seed=0)
    batch = _refer_inputs(cfg, 1, seed=4)
    run = lambda: model.seg_forward(batch["context_views_images"], batch["context_views_intrinsics"],
                                    text_tokens=batch["text_token"])
    expected = expected_launches(mcfg, words=True)
    shapes = {}
    with torch.inference_mode():
        seg, post = _counted_run("refer_forward", run, expected)
        q, n_cls = mcfg.mask2former.num_queries, mcfg.mask2former.num_labels + 1
        want = {"word_logits": (seg.word_logits, (1, REFER_WORDS, q)),
                "class_logits": (seg.class_queries_logits, (1, q, n_cls)),
                "mask_logits": (seg.masks_queries_logits, (1, q, 2, 64, 64)),
                "segmentation": (post["segmentation"], (1, 2, 256, 256))}
        for name, (t, shape) in want.items():
            if tuple(t.shape) != shape or not bool(torch.isfinite(t.float()).all()):
                raise AssertionError(f"refer_forward: {name} shape {tuple(t.shape)} (expected {shape}) or not finite")
        kept = int(post["keep"].sum())
        del seg, post
        res = dict(launches=expected, kept=kept, **_timed_runs(run, 12))
        log("refer_forward", f"seg_forward, ViT-L 2-view 256x256 B=1 fp32, {REFER_WORDS} expressions of up to "
                             f"{REFER_TOKENS} tokens: launches {expected} (expected), no host sync, outputs finite "
                             f"({kept} queries kept); {_timing_text(res, 'forwards')}")
        for name, ms in res["top_device_ms"][:8]:
            log("refer_forward", f"  device {ms:8.3f} ms  {name[:100]}")
        res["kernels"] = _check_model_kernels("refer_forward", run, 20, shapes)
    language = [(case, r) for case, r in shapes.items() if case[2] == REFER_WORDS]
    if len(language) != 1 or language[0][1]["launches"] != 6:
        raise AssertionError(f"refer_forward: language-layer attention shapes {[c for c, _ in language]}")
    case, lang = language[0]
    res["language_shape"] = dict(case=list(case[:5]), **{k: lang[k] for k in (
        "launches", "err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_fp32_ms", "blocks")})
    log("refer_forward", f"the language layers' attention {case[:5]}: max_abs_err {lang['err']:.3g}, "
                         f"{lang['ms']:.5f} ms a launch against a bound of {lang['bound_ms']:.5f} "
                         f"({lang['bound_by']}) and SDPA's {lang['library_ms']:.5f}")
    del model
    torch.cuda.empty_cache()
    return res


def phase_refer_eval() -> dict:
    """``Pipeline.refer_eval_step`` at full width, B = 1 (the batch of
    ``cli/validate_refer.py``): launch counts, no host sync, the masks'
    shape, then 12 warm steps timed."""
    from siu3r_tpu_torch.pipeline import Pipeline

    cfg = refer_cfg()
    pipe = Pipeline(cfg, device="cuda", seed=0)
    batch = _refer_inputs(cfg, 1, seed=5)
    run = lambda: pipe.refer_eval_step(batch)
    expected = expected_launches(cfg.pipeline.model, words=True)
    masks, word_logits = _counted_run("refer_eval", run, expected)
    q = cfg.pipeline.model.mask2former.num_queries
    if (tuple(masks.shape) != (1, REFER_WORDS, 2, 256, 256) or masks.dtype != torch.bool
            or tuple(word_logits.shape) != (1, REFER_WORDS, q) or not bool(torch.isfinite(word_logits).all())):
        raise AssertionError(f"refer_eval: masks {tuple(masks.shape)} {masks.dtype}, word logits "
                             f"{tuple(word_logits.shape)} or not finite")
    cover = masks.float().mean().item()
    res = dict(launches=expected, mask_share=cover, **_timed_runs(run, 12))
    log("refer_eval", f"Pipeline.refer_eval_step, ViT-L 2-view 256x256 B=1 fp32, {REFER_WORDS} expressions: launches "
                      f"{expected} (expected), no host sync, masks [1, {REFER_WORDS}, 2, 256, 256] ({cover:.3f} "
                      f"of pixels set); {_timing_text(res, 'steps')}")
    del pipe
    torch.cuda.empty_cache()
    return res


def phase_refer_train() -> dict:
    """``Pipeline.train_step`` on a refer batch at full width, B = 3 (the
    loader batch of configs/scanrefer.yaml; its 8-device data parallelism
    waits for the distributed slice), 8 objects, expressions of up to 32
    tokens: launch counts, a finite word-match loss, the text embedding and
    the language layers moved, the frozen encoder unchanged; then 6 steps
    timed with their host syncs, device busy time and peak memory."""
    from siu3r_tpu_torch.kernels import _build
    from siu3r_tpu_torch.pipeline import Pipeline
    from siu3r_tpu_torch.train.optimizer import group_of

    cfg = refer_cfg()
    pipe = Pipeline(cfg, device="cuda", seed=0).init_train(steps_per_epoch=1000, lpips_enabled=False)
    batch = _refer_inputs(cfg, REFER_TRAIN_BATCH, seed=6)
    step_gen = torch.Generator(device="cuda").manual_seed(1)
    run = lambda: pipe.train_step(batch, step_gen)
    params = dict(pipe.model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}

    for _ in range(2):  # warm-up: cuDNN algorithm choice, allocator
        run()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    n_syncs, sync_sources = _count_syncs(run)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    expected = expected_launches(cfg.pipeline.model, words=True)
    if launches != expected:
        raise AssertionError(f"refer_train: train step launches {launches} != expected {expected}")
    check_variants(expected)
    lap_syncs = sum(n for where, n in sync_sources.items() if "lap.py:" in where)
    values = {key: float(x) for key, x in run().items()}
    if set(values) != {"word_match", "total"} or not all(math.isfinite(x) for x in values.values()):
        raise AssertionError(f"refer_train: losses {values}")
    moved = {}
    for n, p in params.items():
        part = ("frozen" if group_of(n, True) == "frozen" else "lang" if n.startswith("mask2former.lang_")
                else n.split(".")[0])
        moved[part] = max(moved.get(part, 0.0), (p.detach() - before[n]).abs().max().item())
    del before
    if moved["frozen"] != 0.0:
        raise AssertionError(f"refer_train: the frozen encoder moved by {moved['frozen']}")
    for part in ("text_embed", "lang", "mask2former", "adapter"):
        if not moved.get(part, 0.0) > 0.0:
            raise AssertionError(f"refer_train: {part} did not move: {moved}")
    res = dict(launches=launches, losses=values, moved=moved, host_syncs=n_syncs, lap_syncs=lap_syncs,
               sync_sources=sync_sources, step=pipe.optimizer.count, **_timed_runs(run, 6))
    log("refer_train", f"Pipeline.train_step on a refer batch, ViT-L 2-view 256x256 B={REFER_TRAIN_BATCH} fp32, "
                       f"{REFER_WORDS} objects: launches {launches} (expected), word_match {values['word_match']:.4f}, "
                       f"frozen encoder unchanged, moved {({k: round(v, 8) for k, v in moved.items()})}; host syncs "
                       f"per step {n_syncs} (the LAP's {lap_syncs}; sources {sync_sources}); "
                       f"{_timing_text(res, 'steps')}")
    for name, ms in res["top_device_ms"][:12]:
        log("refer_train", f"  device {ms:8.3f} ms  {name[:100]}")
    del pipe, params, batch
    torch.cuda.empty_cache()
    return res


# the synthetic ScanRefer scene: (instance id, panoptic class) of each object,
# and the val pairs (context views, referred objects) that phase refer_cli reads
REFER_OBJECTS = ((7, 5), (9, 6), (11, 7), (13, 3))
REFER_PAIRS = (((0, 10), (7, 9, 11)), ((2, 12), (9, 13)))


def _scanrefer_root(root: Path, vocab: int, seed: int) -> None:
    """A ScanRefer val split at 256x256 in the layout the dataset reads
    (tests/test_refer.py's): one scene of 14 frames with colour, depth and
    panoptic PNGs (a wall and four objects), ``val_refer_seg_data.json`` with
    one or two tokenised expressions an object, ``val_refer_pair.json``."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    scan = root / "val" / "scene0000_00"
    for sub in ("color", "depth", "panoptic"):
        (scan / sub).mkdir(parents=True)
    np.savetxt(scan / "intrinsic.txt", np.array([[318.0, 0, 128], [0, 318, 128], [0, 0, 1]]))
    n, s = 14, 256
    for i in range(n):
        Image.fromarray((rng.rand(s, s, 3) * 255).astype(np.uint8)).save(scan / "color" / f"{i}.jpg")
        Image.fromarray((rng.rand(s, s) * 4000).astype(np.uint16)).save(scan / "depth" / f"{i}.png")
        seg = np.full((s, s), 1000, np.int64)  # the wall, instance 0
        shift = 4 * i
        boxes = ((0, 256, 128, 256), (160, 256, 0, 64), (16, 96, 16 + shift, 112 + shift), (180, 240, 80, 120))
        for (inst, cls), (y0, y1, x0, x1) in zip(REFER_OBJECTS, boxes):
            seg[y0:y1, x0:x1] = cls * 1000 + inst
        Image.fromarray(np.stack([seg % 256, (seg // 256) % 256, seg // 65536], -1).astype(np.uint8)).save(
            scan / "panoptic" / f"{i}.png")
    tokens = lambda: rng.randint(1, vocab, rng.randint(3, REFER_TOKENS + 1)).tolist()
    objects = {str(inst): {"panoptic_label_id": cls, "text": [f"object {inst}", f"the object {inst}"],
                           "text_token": [tokens(), tokens()]} for inst, cls in REFER_OBJECTS}
    frames = {str(i): [inst for inst, _ in REFER_OBJECTS] for i in range(n)}
    (root / "val_refer_seg_data.json").write_text(json.dumps({"scene0000_00": {"frame2object": frames,
                                                                                "objects": objects}}))
    (root / "val_refer_pair.json").write_text(json.dumps([
        {"scan": "scene0000_00", "context_views_id": list(views), "context_objects": list(objs)}
        for views, objs in REFER_PAIRS]))


def phase_refer_cli() -> dict:
    """``python -m siu3r_tpu_torch.cli.validate_refer`` (its own process) on a
    synthetic ScanRefer root at 256x256 with this process's weights
    (``--ckpt``), its JSON held against this process's ``refer_eval_step``
    and ``referred_mask_iou`` on the same items."""
    from siu3r_tpu_torch.cli import validate_refer
    from siu3r_tpu_torch.cli.train import build_dataset
    from siu3r_tpu_torch.eval.metrics import referred_mask_iou
    from siu3r_tpu_torch.pipeline import Pipeline

    here = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        cfg = refer_cfg()
        root = Path(tmp) / "scanrefer"
        _scanrefer_root(root, cfg.pipeline.model.mask2former.text_vocab_size, seed=9)
        cfg.datamodule.dataset_cfg.root = str(root)
        pipe = Pipeline(cfg, device="cuda", seed=3)  # not the CLI's own seed: the weights must come from --ckpt
        weights = Path(tmp) / "weights.pt"
        torch.save(pipe.model.state_dict(), weights)
        cli = subprocess.run([sys.executable, "-m", "siu3r_tpu_torch.cli.validate_refer", "--config",
                              str(here / "configs" / "scanrefer.yaml"), "--ckpt", str(weights), "--limit",
                              str(REFER_CLI_ITEMS), f"datamodule.dataset_cfg.root={root}"],
                             cwd=here, capture_output=True, text=True, timeout=600)
        if cli.returncode != 0:
            raise RuntimeError(f"validate_refer exited {cli.returncode}:\n{cli.stderr[-4000:]}")
        got = json.loads(cli.stdout[cli.stdout.index("{"):])
        dataset = build_dataset(cfg, train=False)
        ious = []
        for i in range(REFER_CLI_ITEMS):
            item = dataset[i]
            masks, _ = pipe.refer_eval_step({k: torch.from_numpy(item[k])[None].cuda()
                                             for k in validate_refer.BATCH_KEYS})
            ious.extend(referred_mask_iou(masks[0].cpu().numpy(), item["gt_masks"], item["gt_valid"])[1].tolist())
    want = dict(refer_miou=float(np.mean(ious)), num_referred=len(ious))
    if got["num_referred"] != want["num_referred"] or abs(got["refer_miou"] - want["refer_miou"]) > 1e-3:
        raise AssertionError(f"refer_cli: validate_refer gave {got}, this process {want}")
    log("refer_cli", f"siu3r_tpu_torch.cli.validate_refer on {REFER_CLI_ITEMS} synthetic ScanRefer items at "
                     f"256x256 with --ckpt: {got}; this process's refer_eval_step: refer_miou "
                     f"{want['refer_miou']:.6f} over {want['num_referred']} referred objects")
    del pipe
    torch.cuda.empty_cache()
    return got


# ---------------------------------------------------------------- phases 19-22: the validation sweep and training CLI

VAL_SCENES = 4  # the validate CLI's --limit, at batch 1
TRAIN_SCENES, SCENE_FRAMES = 6, 16  # B = 3: two steps an epoch
SCENE_SIZE = 256
TRAIN_CLI_STEPS = 4
CLI_ATOL = 1e-6
# each limit ten times the largest difference measured on an H100, rounded
# up to 1, 2 or 5 of its decade (PERF.md §6 lists the readings). The small
# sweep on the card against the CPU:
SWEEP_LIMITS = dict(psnr=5e-5, ssim=2e-5, lpips=2e-7, absrel=5e-8, rmse=5e-8)
# the validate CLI against this process's eval steps: a repeat in one process
# writes the same files bit for bit, two processes differ by one level in a
# few rgb pixels and by a few millimetres in depth pixels
PROCESS_LIMITS = dict(psnr=5e-5, ssim=2e-7, lpips=5e-9, absrel=5e-8, rmse=5e-8)
# the synthetic ScanNet scene: (panoptic class, instance) of each object
SCANNET_OBJECTS = ((1, 0), (2, 0), (4, 1), (5, 2), (6, 3), (7, 4))  # wall, floor, bed, chair, sofa, table


def sm_clock() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _scannet_root(root: Path, seed: int, colour: str = "jpg", train_scenes: int = TRAIN_SCENES,
                  scene: str = "scene{:04d}_00", iou_pt: bool = False, val: bool = True) -> None:
    """A ScanNet root at 256x256 in the layout the dataset reads
    (tests/test_cli_smoke.py's): ``train`` with ``train_scenes`` scenes and
    ``val`` with one, each of SCENE_FRAMES frames with colour (``colour``:
    jpg, or png as ScanNet++ stores it), 16-bit depth, extrinsics and
    panoptic PNGs (a wall, a floor and four objects of four thing classes,
    moving from frame to frame), an overlap table of 0.5 (inside ScanNet's
    and Replica's windows; ``iou.pt`` written by ``torch.save`` as the
    reference's data has it, else ``iou.npy``), and ``val_pair.json`` with
    VAL_SCENES pairs of 2 context and 6 target views (no val split where
    ``val`` is False). Scene i is named ``scene.format(i)``."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    s = SCENE_SIZE
    for split, n_scenes in (("train", train_scenes), ("val", 1 if val else 0)):
        for si in range(n_scenes):
            scan = root / split / scene.format(si)
            for sub in ("color", "depth", "extrinsic", "panoptic"):
                (scan / sub).mkdir(parents=True)
            np.savetxt(scan / "intrinsic.txt", np.array([[1.24 * s, 0, s / 2], [0, 1.24 * s, s / 2], [0, 0, 1]]))
            if iou_pt:
                torch.save(torch.full((100, 100), 0.5, dtype=torch.float64), scan / "iou.pt")
            else:
                np.save(scan / "iou.npy", np.full((100, 100), 0.5))
            for i in range(SCENE_FRAMES):
                Image.fromarray((rng.rand(s, s, 3) * 255).astype(np.uint8)).save(scan / "color" / f"{i}.{colour}")
                Image.fromarray((rng.rand(s, s) * 4000 + 500).astype(np.uint16)).save(scan / "depth" / f"{i}.png")
                ext = np.eye(4)
                ext[0, 3] = 0.01 * i  # a train pair is 10 to 15 frames apart: both see what _scored puts in front
                np.savetxt(scan / "extrinsic" / f"{i}.txt", ext)
                seg = np.zeros((s, s), np.int64)
                shift = 3 * i
                boxes = ((0, 160, 0, 256), (160, 256, 0, 256), (100, 200, 10 + shift, 90 + shift),
                         (40, 120, 120, 180), (170, 240, 150 + shift // 2, 230 + shift // 2), (20, 70, 20, 100))
                for (cls, inst), box in zip(SCANNET_OBJECTS, boxes):
                    y0, y1, x0, x1 = (c * s // 256 for c in box)
                    seg[y0:y1, x0:x1] = cls * 1000 + inst
                Image.fromarray(np.stack([seg % 256, (seg // 256) % 256, seg // 65536], -1).astype(np.uint8)).save(
                    scan / "panoptic" / f"{i}.png")
    if val:
        pairs = [{"scan": scene.format(0), "context_ids": [c, c + 5],
                  "target_ids": [c, c + 1, c + 2, c + 3, c + 4, c + 5]} for c in range(VAL_SCENES)]
        (root / "val_pair.json").write_text(json.dumps(pairs))


def _scored(model, label: int, depth: float = 0.0, scale: float = 0.0) -> None:
    """Bias seeded random weights so that a sweep has something to score:
    the class logit of ``label`` raised (queries are kept and lifted), the
    splats opaque, and, where the sweep sees the scene from the data's
    cameras, the points ``depth`` further out along z (past the near plane:
    a random init puts them 0.01 from the camera) and their scales raised."""
    with torch.no_grad():
        model.mask2former.class_predictor.bias[label] += 4.0
        for head in (model.downstream_head1, model.downstream_head2):
            head.dpt.head[4].bias[2] += depth
        for head in (model.gaussian_param_head1, model.gaussian_param_head2):
            head.dpt.head[4].bias[0] += 2.0
            head.dpt.head[4].bias[1:4] += scale


def _sweep_cfg(root: Path):
    """configs/scannet.yaml with the ScanNet classes, at ``root``, as the
    validate CLI sets it (2 context + 4 extra target views)."""
    from siu3r_tpu_torch.config import bind_scannet_classes, load_config

    cfg = bind_scannet_classes(load_config(Path(__file__).resolve().parent / "configs" / "scannet.yaml",
                                           [f"datamodule.dataset_cfg.root={root}"]))
    cfg.mode = "val"
    cfg.datamodule.dataset_cfg.num_extra_target_views = 4
    return cfg


def _results_excess(got: dict, want: dict, keys) -> dict:
    """|got - want| of each of ``keys`` (an mAP's worst entry)."""
    out = {}
    for k in keys:
        if isinstance(want[k], dict):
            out[k] = max(abs(got[k][x] - want[k][x]) for x in want[k])
        elif isinstance(want[k], bool):
            out[k] = 0.0 if got[k] == want[k] else math.inf
        else:
            out[k] = abs(got[k] - want[k])
    return out


def _label_agreement(a: Path, b: Path) -> float:
    """The share of pixels whose packed label equals across the two sweeps'
    ``*_seg_pred`` PNGs."""
    from PIL import Image

    shares = [float((np.asarray(Image.open(p)) == np.asarray(Image.open(b / p.relative_to(a)))).all(-1).mean())
              for p in sorted(a.rglob("*_seg_pred/*.png"))]
    if not shares:
        raise AssertionError(f"no label maps under {a}")
    return min(shares)


RESULT_KEYS = ("psnr", "ssim", "lpips", "lpips_pretrained", "absrel", "rmse", "context_miou", "context_pq",
               "context_map", "target_miou", "target_pq", "target_map")


def _png_diff(a: Path, b: Path) -> dict:
    """Per kind of file the Visualizer writes (a PNG's directory or name,
    and pred.json), across two sweeps' directories: [files, files that
    differ, largest pixel difference]."""
    from PIL import Image

    out: dict = {}
    for p in sorted([*a.rglob("*.png"), *a.rglob("pred.json")]):
        q = b / p.relative_to(a)
        kind = p.name if p.suffix == ".json" else p.parent.name if p.parent.parent != a else p.stem
        entry = out.setdefault(kind, [0, 0, 0])
        entry[0] += 1
        if p.suffix == ".json":
            entry[1] += int(json.loads(p.read_text()) != json.loads(q.read_text()))
            continue
        x, y = np.asarray(Image.open(p)).astype(np.int64), np.asarray(Image.open(q)).astype(np.int64)
        if x.shape != y.shape or not np.array_equal(x, y):
            entry[1] += 1
            entry[2] = max(entry[2], int(np.abs(x - y).max()) if x.shape == y.shape else 1 << 30)
    return out


def _swapped_results(evaluator, got_dir: Path, want_dir: Path, tmp: Path) -> dict:
    """``evaluator`` (the ``want`` side's) on a copy of ``want_dir`` holding
    ``got_dir``'s predicted label maps and segments (``*_seg_pred/``): its
    mIoU, PQ and mAP are the ``got`` side's wherever the two sides' metric
    code agrees, whatever share of the label maps differs."""
    swapped = tmp / f"{want_dir.name}_with_{got_dir.name}_labels"
    shutil.copytree(want_dir, swapped)
    for p in got_dir.rglob("*_seg_pred/*"):
        shutil.copyfile(p, swapped / p.relative_to(got_dir))
    out = evaluator.evaluate(str(swapped))
    shutil.rmtree(swapped)
    return out


def _compare_sweeps(phase: str, got: dict, want: dict, agree: float, image_limits: dict, swapped: dict) -> dict:
    """Two sweeps' results.json: the same keys; label maps at least
    LABEL_AGREEMENT equal; the image and depth metrics within
    ``image_limits``; mIoU, PQ and mAP within CLI_ATOL of ``swapped`` (the
    ``want`` side's evaluator on its own directory with ``got``'s label
    maps, ``_swapped_results``), and of ``want`` where the label maps are
    all equal. Returns each value's excess over ``want``, and over
    ``swapped`` under "swapped_<key>"."""
    keys = [k for k in RESULT_KEYS if k in want and k != "lpips_pretrained"]
    seg_keys = [k for k in keys if k not in SWEEP_LIMITS]
    excess = _results_excess(got, want, keys)
    excess.update({f"swapped_{k}": v for k, v in _results_excess(got, swapped, seg_keys).items()})
    limits = dict(image_limits)
    limits.update({k: CLI_ATOL if agree == 1.0 else math.inf for k in seg_keys})
    limits.update({f"swapped_{k}": CLI_ATOL for k in seg_keys})
    if (got.keys() != want.keys() or got.get("lpips_pretrained") != want.get("lpips_pretrained")
            or agree < LABEL_AGREEMENT or any(excess[k] > limits[k] for k in excess)):
        raise AssertionError(f"{phase}: {got} vs {want} (with its labels: {swapped}): label maps agree {agree}, "
                             f"excess {excess} over {limits}")
    return excess


def phase_val_slice() -> dict:
    """The small config's validation sweep on the GPU (kernels) against the
    same weights on the CPU (plain versions), on one synthetic batch: eval
    step, ``segments_info``, the lift, the Visualizer and the Evaluator, each
    side into its own directory. PSNR, SSIM, LPIPS and the depth errors
    within SWEEP_LIMITS, label maps at least LABEL_AGREEMENT equal, and
    mIoU, PQ and mAP as ``_compare_sweeps`` holds them."""
    from siu3r_tpu_torch.config import EvaluatorCfg, PipelineCfg, RootCfg
    from siu3r_tpu_torch.eval.evaluator import Evaluator
    from siu3r_tpu_torch.pipeline import EVAL_KEYS, Pipeline
    from siu3r_tpu_torch.visualizer import Visualizer

    mcfg = _small_cfg(2)
    root = RootCfg(pipeline=PipelineCfg(model=mcfg))
    gpu = Pipeline(root, device="cuda", seed=7)
    _scored(gpu.model, 2)  # the targets frame the Gaussians: no depth or scale change
    cpu = Pipeline(root, device="cpu", seed=0)
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    rng = np.random.RandomState(0)
    n_t, hw = 6, 64
    images = torch.from_numpy(rng.rand(1, 2, hw, hw, 3).astype(np.float32))
    intr = torch.tensor([[1.24, 0, 0.5], [0, 1.24, 0.5], [0, 0, 1]]).expand(1, 2, 3, 3).contiguous()
    with torch.inference_mode():
        means = cpu.model(images, intr).gaussians.means
    ext, tintr = _target_views(means, n_t, 2)
    o = 4
    gt = np.zeros((1, o, n_t, hw, hw), np.float32)
    for k, (y0, y1, x0, x1) in enumerate(((0, 40, 0, 64), (40, 64, 0, 64), (10, 40, 8, 30), (20, 50, 34, 60))):
        gt[0, k, :, y0:y1, x0:x1] = 1.0
        gt[0, :k, :, y0:y1, x0:x1] = 0.0
    batch = {
        "context_views_images": images.numpy(), "context_views_intrinsics": intr.numpy(),
        "target_views_extrinsics": ext.numpy(), "target_views_intrinsics": tintr.numpy(),
        "context_views_id": np.array([[10, 15]], np.int32), "target_views_id": np.array([[10, 11, 12, 13, 14, 15]],
                                                                                        np.int32),
        "scene_names": ["scene0000_00"], "target_views_images": rng.rand(1, n_t, hw, hw, 3).astype(np.float32),
        "target_views_depths": rng.rand(1, n_t, hw, hw).astype(np.float32) + 0.5,
        "target_gt_masks": gt, "target_gt_classes": np.array([[0, 1, 2, 3]]), "target_gt_valid": np.ones((1, o), bool),
        "gt_masks": gt[:, :, [0, 5]], "gt_classes": np.array([[0, 1, 2, 3]]), "gt_valid": np.ones((1, o), bool),
    }
    ecfg = EvaluatorCfg(id2label=dict(mcfg.mask2former.id2label), stuffs=[0, 1], things=[2, 3, 4])
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, pipe in (("cuda", gpu), ("cpu", cpu)):
            dev = pipe.device
            out, render, qc = pipe.eval_step({k: torch.from_numpy(batch[k]).to(dev) for k in EVAL_KEYS})
            viz = Visualizer(root.pipeline.visualizer)
            viz.add_eval_step(str(tmp / name), batch, out, render, qc=qc, m2f=mcfg.mask2former)
            viz.write_files()
            results[name] = Evaluator(ecfg, device=dev).evaluate(str(tmp / name))
            if name == "cuda":
                coverage = render.alpha.mean().item()
        agree = _label_agreement(tmp / "cuda", tmp / "cpu")
        files = _png_diff(tmp / "cuda", tmp / "cpu")
        swapped = _swapped_results(Evaluator(ecfg, device="cpu"), tmp / "cuda", tmp / "cpu", tmp)
    got, want = results["cuda"], results["cpu"]
    if coverage < MIN_COVERAGE:
        raise AssertionError(f"val_slice: the target views see almost nothing (mean alpha {coverage})")
    excess = _compare_sweeps("val_slice", got, want, agree, SWEEP_LIMITS, swapped)
    log("val_slice", f"small config sweep (eval step, segments_info, lift, Visualizer, Evaluator) on cuda (kernels) vs "
                     f"cpu (plain), 6 target views, mean alpha {coverage:.3f}: label maps agree {agree:.5f}; "
                     f"image metrics within {SWEEP_LIMITS}, mIoU, PQ, mAP within {CLI_ATOL} of the cpu evaluator's "
                     f"on the cuda label maps (and of the cpu sweep's where the label maps are equal); excess "
                     f"{({k: float(f'{v:.3g}') for k, v in excess.items()})}; files [n, differing, largest pixel "
                     f"difference] {files}; cuda target miou {got.get('target_miou')}, pq {got.get('target_pq')}, "
                     f"map {got.get('target_map', {}).get('map')}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return dict(label_agreement=agree, excess=excess, files=files, cuda=got, cpu=want, mean_alpha=coverage)


_SWEEP: dict = {}  # the validate phase's synthetic root and output, for the evaluate phase


def _sweep_root() -> Path:
    if "tmp" not in _SWEEP:
        _SWEEP["tmp"] = tempfile.TemporaryDirectory()
        root = Path(_SWEEP["tmp"].name) / "scannet"
        _scannet_root(root, seed=11)
        _SWEEP["root"] = root
    return _SWEEP["root"]


# configs/concat.yaml's members beside the sweep's ScanNet root: (sub-root,
# its scenes' names, _scannet_root's arguments). Six ScanNet++ scenes: with
# Replica's one scene counting 50 times, the loader's epoch-0 order (seed 0,
# 62 items) reaches a ScanNet++ item in its third batch, inside
# TRAIN_CLI_STEPS; with one it came at the fifteenth. Replica's overlap
# table is an iou.pt, read through torch.load
CONCAT_MEMBERS = (("scannetpp", "pp{:04d}_00", dict(seed=12, colour="png", train_scenes=6)),
                  ("replica", "room{}", dict(seed=13, train_scenes=1, iou_pt=True)))


def _concat_root() -> Path:
    """The concat dataset's root (``{root}/scannet``, ``{root}/scannetpp``,
    ``{root}/replica``): ``scannet`` is the sweep's root (a link), the
    others train splits written by ``_scannet_root``."""
    if "concat" not in _SWEEP:
        scannet = _sweep_root()
        root = Path(_SWEEP["tmp"].name) / "concat"
        root.mkdir()
        (root / "scannet").symlink_to(scannet, target_is_directory=True)
        for sub, scene, kw in CONCAT_MEMBERS:
            _scannet_root(root / sub, scene=scene, val=False, **kw)
        _SWEEP["concat"] = root
    return _SWEEP["concat"]


def _member_of(scene_name: str) -> str:
    """The concat member a train item's scene belongs to, by its name."""
    for sub, scene, _ in CONCAT_MEMBERS:
        if scene_name.startswith(scene.split("{")[0]):
            return sub
    return "scannet"


def _timed_stage(timer, name: str, module, attr: str):
    """Wrap ``module.attr`` so that its time adds to ``timer`` under ``name``."""
    orig = getattr(module, attr)

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return orig(*args, **kwargs)
        finally:
            timer[name] = timer.get(name, 0.0) + time.perf_counter() - t0

    setattr(module, attr, wrapped)
    return lambda: setattr(module, attr, orig)


def phase_validate() -> dict:
    """``python -m siu3r_tpu_torch.cli.validate --config configs/scannet.yaml
    --ckpt W --limit 4`` (its own process) at full width on a synthetic
    ScanNet root, W this process's weights (another seed than the CLI's own
    init); its results.json holds every key the JAX evaluator writes, finite,
    each held against this process's eval steps on the same items written
    through the Visualizer into a second directory and evaluated there
    (label maps at least LABEL_AGREEMENT equal, the image metrics within
    PROCESS_LIMITS, mIoU, PQ and mAP as ``_compare_sweeps`` holds them);
    each of those scenes' renders covered (MIN_COVERAGE); the same eval
    steps repeated in this process write the same files bit for bit. W is
    biased by ``_scored`` so that the sweep keeps a query and sees the
    Gaussians. One eval step's launches are phase eval's, with no host sync
    inside it. The
    in-process sweep is timed by stage (eval step; segments_info, lift and
    overlays; PNG writes; the evaluator's PSNR, SSIM, LPIPS and mAP)."""
    from siu3r_tpu_torch.cli.train import build_dataset
    from siu3r_tpu_torch.eval import evaluator as E
    from siu3r_tpu_torch.eval import metrics as M
    from siu3r_tpu_torch.pipeline import EVAL_KEYS, Pipeline
    from siu3r_tpu_torch.utils import visualize as V
    from siu3r_tpu_torch.visualizer import Visualizer

    here = Path(__file__).resolve().parent
    root = _sweep_root()
    tmp = Path(_SWEEP["tmp"].name)
    cfg = _sweep_cfg(root)
    m2f = cfg.pipeline.model.mask2former
    pipe = Pipeline(cfg, device="cuda", seed=3)  # not the CLI's own seed: the weights must come from --ckpt
    _scored(pipe.model, 4, depth=0.5, scale=30.0)  # chairs; the views are the data's cameras
    weights = tmp / "weights.pt"
    torch.save(pipe.model.state_dict(), weights)
    out_dir = tmp / "val_cli"
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "siu3r_tpu_torch.cli.validate", "--config",
                          str(here / "configs" / "scannet.yaml"), "--ckpt", str(weights), "--limit", str(VAL_SCENES),
                          "--output_path", str(out_dir), f"datamodule.dataset_cfg.root={root}"],
                         cwd=here, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    _SWEEP["weights"] = weights  # for phase dp_validate
    if cli.returncode != 0:
        raise RuntimeError(f"validate exited {cli.returncode}:\n{cli.stdout[-3000:]}\n{cli.stderr[-4000:]}")
    got = json.loads((out_dir / "results.json").read_text())
    sweep = json.loads((out_dir / "sweep.json").read_text())
    missing = [k for k in RESULT_KEYS if k not in got]
    finite = all(math.isfinite(v) for k, x in got.items() if not isinstance(x, bool)
                 for v in (x.values() if isinstance(x, dict) else x if isinstance(x, list) else [x]))
    if missing or not finite or sweep["n_scenes"] != VAL_SCENES:
        raise AssertionError(f"validate: results.json lacks {missing} or is not finite: {got}; sweep {sweep}")

    # this process: the same items, the same weights, its own directory
    dataset = build_dataset(cfg, train=False)
    items = [dataset[i] for i in range(VAL_SCENES)]
    as_batch = lambda item: {k: (np.asarray(v)[None] if not isinstance(v, str) else [v]) for k, v in item.items()}
    inputs = lambda b: {k: torch.from_numpy(b[k]).cuda() for k in EVAL_KEYS}
    expected = {**expected_launches(cfg.pipeline.model), "bin": 1, "raster": 2}
    first = inputs(as_batch(items[0]))
    _counted_run("validate", lambda: pipe.eval_step(first), expected)
    viz = Visualizer(cfg.pipeline.visualizer)
    own, repeat = tmp / "val_own", tmp / "val_repeat"
    stages: dict = {}
    restore = [_timed_stage(stages, "labeled overlays", V, "labeled_instance_overlay"),
               _timed_stage(stages, "labeled overlays", V, "labeled_gt_overlay")]
    coverage = []
    for item in items:
        b = as_batch(item)
        x = inputs(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, render, qc = pipe.eval_step(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        viz.add_eval_step(str(own), b, out, render, qc=qc, m2f=m2f)
        t2 = time.perf_counter()
        viz.write_files()
        t3 = time.perf_counter()
        for name, dt in (("eval step", t1 - t0), ("segments_info, lift, scene arrays", t2 - t1), ("PNG writes", t3 - t2)):
            stages[name] = stages.get(name, 0.0) + dt
        coverage.append(render.alpha.mean().item())
    stages["segments_info, lift, scene arrays"] -= stages.get("labeled overlays", 0.0)
    for undo in restore:
        undo()
    if min(coverage) < MIN_COVERAGE:
        raise AssertionError(f"validate: the target views see almost nothing (mean alpha per scene {coverage})")
    # the same eval steps again in this process: whether a repeat is bitwise
    # the same tells a nondeterministic step from one that differs between
    # processes
    for item in items:
        b = as_batch(item)
        out, render, qc = pipe.eval_step(inputs(b))
        viz.add_eval_step(str(repeat), b, out, render, qc=qc, m2f=m2f)
        viz.write_files()
    del out, render, qc
    evaluator = E.Evaluator(cfg.pipeline.evaluator, device="cuda")
    restore = [_timed_stage(stages, "evaluator: ssim", M, "ssim"), _timed_stage(stages, "evaluator: psnr", M, "psnr"),
               _timed_stage(stages, "evaluator: lpips", E.Evaluator, "_lpips"),
               _timed_stage(stages, "evaluator: mAP", M.MeanAveragePrecision, "compute"),
               _timed_stage(stages, "evaluator: PQ", M.PanopticQuality, "update")]
    t0 = time.perf_counter()
    want = evaluator.evaluate(str(own))
    stages["evaluator: all"] = time.perf_counter() - t0
    for undo in restore:
        undo()
    repeat_files = _png_diff(own, repeat)  # before the evaluator writes its scores there
    repeat_excess = _results_excess(evaluator.evaluate(str(repeat)), want, [k for k in RESULT_KEYS if k in want])
    if any(n for _, n, _ in repeat_files.values()):
        raise AssertionError(f"validate: this process's eval steps, repeated on the same items, wrote other files "
                             f"{repeat_files}")
    agree = _label_agreement(out_dir, own)
    cli_files = _png_diff(out_dir, own)
    swapped = _swapped_results(evaluator, out_dir, own, tmp)
    shutil.rmtree(repeat)
    excess = _compare_sweeps("validate", got, want, agree, PROCESS_LIMITS, swapped)
    per_scene = {k: v / VAL_SCENES * 1e3 for k, v in stages.items()}
    res = dict(results=got, sweep=sweep, cli_seconds=cli_s, own_ms_per_scene=per_scene, launches=expected,
               excess=excess, label_agreement=agree, cli_files=cli_files, mean_alpha=coverage)
    steps = ", ".join(f"{s:.3f}" for s in sweep["step_seconds"])
    hosts = ", ".join(f"{s:.3f}" for s in sweep["host_seconds"])
    log("validate", f"siu3r_tpu_torch.cli.validate, ViT-L 2-view 256x256 B=1 fp32, {VAL_SCENES} synthetic ScanNet "
                    f"scenes of 2 context + 6 target views, --ckpt: {cli_s:.1f} s in its own process; per batch step "
                    f"s [{steps}], host s [{hosts}]; {sweep.get('ms_per_scene', 0):.1f} ms/scene eval step "
                    f"({sweep.get('scenes_per_sec', 0):.2f} scenes/s, batches 2-{VAL_SCENES}); evaluator "
                    f"{sweep['evaluate_seconds']:.2f} s")
    log("validate", "results.json: " + json.dumps({k: got[k] for k in RESULT_KEYS}))
    log("validate", f"this process's eval steps on the same items (mean alpha per scene "
                    f"{[round(c, 3) for c in coverage]}), repeated: every file bitwise the same (the evaluator's "
                    f"results on the two differ by {({k: float(f'{v:.3g}') for k, v in repeat_excess.items()})}); "
                    f"files [n, differing, largest pixel difference] against the CLI's {cli_files}")
    log("validate", f"against the CLI's results.json: label maps agree {agree:.6f}, image metrics within "
                    f"{PROCESS_LIMITS}, mIoU, PQ and mAP within {CLI_ATOL} of this process's evaluator on the CLI's "
                    f"label maps (and of this sweep's where the label maps are equal); excess "
                    f"{({k: float(f'{v:.3g}') for k, v in excess.items()})}; one eval step's launches {expected} "
                    f"(phase eval's), no host sync inside it")
    log("validate", "this process's sweep by stage, ms per scene: "
        + ", ".join(f"{k} {v:.1f}" for k, v in sorted(per_scene.items(), key=lambda kv: -kv[1])))
    _SWEEP["dir"], _SWEEP["results"] = out_dir, got
    del pipe
    torch.cuda.empty_cache()
    return res


def phase_evaluate() -> dict:
    """``python -m siu3r_tpu_torch.cli.evaluate --eval_path <the validate
    phase's directory>`` (its own process) gives the sweep's results.json
    value for value (within CLI_ATOL)."""
    if "dir" not in _SWEEP:
        phase_validate()
    here = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "siu3r_tpu_torch.cli.evaluate", "--eval_path", str(_SWEEP["dir"])],
                         cwd=here, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if cli.returncode != 0:
        raise RuntimeError(f"evaluate exited {cli.returncode}:\n{cli.stderr[-4000:]}")
    got = json.loads(cli.stdout[cli.stdout.index("{"):])
    want = _SWEEP["results"]
    keys = [k for k in want if not k.endswith("per_class")]
    excess = _results_excess(got, want, keys)
    per_class = all(np.allclose(got[k], want[k], rtol=0, atol=CLI_ATOL) for k in want if k.endswith("per_class"))
    if got.keys() != want.keys() or max(excess.values()) > CLI_ATOL or not per_class:
        raise AssertionError(f"evaluate: {got} vs the sweep's {want}")
    log("evaluate", f"siu3r_tpu_torch.cli.evaluate on the validate phase's directory ({seconds:.1f} s, its own "
                    f"process): results.json value for value (worst {max(excess.values()):.3g}, per-class lists "
                    f"within {CLI_ATOL})")
    return dict(seconds=seconds, worst=max(excess.values()))


# the data-parallel training phases (dp_train, nccl, zero1_train,
# dp_train_cli), which measure correctness and memory, not speed, and the
# training loop (train_cli) run their models at every width with the depth
# cut to 4 encoder and 2 + 2 decoder blocks (of 24 and 12 + 12; 6 and 3 + 3
# took the script past its 1200 s on a slow host): shorter model builds,
# steps, all-reduces and checkpoints; dp_validate sweeps the full model. 4 is
# the least encoder depth whose adapter interaction indexes (d k / 4 - 1)
# are all blocks
CUT_DEPTH = dict(enc_depth=4, dec_depth=2)


def _cut_depth(cfg):
    """``cfg`` (a RootCfg) with the depth CUT_DEPTH."""
    cfg.pipeline.model.croco = dataclasses.replace(cfg.pipeline.model.croco, **CUT_DEPTH)
    return cfg


def _train_cli(root: Path, out: Path, max_steps: int, resume: Path) -> tuple[float, str]:
    """``python -m siu3r_tpu_torch.cli.train --resume resume`` (its own
    process) on configs/concat.yaml at the concat root ``root``, k = 2, a
    visualisation every 2 steps, a record every step; (seconds, its standard
    output)."""
    here = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "siu3r_tpu_torch.cli.train", "--resume", str(resume),
                          "--config", str(here / "configs" / "concat.yaml"), "datamodule.dataset_cfg.name=concat",
                          "trainer.devices=1",
                          f"trainer.max_steps={max_steps}", "trainer.accumulate_grad_batches=2",
                          "pipeline.log_training_result_interval=2", "trainer.log_every_n_steps=1",
                          "datamodule.train_loader_cfg.num_workers=2", f"datamodule.dataset_cfg.root={root}",
                          f"output_path={out}", *[f"pipeline.model.croco.{k}={v}" for k, v in CUT_DEPTH.items()]],
                         cwd=here, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    if cli.returncode != 0:
        raise RuntimeError(f"train exited {cli.returncode}:\n{cli.stdout[-3000:]}\n{cli.stderr[-4000:]}")
    return seconds, cli.stdout


def _train_records(out: Path) -> list:
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    return [r for r in records if "train/total" in r]


def _adam_moves(pipe, before: dict, after, lrs: list) -> dict:
    """Per top-level module ("frozen" for the frozen encoder): the largest
    |after - before + sum(lrs) x wd x before| / lrs[0] over its parameters,
    after len(lrs) optimizer steps at those learning rates (per group), from
    the parameters ``before``: the move with AdamW's decay taken out, in
    units of the first step's learning rate. An Adam step moves an entry
    with any gradient by about its learning rate; the decay alone moves it
    by lr x wd x |p|, taken out here (exactly for one step, to terms of
    order lr^2 x wd for two)."""
    from siu3r_tpu_torch.train.optimizer import group_of

    wd = pipe.optimizer.inner.weight_decay
    moves: dict = {}
    for n, p0 in before.items():
        group = group_of(n, True)
        part = "frozen" if group == "frozen" else n.split(".")[0]
        p1 = after(n)
        if group == "frozen":
            move = (p1 - p0).abs().max().item()
        else:
            rates = [pipe.optimizer.lr(group, step) for step in lrs]
            move = (p1 - p0 + sum(rates) * wd * p0).abs().max().item() / rates[0]
        moves[part] = max(moves.get(part, 0.0), move)
    return moves


TRAINED_PARTS = ("mask2former", "adapter", "gaussian_param_head1", "gaussian_param_head2", "downstream_head1",
                 "downstream_head2")
MIN_ADAM_MOVE = 0.5  # of the learning rate: a part with any gradient moves about 1


def _check_moves(phase: str, moves: dict) -> None:
    """The frozen encoder did not move; every trained part moved by more
    than its decay, by at least MIN_ADAM_MOVE of its learning rate (a part
    that no gradient reaches, as through a render that composites nothing,
    moves by its decay alone, about 0)."""
    slow = {k: moves.get(k, 0.0) for k in TRAINED_PARTS if not moves.get(k, 0.0) > MIN_ADAM_MOVE}
    if moves["frozen"] != 0.0 or slow:
        raise AssertionError(f"{phase}: moves (decay taken out, in learning rates) {moves}: the frozen encoder "
                             f"moved, or {slow} below {MIN_ADAM_MOVE}")


def phase_train_cli() -> dict:
    """``python -m siu3r_tpu_torch.cli.train --config configs/concat.yaml
    datamodule.dataset_cfg.name=concat trainer.devices=1 trainer.max_steps=4
    trainer.accumulate_grad_batches=2 pipeline.log_training_result_interval=2``
    (its own process) at full width with the depth cut to CUT_DEPTH, and
    B = 3, on the synthetic concat root (``_concat_root``: the sweep's six
    ScanNet scenes, six ScanNet++ scenes in PNG and one Replica scene, which
    counts 50 times: 62 items, 20 steps an epoch), from a training state
    before the first epoch (``--resume`` of epoch -1, step 0) whose weights
    W are a seeded init biased by ``_scored`` so that the data's target
    views see the Gaussians: the CLI's steps an epoch equal to this
    process's loader's, four finite records in metrics.jsonl, rgb, rgb_gt
    and depth PNGs under train_viz/, one checkpoint (epoch 0, inside it),
    whose frozen encoder equals W's and whose trained parts, the Gaussian and
    depth heads included, moved from W by more than their decay
    (``_check_moves``: gradients reached every head through the render).
    The items each member gave the run are counted from the scene names of
    the loader's first four batches in this process (the CLI's seed, epoch
    and order), and each member must give one.
    (A resumed run of the CLI, in one process and in two ranks, is phase
    dp_train_cli's.) In this process from W (the same cut), B = 3,
    k = 2: every parameter bitwise unchanged after micro-step 1; after
    micro-step 2 the frozen encoder unchanged and every trained part moved
    by more than its decay; one micro-step's launches; then micro-steps
    timed, each recorded and held to MIN_COVERAGE and MIN_SWEPT, with their
    host syncs and peak memory; the binning, raster and raster_bwd kernels
    held against their plain versions on a timed micro-step's own inputs;
    and the training state's size on disk, save and restore seconds."""
    from siu3r_tpu_torch.checkpoint_io import restore_train_state, save_train_state
    from siu3r_tpu_torch.cli.train import build_dataset, step_generator
    from siu3r_tpu_torch.config import bind_scannet_classes, load_config
    from siu3r_tpu_torch.kernels import _build
    from siu3r_tpu_torch.data import Loader
    from siu3r_tpu_torch.pipeline import Pipeline
    from siu3r_tpu_torch.train.optimizer import MultiSteps

    root = _concat_root()
    tmp = Path(_SWEEP["tmp"].name)
    cfg = _cut_depth(bind_scannet_classes(load_config(Path(__file__).resolve().parent / "configs" / "concat.yaml",
                                                      [f"datamodule.dataset_cfg.root={root}"])))
    cfg.trainer.accumulate_grad_batches = 2
    if (cfg.mode, cfg.datamodule.dataset_cfg.name, cfg.datamodule.dataset_cfg.num_extra_target_views) != (
            "train", "concat", 2):
        raise AssertionError(f"train_cli: configs/concat.yaml is not a concat training config: {cfg.datamodule}")
    dataset = build_dataset(cfg, train=True)
    loader = Loader(dataset, batch_size=cfg.datamodule.train_loader_cfg.batch_size, num_workers=2, seed=cfg.seed)
    loader.set_epoch(0)
    pipe = Pipeline(cfg, device="cuda", seed=5).init_train(steps_per_epoch=len(loader))
    _scored(pipe.model, 4, depth=0.5, scale=30.0)  # the data's cameras, as phase validate
    params = dict(pipe.model.named_parameters())
    start = tmp / "start.pt"
    save_train_state(start, pipe, -1, 0)
    # the CLI's first TRAIN_CLI_STEPS batches: the same dataset, seed, epoch
    # and batch order (two workers draw the views in either order, never
    # another scene); the items each member gave the run by scene name
    batch_iter = iter(loader)
    host = [next(batch_iter) for _ in range(TRAIN_CLI_STEPS)]
    batch_iter.close()
    counted = collections.Counter(_member_of(name) for b in host for name in b["scene_names"])
    members = {sub: counted.get(sub, 0) for sub in ("scannet", "scannetpp", "replica")}
    if min(members.values()) < 1 or len(dataset.datasets) != 3:
        raise AssertionError(f"train_cli: items each member gave the run {members}: a member gave none")

    out = tmp / "train_cli"
    first_s, stdout = _train_cli(root, out, TRAIN_CLI_STEPS, resume=start)
    start.unlink()
    records = _train_records(out)
    viz_dirs = {p.parent.name for p in (out / "train_viz").rglob("*.png")}
    ckpts = sorted((out / "checkpoints").iterdir())
    if ("epoch 0, step 0" not in stdout or f"steps/epoch {len(loader)};" not in stdout
            or [r["step"] for r in records] != list(range(TRAIN_CLI_STEPS))
            or not all(math.isfinite(r["train/total"]) and math.isfinite(r["lr"]) for r in records)
            or not {"rgb", "rgb_gt", "depth"} <= viz_dirs or [c.name for c in ckpts] != ["epoch000-4"]):
        raise AssertionError(f"train_cli: records {records}, train_viz {viz_dirs}, checkpoints {ckpts}:\n"
                             f"{stdout[-2000:]}")
    ckpt_bytes = ckpts[0].stat().st_size
    state = torch.load(ckpts[0], map_location="cpu", mmap=True, weights_only=False)
    if (state["epoch"], state["global_step"], state["epoch_step"]) != (0, TRAIN_CLI_STEPS, TRAIN_CLI_STEPS):
        raise AssertionError(f"train_cli: the checkpoint's epoch, step and place in the epoch "
                             f"{(state['epoch'], state['global_step'], state['epoch_step'])}")
    saved = state["model"]
    del state
    cli_moves = _adam_moves(pipe, {n: p.detach() for n, p in params.items()},
                            lambda n: saved[n].to("cuda", non_blocking=True), [0, 1])
    del saved
    _check_moves("train_cli (the CLI's checkpoint against W)", cli_moves)
    shutil.rmtree(out / "checkpoints")
    log("train_cli", f"siu3r_tpu_torch.cli.train, configs/concat.yaml (ViT-L 2-view 256x256 fp32 at depth "
                     f"{CUT_DEPTH}, B=3, 2 + 4 views) on a concat root of {len(dataset)} items "
                     f"({dict(zip(('scannet', 'scannetpp', 'replica'), dataset._lens))}), {len(loader)} steps an "
                     f"epoch, items each member gave the run {members}, k=2, max_steps {TRAIN_CLI_STEPS}, from W "
                     f"at epoch -1: {first_s:.1f} s in its own "
                     f"process, totals {[round(r['train/total'], 4) for r in records]}, train_viz "
                     f"{sorted(viz_dirs)}, checkpoint {ckpts[0].name} ({ckpt_bytes / 2**30:.3f} GiB), its moves from "
                     f"W (decay out, in learning rates) {({k: round(v, 3) for k, v in cli_moves.items()})}")

    # this process, from W: the accumulation at full width on the CLI's
    # first batches, then timing
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items() if isinstance(v, np.ndarray)}
               for b in host]
    if not isinstance(pipe.optimizer, MultiSteps) or batches[0]["context_views_images"].shape[0] != 3:
        raise AssertionError("train_cli: not accumulating, or not at B = 3")
    before = {n: p.detach().clone() for n, p in params.items()}
    pipe.train_step(batches[0], step_generator(0, 0, "cuda"))
    changed = [n for n, p in params.items() if not torch.equal(p.detach(), before[n])]
    if changed or pipe.optimizer.count != 0:
        raise AssertionError(f"train_cli: micro-step 1 of 2 moved {changed[:5]} (count {pipe.optimizer.count})")
    losses = pipe.train_step(batches[1], step_generator(0, 1, "cuda"))
    moves = _adam_moves(pipe, before, lambda n: params[n].detach(), [0])
    del before
    if pipe.optimizer.count != 1 or not all(math.isfinite(float(x)) for x in losses.values()):
        raise AssertionError(f"train_cli: after micro-step 2 count {pipe.optimizer.count}, losses {losses}")
    _check_moves("train_cli (micro-step 2)", moves)
    gen = step_generator(0, 2, "cuda")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    n_syncs, sources = _count_syncs(lambda: pipe.train_step(batches[0], gen))
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    expected = {**expected_launches(cfg.pipeline.model), "bin": 1, "raster": 1, "raster_bwd": 1}
    if launches != expected:
        raise AssertionError(f"train_cli: micro-step launches {launches} != expected {expected}")
    check_variants(expected)
    lap_syncs = sum(n for where, n in sources.items() if "lap.py:" in where)

    # timed micro-steps, each recorded: every one must see the scene and
    # composite real work (MIN_COVERAGE, MIN_SWEPT)
    torch.cuda.reset_peak_memory_stats()
    clock0 = sm_clock()
    times, occupancy = [], []
    for i in range(4):
        with _render_calls() as calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.train_step(batches[i % len(batches)], gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        occupancy.append(_occupancy(calls))
    clock1 = sm_clock()
    peak = torch.cuda.max_memory_allocated() / 2**30
    alphas, swepts = zip(*occupancy)
    if min(alphas) < MIN_COVERAGE or min(swepts) < MIN_SWEPT:
        raise AssertionError(f"train_cli: timed micro-steps: mean alpha {alphas}, chunks swept per live tile "
                             f"{swepts}: below {MIN_COVERAGE} or {MIN_SWEPT}")
    # the render kernels on the last timed micro-step's own inputs (4 target
    # views of each of the 3 items)
    if len(calls["bin"]) != 1 or len(calls["raster"]) != 1:
        raise AssertionError(f"train_cli: recorded {len(calls['bin'])} binning and {len(calls['raster'])} raster "
                             f"calls")
    table, counts, rparams, colors = (calls["raster"][0][k].detach() for k in ("table", "counts", "params", "colors"))
    kernels = {"bin": check_bin("train_cli_step", calls["bin"][0]["proj"], calls["bin"][0]["max_per_tile"], 10),
               "raster": check_raster("train_cli_step_C3", table, counts, rparams, colors, 10),
               "raster_bwd": check_raster_bwd("train_cli_step_C3", table, counts, rparams, colors, 5,
                                              torch.Generator(device="cuda").manual_seed(9))}
    del calls, table, counts, rparams, colors
    device_ms, top = _device_breakdown(lambda: pipe.train_step(batches[0], gen), 1)
    if pipe.optimizer.mini_step == 0:
        pipe.train_step(batches[0], gen)  # save in the middle of an accumulation: the larger state
    state = tmp / "state.pt"
    t0 = time.perf_counter()
    save_train_state(state, pipe, 0, 7)
    save_s = time.perf_counter() - t0
    size = state.stat().st_size
    t0 = time.perf_counter()
    restore_train_state(state, pipe)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    state.unlink()
    med = statistics.median(times)
    res = dict(first_run_s=first_s, items_per_member=members, steps_per_epoch=len(loader),
               totals=[r["train/total"] for r in records], cli_checkpoint_gib=ckpt_bytes / 2**30,
               cli_moves=cli_moves, moves=moves, launches=launches, kernels=kernels, micro_step_median_s=med,
               micro_step_s=times, device_ms=device_ms, idle_share=1.0 - device_ms / (med * 1e3), top_device_ms=top,
               micro_steps_per_s=1.0 / med, peak_gib=peak, host_syncs=n_syncs,
               lap_syncs=lap_syncs, sync_sources=sources, mean_alpha=list(alphas), swept_per_live_tile=list(swepts),
               state_gib=size / 2**30, save_s=save_s, restore_s=restore_s, sm_clock=[clock0, clock1])
    log("train_cli", f"this process from W, Pipeline.train_step at k=2, ViT-L 2-view 256x256 B=3 fp32 (2 + 4 views, "
                     f"{batches[0]['gt_masks'].shape[1]} objects): micro-step 1 left every parameter bitwise "
                     f"unchanged; micro-step 2's moves (decay out, in learning rates) "
                     f"{({k: round(v, 3) for k, v in moves.items()})}")
    log("train_cli", f"median of 4 warm micro-steps {med * 1e3:.1f} ms (min {min(times) * 1e3:.1f}, max "
                     f"{max(times) * 1e3:.1f}) = {1.0 / med:.3f} micro-steps/s ({0.5 / med:.3f} optimizer steps/s), "
                     f"peak memory {peak:.3f} GiB; device busy {device_ms:.2f} ms a micro-step, idle share "
                     f"{res['idle_share']:.3f}; per timed micro-step mean alpha {[round(a, 3) for a in alphas]}, "
                     f"chunks swept per live tile {[round(x, 2) for x in swepts]}; launches per micro-step "
                     f"{launches} (expected); host syncs per micro-step {n_syncs} (the LAP's {lap_syncs}); "
                     f"training state mid-accumulation {size / 2**30:.3f} GiB on disk, saved in {save_s:.2f} s, "
                     f"restored in {restore_s:.2f} s; SM clock {clock0} -> {clock1}")
    log("train_cli", "the micro-step's render kernels: " + "; ".join(
        f"{k} {r['ms']:.5f} ms (plain {r['plain_ms']:.3f}, bound {r['bound_ms']:.5f}, {r['bound_by']})"
        for k, r in kernels.items()))
    for name, ms in top[:8]:
        log("train_cli", f"  device {ms:8.3f} ms  {name[:100]}")
    del pipe, params, batches, host
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- phases 23-27: data parallelism

DP_RANKS = 2  # ranks on the one card, over gloo: NCCL refuses two ranks on one GPU
DP_STEPS = 2
# the ranks against the one-process oracle (and a resumed run against the
# uninterrupted one): the kernels' atomics and the plain VJPs' index_add sum
# in an order that varies from run to run, so gradients differ in their last
# bits, and Adam's first steps (m / sqrt(v), about the gradient's sign) carry
# that into entries whose gradient is near zero (a tensor whose gradient is
# rounding noise alone, as a bias before a normalisation, moves by +-lr at
# random). The first step's loss terms within DP_LOSS_RTOL (the same weights
# on the same inputs), a later step's within DP_LATER_LOSS_RTOL (its weights
# carry the earlier update's difference); BatchNorm running statistics rtol
# and atol; the
# parameters' update (after - before) over all tensors together within
# DP_UPDATE_REL_L2 of the oracle's in relative L2; Adam's first moment after
# the first step (the clipped averaged gradient times 1 - b1) within
# DP_MOMENT_REL_L2 for each tensor whose gradient exceeds 1e-6 of the norm
# (the gradient tolerance of tests/test_torch_train_step.py)
DP_LOSS_RTOL = 1e-4
DP_LATER_LOSS_RTOL = 2e-2
DP_STATS_RTOL, DP_STATS_ATOL = 1e-4, 1e-6
DP_UPDATE_REL_L2 = 5e-2
DP_MOMENT_REL_L2 = 2e-3
# ZeRO-1 against the replicated update on the same gradients
# (tests/test_train.py's tolerance)
ZERO1_ATOL = 1e-6
_DP: dict = {}  # phase dp_train's inputs, for phase nccl


def _torchrun(phase: str, nproc: int, args: list, timeout: float) -> tuple[float, str]:
    """``python -m torch.distributed.run --standalone --nproc_per_node nproc
    args`` from the checkout, in a session of its own: (seconds, its output).
    Raises unless it exits 0 (torchrun exits non-zero when any rank does);
    on the timeout, kills the launcher and every rank."""
    here = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc), *args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise RuntimeError(f"{phase}: torchrun did not end in {timeout} s:\n{out[-6000:]}")
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{phase}: torchrun exited {proc.returncode}:\n{out[-8000:]}")
    return seconds, out


def _ranks(phase: str, worker: str, nproc: int, wdir: Path, backend: str, timeout: float = 600) -> tuple:
    """This script's ``worker`` under torchrun on ``nproc`` ranks: (seconds,
    output, each rank's JSON result). Fails unless every rank wrote one."""
    seconds, out = _torchrun(phase, nproc, [str(Path(__file__).resolve()), "--rank_worker", worker, "--worker_dir",
                                            str(wdir), "--dist_backend", backend], timeout)
    results = []
    for r in range(nproc):
        path = wdir / f"rank{r}.json"
        if not path.exists():
            raise AssertionError(f"{phase}: rank {r} of {nproc} wrote no result:\n{out[-4000:]}")
        results.append(json.loads(path.read_text()))
        path.unlink()
    return seconds, out, results


def _bn_buffers(model) -> list:
    return [t for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
            for t in (m.running_mean, m.running_var)]


def _checksum(model) -> float:
    return float(sum(p.detach().double().sum() for p in model.parameters()))


def _framed_items(pipe, views: int, n_target: int, items: int, seed: int) -> dict:
    """A global batch of ``items`` train items (``_train_batch``'s, 48
    objects), each item's target cameras framing the Gaussians of a
    train-mode forward of ``pipe``'s weights on its images; the BatchNorm
    running statistics are put back after that forward. On the card."""
    images, intr = _view_inputs(views, seed=seed, batch=items)
    saved = [t.clone() for t in _bn_buffers(pipe.model)]
    with torch.no_grad():
        means = pipe.model.train()(images, intr).gaussians.means
    for t, s in zip(_bn_buffers(pipe.model), saved):
        t.copy_(s)
    targets = [_target_views(means[i:i + 1], n_target, views) for i in range(items)]
    batch = _train_batch(images, intr, (torch.cat([t[0] for t in targets]), torch.cat([t[1] for t in targets])),
                         N_OBJECTS, N_VALID, pipe.cfg.pipeline.model.mask2former.num_labels, seed=seed + 1)
    for key in ("context_views_id", "target_views_id"):
        batch[key] = batch[key].expand(items, -1).contiguous()
    return batch


def _dp_step_record(pipe, batch, injected, device) -> dict:
    """One ``Pipeline.train_step`` on this rank's slice with injected sample
    points: its wall ms between two synchronisations, peak memory, kernel
    launches (set to 0 just before it), the collectives' bytes and ms, and
    the averaged loss terms."""
    from siu3r_tpu_torch import parallel
    from siu3r_tpu_torch.kernels import _build

    inj = [{k: v.to(device) for k, v in parallel.shard_batch(d).items()} for d in injected]
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    parallel.stats.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = pipe.train_step(batch, None, injected_coords=inj)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return dict(ms=ms, peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=dict(_build.launch_counts),
                variants=dict(_build.variant_counts), losses={k: float(v) for k, v in losses.items()},
                **{f"{name}_{what}": value for name in ("all_reduce", "all_gather")
                   for what, value in (("bytes", parallel.stats.bytes[name]),
                                       ("ms", parallel.stats.seconds[name] * 1e3),
                                       ("calls", parallel.stats.calls[name]))})


def worker_dp_train(wdir: Path, backend: str) -> None:
    """One rank of phases dp_train and nccl: configs/scannet.yaml's model
    (seed 0) on its slice of ``inputs.pt``'s global batch, one
    ``Pipeline.train_step`` for each step's injected points, each recorded
    by ``_dp_step_record``; rank 0 saves the parameters and BatchNorm
    statistics after the steps where ``inputs.pt`` asks for them."""
    from siu3r_tpu_torch import parallel
    from siu3r_tpu_torch.pipeline import Pipeline

    device = parallel.init_distributed(backend, "cuda")
    rank = parallel.rank()
    parallel.stats.timed = True
    inp = torch.load(wdir / "inputs.pt", weights_only=False)
    pipe = Pipeline(_cut_depth(two_view_cfg()), device=device, seed=0).init_train(steps_per_epoch=1000)
    initial = _checksum(pipe.model)
    batch = {k: v.to(device) for k, v in parallel.shard_batch(inp["batch"]).items()}
    steps = []
    for injected in inp["injected"]:
        steps.append(_dp_step_record(pipe, batch, injected, device))
        if len(steps) == 1 and rank == 0 and inp["save_state"]:
            first_mu = {n: t.to("cpu", copy=True) for n, t in pipe.optimizer.mu.items()}
    if rank == 0 and inp["save_state"]:
        torch.save({"params": {n: p.detach().cpu() for n, p in pipe.model.named_parameters()}, "mu": first_mu,
                    "stats": [t.cpu() for t in _bn_buffers(pipe.model)]}, wdir / "state.pt")
    (wdir / f"rank{rank}.json").write_text(json.dumps(dict(
        rank=rank, world=parallel.world_size(), backend=backend, device=str(device), items=len(batch["gt_valid"]),
        initial_checksum=initial, checksum=_checksum(pipe.model), steps=steps)))
    parallel.barrier()
    parallel.shutdown()


def _oracle(pipe, batch: dict, injected: list, ranks: int) -> tuple[list, set, dict]:
    """The one-process data-parallel step, on the card: for each step's
    injected points, each rank's slice's loss and backward from the step's
    starting BatchNorm statistics (the gradients summing), then the mean of
    the gradients and of the slices' statistics, and one ``AdamW3`` step.
    Returns each step's mean loss terms, the parameters whose averaged
    gradient's norm exceeded 1e-6 of the global norm at every step (the
    others' gradients are rounding noise, a bias before a normalisation,
    whose Adam update has a random sign), and Adam's first moment after the
    first step, on the host."""
    from siu3r_tpu_torch import parallel

    named = dict(pipe.model.named_parameters())
    params = list(named.values())
    stats = _bn_buffers(pipe.model)
    out, significant = [], set(named)
    for step in injected:
        start = [t.clone() for t in stats]
        shard_stats, shard_losses = [], []
        for p in params:
            p.grad = None
        for r in range(ranks):
            cut = parallel.shard_slice(len(batch["gt_valid"]), ranks, r)
            for t, s in zip(stats, start):
                t.copy_(s)
            loss, losses = pipe.loss_fn({k: v[cut] for k, v in batch.items()}, None,
                                        [{k: v[cut].cuda() for k, v in d.items()} for d in step])
            loss.backward()
            shard_losses.append({k: float(v) for k, v in losses.items()})
            shard_stats.append([t.clone() for t in stats])
        with torch.no_grad():
            for p in params:
                p.grad = torch.zeros_like(p) if p.grad is None else p.grad.div_(ranks)
            for i, t in enumerate(stats):
                t.copy_(sum(s[i] for s in shard_stats) / ranks)
            norms = {n: torch.linalg.vector_norm(p.grad).item() for n, p in named.items()}
        total = math.sqrt(sum(x * x for x in norms.values()))
        significant &= {n for n, x in norms.items() if x > 1e-6 * total}
        pipe.optimizer.step()
        for p in params:
            p.grad = None
        out.append({k: sum(x[k] for x in shard_losses) / ranks for k in shard_losses[0]})
        if len(out) == 1:
            first_mu = {n: t.to("cpu", copy=True) for n, t in pipe.optimizer.mu.items()}
    return out, significant, first_mu


def _update_rel_l2(before: dict, got: dict, want: dict, names=None) -> tuple[float, float, str]:
    """got's update (after - before) against want's, in relative L2: over
    all the tensors together, and the largest over the tensors ``names``
    (all by default), with its name; a tensor that want leaves in place must
    be left in place by got (else infinity)."""
    worst, where, diff2, ref2 = 0.0, "", 0.0, 0.0
    for n, b in before.items():
        if not b.is_floating_point():
            continue
        g, w, b = got[n].cuda(), want[n].cuda(), b.cuda()
        ref = torch.linalg.vector_norm((w - b).double()).item()
        diff = torch.linalg.vector_norm((g - w).double()).item()
        diff2, ref2 = diff2 + diff * diff, ref2 + ref * ref
        rel = diff / ref if ref > 0 else (0.0 if diff == 0 else math.inf)
        if (names is None or n in names) and rel > worst:
            worst, where = rel, n
    return math.sqrt(diff2 / ref2) if ref2 > 0 else math.inf, worst, where


def _dp_inputs(n_items: int = DP_RANKS):
    """The seed-0 two-view pipeline, a framed global batch of ``n_items`` (on
    the card) and DP_STEPS steps of injected sample points (on the host)."""
    from siu3r_tpu_torch.pipeline import Pipeline

    pipe = Pipeline(_cut_depth(two_view_cfg()), device="cuda", seed=0).init_train(steps_per_epoch=1000)
    mcfg = pipe.cfg.pipeline.model
    batch = _framed_items(pipe, mcfg.num_views, TRAIN_TARGETS, n_items, seed=21)
    injected = [_injected_coords(mcfg, n_items, N_OBJECTS, mcfg.num_views, "cpu", seed=30 + s) for s in range(DP_STEPS)]
    return pipe, batch, injected


def _rank_text(r: dict) -> str:
    return "; ".join(
        f"step {i + 1}: {s['ms']:.1f} ms, peak {s['peak_gib']:.3f} GiB, all_reduce {s['all_reduce_bytes'] / 2**30:.3f} GiB "
        f"in {s['all_reduce_calls']} calls {s['all_reduce_ms']:.1f} ms, launches {s['launches']}"
        for i, s in enumerate(r["steps"]))


def phase_dp_train() -> dict:
    """Two ranks on the one card over gloo (``torchrun --standalone
    --nproc_per_node 2``): configs/scannet.yaml's model at full width (depth
    cut to CUT_DEPTH), a
    global batch of 2 (one item a rank; the config's 3 does not divide by 2),
    2 + 4 views framed as phase train frames them, 48 objects, two data-
    parallel ``Pipeline.train_step``s with injected sample points. Held
    against a one-process oracle on the card (``_oracle``: each rank's slice
    with its points, the gradients and statistics averaged, one ``AdamW3``
    step each): the averaged loss terms within DP_LOSS_RTOL at the first
    step and DP_LATER_LOSS_RTOL at the second, the BatchNorm
    running statistics within DP_STATS_RTOL / DP_STATS_ATOL, each
    parameter's update within DP_UPDATE_REL_L2; both ranks start from the
    oracle's weights and end with the same ones. Each rank's launches of
    kernels 1-6 per step (phase train's), step ms, peak memory and the
    all-reduce's bytes and ms (gloo stages CUDA tensors through the host)."""
    pipe, batch, injected = _dp_inputs()
    before = {n: p.detach().to("cpu", copy=True) for n, p in pipe.model.named_parameters()}
    initial = _checksum(pipe.model)
    oracle_losses, significant, oracle_mu = _oracle(pipe, batch, injected, DP_RANKS)
    oracle = {n: p.detach().to("cpu", copy=True) for n, p in pipe.model.named_parameters()}
    oracle_stats = [t.to("cpu", copy=True) for t in _bn_buffers(pipe.model)]
    expected = {**expected_launches(pipe.cfg.pipeline.model), "bin": 1, "raster": 1, "raster_bwd": 1}
    del pipe
    torch.cuda.empty_cache()
    wdir = Path(tempfile.mkdtemp(prefix="dp_train_"))
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    torch.save({"batch": cpu_batch, "injected": injected, "save_state": True}, wdir / "inputs.pt")
    _DP.update(batch=cpu_batch, injected=injected)
    seconds, _, ranks = _ranks("dp_train", "dp_train", DP_RANKS, wdir, "gloo")
    state = torch.load(wdir / "state.pt", weights_only=False)
    shutil.rmtree(wdir)
    if any(r["initial_checksum"] != initial for r in ranks) or len({r["checksum"] for r in ranks}) != 1:
        raise AssertionError(f"dp_train: the ranks did not start from the oracle's weights ({initial}) or did not "
                             f"end alike: {[(r['initial_checksum'], r['checksum']) for r in ranks]}")
    for r in ranks:
        for s in r["steps"]:
            if s["launches"] != expected or s["variants"] != {"msda.staged": expected["msda"]}:
                raise AssertionError(f"dp_train: rank {r['rank']} launches {s['launches']} {s['variants']} != "
                                     f"expected {expected}")
    # per step, the worst relative difference of a loss term and its term
    loss_rel = [max((abs(s["losses"][k] - want[k]) / max(abs(want[k]), 1e-30), k) for r in ranks for k in want)
                for s, want in zip(ranks[0]["steps"], oracle_losses)]
    loss_excess = max(rel - (DP_LOSS_RTOL if i == 0 else DP_LATER_LOSS_RTOL) for i, (rel, _) in enumerate(loss_rel))
    stats_err = max(((g - w).abs() - DP_STATS_RTOL * w.abs()).max().item()
                    for g, w in zip(state["stats"], oracle_stats))
    update_all, update_rel, where = _update_rel_l2(before, state["params"], oracle, significant)
    zero = {n: torch.zeros_like(t) for n, t in oracle_mu.items()}
    _, mu_rel, mu_where = _update_rel_l2(zero, state["mu"], oracle_mu, significant)
    if (loss_excess > 0 or stats_err > DP_STATS_ATOL or update_all > DP_UPDATE_REL_L2
            or mu_rel > DP_MOMENT_REL_L2):
        raise AssertionError(f"dp_train: against the oracle, loss terms worst rel per step {loss_rel} (rtol "
                             f"{DP_LOSS_RTOL}, then {DP_LATER_LOSS_RTOL}), "
                             f"statistics excess {stats_err:.3g} (atol {DP_STATS_ATOL}), update rel L2 {update_all:.3g} "
                             f"over all (limit {DP_UPDATE_REL_L2}), step 1's first moment worst rel L2 {mu_rel:.3g} "
                             f"({mu_where}) "
                             f"of the {len(significant)} tensors with a gradient (limit {DP_MOMENT_REL_L2})")
    log("dp_train", f"torchrun 2 ranks on one card over gloo, ViT-L 2-view 256x256 fp32 at depth {CUT_DEPTH}, global batch 2 (1 a rank; "
                    f"configs/scannet.yaml's 3 does not divide by 2), 2 + 4 views, {N_OBJECTS} objects, "
                    f"{DP_STEPS} steps with injected points: {seconds:.1f} s; against the one-process oracle: loss "
                    f"terms worst rel per step {[(float(f'{x:.3g}'), k) for x, k in loss_rel]} (rtol {DP_LOSS_RTOL}, "
                    f"then {DP_LATER_LOSS_RTOL}), BatchNorm statistics within "
                    f"rtol {DP_STATS_RTOL} (worst excess {stats_err:.3g} <= {DP_STATS_ATOL}), parameter updates rel "
                    f"L2 {update_all:.3g} over all (limit {DP_UPDATE_REL_L2}; the worst tensor {update_rel:.3g}, "
                    f"{where}), Adam's first moment after step 1 worst rel L2 {mu_rel:.3g} ({mu_where}) of the "
                    f"{len(significant)} "
                    f"of {len(before)} tensors with a gradient above 1e-6 of the norm (limit {DP_MOMENT_REL_L2}); both "
                    f"ranks end with the same weights; totals {[round(s['losses']['total'], 5) for s in ranks[0]['steps']]}")
    for r in ranks:
        log("dp_train", f"rank {r['rank']} ({r['device']}, {r['backend']}): {_rank_text(r)}")
    return dict(seconds=seconds, ranks=ranks, oracle_losses=oracle_losses, loss_rel=loss_rel, stats_excess=stats_err,
                update_rel_l2=update_all, update_rel_l2_worst=update_rel, update_worst=where, moment_rel_l2=mu_rel,
                launches=[r["steps"][-1]["launches"] for r in ranks])


def phase_nccl() -> dict:
    """Phase dp_train's steps under ``torchrun --nproc_per_node 1`` with
    the nccl backend (one item, both steps' points): NCCL's init and
    all-reduce on the card, their bytes and ms (the second step's: the
    first one's all-reduce includes the communicator's set-up). Where the
    machine has two cards, the same two-rank run as phase dp_train over
    nccl, printed (no gate)."""
    if "batch" not in _DP:
        pipe, batch, injected = _dp_inputs()
        _DP.update(batch={k: v.cpu() for k, v in batch.items()}, injected=injected)
        del pipe
        torch.cuda.empty_cache()
    wdir = Path(tempfile.mkdtemp(prefix="nccl_"))
    first = {k: v[:1] for k, v in _DP["batch"].items()}
    torch.save({"batch": first, "injected": [[{k: v[:1] for k, v in d.items()} for d in step]
                                             for step in _DP["injected"]], "save_state": False}, wdir / "inputs.pt")
    seconds, _, (r,) = _ranks("nccl", "dp_train", 1, wdir, "nccl")
    s = r["steps"][-1]
    if (r["backend"] != "nccl" or not s["all_reduce_bytes"]
            or not all(math.isfinite(x) for step in r["steps"] for x in step["losses"].values())):
        raise AssertionError(f"nccl: {r}")
    log("nccl", f"torchrun 1 rank over nccl, ViT-L 2-view 256x256 fp32 at depth {CUT_DEPTH}, B=1: {seconds:.1f} s; {_rank_text(r)}")
    res = dict(seconds=seconds, rank=r, launches=s["launches"])
    if torch.cuda.device_count() >= 2:
        torch.save({"batch": _DP["batch"], "injected": _DP["injected"], "save_state": False}, wdir / "inputs.pt")
        seconds, _, ranks = _ranks("nccl", "dp_train", 2, wdir, "nccl")
        for r in ranks:
            log("nccl", f"two cards over nccl, rank {r['rank']} ({r['device']}): {_rank_text(r)}")
        res["two_cards"] = ranks
    shutil.rmtree(wdir)
    return res


def worker_zero1_train(wdir: Path, backend: str) -> None:
    """One rank of phase zero1_train: configs/scannet_multi.yaml's model
    (seed 0) on its slice of ``inputs.pt``'s batch. From the same state: one
    step with the replicated ``AdamW3`` and one with ZeRO-1
    (``trainer.zero1``, ``Zero1AdamW3``), each with its ms, peak memory,
    launches, collectives and the optimizer state's bytes; then a third,
    ZeRO-1 again, whose averaged gradients are kept on the host, and from
    the same state the replicated ``AdamW3`` update on those gradients, held
    against that step's ZeRO-1 parameters."""
    from siu3r_tpu_torch import parallel
    from siu3r_tpu_torch.pipeline import Pipeline
    from siu3r_tpu_torch.train.optimizer import AdamW3

    device = parallel.init_distributed(backend, "cuda")
    rank = parallel.rank()
    parallel.stats.timed = True
    inp = torch.load(wdir / "inputs.pt", weights_only=False)
    cfg = _cut_depth(multi_cfg())
    pipe = Pipeline(cfg, device=device, seed=0)
    batch = {k: v.to(device) for k, v in parallel.shard_batch(inp["batch"]).items()}
    start = {k: v.detach().cpu().clone() for k, v in pipe.model.state_dict().items()}
    params = dict(pipe.model.named_parameters())
    res, grads = {}, {}
    for mode in ("replicated", "zero1", "zero1, gradients kept"):
        pipe.model.load_state_dict(start)
        pipe.optimizer = None
        torch.cuda.empty_cache()
        cfg.trainer.zero1 = mode != "replicated"
        pipe.init_train(steps_per_epoch=1000)
        opt = pipe.optimizer
        if mode == "zero1, gradients kept":  # on the host, out of the timed and measured steps
            step = opt.step

            def recording_step():
                grads.update({n: p.grad.to("cpu", copy=True) for n, p in params.items()})
                return step()

            opt.step = recording_step
            _dp_step_record(pipe, batch, inp["injected"][0], device)
            break
        rec = _dp_step_record(pipe, batch, inp["injected"][0], device)
        rec["optimizer"] = type(opt).__name__
        rec["state_bytes"] = sum(t.numel() * t.element_size() for t in [*opt.mu.values(), *opt.nu.values()])
        res[mode] = rec
    zero1 = {n: p.detach().clone() for n, p in params.items()}
    pipe.model.load_state_dict(start)
    pipe.optimizer = None
    torch.cuda.empty_cache()
    replicated = AdamW3(pipe.model, cfg.optimizer, cfg.trainer, steps_per_epoch=1000,
                        freeze_encoder=cfg.pipeline.model.croco.freeze == "encoder")
    for n, p in params.items():
        p.grad = grads[n].to(device)
    replicated.step()
    res["zero1_vs_replicated"] = max((p.detach() - zero1[n]).abs().max().item() for n, p in params.items())
    res["moved"] = max((zero1[n] - start[n].to(device)).abs().max().item() for n in params)
    res.update(rank=rank, device=str(device), backend=backend, checksum=float(sum(p.double().sum() for p in zero1.values())))
    (wdir / f"rank{rank}.json").write_text(json.dumps(res))
    parallel.barrier()
    parallel.shutdown()


def phase_zero1_train() -> dict:
    """Two ranks on the one card over gloo, configs/scannet_multi.yaml at full
    width (8 context + 10 target views, 48 objects, one item a rank), one
    step: on each rank the ZeRO-1 parameters within ZERO1_ATOL of the
    replicated ``AdamW3`` update on the same averaged gradients from the
    same state (``worker_zero1_train``), both ranks alike; each rank's
    optimizer-state bytes, step ms and peak memory, ZeRO-1 against the
    replicated step's, and the launches of kernels 1-6."""
    from siu3r_tpu_torch.pipeline import Pipeline

    cfg = _cut_depth(multi_cfg())
    mcfg = cfg.pipeline.model
    pipe = Pipeline(cfg, device="cuda", seed=0)
    batch = _framed_items(pipe, mcfg.num_views, multi_targets(cfg), DP_RANKS, seed=41)
    injected = _injected_coords(mcfg, DP_RANKS, N_OBJECTS, mcfg.num_views, "cpu", seed=42)
    expected = {**expected_launches(mcfg), "bin": 1, "raster": 1, "raster_bwd": 1}
    del pipe
    torch.cuda.empty_cache()
    wdir = Path(tempfile.mkdtemp(prefix="zero1_"))
    torch.save({"batch": {k: v.cpu() for k, v in batch.items()}, "injected": [injected]}, wdir / "inputs.pt")
    del batch
    seconds, _, ranks = _ranks("zero1_train", "zero1_train", DP_RANKS, wdir, "gloo")
    shutil.rmtree(wdir)
    worst = max(r["zero1_vs_replicated"] for r in ranks)
    launches_ok = all(r[m]["launches"] == expected for r in ranks for m in ("replicated", "zero1"))
    if (worst > ZERO1_ATOL or not all(r["moved"] > 0 for r in ranks) or len({r["checksum"] for r in ranks}) != 1
            or not launches_ok or any(r["zero1"]["optimizer"] != "Zero1AdamW3" for r in ranks)):
        raise AssertionError(f"zero1_train: ZeRO-1 against the replicated update {[r['zero1_vs_replicated'] for r in ranks]}"
                             f" (atol {ZERO1_ATOL}), moved {[r['moved'] for r in ranks]}, launches "
                             f"{[(r['replicated']['launches'], r['zero1']['launches']) for r in ranks]} (expected "
                             f"{expected}), checksums {[r['checksum'] for r in ranks]}")
    log("zero1_train", f"torchrun 2 ranks on one card over gloo, configs/scannet_multi.yaml ViT-L 8-view 256x256 fp32 "
                           f"at depth {CUT_DEPTH}, "
                       f"8 + {multi_targets(cfg)} views, {N_OBJECTS} objects, 1 item a rank, one step: {seconds:.1f} s; "
                       f"ZeRO-1 parameters against the replicated AdamW3 update on the same averaged gradients from "
                       f"the same state: worst {worst:.3g} (atol {ZERO1_ATOL}); both ranks alike; launches per step "
                       f"{expected} (expected) on every rank")
    for r in ranks:
        for mode in ("replicated", "zero1"):
            s = r[mode]
            log("zero1_train", f"rank {r['rank']} {mode} ({s['optimizer']}): optimizer state "
                               f"{s['state_bytes'] / 2**30:.3f} GiB, step {s['ms']:.1f} ms, peak {s['peak_gib']:.3f} "
                               f"GiB, all_reduce {s['all_reduce_bytes'] / 2**30:.3f} GiB {s['all_reduce_ms']:.1f} ms, "
                               f"all_gather {s['all_gather_bytes'] / 2**30:.3f} GiB {s['all_gather_ms']:.1f} ms")
    return dict(seconds=seconds, ranks=ranks, worst=worst, launches=[r["zero1"]["launches"] for r in ranks])


def phase_dp_validate() -> dict:
    """``torchrun --nproc_per_node 2 -m siu3r_tpu_torch.cli.validate
    --dist_backend gloo --config configs/scannet.yaml --ckpt W`` on phase
    validate's synthetic root and weights: batch 2 (the default, one scene a
    rank), its VAL_SCENES scenes; the same files as the one-rank sweep of
    phase validate, written once (one writer), and results within the
    limits phase validate holds its CLI to (``_compare_sweeps``, the label
    maps, PROCESS_LIMITS); each rank's launches (``sweep.json``) those of
    kernels 1-5 only; the sweep's ms a scene."""
    from siu3r_tpu_torch.eval import evaluator as E

    if "dir" not in _SWEEP:
        phase_validate()
    here = Path(__file__).resolve().parent
    root, tmp = _SWEEP["root"], Path(_SWEEP["tmp"].name)
    out = tmp / "val_dp"
    seconds, stdout = _torchrun("dp_validate", DP_RANKS, [
        "-m", "siu3r_tpu_torch.cli.validate", "--dist_backend", "gloo", "--config",
        str(here / "configs" / "scannet.yaml"), "--ckpt", str(_SWEEP["weights"]), "--limit",
        str(VAL_SCENES // DP_RANKS), "--output_path", str(out), f"datamodule.dataset_cfg.root={root}"], 600)
    got = json.loads((out / "results.json").read_text())
    sweep = json.loads((out / "sweep.json").read_text())
    files = lambda d: sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())
    if files(out) != files(_SWEEP["dir"]):
        raise AssertionError(f"dp_validate: files {sorted(set(files(out)) ^ set(files(_SWEEP['dir'])))} differ "
                             f"from the one-rank sweep's")
    launches = sweep["launches"]
    bad = [x for x in launches if not all(x.get(k, 0) > 0 for k in ("flash_attn_rope", "flash_attn", "msda", "bin",
                                                                      "raster")) or x.get("raster_bwd", 0)]
    if (sweep["devices"] != DP_RANKS or sweep["batch_size"] != DP_RANKS or sweep["n_scenes"] != VAL_SCENES
            or len(launches) != DP_RANKS or bad):
        raise AssertionError(f"dp_validate: sweep {sweep}")
    agree = _label_agreement(out, _SWEEP["dir"])
    evaluator = E.Evaluator(_sweep_cfg(root).pipeline.evaluator, device="cuda")
    swapped = _swapped_results(evaluator, out, _SWEEP["dir"], tmp)
    excess = _compare_sweeps("dp_validate", got, _SWEEP["results"], agree, PROCESS_LIMITS, swapped)
    diff = _png_diff(out, _SWEEP["dir"])
    shutil.rmtree(out)
    log("dp_validate", f"torchrun 2 ranks on one card over gloo, siu3r_tpu_torch.cli.validate, ViT-L 2-view 256x256 "
                       f"fp32, batch 2 (one scene a rank), {VAL_SCENES} scenes: {seconds:.1f} s; per batch step s "
                       f"{[round(x, 3) for x in sweep['step_seconds']]}, host s "
                       f"{[round(x, 3) for x in sweep['host_seconds']]}; {sweep.get('ms_per_scene', 0):.1f} ms/scene "
                       f"eval step (batches 2-{VAL_SCENES // DP_RANKS}); launches per rank {launches}; the one-rank "
                       f"sweep's files, once; label maps agree {agree:.6f}; excess over the one-rank sweep "
                       f"{({k: float(f'{v:.3g}') for k, v in excess.items()})}; files [n, differing, largest pixel "
                       f"difference] {diff}")
    return dict(seconds=seconds, sweep=sweep, excess=excess, label_agreement=agree, files=diff, launches=launches)


def _train_cli_dp(out: Path, resume: Path, extra: list, nproc: int) -> tuple[float, str]:
    """``siu3r_tpu_torch.cli.train`` on configs/scannet.yaml at the sweep's
    root, ZeRO-1, k = 2, a global batch of 2, max_steps 4, one loader
    worker: under torchrun over gloo on ``nproc`` ranks, or one process."""
    here = Path(__file__).resolve().parent
    args = ["--resume", str(resume), "--config", str(here / "configs" / "scannet.yaml"), "trainer.zero1=true",
            f"trainer.devices={nproc}", "trainer.accumulate_grad_batches=2", "trainer.max_steps=4",
            "trainer.log_every_n_steps=1", "trainer.check_val_every_n_epoch=1", "datamodule.train_loader_cfg.batch_size=2",
            "datamodule.train_loader_cfg.num_workers=1", f"datamodule.dataset_cfg.root={_SWEEP['root']}",
            f"output_path={out}", *[f"pipeline.model.croco.{k}={v}" for k, v in CUT_DEPTH.items()], *extra]
    if nproc > 1:
        return _torchrun("dp_train_cli", nproc, ["-m", "siu3r_tpu_torch.cli.train", "--dist_backend", "gloo", *args],
                         900)
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "siu3r_tpu_torch.cli.train", *args], cwd=here, capture_output=True,
                         text=True, timeout=900)
    if cli.returncode != 0:
        raise RuntimeError(f"dp_train_cli: the one-process run exited {cli.returncode}:\n{cli.stdout[-3000:]}\n"
                           f"{cli.stderr[-4000:]}")
    return time.perf_counter() - t0, cli.stdout


def phase_dp_train_cli() -> dict:
    """``torchrun --nproc_per_node 2 -m siu3r_tpu_torch.cli.train
    --dist_backend gloo`` with ``trainer.zero1=true`` and k = 2 at full width
    (depth cut to CUT_DEPTH),
    a global batch of 2 (three steps an epoch on the six train scenes), from
    a one-process training state of ``_scored`` weights (epoch -1): four
    steps, with train_viz every 2 and a checkpoint at the end of epoch 0, in
    the middle of an accumulation (a step and a half done); then
    ``--resume`` of that checkpoint under two ranks, whose step 3 and final
    checkpoint must equal the uninterrupted run's (the record bitwise; each
    parameter's update from the checkpoint within DP_UPDATE_REL_L2, the
    moments within it in relative L2); then the same checkpoint resumed by a
    one-process ``cli/train`` (ZeRO-1 ignored there), with finite losses."""
    from siu3r_tpu_torch.checkpoint_io import save_train_state
    from siu3r_tpu_torch.pipeline import Pipeline

    root = _sweep_root()
    tmp = Path(_SWEEP["tmp"].name)
    cfg = _cut_depth(_sweep_cfg(root))
    cfg.mode = "train"
    cfg.trainer.accumulate_grad_batches = 2
    pipe = Pipeline(cfg, device="cuda", seed=5).init_train(steps_per_epoch=TRAIN_SCENES // DP_RANKS)
    _scored(pipe.model, 4, depth=0.5, scale=30.0)
    start = tmp / "dp_start.pt"
    save_train_state(start, pipe, -1, 0)
    del pipe
    torch.cuda.empty_cache()
    full, resumed, one = tmp / "dp_cli", tmp / "dp_cli_resumed", tmp / "dp_cli_one"
    full_s, stdout = _train_cli_dp(full, start, ["pipeline.log_training_result_interval=2"], DP_RANKS)
    start.unlink()
    ckpts = sorted(p.name for p in (full / "checkpoints").iterdir())
    records = _train_records(full)
    viz = sorted(p.name for p in (full / "train_viz").iterdir())
    scenes = {p.parent.parent.name for p in (full / "train_viz" / "step0000000").rglob("rgb/*.png")}
    if ([r["step"] for r in records] != [0, 1, 2, 3] or ckpts != ["epoch000-3", "epoch001-4"]
            or viz != ["step0000000", "step0000002"] or len(scenes) != DP_RANKS or "Zero1AdamW3" not in stdout
            or not all(math.isfinite(r["train/total"]) for r in records)):
        raise AssertionError(f"dp_train_cli: records {records}, checkpoints {ckpts}, train_viz {viz} {scenes}:\n"
                             f"{stdout[-3000:]}")
    mid_path = full / "checkpoints" / "epoch000-3"
    mid = torch.load(mid_path, map_location="cpu", mmap=True, weights_only=False)
    if mid["optimizer"]["mini_step"] != 1 or mid["optimizer"]["inner"]["count"] != 1 or mid["optimizer"]["acc"] is None:
        raise AssertionError(f"dp_train_cli: epoch000-3 is not mid-accumulation: mini_step "
                             f"{mid['optimizer']['mini_step']}, count {mid['optimizer']['inner']['count']}")
    resumed_s, rstdout = _train_cli_dp(resumed, mid_path, [], DP_RANKS)
    rrec = _train_records(resumed)
    if "epoch 1, step 3" not in rstdout or [r["step"] for r in rrec] != [3]:
        raise AssertionError(f"dp_train_cli: the resumed run's records {rrec}:\n{rstdout[-3000:]}")
    a = torch.load(full / "checkpoints" / "epoch001-4", map_location="cpu", mmap=True, weights_only=False)
    b = torch.load(resumed / "checkpoints" / "epoch001-4", map_location="cpu", mmap=True, weights_only=False)
    update_rel, _, _ = _update_rel_l2(mid["model"], b["model"], a["model"])
    zero = {n: torch.zeros_like(v) for n, v in a["optimizer"]["inner"]["mu"].items()}
    moments = {key: _update_rel_l2(zero, b["optimizer"]["inner"][key], a["optimizer"]["inner"][key])[0]
               for key in ("mu", "nu")}
    loss_rel = abs(rrec[0]["train/total"] - records[3]["train/total"]) / abs(records[3]["train/total"])
    if loss_rel > DP_LOSS_RTOL or update_rel > DP_UPDATE_REL_L2 or max(moments.values()) > DP_MOMENT_REL_L2:
        raise AssertionError(f"dp_train_cli: the resumed step 3 {rrec[0]['train/total']} against "
                             f"{records[3]['train/total']} (rtol {DP_LOSS_RTOL}); update rel L2 {update_rel:.3g} over "
                             f"all parameters (limit {DP_UPDATE_REL_L2}), moments {moments} (limit "
                             f"{DP_MOMENT_REL_L2})")
    del a, b
    one_s, ostdout = _train_cli_dp(one, mid_path, [], 1)
    orec = _train_records(one)
    if ("epoch 1, step 3" not in ostdout or "AdamW3" not in ostdout or [r["step"] for r in orec] != [3]
            or not math.isfinite(orec[0]["train/total"]) or not (one / "checkpoints" / "epoch001-4").exists()):
        raise AssertionError(f"dp_train_cli: the one-process resume's records {orec}:\n{ostdout[-3000:]}")
    ckpt_gib = mid_path.stat().st_size / 2**30
    del mid
    for d in (full, resumed, one):
        shutil.rmtree(d / "checkpoints")
    log("dp_train_cli", f"torchrun 2 ranks on one card over gloo, siu3r_tpu_torch.cli.train, configs/scannet.yaml "
                        f"(ViT-L 2-view 256x256 fp32 at depth {CUT_DEPTH}), ZeRO-1, k=2, global batch 2, 4 steps: {full_s:.1f} s, totals "
                        f"{[round(r['train/total'], 4) for r in records]}, train_viz {viz} ({len(scenes)} scenes "
                        f"gathered), checkpoints {ckpts} (epoch000-3 mid-accumulation, {ckpt_gib:.3f} GiB in the "
                        f"one-device layout); --resume epoch000-3 under 2 ranks: {resumed_s:.1f} s, step 3's total "
                        f"rel {loss_rel:.3g} (rtol {DP_LOSS_RTOL}), its checkpoint's update rel L2 {update_rel:.3g} "
                        f"over all parameters, moments "
                        f"{({k: float(f'{v:.3g}') for k, v in moments.items()})} (limits {DP_UPDATE_REL_L2}, "
                        f"{DP_MOMENT_REL_L2}); the "
                        f"same checkpoint in one process: {one_s:.1f} s, step 3 total {orec[0]['train/total']:.4f}")
    return dict(full_s=full_s, resumed_s=resumed_s, one_s=one_s, totals=[r["train/total"] for r in records],
                loss_rel=loss_rel, update_rel_l2=update_rel, moments_rel_l2=moments, checkpoint_gib=ckpt_gib,
                one_process_total=orec[0]["train/total"])


WORKERS = {"dp_train": worker_dp_train, "zero1_train": worker_zero1_train}


# ---------------------------------------------------------------- phase 28: off the paths


# the camera functions on the card against the CPU: the JAX package's own
# tolerance for its fp32 modules (tests/test_torch_offpath.py)
CAMERA_RTOL, CAMERA_ATOL = 1e-4, 1e-5


def _hooks(depth: int) -> list:
    """The encoder blocks whose outputs the multi-resolution head takes:
    blocks depth/4, depth/2, 3 depth/4 and depth (0-based indices)."""
    return [depth * k // 4 - 1 for k in (1, 2, 3, 4)]


def _seeded(build, device: str, seed: int):
    """The module ``build()`` makes, materialised on ``device`` with the
    model's seeded init (``SIU3RModel``'s idiom), in eval mode."""
    from siu3r_tpu_torch.models.layers import init_weights

    with torch.device("meta"):
        module = build()
    module.to_empty(device=device)
    return init_weights(module, torch.Generator(device=device).manual_seed(seed)).eval()


def _off_path_modules(cfg, device: str, seed: int, raw: int) -> tuple:
    """The encoder-only backbone of ``cfg`` and, on its width, the
    multi-resolution head and both linear heads, seeded, on ``device``."""
    from siu3r_tpu_torch.models.backbone import CroCoEncoderOnly
    from siu3r_tpu_torch.models.heads import LinearGS, LinearPts3d, MultiResDPTGSHead

    d = cfg.enc_embed_dim
    return (CroCoEncoderOnly(cfg, device=device, seed=seed).eval(),
            _seeded(lambda: MultiResDPTGSHead(raw, (d,) * 4), device, seed + 1),
            _seeded(lambda: LinearPts3d(d), device, seed + 2),
            _seeded(lambda: LinearGS(d, d_out=raw), device, seed + 3))


def _off_path_outputs(modules, images: torch.Tensor) -> dict:
    """Every output of the encoder-only forward and of the three heads on it
    (the multi-resolution head on blocks ``_hooks``, the linear heads on the
    normed last output), by name."""
    enc, multi, pts, gs = modules
    out = enc(images)
    hw = tuple(images.shape[2:4])
    res = {"feat1": out.feat1, "feat2": out.feat2,
           **{f"all_feat{v}.{i}": t for v in (1, 2) for i, t in enumerate(getattr(out, f"all_feat{v}"))}}
    scales = multi([out.all_feat1[i] for i in _hooks(len(out.all_feat1))], images[:, 0], hw)
    res.update({f"multi_res.ds{ds}": t for ds, t in zip((4, 8, 16, 32), scales)})
    res["linear_pts3d"] = pts([out.feat1], hw)
    res["linear_gs"] = gs([out.feat1], hw)
    return res


def _off_path_slice(phase: str, raw: int) -> float:
    """The small config's encoder (4 x 512, 8 heads: D = 64, as phase 4's)
    and the three heads on the GPU (kernel 1) against the same weights on
    the CPU (plain versions), at 64x64: every output within SLICE_RTOL /
    SLICE_ATOL. Returns the worst excess."""
    from siu3r_tpu_torch.config import CrocoCfg

    cfg = CrocoCfg(enc_depth=4, enc_embed_dim=512, enc_num_heads=8)
    gpu = _off_path_modules(cfg, "cuda", 7, raw)
    cpu = _off_path_modules(cfg, "cpu", 0, raw)
    for g, c in zip(gpu, cpu):
        c.load_state_dict({k: v.cpu() for k, v in g.state_dict().items()})
    images = torch.from_numpy(np.random.RandomState(3).rand(1, 2, 64, 64, 3).astype(np.float32))
    with torch.inference_mode():
        og = _off_path_outputs(gpu, images.cuda())
        oc = _off_path_outputs(cpu, images)
    worst = 0.0
    for key, b in oc.items():
        a = og[key].cpu().double()
        excess = ((a - b.double()).abs() - SLICE_RTOL * b.double().abs()).max().item()
        worst = max(worst, excess)
        if tuple(a.shape) != tuple(b.shape) or not torch.isfinite(a).all() or excess > SLICE_ATOL:
            raise AssertionError(f"{phase}: small config {key} {tuple(a.shape)} differs from the cpu's by {excess} "
                                 f"beyond rtol {SLICE_RTOL}")
    log(phase, f"small config (encoder 4 x 512, 8 heads, 64x64, 2 views; the multi-resolution head and both linear "
               f"heads on it) on cuda (kernels) vs cpu (plain): {len(oc)} outputs within rtol {SLICE_RTOL} atol "
               f"{SLICE_ATOL} (worst excess {worst:.3g})")
    return worst


def _encoder_only_forward(phase: str, enc, images, dtype: torch.dtype) -> tuple:
    """One encoder-only forward in ``dtype`` on ``enc``'s weights: launch
    counts (kernel 1, or kernel 1b in its resident variant, once a block; no
    other kernel), no host sync, finite outputs of the expected shapes; 12
    warm forwards timed; kernel 1 or 1b held against its plain version on the
    forward's own inputs. Returns (output, result)."""
    from siu3r_tpu_torch.models.layers import set_layers_dtype

    depth, width = enc.cfg.enc_depth, enc.cfg.enc_embed_dim
    set_layers_dtype(enc, dtype)
    run = lambda: enc(images)
    expected = {"flash_attn_rope_bf16" if dtype == torch.bfloat16 else "flash_attn_rope": depth}
    with torch.inference_mode():
        out = _counted_run(phase, run, expected)
        grid = (images.shape[2] // 16) * (images.shape[3] // 16)
        feats = [out.feat1, out.feat2, *out.all_feat1, *out.all_feat2]
        if len(out.all_feat1) != depth or out.dec1 or out.dec2 or any(
                tuple(t.shape) != (images.shape[0], grid, width) or not torch.isfinite(t).all() for t in feats):
            raise AssertionError(f"{phase}: encoder-only outputs {[tuple(t.shape) for t in feats[:3]]} ..., "
                                 f"expected [{images.shape[0]}, {grid}, {width}], finite, and no decoder outputs")
        res = dict(launches=expected, **_timed_runs(run, 12))
        res["kernels"] = _check_model_kernels(f"{phase} {str(dtype).removeprefix('torch.')}", run, 20)
    log(phase, f"encoder only, ViT-L {depth} x {width}, 2 views 256x256 B=1, {str(dtype).removeprefix('torch.')}: "
               f"launches {expected} (expected), no host sync, outputs finite; {_timing_text(res, 'forwards')}")
    for name, ms in res["top_device_ms"][:5]:
        log(phase, f"  device {ms:8.3f} ms  {name[:100]}")
    return out, res


def _camera_on_card(phase: str) -> int:
    """Every function of ``siu3r_tpu_torch.camera`` on CUDA tensors against
    the same call on the CPU, within CAMERA_RTOL / CAMERA_ATOL, with no host
    sync; ``intersect_rays`` with a parallel pair (inf, no NaN) and an
    opposite pair; ``sample_training_rays`` against the CPU's full-grid
    world rays at the indices its CUDA generator draws. Returns the number
    of outputs compared."""
    from siu3r_tpu_torch import camera as C

    rng = np.random.RandomState(5)
    f32 = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    q = torch.linalg.qr(f32(2, 3, 3, 3)).Q
    ext = torch.eye(4).repeat(2, 3, 1, 1)
    ext[..., :3, :3] = q * torch.linalg.det(q)[..., None, None]  # det +1
    ext[..., :3, 3] = f32(2, 3, 3)
    intr = torch.eye(3).repeat(2, 3, 1, 1)
    intr[..., 0, 0] = 1.2 + 0.1 * f32(2, 3)
    intr[..., 1, 1] = 1.1 + 0.1 * f32(2, 3)
    intr[..., :2, 2] = 0.5 + 0.05 * f32(2, 3, 2)
    unit = lambda x: x / x.norm(dim=-1, keepdim=True)
    ox, oy, dx, dy = f32(64, 3), f32(64, 3), unit(f32(64, 3)), unit(f32(64, 3))
    dy[0] = dx[0]  # parallel: inf
    dy[1] = -dx[1]  # opposite: the point of the middle line nearest the origin
    xy = torch.from_numpy(rng.rand(2, 3, 50, 2).astype(np.float32))
    # camera-space points at least 0.5 in front (near the camera plane the
    # projection divides rounding noise by a small depth), and the same
    # points in the world
    pts = f32(2, 3, 50, 3)
    pts[..., 2] = pts[..., 2].abs() + 0.5
    world = C.transform_cam2world(C.homogenize_points(pts), ext[..., None, :, :])[..., :3]
    near = torch.from_numpy(rng.uniform(0.1, 1.0, 4).astype(np.float32))
    calls = {
        "homogenize_points": (C.homogenize_points, (pts,)),
        "homogenize_vectors": (C.homogenize_vectors, (pts,)),
        "transform_rigid": (C.transform_rigid, (C.homogenize_points(pts), ext[..., None, :, :])),
        "transform_cam2world": (C.transform_cam2world, (C.homogenize_points(pts), ext[..., None, :, :])),
        "transform_world2cam": (C.transform_world2cam, (C.homogenize_points(pts), ext[..., None, :, :])),
        "project_camera_space": (C.project_camera_space, (pts, intr[..., None, :, :])),
        "project": (C.project, (world, ext[..., None, :, :], intr[..., None, :, :])),
        "unproject": (C.unproject, (xy, pts[..., 2], intr[..., None, :, :])),
        "get_local_rays": (C.get_local_rays, (xy, intr[..., None, :, :])),
        "get_world_rays": (C.get_world_rays, (xy, ext[..., None, :, :], intr[..., None, :, :])),
        "intersect_rays": (C.intersect_rays, (ox, dx, oy, dy)),
        "get_fov": (C.get_fov, (intr,)),
        "get_projection_matrix": (C.get_projection_matrix, (near, near + 50.0, near + 0.5, near + 0.3)),
        "relative_pose": (C.relative_pose, (ext,)),
    }
    n = 0
    for name, (fn, args) in calls.items():
        want = fn(*args)
        dev_args = tuple(a.cuda() for a in args)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        got = fn(*dev_args)
        torch.cuda.set_sync_debug_mode("default")
        for g, w in zip(*((x,) if isinstance(x, torch.Tensor) else x for x in (got, want))):
            n += 1
            g = g.cpu()
            if g.dtype == torch.bool:
                ok = torch.equal(g, w)
            else:
                ok = torch.isfinite(g).all() and torch.allclose(g, w, rtol=CAMERA_RTOL, atol=CAMERA_ATOL)
            if not ok:
                raise AssertionError(f"{phase}: camera {name} on cuda differs from the cpu beyond rtol "
                                     f"{CAMERA_RTOL} atol {CAMERA_ATOL}")
        if name == "intersect_rays" and not (bool((got[0] == 1e10).all()) and bool(torch.isfinite(got).all())
                                             and not bool((got[1:] == 1e10).any())):
            raise AssertionError(f"{phase}: intersect_rays: the parallel pair is not inf, or another is")
    image = torch.from_numpy(rng.rand(2, 3, 4, 5, 3).astype(np.float32))
    dev_args = (image.cuda(), intr.cuda(), ext.cuda())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    grid = C.sample_image_grid((4, 5), device="cuda")
    rays = C.sample_training_rays(*dev_args, 32, torch.Generator(device="cuda").manual_seed(9))
    torch.cuda.set_sync_debug_mode("default")
    xy_grid, ij = C.sample_image_grid((4, 5))
    # (the card divides by a scalar as a product with its reciprocal: within an ulp)
    if not (torch.equal(grid[1].cpu(), ij) and torch.allclose(grid[0].cpu(), xy_grid, rtol=CAMERA_RTOL,
                                                               atol=CAMERA_ATOL)):
        raise AssertionError(f"{phase}: sample_image_grid on cuda differs from the cpu")
    # the indices the function drew: the same draw from a generator of the same seed
    idx = torch.randint(0, 3 * 4 * 5, (2, 32), device="cuda", generator=torch.Generator(device="cuda").manual_seed(9))
    idx = idx.cpu()[..., None]
    wo, wd = C.get_world_rays(xy_grid[..., None, None, :], ext, intr)
    at = lambda t: t.reshape(2, 60, -1).gather(1, idx.expand(-1, -1, t.shape[-1]))
    for got, want in zip(rays, (at(wo.permute(2, 3, 0, 1, 4)), at(wd.permute(2, 3, 0, 1, 4)), at(image))):
        n += 1
        if not torch.allclose(got.cpu(), want, rtol=CAMERA_RTOL, atol=CAMERA_ATOL):
            raise AssertionError(f"{phase}: sample_training_rays on cuda differs from the cpu's rays at its indices")
    log(phase, f"camera: {len(calls) + 2} functions, {n} outputs on cuda equal to the cpu's within rtol {CAMERA_RTOL} "
               f"atol {CAMERA_ATOL}, no host sync; intersect_rays: the parallel pair inf, the opposite pair finite")
    return n


def _bin_against_sort(phase: str, name: str, gen, g: int, views: int) -> dict:
    """Kernel 4 against ``bin_gaussians_sort`` on a synthetic scene of g
    Gaussians seen by ``views`` cameras (K = 4096): tables equal up to each
    tile's count, counts equal; then kernel 4 against its plain version,
    timed (``check_bin``), and the sort path's device time beside it."""
    from siu3r_tpu_torch.kernels.binning import bin_gaussians
    from siu3r_tpu_torch.render.rasterizer import bin_gaussians_sort

    k = 4096
    proj, _ = _synthetic_scene(gen, g, views)
    sort = lambda: bin_gaussians_sort(proj, IMAGE, k, *SLOTS)
    if not _same_table(bin_gaussians(proj, IMAGE, k, *SLOTS), sort()):
        raise AssertionError(f"{phase}: {name}: the binning kernel's tables or counts differ from the sort path's")
    res = check_bin(f"{phase} {name}", proj, k, 20)
    res["sort_ms"] = time_ms(sort, 10, whole=True, events=False)[0]
    log(phase, f"bin {name} ({views} views, G = {g}, K = {k}): kernel 4 equal to the sort path (tables up to each "
               f"count, counts); kernel {res['ms']:.5f} ms (bound {res['bound_ms']:.5f}, plain {res['plain_ms']:.5f}), "
               f"sort path {res['sort_ms']:.5f} ms")
    return res


def phase_off_path() -> dict:
    """The modules no model builds: the encoder-only backbone at full ViT-L
    width (fp32, then bf16 on the same weights), the multi-resolution and
    linear heads at full width on its outputs, the small config's encoder
    and heads against the CPU, the camera functions against the CPU, and
    kernel 4 against the sort path at the eval and 8-view eval shapes."""
    from siu3r_tpu_torch.config import CrocoCfg
    from siu3r_tpu_torch.models.layers import set_layers_dtype

    phase = "off_path"
    raw = two_view_cfg().pipeline.model.gaussian_head.raw_dim
    res = {"slice_excess": _off_path_slice(phase, raw)}
    modules = _off_path_modules(CrocoCfg(), "cuda", 0, raw)
    enc = modules[0]
    images, _ = _view_inputs(2)
    out32, res["fp32"] = _encoder_only_forward(phase, enc, images, torch.float32)
    out16, res["bf16"] = _encoder_only_forward(phase, enc, images, torch.bfloat16)
    res["bf16_feat_rel"] = ((out16.feat1 - out32.feat1).abs().mean() / out32.feat1.abs().mean()).item()
    if not res["bf16_feat_rel"] < ORACLE_MEANS_REL:
        raise AssertionError(f"{phase}: the bf16 encoder's output off the fp32 one by a mean relative error of "
                             f"{res['bf16_feat_rel']:.4g} (limit {ORACLE_MEANS_REL})")
    set_layers_dtype(enc, torch.float32)
    with torch.inference_mode():
        heads = _off_path_outputs(modules, images)
    want = {f"multi_res.ds{ds}": (1, 256 // ds, 256 // ds, raw) for ds in (4, 8, 16, 32)}
    want.update(linear_pts3d=(1, 256, 256, 3), linear_gs=(1, 256, 256, raw))
    for key, shape in want.items():
        if tuple(heads[key].shape) != shape or not torch.isfinite(heads[key]).all():
            raise AssertionError(f"{phase}: {key} {tuple(heads[key].shape)}, expected {shape} and finite")
    log(phase, f"bf16 encoder output against fp32 on the same weights: mean rel err {res['bf16_feat_rel']:.4g} "
               f"(limit {ORACLE_MEANS_REL}); bf16 device {res['bf16']['device_ms']:.3f} ms against fp32 "
               f"{res['fp32']['device_ms']:.3f}; full-width heads on its blocks {_hooks(enc.cfg.enc_depth)} and "
               f"its output: {want}, finite")
    del modules, enc, out32, out16, heads
    torch.cuda.empty_cache()
    res["camera_outputs"] = _camera_on_card(phase)
    gen = torch.Generator(device="cuda").manual_seed(2468)
    mcfg = multi_cfg()
    res["bin"] = {"eval_shapes": _bin_against_sort(phase, "eval_shapes", gen, 2 * 256 * 256, N_TARGET),
                  "multi_view": _bin_against_sort(phase, "multi_view", gen, mcfg.pipeline.model.num_views * 256 * 256,
                                                  multi_targets(mcfg))}
    return res


# ---------------------------------------------------------------- phase 29: full width against the JAX package


def _fullwidth_common():
    """tests/torch_fullwidth_common.py: the full-width config, its numpy
    weights and inputs (numpy, torch and the port only)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_fullwidth_common

    return torch_fullwidth_common


def phase_fullwidth() -> dict:
    """configs/scannet.yaml's model at every width, cut to 4 / 4 + 4 blocks
    and 4 + 1 Mask2Former layers, with weights drawn from numpy
    (tests/torch_fullwidth_common.py), on the card against the JAX package's
    numbers for the same weights and inputs (tests/torch_fullwidth_ref.npz):
    ``Pipeline.eval_step`` over the two views and the fixture's 2 framed
    targets, its launches counted (kernels 1-3 in the forward, 4 and 5 in
    the render) with no host sync; then, with the masked attention given the
    reference's decision at its ties, the subset of every Gaussian field, the
    class logits and kept queries within rtol 1e-3 / atol 1e-4 x the field's
    largest magnitude, the label maps exact outside the reference's ties,
    colour, depth and alpha within 2e-4 on 99.9% of the pixels."""
    from siu3r_tpu_torch.pipeline import Pipeline

    phase = "fullwidth"
    C = _fullwidth_common()
    with np.load(C.FIXTURE) as f:
        fx = {k: f[k] for k in f.files}
    root = two_view_cfg()
    root.pipeline.model = mcfg = C.fullwidth_cfg("cut")
    pipe = Pipeline(root, device="cuda", seed=0)
    C.fill_numpy_weights(pipe.model)
    images, intr = (torch.from_numpy(x).cuda() for x in C.fullwidth_inputs(mcfg))
    targets = tuple(torch.from_numpy(fx[k]).cuda() for k in ("target_ext", "target_intr"))
    batch = _eval_batch(images, intr, targets)
    expected = {**expected_launches(mcfg), "bin": 1, "raster": 2}
    _counted_run(phase, lambda: pipe.eval_step(batch), expected)
    log(phase, f"Pipeline.eval_step at full width, depth 4 / 4 + 4 (Mask2Former 4 + 1), numpy weights, "
               f"{C.N_TARGETS} framed targets: launches {expected} (expected), no host sync")

    layers = mcfg.mask2former.decoder_layers
    ties = [(fx[f"mask_ties_{i}"], fx[f"mask_excl_{i}"]) for i in range(layers)]
    with C.reference_ties(pipe.model, ties) as changed:
        out, render, qc = pipe.eval_step(batch)
    sub = torch.from_numpy(fx["subset"]).cuda()
    floats = {f: (getattr(out.gaussians, f) if f == "seg_query_scores" else getattr(out.gaussians, f)[:, sub],
                  fx[f"g_{f}"], float(fx[f"scale_{f}"])) for f in C.GAUSSIAN_FIELDS}
    floats["class_logits"] = (out.seg.class_queries_logits, fx["class_logits"], None)
    excess = {k: C.excess(got, want, scale=scale) for k, (got, want, scale) in floats.items()}
    largest = {k: (got.float().cpu() - torch.from_numpy(want)).abs().max().item()
               for k, (got, want, _) in floats.items()}
    keep_equal = bool(np.array_equal(out.post["keep"].cpu().numpy(), fx["keep"]))
    misses = {k: C.label_misses(out.post[k], fx[k], fx["label_ties"]) for k in ("semantic", "segmentation")}
    shares = {k: C.render_share(getattr(render, k), fx[k]) for k in ("color", "depth", "alpha")}
    render_abs = {k: (getattr(render, k).cpu() - torch.from_numpy(fx[k])).abs().max().item()
                  for k in ("color", "depth", "alpha")}
    n_changed = [int(c) for c in changed]
    text = lambda d, fmt: ", ".join(f"{k} {v:{fmt}}" for k, v in d.items())
    log(phase, f"against the JAX package: excess over rtol {C.RTOL} / atol {C.ATOL_SCALE} x max (<= 0 passes) "
               f"{text(excess, '.3g')}; largest abs errors {text(largest, '.3g')}; kept queries equal {keep_equal} "
               f"({int(fx['keep'].sum())} kept); labels differing (outside the reference's "
               f"{len(fx['label_ties'])} ties) " + ", ".join(f"{k} {d} ({o})" for k, (d, o) in misses.items())
               + f"; masked-attention tie bits given the reference's decision {n_changed} of "
               f"{[len(i) for i, _ in ties]}; render share within {C.RENDER_ATOL} {text(shares, '.6f')} "
               f"(largest abs {text(render_abs, '.3g')}), mean alpha {render.alpha.mean().item():.3f}")
    bad = [k for k, v in excess.items() if v > 0]
    bad += [k for k, (_, outside) in misses.items() if outside]
    bad += [k for k, v in shares.items() if v < C.RENDER_SHARE]
    if not keep_equal:
        bad.append("keep")
    if bad:
        raise AssertionError(f"{phase}: the GPU run misses the JAX package's numbers in {bad}")
    del out, render, qc, pipe
    torch.cuda.empty_cache()
    return dict(launches=expected, excess=excess, largest_abs=largest, label_misses=misses, render_share=shares,
                render_abs=render_abs, keep_equal=keep_equal, tie_bits_changed=n_changed)


# ---------------------------------------------------------------- main


SOURCES = {
    "flash_attn_rope": ("siu3r_tpu_torch/csrc/flash_attention.cu", "siu3r_tpu/ops/flash_attention.py:67"),
    "flash_attn": ("siu3r_tpu_torch/csrc/flash_attention.cu", "siu3r_tpu/ops/flash_attention.py:33"),
    # kernel 1b: the same TPU kernel on bf16 q, k, v
    "flash_attn_rope_bf16": ("siu3r_tpu_torch/csrc/flash_attention.cu", "siu3r_tpu/ops/flash_attention.py:67"),
    "msda": ("siu3r_tpu_torch/csrc/msda.cu", "siu3r_tpu/ops/msda_pallas.py:44"),
    "bin": ("siu3r_tpu_torch/csrc/binning.cu", "siu3r_tpu/render/rasterizer.py:189"),
    "raster": ("siu3r_tpu_torch/csrc/raster.cu", "siu3r_tpu/render/rasterizer.py:379"),
    "raster_bwd": ("siu3r_tpu_torch/csrc/raster_bwd.cu", "siu3r_tpu/render/rasterizer.py:527"),
}
PHASES = {"kernels": phase_kernels, "render_kernels": phase_render_kernels, "raster_bwd": phase_raster_bwd,
          "autograd": phase_autograd, "slice": phase_slice_check, "bf16_slice": phase_bf16_slice,
          "forward": phase_forward, "bf16_forward": phase_bf16_forward, "eval": phase_eval,
          "bf16_eval": phase_bf16_eval, "train": phase_train, "bf16_train": phase_bf16_train, "cli": phase_cli, "multi_slice": phase_multi_slice,
          "multi_forward": phase_multi_forward, "bf16_multi_forward": phase_bf16_multi_forward,
          "multi_eval": phase_multi_eval, "multi_train": phase_multi_train,
          "multi_cli": phase_multi_cli, "refer_slice": phase_refer_slice, "refer_forward": phase_refer_forward,
          "refer_eval": phase_refer_eval, "refer_train": phase_refer_train, "refer_cli": phase_refer_cli,
          "val_slice": phase_val_slice, "validate": phase_validate, "evaluate": phase_evaluate,
          "dp_validate": phase_dp_validate, "train_cli": phase_train_cli, "dp_train": phase_dp_train,
          "zero1_train": phase_zero1_train, "dp_train_cli": phase_dp_train_cli, "nccl": phase_nccl,
          "off_path": phase_off_path, "fullwidth": phase_fullwidth}


T0 = time.perf_counter()
SM_CLOCKS: dict = {}  # phase -> the SM clock (current, max) at its start and end
PHASE_SECONDS: dict = {}  # phase -> its seconds


def run_phase(name: str):
    """Run phase ``name`` between two samples of the SM clock, logged on the
    phase's lines."""
    start = sm_clock()
    t0 = time.perf_counter()
    out = PHASES[name]()
    seconds = time.perf_counter() - t0
    PHASE_SECONDS[name] = round(seconds, 1)
    SM_CLOCKS[name] = [start, sm_clock()]
    log(name, f"SM clock (current, max) at the start {SM_CLOCKS[name][0]}, at the end {SM_CLOCKS[name][1]}; "
              f"{seconds:.1f} s")
    return out


def _raster_sum(checks: list) -> dict:
    """One entry for the raster launches of a step: times summed, the bound
    named by the largest one."""
    out = {key: sum(r[key] for r in checks) for key in ("ms", "plain_ms", "bound_ms")}
    out["err"] = max(r["err"] for r in checks)
    out["bound_by"] = max(checks, key=lambda r: r["bound_ms"])["bound_by"]
    return out


def _off_path_entry(name: str, off: dict) -> dict:
    """A kernel's entry under "off_path": its launches in one encoder-only
    forward, fp32 and bf16; for kernels 1 and 1b their times on that
    forward's inputs; for kernel 4 its times at the eval and 8-view eval
    shapes with the sort path's beside them."""
    entry = {"launches": off["fp32"]["launches"].get(name, 0), "bf16_launches": off["bf16"]["launches"].get(name, 0)}
    timed = {"flash_attn_rope": off["fp32"]["kernels"], "flash_attn_rope_bf16": off["bf16"]["kernels"]}.get(name)
    if timed:
        entry.update({k: timed[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    if name == "bin":
        entry.update({shape: {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "sort_ms")}
                      for shape, r in off["bin"].items()})
    return entry


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--report", type=str, default=None, help="also write every number as JSON here")
    parser.add_argument("--phases", type=str, default=",".join(PHASES),
                        help="comma-separated phases to run after the environment and the build "
                             f"(default: all of {','.join(PHASES)}); the JSON lines need all of them")
    # the data-parallel phases start this script on each rank under torchrun
    parser.add_argument("--rank_worker", choices=sorted(WORKERS), default=None, help=argparse.SUPPRESS)
    parser.add_argument("--worker_dir", type=str, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--dist_backend", choices=("nccl", "gloo"), default="nccl", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank_worker:
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU only")
        WORKERS[args.rank_worker](Path(args.worker_dir), args.dist_backend)
        return
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        parser.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")

    smi = phase_environment()
    phase_build()
    if set(phases) != set(PHASES):
        for name in PHASES:
            if name in phases:
                run_phase(name)
        log("done", f"phases {phases} passed; {len(TIMED_BY_EVENTS)} kernel times by CUDA events for want of "
                    f"a whole trace; no JSON lines (they need every phase)")
        return
    per_kernel = run_phase("kernels")
    render_err = run_phase("render_kernels")
    bwd_err = run_phase("raster_bwd")
    run_phase("autograd")
    run_phase("slice")
    run_phase("bf16_slice")
    fwd = run_phase("forward")
    bfwd = run_phase("bf16_forward")
    ev = run_phase("eval")
    bev = run_phase("bf16_eval")
    tr = run_phase("train")
    btr = run_phase("bf16_train")
    run_phase("cli")
    run_phase("multi_slice")
    mfwd = run_phase("multi_forward")
    bmfwd = run_phase("bf16_multi_forward")
    mev = run_phase("multi_eval")
    mtr = run_phase("multi_train")
    run_phase("multi_cli")
    run_phase("refer_slice")
    rfwd = run_phase("refer_forward")
    rev = run_phase("refer_eval")
    rtr = run_phase("refer_train")
    rcli = run_phase("refer_cli")
    vsl = run_phase("val_slice")
    val = run_phase("validate")
    evl = run_phase("evaluate")
    dval = run_phase("dp_validate")
    tcli = run_phase("train_cli")
    dtr = run_phase("dp_train")
    ztr = run_phase("zero1_train")
    dcli = run_phase("dp_train_cli")
    nccl = run_phase("nccl")
    off = run_phase("off_path")
    fw = run_phase("fullwidth")
    _SWEEP["tmp"].cleanup()

    # per kernel: the two-view path's launches and times (model kernels per
    # forward, at its shapes; render kernels per eval step and kernel 6 per
    # train step, on the step's own inputs), then the multi-view path's, each
    # on its own run's inputs
    two_view = {**per_kernel, "bin": ev["bin"], "raster": _raster_sum(ev["raster"]), "raster_bwd": tr["raster_bwd"]}
    two_view_launches = {**fwd["launches"], "bin": ev["launches"]["bin"], "raster": ev["launches"]["raster"],
                         "raster_bwd": tr["launches"]["raster_bwd"]}
    multi = {**mfwd["kernels"], "bin": mev["bin"], "raster": _raster_sum(mev["raster"]),
             "raster_bwd": mtr["raster_bwd"]}
    multi_launches = {**mfwd["launches"], "bin": mev["launches"]["bin"], "raster": mev["launches"]["raster"],
                      "raster_bwd": mtr["launches"]["raster_bwd"]}
    worst = {**{k: max(two_view[k]["err"], rfwd["kernels"][k]["err"], bfwd["kernels"][k]["err"],
                        bmfwd["kernels"][k]["err"]) for k in per_kernel}, "bin": render_err["bin"],
             "raster": max(render_err["raster"], two_view["raster"]["err"]),
             "raster_bwd": max(bwd_err, tr["raster_bwd"]["err"], btr["raster_bwd"]["err"])}
    worst.update({k: max(worst[k], r["err"]) for k, r in tcli["kernels"].items()})
    worst.update({k: max(worst[k], off[dt]["kernels"][k]["err"])
                  for k, dt in (("flash_attn_rope", "fp32"), ("flash_attn_rope_bf16", "bf16"))})
    # the refer path's: the model kernels per refer forward on its own inputs
    # (the language layers' attention shape also on its own); no render
    # kernel 1b runs on the bf16 paths only: its launches are the bf16
    # forward's (and the bf16 8-view forward's under "multi_view"), its times
    # per bf16 forward at the main path's shapes (phase kernels)
    bf16 = "flash_attn_rope_bf16"
    two_view_launches[bf16] = bfwd["launches"][bf16]
    multi[bf16] = bmfwd["kernels"][bf16]
    multi_launches[bf16] = bmfwd["launches"][bf16]
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        acc, macc = two_view[name], multi[name]
        racc = rfwd["kernels"].get(name)
        refer = {"launches": rfwd["launches"].get(name, 0),
                 **{k: None if racc is None else racc.get(k) for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                                        "library_ms")}}
        if name == "flash_attn":
            refer["language_shape"] = rfwd["language_shape"]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": two_view_launches[name], "max_abs_err": max(worst[name], macc["err"]),
            "ms": acc["ms"], "plain_ms": acc["plain_ms"], "bound_ms": acc["bound_ms"],
            "bound_by": acc["bound_by"], "library_ms": acc.get("library_ms"),
            "multi_view": {"launches": multi_launches[name], "ms": macc["ms"], "plain_ms": macc["plain_ms"],
                           "bound_ms": macc["bound_ms"], "bound_by": macc["bound_by"],
                           "library_ms": macc.get("library_ms")},
            "refer": refer,
            # this slice's paths: one eval step of the validation sweep, one
            # micro-step of the training loop (B = 3, k = 2)
            "validate": {"launches": val["launches"].get(name, 0)},
            "train_cli": {"launches": tcli["launches"].get(name, 0),
                          **({k: tcli["kernels"][name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
                             if name in tcli["kernels"] else {})},
            # the data-parallel paths, each rank's launches: one step of
            # phases dp_train, zero1_train and nccl, the whole sweep of
            # dp_validate
            **{phase: {"launches": [x.get(name, 0) for x in res["launches"]]}
               for phase, res in (("dp_train", dtr), ("zero1_train", ztr), ("dp_validate", dval))},
            "nccl": {"launches": nccl["launches"].get(name, 0)},
            # the bf16 compute path's launches: one forward, one eval step,
            # one 8-view forward; its times per forward on its own inputs
            "bf16": {"launches": bfwd["launches"].get(name, 0),
                     **{k: bfwd["kernels"][name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")
                        if name in bfwd["kernels"]}},
            "bf16_eval": {"launches": bev["launches"].get(name, 0)},
            # one bf16 train step (phase bf16_train): its launches, and
            # kernel 6's time on the step's own inputs
            "bf16_train": {"launches": btr["launches"].get(name, 0),
                           **({k: btr["raster_bwd"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
                              if name == "raster_bwd" else {})},
            "bf16_multi_view": {"launches": bmfwd["launches"].get(name, 0),
                                **{k: bmfwd["kernels"][name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")
                                   if name in bmfwd["kernels"]}},
            "off_path": _off_path_entry(name, off),
            # one eval step of the full-width model held against the JAX
            # package's numbers (phase fullwidth)
            "fullwidth": {"launches": fw["launches"].get(name, 0)},
        })
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(
            {"card": smi, "kernels": kernels, "forward": fwd, "eval": ev, "train": tr, "bf16_train": btr,
             "multi_forward": mfwd,
             "bf16_forward": bfwd, "bf16_eval": bev, "bf16_multi_forward": bmfwd,
             "multi_eval": mev, "multi_train": mtr, "refer_forward": rfwd, "refer_eval": rev, "refer_train": rtr,
             "refer_cli": rcli, "val_slice": vsl, "validate": val, "evaluate": evl, "train_cli": tcli,
             "dp_validate": dval, "dp_train": dtr, "zero1_train": ztr, "dp_train_cli": dcli, "nccl": nccl,
             "off_path": off, "fullwidth": fw, "sm_clock": SM_CLOCKS, "phase_seconds": PHASE_SECONDS},
            indent=1, default=str))
    log("done", f"every phase passed; {len(TIMED_BY_EVENTS)} kernel times by CUDA events for want of a whole "
                f"trace; seconds by phase {PHASE_SECONDS}, "
                f"{sum(PHASE_SECONDS.values()):.1f} s in all, from the start {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
