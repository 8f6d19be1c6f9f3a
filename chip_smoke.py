#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. requires CUDA and prints the card's name and power limit;
2. builds the port's CUDA kernels from ``classpose_tpu_torch/csrc`` with
   nvcc (one process per source, in parallel) and prints the build time;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes the main paths give it (attention forward: 25 crops × 16 heads
   × 1024 tokens, bf16; attention backward: 8 crops × 16 heads × 1024
   tokens, bf16; sampler and diffusion: 8 tiles of 1024²; histogram: 8
   tiles of 1024² on a uniform input (pixels land within ±8 px of
   themselves) and a converged one (every foreground pixel of the design
   field on its cell's centre, the line's numbers), and on the eval_batch
   path's own input from step 4's warm-up; LayerNorm: (25, 1024, 1024)
   bf16 with the fast variance and (25, 32, 32, 256) bf16 two-pass;
   kernel 4 also on a 512² training target at 1200 iterations, with its
   launches per call; kernel 7 (the diffusion from a start field, on
   kernel 4's body), bitwise, timed with its launches per call at the
   evaluate QC of one 448² image at niter 80 (the line's numbers, with
   the wall of one call given an int count, which reads nothing back), a
   500² target at 100, 8 × 448² at 40/80/120, a 2048² target at 120 and
   8 × 1024² at 40/80/120 (beside kernel 4), plus counts off multiples
   of k from a nonzero start on raw labels;
   head-major attention: 8 crops × 16 heads × 1024 tokens in fp32 and
   bf16) and times kernel, plain version, a one-call PyTorch yardstick
   where there is one (for the attention forwards the fastest SDPA
   backend that takes a float mask, named, with its spread) and the
   least time the card could take (the bound); checks kernel 1's
   log-sum-exp and fp32 output at 8 × 16 × 1024, sampler and histogram
   also at 8 × 448², 300 × 500 and widths off a multiple of 4 (2 × 130 ×
   70, 1 × 257 × 1023), and that the LayerNorm and head-major
   attention kernel routes raise where a gradient would flow through
   them; then the attention kernels on the token grids of other crop
   sizes (28 × 28, 64 × 64, 12 × 20, 8 × 128 and 128 × 128: kernels 1, 8
   in fp32 and bf16, and 5), each against its plain version;
4. runs ``ClassposeModel.eval_batch`` at full ViT-L width (24 blocks,
   1024 wide, bf16) with the structured synthetic checkpoint on 8 uint8
   tiles of 1024², ``batch_size=32``, ``niter=200``, with every launch
   count reset just before and read just after; checks ~1k instances per
   tile, that every kernel was launched, and that the masks agree with a
   run of the same slice with the plain versions swapped in; then runs
   the same batch again with ``CLASSPOSE_LN_PALLAS=1`` (400 LayerNorm
   launches: 48 block and 2 neck calls per tile's 25-crop chunk) and
   compares its masks with the first run's;
5. runs the training slice at full ViT-L width in bf16 (``rdrop`` 0.4,
   seeded random weights): synthetic disc images through
   ``process_train_test`` (flow targets by the diffusion kernel) and
   ``ClassposeTrainingDataset``, then ``train_class_seg`` for 3 epochs of
   2 steps at batch 8, with every launch count reset just before and
   read just after; checks the diffusion ran for the targets, finite
   losses, moved parameters and ``depth`` launches of each attention
   kernel per step; times one batch of augmentation and one save of the
   final weights (the trainer's host work), the train step at batch 8
   (median, imgs/s, peak memory, MFU), and traces one step; then takes
   one step at batch 2
   without layer-drop, checks that every attention parameter got a
   finite non-zero gradient, and compares loss and gradients with the
   same step with the plain versions swapped in; then the same check for
   one step at batch 8 of 224² crops (28 × 28 tokens);
6. runs the WSI CLI (``entrypoints.predict_wsi.main_with_args``) with
   ``CLASSPOSE_LN_PALLAS=1`` on a ~6144² synthetic slide at 0.4 µm/px
   (25 tiles of 1280² read and resized to 1024² at the config's 0.5 µm/px)
   with a ViT-L bf16 checkpoint whose patch embed and attention are live
   (``perturbed_structured_params`` with ``attn_ripple``), ``--output_type
   csv spatialdata``: checks that the outputs parse, that the cell count
   lies in the design field's range and that all five inference kernels
   ran; a second run under ``--profile`` gives the device's idle share;
   a third with the plain versions swapped in must agree (cell counts
   within 0.5%, ≥ 99% of centroids within 1 px with the same class);
7. runs the evaluate CLI (``entrypoints.run_inference.main_with_args``)
   at fp32 on 8 RGB images of 448² (3 × 3 crops each) written as
   ``images.npy`` with their design-field ``labels.npy``, with the WSI
   phase's ViT-L checkpoint: checks that ``predictions.npy`` and
   ``metrics.csv`` parse, that the PQ table is printed, that the
   head-major attention ran 24 times per crop chunk, that the QC took the
   halo-blocked diffusion and not kernel 4, and that the sampler and
   histogram ran; a run with the plain versions swapped in must give the
   same masks; the metrics CLI (``calculate_metrics.main_with_args``) on
   the outputs must reproduce the evaluate CLI's numbers; then
   ``ClassposeModel.eval`` on one 448² image under the profiler, on one
   256² image (kernel 4, not kernel 7), and ``eval(do_3D=True)`` in bf16
   on a 16 × 128 × 128 stack (kernel 1), compared with the plain
   versions; then ``eval`` with a ViT-L at bsize 224 (28 × 28 tokens) on
   one 480² image in fp32 and bf16, against the plain versions, and with
   a ViT-L at bsize 1024 (128 × 128 tokens, L = 16384) on one 1024² image
   in fp32 and bf16 against the plain versions run one head at a time,
   and one kernel-route train step at batch 1 of a 1024² crop;
8. under ``--ab`` only, the A/B of ``ab_attention.py``: kernels 1, 8
   (fp32 and bf16), 5, 2, 3 (also on step 4's input), 4 and 7 at the
   main paths' shapes, the bodies of
   commit ``AB_PARENT`` (``_archive/<AB_PARENT>``, or ``git archive`` of
   it; raises when neither gives them) and the package's timed in turns
   in this process. It is not part of the default run because a checkout
   need not hold the repository's history;
9. prints one JSON line describing the kernels, then the last line
   ``{"ok": true, "device": {...}}``.

Any failure raises, so the exit code is not 0 and the last line is not
printed. Without CUDA, or without the rest of the repository beside it,
it fails before printing a result.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from ab_attention import (
    BUILD,
    KERNEL7_SHAPES,
    PEAK_BF16,
    PEAK_FP32,
    bincount_yardstick,
    bound_ms,
    converged_landing,
    design_labels,
    diffusion_ops,
    grid_sample_yardstick,
    kernel7_inputs,
    parent_sources,
    positions,
    run_ab,
    sdpa_yardstick,
    spread,
    time_ms,
    time_runs,
    uniform_landing,
)
import classpose_tpu_torch.dynamics.flows as port_flows
import classpose_tpu_torch.dynamics.masks as port_masks
import classpose_tpu_torch.nn.layernorm as port_ln
import classpose_tpu_torch.nn.vit_sam as port_vit
from classpose_tpu_torch import _build
from classpose_tpu_torch.entrypoints.calculate_metrics import (
    main_with_args as metrics_cli,
)
from classpose_tpu_torch.entrypoints.predict_wsi import main_with_args
from classpose_tpu_torch.entrypoints.run_inference import (
    main_with_args as evaluate_cli,
)
from classpose_tpu_torch.nn.attention import (
    _fwd_kernel,
    attention_relpos,
    attention_relpos_bwd,
    attention_relpos_bwd_plain,
    attention_relpos_plain,
    attention_relpos_plain_route,
    flash_attention_relpos,
    flash_attention_relpos_plain,
)
from classpose_tpu_torch.io.array_reader import synthetic_wsi
from classpose_tpu_torch.io.zarrlite import read_zarr_array
from classpose_tpu_torch.nn.convert import save_params
from classpose_tpu_torch.nn.layernorm import layernorm, layernorm_cuda, \
    layernorm_ref
from classpose_tpu_torch.nn.synthetic import (
    PERIOD,
    RADIUS,
    perturbed_structured_params,
    structured_params,
)
from classpose_tpu_torch.nn.vit_sam import ClassTransformerConfig
from classpose_tpu_torch.ops.diffusion import (
    WINDOWS,
    diffuse_blocked,
    diffuse_blocked_plain,
    diffuse_counts,
    diffuse_counts_plain,
    diffusion_plan,
    masked_diffusion,
    masked_diffusion_plain,
    resident_diffusion_supported,
)
from classpose_tpu_torch.ops.sample import (
    bilinear_sample,
    bilinear_sample_plain,
    landing_histogram,
    landing_histogram_plain,
)
from classpose_tpu_torch.ops.tiles import compute_tile_grid
from classpose_tpu_torch.runner import ClassposeModel
from classpose_tpu_torch.runner.core import chunk_plan
from classpose_tpu_torch.train.dataset import ClassposeTrainingDataset
from classpose_tpu_torch.train.train import (
    make_optimizer,
    make_train_step,
    train_class_seg,
)
from classpose_tpu_torch.train.train_utils import process_train_test

SEED = 0
N_TILES, TILE = 8, 1024
# kernels of the eval_batch path (phase 4); the attention backward runs in
# training only (phase 5), the LayerNorm kernel with its switch on (phase 4's
# second run and the WSI phase)
EVAL_KERNELS = ("attention_fwd", "bilinear_sample", "landing_histogram",
                "masked_diffusion")
WSI_KERNELS = EVAL_KERNELS + ("layernorm",)
LN_SWITCH = "CLASSPOSE_LN_PALLAS"
# the WSI slide: 6144² at 0.4 µm/px, read in 1280² tiles with 80 px overlap
# and resized to 1024² at the config's 0.5 µm/px → a 5×5 grid of tiles
# covering 4864² model pixels
WSI_SIZE, WSI_MPP, WSI_MODEL_MPP = 6144, 0.4, 0.5
TRAIN_BATCH, TRAIN_IMAGES, TRAIN_SIZE = 8, 16, 512
# the evaluate phase: 8 RGB images of 448² (3 × 3 crops of 256² each;
# 448 % 128 != 0, so the QC diffusion takes kernel 7), fp32 as the CLI
# defaults; its kernels, and those of eval's 3D branch in bf16
EVAL_IMAGES, EVAL_SIZE, EVAL_BATCH = 8, 448, 8
EVALUATE_KERNELS = ("flash_attention_relpos", "bilinear_sample",
                    "landing_histogram", "diffuse_blocked")
STACK_SHAPE = (16, 128, 128)
# fault 3: token grids off the 32 x 32 of bsize 256 (bsize 224 and 512 at
# patch 8, and a non-square one), and the end-to-end checks at bsize 224
# (28 x 28 tokens, L = 784): eval on one image of 480², whose 3 x 3 crop
# origins (0, 128, 256) fall on the design field's period, and a train step
FAULT3_GRIDS = ((28, 28), (64, 64), (12, 20), (8, 128), (128, 128))
FAULT3_BSIZE, FAULT3_SIZE = 224, 480
# the largest crop the kernels take (H + W = 256): bsize 1024 at patch 8,
# 128 x 128 tokens (L = 16384), one WSI tile; eval on one 1024² image
BIG_BSIZE, BIG_SIZE = 1024, 1024
# the commit whose kernel bodies the A/B phase (``--ab``) holds the
# working tree's against
AB_PARENT = "5846458"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def attention_rates(ms: float, flops: float, bound: float) -> dict:
    """Achieved TFLOP/s at the standard count and share of the bound."""
    return dict(tflops=flops / ms / 1e9, bound_share=bound / ms)


@contextlib.contextmanager
def ln_switch(on: bool):
    """``CLASSPOSE_LN_PALLAS`` set to 1 (the LayerNorm kernel) or 0 (its
    plain version) inside the block, restored after."""
    saved = os.environ.get(LN_SWITCH)
    os.environ[LN_SWITCH] = "1" if on else "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(LN_SWITCH)
        else:
            os.environ[LN_SWITCH] = saved


# ---------------------------------------------------------------- phase 3

def check_attention(gen, dev) -> dict:
    """Kernel 1 at the inference shape (25 crops × 16 heads × 1024 × 64)
    against its plain version, |Δ| ≤ 1e-2 + 1e-2·|ref|; at the training
    shape (8 crops) its row log-sum-exp against the plain fp32 logits'
    (|Δ| ≤ 1e-3 + 1e-4·|lse|) and its fp32 output against the plain fp32
    softmax product (1e-2 + 1e-2·|ref|). Yardstick: the fastest SDPA
    backend that takes the materialized float bias."""
    B, n, L, hd, G = 25, 16, 1024, 64, 32
    qkv = torch.randn(B, L, 3 * n * hd, generator=gen, device=dev).to(
        torch.bfloat16)
    rel = torch.randn(B, L, n, 2 * G, generator=gen, device=dev).to(
        torch.bfloat16)
    scale = hd ** -0.5
    got = attention_relpos(qkv, rel, scale, (G, G), n)
    ref = attention_relpos_plain(qkv, rel, scale, (G, G), n)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    # bf16 output: the kernel rounds unnormalized probabilities to bf16,
    # the plain version normalized ones; both round the output to bf16
    tol = 1e-2 + 1e-2 * ref.float().abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"attention max|Δ| {float(err.max())}")
    stats = check_attention_stats(qkv[:TRAIN_BATCH], rel[:TRAIN_BATCH],
                                  scale, G, n)
    q, k, v = (qkv[..., i * n * hd:(i + 1) * n * hd].reshape(B, L, n, hd)
               .transpose(1, 2).contiguous() for i in range(3))
    mask = (rel[..., :G].transpose(1, 2)[..., :, None]
            + rel[..., G:].transpose(1, 2)[..., None, :]).reshape(B, n, L, L)
    nbytes = (qkv.numel() + rel.numel() + got.numel()) * 2
    flops = 4.0 * B * n * L * L * hd
    b, by = bound_ms(nbytes, flops, PEAK_BF16)
    ms = time_ms(lambda: attention_relpos(qkv, rel, scale, (G, G), n), 10,
                 5)
    res = dict(
        name="attention_fwd", route="cuda",
        source="classpose_tpu_torch/csrc/attention.cu",
        replaces="classpose_tpu/nn/attention.py:404",
        max_abs_err=float(err.max()), ms=ms,
        plain_ms=time_ms(
            lambda: attention_relpos_plain(qkv, rel, scale, (G, G), n), 3),
        bound_ms=b, bound_by=by, **attention_rates(ms, flops, b), **stats,
        **sdpa_yardstick(q, k, v, mask, scale))
    del mask
    return res


def check_attention_stats(qkv, rel, scale, G, n) -> dict:
    """The forward's statistics for the backward at the training shape:
    natural-log lse and the fp32 output, against the plain fp32 logits
    and softmax product; their max |Δ|."""
    B, L, _ = qkv.shape
    hd = qkv.shape[-1] // (3 * n)
    out, lse, out32 = _fwd_kernel(qkv, rel, scale, (G, G), n, True)
    q, k, v = (qkv[..., i * n * hd:(i + 1) * n * hd].float()
               .reshape(B, L, n, hd).transpose(1, 2) for i in range(3))
    s = q @ k.transpose(-1, -2) * scale + (
        rel[..., :G].float().transpose(1, 2)[..., :, None]
        + rel[..., G:].float().transpose(1, 2)[..., None, :]
    ).reshape(B, n, L, L)
    lse_ref = torch.logsumexp(s, -1)
    o_ref = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(B, L, n * hd)
    del s
    lse_err = (lse - lse_ref).abs()
    o_err = (out32 - o_ref).abs()
    if not bool((lse_err <= 1e-3 + 1e-4 * lse_ref.abs()).all()):
        raise AssertionError(f"attention lse max|Δ| {float(lse_err.max())}")
    if not bool((o_err <= 1e-2 + 1e-2 * o_ref.abs()).all()):
        raise AssertionError(f"attention out32 max|Δ| {float(o_err.max())}")
    if not torch.equal(out32.bfloat16(), out):
        raise AssertionError("attention out32 does not round to out")
    return dict(lse_max_abs_err=float(lse_err.max()),
                out32_max_abs_err=float(o_err.max()))


def check_attention_bwd(gen, dev) -> dict:
    B, n, L, hd, G = TRAIN_BATCH, 16, 1024, 64, 32
    qkv = torch.randn(B, L, 3 * n * hd, generator=gen, device=dev).to(
        torch.bfloat16)
    rel = torch.randn(B, L, n, 2 * G, generator=gen, device=dev).to(
        torch.bfloat16)
    dout = torch.randn(B, L, n * hd, generator=gen, device=dev).to(
        torch.bfloat16)
    scale = hd ** -0.5
    _, lse, out32 = _fwd_kernel(qkv, rel, scale, (G, G), n, True)

    def kernel():
        return attention_relpos_bwd(qkv, rel, out32, lse, dout, scale,
                                    (G, G), n)

    got = kernel()
    ref = attention_relpos_bwd_plain(qkv, rel, dout, scale, (G, G), n)
    torch.cuda.synchronize()
    # bf16 outputs of bf16 products with fp32 sums: the kernel rounds p
    # and ds to bf16 before the products (as the TPU kernel does), the
    # plain version keeps them fp32; both round the result to bf16
    errs = []
    for a, r in zip(got, ref):
        a, r = a.float(), r.float()
        err = (a - r).abs()
        if not bool((err <= 2e-2 * r.abs().max() + 2e-2 * r.abs()).all()):
            raise AssertionError(f"attention bwd max|Δ| {float(err.max())} "
                                 f"of max|ref| {float(r.abs().max())}")
        errs.append(float(err.max()))
    # yardstick: SDPA's backward with a materialized bias that requires
    # grad, with respect to q, k, v and the two bias terms
    q, k, v = (qkv[..., i * n * hd:(i + 1) * n * hd].reshape(B, L, n, hd)
               .transpose(1, 2).contiguous().requires_grad_()
               for i in range(3))
    rh = rel[..., :G].transpose(1, 2).contiguous().requires_grad_()
    rw = rel[..., G:].transpose(1, 2).contiguous().requires_grad_()
    mask = (rh[..., :, None] + rw[..., None, :]).reshape(B, n, L, L)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
    do = dout.reshape(B, L, n, hd).transpose(1, 2)
    # read qkv, rel, dout (bf16), out32, lse (f32); write dqkv, drel (bf16)
    nbytes = (2 * (qkv.numel() + rel.numel() + dout.numel())
              + 4 * (out32.numel() + lse.numel())
              + 2 * (qkv.numel() + rel.numel()))
    b, by = bound_ms(nbytes, 10.0 * B * n * L * L * hd, PEAK_BF16)
    return dict(
        name="attention_bwd", route="cuda",
        source="classpose_tpu_torch/csrc/attention_bwd.cu",
        replaces="classpose_tpu/nn/attention.py:540",
        max_abs_err=max(errs),
        ms=time_ms(kernel),
        plain_ms=time_ms(lambda: attention_relpos_bwd_plain(
            qkv, rel, dout, scale, (G, G), n), 3),
        library_ms=time_ms(lambda: torch.autograd.grad(
            o, (q, k, v, rh, rw), do, retain_graph=True)),
        bound_ms=b, bound_by=by,
    )


def check_sampler(gen, dev) -> dict:
    B, C, H, W = N_TILES, 2, TILE, TILE
    u = (torch.randn(B, C, H, W, generator=gen, device=dev) * 2).contiguous()
    py, px = positions(gen, dev, 20.0, N_TILES, TILE, TILE)
    got = bilinear_sample(u, py, px)
    ref = bilinear_sample_plain(u, py, px)
    err2 = float((got - ref).abs().max())
    if err2 > 1e-6:
        raise AssertionError(f"sampler C=2 max|Δ| {err2}")
    # C=1 at integer positions (the label lookup) must be exact
    lab = torch.randint(0, 5000, (B, 1, H, W), generator=gen,
                        device=dev).float()
    fy, fx = torch.round(py), torch.round(px)
    g1 = bilinear_sample(lab, fy, fx)
    exact = torch.gather(lab.reshape(B, 1, -1), 2,
                         (fy * W + fx).long().reshape(B, 1, -1))
    if not torch.equal(g1.reshape(B, 1, -1), exact) or not torch.equal(
            g1, bilinear_sample_plain(lab, fy, fx)):
        raise AssertionError("sampler C=1 at integer positions not exact")
    npx = B * H * W
    b, by = bound_ms(npx * (2 * C * 4 + 2 * 4), npx * (6 * C + 4),
                     PEAK_FP32)
    # kernel and yardstick (grid_sample) alike: 15 timings of 3 calls,
    # with the spread
    return dict(
        name="bilinear_sample", route="cuda",
        source="classpose_tpu_torch/csrc/sample.cu",
        replaces="classpose_tpu/ops/sample_pallas.py:297",
        max_abs_err=err2,
        **spread("", time_runs(lambda: bilinear_sample(u, py, px), 15, 3)),
        plain_ms=time_ms(lambda: bilinear_sample_plain(u, py, px)),
        **grid_sample_yardstick(u, py, px),
        bound_ms=b, bound_by=by,
    )


def histogram_timing(fy, fx, cell) -> dict:
    """Kernel 3 on one input against its plain version (bitwise), timed
    (15 timings of 3 calls, with the spread) beside ``bincount``, with
    what the input holds: its counted pixels, the bins they land on and
    the most pixels on one bin."""
    got = landing_histogram(fy, fx, cell)
    ref = landing_histogram_plain(fy, fx, cell)
    if not torch.equal(got, ref):
        raise AssertionError("histogram not exact")
    # read fy, fx, cell once and write the bins once; one add per counted
    # pixel
    b, by = bound_ms(fy.numel() * 16, float(cell.sum()), PEAK_FP32)
    return dict(
        max_abs_err=float((got - ref).abs().max()),
        **spread("", time_runs(lambda: landing_histogram(fy, fx, cell), 15,
                               3)),
        plain_ms=time_ms(lambda: landing_histogram_plain(fy, fx, cell)),
        **bincount_yardstick(fy, fx, cell),
        bound_ms=b, bound_by=by, counted=float(cell.sum()),
        bins=int((ref > 0).sum()), most_on_one_bin=float(ref.max()))


def check_histogram(gen, dev) -> dict:
    """Kernel 3 at 8 × 1024² on two inputs: uniform (each pixel lands
    within ±8 px of itself) and converged (every foreground pixel of the
    design field on its cell's centre, as the masks path's flow steps
    leave them: the line's numbers); see :func:`histogram_timing`."""
    inputs = dict(uniform=uniform_landing(gen, dev, N_TILES, TILE, TILE),
                  converged=converged_landing(dev, N_TILES, TILE, TILE))
    res = {name: histogram_timing(*args) for name, args in inputs.items()}
    line = res["converged"]
    return dict(
        name="landing_histogram", route="cuda",
        source="classpose_tpu_torch/csrc/sample.cu",
        replaces="classpose_tpu/ops/sample_pallas.py:496",
        max_abs_err=max(r["max_abs_err"] for r in res.values()),
        **{k: line[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by")},
        inputs=res,
    )


def launches_of(name: str, fn):
    """``fn()`` and the launches of kernel ``name`` it made."""
    before = _build.LAUNCHES[name]
    out = fn()
    return out, _build.LAUNCHES[name] - before


def check_diffusion(dev) -> dict:
    """Kernel 4 against its plain version, bitwise: the QC call of one
    8-tile batch (8 × 1024² of the design field, counts 40/80/120: the
    line's numbers, with its launches per call) and one training target
    (a 512² image at 1200 iterations, ``dynamics/flows.py``'s count for
    targets: its time and launches in ``target_512``)."""
    ids, cen = design_labels(dev, N_TILES, TILE, TILE)
    niter = torch.tensor([40, 80, 120, 40, 80, 120, 40, 80],
                         dtype=torch.int32, device=dev)
    got, per_call = launches_of(
        "masked_diffusion", lambda: masked_diffusion(ids, cen, niter))
    ref = masked_diffusion_plain(ids, cen, niter)
    if not torch.equal(got, ref):
        raise AssertionError("diffusion not bitwise equal to plain")
    i1, c1 = design_labels(dev, 1, TRAIN_SIZE, TRAIN_SIZE)
    n1 = torch.tensor([1200], dtype=torch.int32, device=dev)
    t1, per_target = launches_of(
        "masked_diffusion", lambda: masked_diffusion(i1, c1, n1))
    if not torch.equal(t1, masked_diffusion_plain(i1, c1, n1)):
        raise AssertionError("diffusion at 512²/1200 not bitwise equal")
    b, by = bound_ms(ids.numel() * 12, diffusion_ops(ids, niter), PEAK_FP32)
    b1, _ = bound_ms(i1.numel() * 12, diffusion_ops(i1, n1), PEAK_FP32)
    return dict(
        name="masked_diffusion", route="cuda",
        source="classpose_tpu_torch/csrc/diffusion.cu",
        replaces="classpose_tpu/ops/diffusion_pallas.py:289",
        max_abs_err=float((got - ref).abs().max()),
        ms=time_ms(lambda: masked_diffusion(ids, cen, niter)),
        plain_ms=time_ms(lambda: masked_diffusion_plain(ids, cen, niter), 3),
        library_ms=None,
        bound_ms=b, bound_by=by, launches_per_call=per_call,
        target_512=dict(niter=1200, launches=per_target, bound_ms=b1,
                        ms=time_ms(lambda: masked_diffusion(i1, c1, n1), 3)),
    )


def check_layernorm(gen, dev) -> dict:
    """Kernel 6 at the blocks' (25, 1024, 1024) shape with the fast
    variance (timed, the line's numbers) and the neck's (25, 32, 32, 256)
    two-pass (checked and timed, in ``neck``), each time per call over 10
    calls back to back; inputs ``normal·3 + 0.5``
    as ``tests/test_layernorm.py`` draws them. Tolerance: bf16 outputs of
    fp32 math summed in another order, |Δ| ≤ 0.06 + 0.02·|ref| (the JAX
    package's kernel test). Also checks that the kernel route raises
    where a gradient would flow through it."""
    errs, times = [], {}
    for shape, fast in (((25, 1024, 1024), True), ((25, 32, 32, 256), False)):
        C = shape[-1]
        x = (torch.randn(shape, generator=gen, device=dev) * 3 + 0.5).to(
            torch.bfloat16)
        w = torch.randn(C, generator=gen, device=dev)
        b = torch.randn(C, generator=gen, device=dev)
        got = layernorm_cuda(x, w, b, 1e-6, fast)
        ref = layernorm_ref(x, w, b, 1e-6, fast)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        if not bool((err <= 0.06 + 0.02 * ref.float().abs()).all()):
            raise AssertionError(f"layernorm {shape} max|Δ| "
                                 f"{float(err.max())}")
        errs.append(float(err.max()))
        # read x once and write y once (bf16), read the fp32 affine; ~8
        # fp32 operations per element
        b_ms, by = bound_ms(2 * 2 * x.numel() + 2 * 4 * C, 8.0 * x.numel(),
                            PEAK_FP32)
        wl, bl = w.to(x.dtype), b.to(x.dtype)
        times[C] = dict(
            ms=time_ms(lambda: layernorm_cuda(x, w, b, 1e-6, fast),
                       inner=10),
            plain_ms=time_ms(lambda: layernorm_ref(x, w, b, 1e-6, fast),
                             inner=10),
            library_ms=time_ms(lambda: F.layer_norm(x, (C,), wl, bl, 1e-6),
                               inner=10),
            bound_ms=b_ms, bound_by=by, max_abs_err=float(err.max()))
    with ln_switch(True):
        xg = torch.ones(4, 1024, device=dev, dtype=torch.bfloat16,
                        requires_grad=True)
        try:
            layernorm(xg, torch.ones(1024, device=dev),
                      torch.zeros(1024, device=dev))
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            raise AssertionError("LayerNorm kernel route took a tensor "
                                 "that needs a gradient")
    blk = times[1024]
    return dict(
        name="layernorm", route="cuda",
        source="classpose_tpu_torch/csrc/layernorm.cu",
        replaces="classpose_tpu/nn/layernorm.py:109",
        max_abs_err=max(errs), ms=blk["ms"], plain_ms=blk["plain_ms"],
        library_ms=blk["library_ms"], bound_ms=blk["bound_ms"],
        bound_by=blk["bound_by"], neck=times[256],
    )


def check_sampling_shapes(gen, dev) -> dict:
    """Kernels 2 and 3 against their plain versions at the evaluate
    path's 8 × 448², at an odd 300 × 500 and at widths off a multiple of 4
    (the sampler's scalar path): the sampler to 1e-6 at C = 2, bitwise at
    integer positions with C = 1 and C = 2, the histogram bitwise."""
    out = {}
    for B, H, W in ((EVAL_IMAGES, EVAL_SIZE, EVAL_SIZE), (1, 300, 500),
                    (2, 130, 70), (1, 257, 1023)):
        u = (torch.randn(B, 2, H, W, generator=gen, device=dev) * 2
             ).contiguous()
        py, px = positions(gen, dev, 20.0, B, H, W)
        err = float((bilinear_sample(u, py, px)
                     - bilinear_sample_plain(u, py, px)).abs().max())
        fy, fx = torch.round(py), torch.round(px)
        lab = torch.randint(0, 5000, (B, 2, H, W), generator=gen,
                            device=dev).float()
        fyi = fy.to(torch.int32).contiguous()
        fxi = fx.to(torch.int32).contiguous()
        cell = (torch.rand(B, H, W, generator=gen, device=dev) < 0.6).float()
        if err > 1e-6 or not all(torch.equal(
                bilinear_sample(x, fy, fx), bilinear_sample_plain(x, fy, fx))
                for x in (lab[:, :1].contiguous(), lab)) or not torch.equal(
                landing_histogram(fyi, fxi, cell),
                landing_histogram_plain(fyi, fxi, cell)):
            raise AssertionError(f"sampler/histogram at {B}×{H}×{W}: "
                                 f"max|Δ| {err}")
        out[f"{B}x{H}x{W}"] = dict(sampler_max_abs_err=err,
                                   histogram_bitwise=True)
    return out


@contextlib.contextmanager
def no_device_sync():
    """Inside the block, an operation that makes the host wait for the
    device (a count read back with ``.max()``/``int()``) raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def check_diffuse_blocked(gen, dev) -> dict:
    """Kernel 7 against its plain version, bitwise, at every shape of
    ``KERNEL7_SHAPES`` (the design field from zero with k = 1, as the
    routed QC and the targets call it), each timed (5 timings of 3 calls
    with the count given from the host, with the spread) with its
    launches per call (checked against ``diffusion_plan``) and its
    window; then from a nonzero start on raw (non-dense) labels with
    k = 40 and counts that are multiples neither of k nor of the
    iterations per launch (and a tile with none). At the evaluate call
    (1 × 448², niter 80: the line's numbers) also the device's busy time
    per call from a trace, and the wall of one ``_diffuse_dyn`` call,
    synced, with an int count (under :func:`no_device_sync`: nothing is
    read back) and with a tensor count (read back)."""
    for hw in ((448, 448), (500, 500), (2048, 2048)):
        if resident_diffusion_supported(*hw):
            raise AssertionError(f"{hw} should fail the residency gate")
    shapes = {}
    for name, B, hw, counts in KERNEL7_SHAPES:
        ids, cen, zero, n, nmax = kernel7_inputs(dev, B, hw, counts)
        got, per_call = launches_of(
            "diffuse_blocked", lambda: diffuse_blocked(zero, ids, cen, n, k=1))
        if not torch.equal(got, diffuse_blocked_plain(zero, ids, cen, n,
                                                      k=1)):
            raise AssertionError(f"diffuse_blocked {name}: not bitwise "
                                 f"equal to plain")
        plan = diffusion_plan(B, *hw, nmax)
        if per_call != plan.launches:
            raise AssertionError(f"diffuse_blocked {name}: {per_call} "
                                 f"launches, plan {plan}")
        # read the ids and the centre, write T (and read a T0 where the
        # caller has one); per iteration and foreground pixel two adds a
        # matching neighbour and a multiply
        b, by = bound_ms(ids.numel() * 12, diffusion_ops(ids, n), PEAK_FP32)
        shapes[name] = dict(
            launches_per_call=per_call, window=WINDOWS[plan.window],
            overlap=plan.overlap, bound_ms=b, bound_by=by,
            **spread("", time_runs(lambda: diffuse_counts(
                ids, cen, n, nmax, "diffuse_blocked"), 5, 3)))
        if name == "eval_1x448_80":
            line_plain_ms = time_ms(
                lambda: diffuse_blocked_plain(zero, ids, cen, n, k=1), 3)
            shapes[name]["device_busy_ms"] = traced(lambda: [
                diffuse_counts(ids, cen, n, nmax, "diffuse_blocked")
                for _ in range(10)])["device_busy_ms"] / 10
            walls = {"int": [], "tensor": []}
            n0 = torch.tensor(counts[0], dtype=torch.int32, device=dev)
            for _ in range(20):
                for kind, count in (("int", counts[0]), ("tensor", n0)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with (no_device_sync() if kind == "int"
                          else contextlib.nullcontext()):
                        port_flows._diffuse_dyn(ids[0], cen[0], count)
                    torch.cuda.synchronize()
                    walls[kind].append((time.perf_counter() - t0) * 1e3)
            shapes[name].update(
                wall_ms_int_count=statistics.median(walls["int"]),
                wall_ms_tensor_count=statistics.median(walls["tensor"]))
        if name == "qc_8x1024":
            shapes[name]["masked_diffusion_ms"] = time_ms(
                lambda: diffuse_counts(ids, cen, n, nmax, "masked_diffusion"))
    ids, cen = design_labels(dev, EVAL_IMAGES, EVAL_SIZE, EVAL_SIZE)
    T0 = (torch.rand(ids.shape, generator=gen, device=dev) * 2).contiguous()
    raw = (ids * 977).contiguous()
    odd = torch.tensor([13, 50, 0, 41, 79, 7, 120, 1], dtype=torch.int32,
                       device=dev)
    if not torch.equal(diffuse_blocked(T0, raw, cen, odd, k=40),
                       diffuse_blocked_plain(T0, raw, cen, odd, k=40)):
        raise AssertionError("diffuse_blocked from a nonzero start, raw "
                             "labels, k = 40: not bitwise equal to plain")
    line = shapes["eval_1x448_80"]
    return dict(
        name="diffuse_blocked", route="cuda",
        source="classpose_tpu_torch/csrc/diffusion.cu",
        replaces="classpose_tpu/ops/diffusion_pallas.py:143",
        max_abs_err=0.0, ms=line["ms"], plain_ms=line_plain_ms,
        library_ms=None, bound_ms=line["bound_ms"],
        bound_by=line["bound_by"], shapes=shapes,
    )


def check_flash_attention(gen, dev) -> dict:
    """Kernel 8 at the evaluate path's shape (8 crops × 16 heads × 1024
    tokens × 64, rel_h and rel_w (8, 16, 1024, 32)) against its plain
    version: fp32 (the path's dtype; the line's numbers), true fp32
    products, |Δ| ≤ 1e-4 + 1e-4·|ref|; bf16 (in ``bf16``) as kernel 1,
    |Δ| ≤ 1e-2 + 1e-2·|ref|. Yardstick: SDPA with the materialized
    (B, n, L, L) bias in the same dtype. Also checks that the kernel
    route raises where a gradient would flow through it."""
    B, n, L, hd, G = EVAL_BATCH, 16, 1024, 64, 32
    scale = hd ** -0.5
    res = {}
    for dtype, tol, peak in ((torch.float32, 1e-4, PEAK_FP32),
                             (torch.bfloat16, 1e-2, PEAK_BF16)):
        q, k, v = (torch.randn(B, n, L, hd, generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        rh, rw = ((2 * torch.randn(B, n, L, G, generator=gen, device=dev))
                  .to(dtype) for _ in range(2))
        got = flash_attention_relpos(q, k, v, rh, rw, scale, (G, G))
        ref = flash_attention_relpos_plain(q, k, v, rh, rw, scale)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        if got.dtype != dtype or not bool(
                (err <= tol + tol * ref.float().abs()).all()):
            raise AssertionError(f"flash_attention_relpos {dtype} max|Δ| "
                                 f"{float(err.max())}")
        mask = (rh[..., :, None] + rw[..., None, :]).reshape(B, n, L, L)
        nbytes = (q.numel() * 4 + rh.numel() * 2) * q.element_size()
        b, by = bound_ms(nbytes, 4.0 * B * n * L * L * hd, peak)
        flops = 4.0 * B * n * L * L * hd
        ms = time_ms(lambda: flash_attention_relpos(q, k, v, rh, rw, scale,
                                                    (G, G)), 10, 5)
        res[dtype] = dict(
            max_abs_err=float(err.max()), ms=ms,
            plain_ms=time_ms(lambda: flash_attention_relpos_plain(
                q, k, v, rh, rw, scale), 3),
            bound_ms=b, bound_by=by, **attention_rates(ms, flops, b),
            **sdpa_yardstick(q, k, v, mask, scale))
        del mask
    qg = torch.zeros(1, 1, 64, 64, device=dev, requires_grad=True)
    z = torch.zeros(1, 1, 64, 8, device=dev)
    try:
        flash_attention_relpos(qg, qg, qg, z, z, 0.125, (8, 8))
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
    else:
        raise AssertionError("head-major kernel route took a tensor that "
                             "needs a gradient")
    return dict(name="flash_attention_relpos", route="cuda",
                source="classpose_tpu_torch/csrc/attention_hm.cu",
                replaces="classpose_tpu/nn/attention.py:93",
                **res[torch.float32], bf16=res[torch.bfloat16])


def check_fault3_grids(gen, dev) -> dict:
    """Fault 3: the attention kernels at the grids of ``FAULT3_GRIDS``
    (2 crops × 16 heads; at 128 × 128, L = 16384, 1 crop × 2 heads: the
    plain versions' (B, n, L, L) fp32 intermediates) against their plain
    versions at the tolerances of the main-path checks: kernel 1 (bf16,
    1e-2 + 1e-2·|ref|), kernel 8 in fp32 (1e-4 + 1e-4·|ref|) and bf16
    (1e-2 + 1e-2·|ref|), kernel 5 (2e-2·max|ref| + 2e-2·|ref|); each
    kernel's time (CUDA events, 5 × 3 calls) and the shape it ran at."""
    hd = 64
    scale = hd ** -0.5
    out = {}

    def held(got, ref, tol, what):
        err = (got.float() - ref.float()).abs()
        if not bool((err <= tol(ref.float())).all()):
            raise AssertionError(f"{what}: max|Δ| {float(err.max())}")
        return float(err.max())

    for H, W in FAULT3_GRIDS:
        L = H * W
        B, n = (2, 16) if L <= 4096 else (1, 2)
        res = dict(crops=B, heads=n)
        qkv = torch.randn(B, L, 3 * n * hd, generator=gen, device=dev).to(
            torch.bfloat16)
        rel = (2 * torch.randn(B, L, n, H + W, generator=gen, device=dev)
               ).to(torch.bfloat16)
        fwd = lambda: attention_relpos(qkv, rel, scale, (H, W), n)  # noqa
        res["attention_fwd"] = dict(
            max_abs_err=held(fwd(), attention_relpos_plain(
                qkv, rel, scale, (H, W), n), lambda r: 1e-2 + 1e-2 * r.abs(),
                f"kernel 1 at {H}×{W}"),
            ms=time_ms(fwd, 5, 3))
        dout = torch.randn(B, L, n * hd, generator=gen, device=dev).to(
            torch.bfloat16)
        _, lse, out32 = _fwd_kernel(qkv, rel, scale, (H, W), n, True)
        bwd = lambda: attention_relpos_bwd(  # noqa: E731
            qkv, rel, out32, lse, dout, scale, (H, W), n)
        ref = attention_relpos_bwd_plain(qkv, rel, dout, scale, (H, W), n)
        res["attention_bwd"] = dict(
            max_abs_err=max(held(a, r, lambda x: 2e-2 * x.abs().max()
                                 + 2e-2 * x.abs(), f"kernel 5 at {H}×{W}")
                            for a, r in zip(bwd(), ref)),
            ms=time_ms(bwd, 5, 3))
        del ref
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            q, k, v = (torch.randn(B, n, L, hd, generator=gen, device=dev)
                       .to(dtype) for _ in range(3))
            rh = (2 * torch.randn(B, n, L, H, generator=gen, device=dev)
                  ).to(dtype)
            rw = (2 * torch.randn(B, n, L, W, generator=gen, device=dev)
                  ).to(dtype)
            hm = lambda: flash_attention_relpos(  # noqa: E731
                q, k, v, rh, rw, scale, (H, W))
            res[f"flash_attention_relpos_{str(dtype)[6:]}"] = dict(
                max_abs_err=held(hm(), flash_attention_relpos_plain(
                    q, k, v, rh, rw, scale), lambda r: tol + tol * r.abs(),
                    f"kernel 8 {dtype} at {H}×{W}"),
                ms=time_ms(hm, 5, 3))
        torch.cuda.synchronize()
        out[f"{H}x{W}"] = res
    return out


# ---------------------------------------------------------------- phase 4

def match_masks(ma: np.ndarray, mb: np.ndarray):
    """Pair instances of two label maps by IoU: [(a, b, iou)]."""
    pairs = []
    fg = ma > 0
    a_ids, b_ids = ma[fg], mb[fg]
    inter = np.bincount(a_ids.astype(np.int64) * (int(mb.max()) + 1) + b_ids,
                        minlength=(int(ma.max()) + 1) * (int(mb.max()) + 1))
    inter = inter.reshape(int(ma.max()) + 1, int(mb.max()) + 1)
    inter[:, 0] = 0
    na, nb = np.bincount(ma.ravel()), np.bincount(mb.ravel())
    for a in range(1, len(na)):
        b = int(inter[a].argmax())
        i = inter[a, b]
        pairs.append((a, b, i / (na[a] + (nb[b] if b else 0) - i)))
    return pairs


def instance_classes(m: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Class of each instance id of label map ``m`` (classes are constant
    per instance)."""
    out = np.zeros(int(m.max()) + 1, np.int64)
    out[m.ravel()] = c.ravel()
    return out


def compare_slices(run, ref) -> float:
    """Mask agreement of two eval_batch results (counts equal, every
    instance matched at IoU ≥ 0.95, ≥ 99.5% pixel agreement, equal
    classes on matched instances); returns the worst IoU."""
    worst = 1.0
    for (m, c), (m_ref, c_ref) in zip(run, ref):
        if m.max() != m_ref.max():
            raise AssertionError(f"instances {m.max()} vs {m_ref.max()}")
        pairs = match_masks(m_ref, m)
        worst = min([worst] + [iou for _, _, iou in pairs])
        if worst < 0.95 or ((m > 0) == (m_ref > 0)).mean() < 0.995:
            raise AssertionError(f"masks disagree (worst IoU {worst})")
        cls, cls_ref = instance_classes(m, c), instance_classes(m_ref, c_ref)
        for a, b, _ in pairs:
            if cls_ref[a] != cls[b]:
                raise AssertionError(f"class of instance {a} differs")
    return worst


def attention_by_head(qkv, rel, scale, grid_hw, num_heads):
    """The plain token-major route one head at a time (the same math per
    head): at L = 16384 a head's (L, L) fp32 logits alone take 1 GiB."""
    hd = qkv.shape[-1] // (3 * num_heads)
    outs = []
    for h in range(num_heads):
        cols = torch.cat([qkv[..., (i * num_heads + h) * hd:
                              (i * num_heads + h + 1) * hd]
                          for i in range(3)], -1).contiguous()
        outs.append(attention_relpos_plain_route(
            cols, rel[:, :, h:h + 1].contiguous(), scale, grid_hw, 1))
    return torch.cat(outs, -1)


def flash_attention_by_head(q, k, v, rh, rw, scale, grid_hw):
    """The plain head-major version one head at a time."""
    return torch.cat([flash_attention_relpos_plain(
        q[:, h:h + 1], k[:, h:h + 1], v[:, h:h + 1], rh[:, h:h + 1],
        rw[:, h:h + 1], scale) for h in range(q.shape[1])], 1)


def plain_versions(by_head: bool = False):
    """Swap the plain versions in where the slices call the kernels (the
    attention through its differentiable plain route; with ``by_head``,
    inference only, one head at a time)."""
    saved = (port_masks.bilinear_sample, port_masks.landing_histogram,
             port_flows.diffuse_counts, port_vit.attention_relpos,
             port_vit.flash_attention_relpos, port_ln.layernorm)
    port_masks.bilinear_sample = bilinear_sample_plain
    port_masks.landing_histogram = landing_histogram_plain
    port_flows.diffuse_counts = diffuse_counts_plain
    port_vit.attention_relpos = (attention_by_head if by_head
                                 else attention_relpos_plain_route)
    port_vit.flash_attention_relpos = (
        flash_attention_by_head if by_head else
        lambda q, k, v, rh, rw, scale, grid_hw:
        flash_attention_relpos_plain(q, k, v, rh, rw, scale))
    port_ln.layernorm = layernorm_ref

    def restore():
        (port_masks.bilinear_sample, port_masks.landing_histogram,
         port_flows.diffuse_counts, port_vit.attention_relpos,
         port_vit.flash_attention_relpos, port_ln.layernorm) = saved

    return restore


def kernel_class(name: str) -> str:
    """Coarse class of a device kernel, by its name."""
    n = name.lower()
    for cls, marks in (("attention kernels", ("attn_",)),
                       ("dynamics kernels", ("bilinear_sample",
                                             "landing_histogram",
                                             "round_kernel",
                                             "pack_kernel")),
                       ("convolution", ("conv", "cudnn", "fprop", "dgrad",
                                        "wgrad")),
                       ("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
                       ("optimizer", ("multi_tensor", "foreach")),
                       ("reductions", ("reduce", "norm")),
                       ("memcpy/memset", ("memcpy", "memset")),
                       ("elementwise", ("elementwise", "functor", "copy"))):
        if any(m in n for m in marks):
            return cls
    return "other"


def traced(fn) -> dict:
    """Run ``fn()`` once under torch.profiler: its wall (synced), the
    device's busy time and idle share, and the device time by kernel and
    by class of kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_wall_s = time.perf_counter() - t0
    rows = []  # device-side kernel and memcpy events only
    for e in prof.key_averages():
        # a record_function range (the optimizer's step) shows on the
        # device timeline too; its kernels are counted on their own
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            rows.append((t / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    by_class: dict[str, float] = {}
    for t, k, _ in rows:
        by_class[kernel_class(k)] = by_class.get(kernel_class(k), 0.0) + t
    return dict(
        traced_wall_s=traced_wall_s, device_busy_ms=device_ms,
        device_idle_share=1.0 - device_ms / (traced_wall_s * 1e3),
        by_class_ms=dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        top_kernels=[dict(name=k[:80], ms=t, calls=c)
                     for t, k, c in rows[:12]],
    )


def profile_slice(model, tiles, kw) -> dict:
    """Where one batch's time goes: the device program's wall (synced)
    against the whole call's, and the device time by kernel from a
    torch.profiler trace of one more call."""
    x = torch.as_tensor(tiles).to(model.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model._device_program(x, kw["batch_size"], False, kw["niter"], 0.4, 0.0,
                          0.4)
    torch.cuda.synchronize()
    device_program_s = time.perf_counter() - t0
    return dict(device_program_s=device_program_s,
                **traced(lambda: model.eval_batch(tiles, **kw)))


def run_slice(dev) -> tuple[dict, dict, tuple]:
    cfg = ClassTransformerConfig(n_cell_classes=6, dtype="bfloat16")
    t0 = time.perf_counter()
    model = ClassposeModel(cfg=cfg, params=structured_params(cfg),
                           precision="bf16", device=dev)
    log(f"model built in {time.perf_counter() - t0:.1f} s "
        f"(depth {cfg.depth}, width {cfg.embed_dim})")
    tiles = np.random.default_rng(SEED).integers(
        0, 256, size=(N_TILES, TILE, TILE, 3), dtype=np.uint8)
    kw = dict(batch_size=32, niter=200)

    def timed_run(ln_on: bool):
        with ln_switch(ln_on):
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            res = model.eval_batch(tiles, **kw)
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0, dict(_build.LAUNCHES)

    # warm-up (allocator, cuDNN plans), keeping the histogram's input
    landings = []

    def keep_landing(fy, fx, cell):
        landings.append((fy.clone(), fx.clone(), cell.clone()))
        return landing_histogram(fy, fx, cell)

    port_masks.landing_histogram = keep_landing
    try:
        with ln_switch(False):
            model.eval_batch(tiles, **kw)
    finally:
        port_masks.landing_histogram = landing_histogram
    torch.cuda.reset_peak_memory_stats()
    out, wall, launches = timed_run(False)
    log(f"main path launches: {launches}")
    missing = [k for k in EVAL_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    counts = [int(m.max()) for m, _ in out]
    for m, c in out:
        if m.shape != (TILE, TILE) or m.dtype != np.int32 \
                or c.shape != m.shape:
            raise AssertionError(f"bad output {m.shape} {m.dtype}")
    if not all(900 <= n <= 1100 for n in counts):
        raise AssertionError(f"instances per tile {counts}, expected ~1024")

    breakdown = profile_slice(model, tiles, kw)
    log(f"breakdown: {json.dumps(breakdown)}")

    restore = plain_versions()
    try:
        t1 = time.perf_counter()
        ref = model.eval_batch(tiles, **kw)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t1
    finally:
        restore()
    worst = compare_slices(out, ref)

    # the LayerNorm switch, in turns on one card: off (above), on, on, off
    out_ln, ln_wall, ln_launches = timed_run(True)
    log(f"LayerNorm kernel launches: {ln_launches}")
    want = N_TILES * 2 * (cfg.depth + 1)  # 2 per block + 2 neck per tile
    if ln_launches["layernorm"] != want or launches["layernorm"] != 0:
        raise AssertionError(f"layernorm launches {ln_launches['layernorm']} "
                             f"with the switch on (want {want}), "
                             f"{launches['layernorm']} with it off")
    ln_worst = compare_slices(out_ln, out)
    ln_wall2 = timed_run(True)[1]
    off_wall2 = timed_run(False)[1]
    stats = dict(
        tiles_per_s=N_TILES / wall, wall_s=wall, plain_wall_s=plain_wall,
        ln_switch_walls_s=dict(off=[wall, off_wall2],
                               on=[ln_wall, ln_wall2]),
        ln_launches=ln_launches["layernorm"], worst_iou_ln_vs_off=ln_worst,
        instances=counts, worst_iou_vs_plain=worst,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        breakdown=breakdown,
        # kernel 3 on this path's own input (one call per batch)
        histogram_on_path=histogram_timing(*landings[-1]),
    )
    return launches, stats, landings[-1]


# ---------------------------------------------------------------- phase 5

def disc_images(rng, n_images: int, size: int, n_discs: int,
                n_classes: int):
    """Synthetic training data: ~``n_discs`` non-overlapping discs per
    image in classes 1..n_classes−1, each class darkening the three
    channels by its own amounts over a noisy background. Returns images
    (3, S, S) float32 and labels (2, S, S) [instance, class]."""
    yy, xx = np.mgrid[:size, :size]
    shade = rng.uniform(20, 90, size=(n_classes, 3))
    images, labels = [], []
    for _ in range(n_images):
        inst = np.zeros((size, size), np.float32)
        cls = np.zeros((size, size), np.float32)
        k = 0
        for _ in range(n_discs):
            r = int(rng.integers(8, 15))
            cy, cx = (int(v) for v in rng.integers(r, size - r, 2))
            win = (slice(cy - r, cy + r + 1), slice(cx - r, cx + r + 1))
            m = (((yy[win] - cy) ** 2 + (xx[win] - cx) ** 2 <= r * r)
                 & (inst[win] == 0))
            if m.sum() < 20:
                continue
            k += 1
            inst[win][m] = k
            cls[win][m] = rng.integers(1, n_classes)
        img = 200 + rng.normal(0, 8, (3, size, size))
        img -= shade[cls.astype(np.int64)].transpose(2, 0, 1) * (inst > 0)
        images.append(img.astype(np.float32))
        labels.append(np.stack([inst, cls]))
    return images, labels


def vit_train_flops_per_image(cfg) -> float:
    """3 × the forward's matmul FLOPs for one bsize² crop (the MFU
    convention of tools/bench_train.py, whose count this repeats)."""
    L = cfg.tokens_hw ** 2
    E, ps, D = cfg.embed_dim, cfg.ps, cfg.neck_dim
    per_tok = 3 * E * E * 2 + E * E * 2 + 2 * E * E * cfg.mlp_ratio * 2
    attn = 2 * L * L * E * 2
    blocks = cfg.depth * (L * per_tok + attn)
    patch = L * (3 * ps * ps) * E * 2
    neck = L * (E * D + 9 * D * D) * 2
    heads = L * D * (3 + cfg.n_cell_classes) * ps * ps * 2
    return 3.0 * (blocks + patch + neck + heads)


def attention_grads_ok(grads: dict, depth: int) -> int:
    """Every attention parameter of every block has a finite gradient of
    non-zero norm (the kernels' backward reached it); returns how many
    were checked."""
    keys = [k for k in grads if ".attn." in k]
    if len(keys) != 6 * depth:
        raise AssertionError(f"{len(keys)} attention parameters")
    for k in keys:
        g = grads[k]
        if not bool(torch.isfinite(g).all()) or float(g.norm()) == 0.0:
            raise AssertionError(f"{k}: gradient not finite or zero")
    return len(keys)


def step_grads(net, X, lbl, cw, n_classes):
    """One train step at learning rate 0 without layer-drop: (total loss,
    every parameter's gradient); the parameters do not move."""
    lv = torch.zeros(3, device=X.device)
    opt = make_optimizer(net, lv, 0.1, None, True)
    step = make_train_step(net, opt, lv, np.zeros(1), n_classes,
                           use_uncertainty_weighting=True,
                           class_weights=cw, rdrop=False)
    total = float(step(X, lbl)["total"])
    return total, {k: p.grad.detach().float().clone()
                   for k, p in net.named_parameters()}


def run_training(dev, out_dir: str) -> tuple[dict, dict]:
    cfg = ClassTransformerConfig(n_cell_classes=6, dtype="bfloat16")
    rng = np.random.default_rng(SEED)
    images, labels = disc_images(rng, TRAIN_IMAGES, TRAIN_SIZE, 60,
                                 cfg.n_cell_classes)
    _build.reset_launches()
    t0 = time.perf_counter()
    tr_d, tr_l, tr_diam, *_ = process_train_test(images, labels, device=dev)
    targets_s = time.perf_counter() - t0
    target_launches = _build.LAUNCHES["masked_diffusion"]
    if target_launches == 0 or len(tr_d) != TRAIN_IMAGES:
        raise AssertionError(f"targets: {len(tr_d)} images, "
                             f"{target_launches} diffusion launches")
    ds = ClassposeTrainingDataset(np.stack(tr_d), np.stack(tr_l),
                                  diameter_array=tr_diam, bsize=cfg.bsize,
                                  seed=SEED)
    cw = ds.class_weights
    model = ClassposeModel(cfg=cfg, precision="bf16", device=dev, seed=SEED)
    net = model.net
    watched = {k: p.detach().clone() for k, p in net.named_parameters()
               if ".attn." in k or k.startswith(("out.", "out_class."))}

    # the trainer: 3 epochs of 2 steps, epoch 0 at lr 0 by the schedule
    n_epochs, steps = 3, 3 * (TRAIN_IMAGES // TRAIN_BATCH)
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path, train_losses, _ = train_class_seg(
        model, ds, batch_size=TRAIN_BATCH, n_epochs=n_epochs,
        learning_rate=1e-4, save_path=out_dir, model_name="smoke",
        class_weights=cw, use_uncertainty_weighting=True,
        random_seed=SEED)
    torch.cuda.synchronize()
    trainer_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log(f"training launches: {launches}")
    for k in ("attention_fwd", "attention_bwd"):
        if launches[k] != cfg.depth * steps:
            raise AssertionError(f"{k}: {launches[k]} launches, expected "
                                 f"{cfg.depth} per step × {steps} steps")
    if not np.isfinite(train_losses).all():
        raise AssertionError(f"train losses {train_losses}")
    params = dict(net.named_parameters())
    still = [k for k, v in watched.items() if torch.equal(v, params[k])]
    if still:
        raise AssertionError(f"{len(still)} parameters did not move: "
                             f"{still[:4]}")
    del watched

    # the trainer's host work besides its steps: one batch through the
    # augmentation, and one save of the final weights
    t0 = time.perf_counter()
    items = [ds[i] for i in range(TRAIN_BATCH)]
    batch_load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_params(net.state_dict(), f"{out_dir}/again.npz", cfg)
    save_npz_s = time.perf_counter() - t0

    # the step alone at batch 8: median wall, peak memory, MFU, a trace
    X = torch.from_numpy(np.stack([x for x, _ in items])).to(dev)
    lbl = torch.from_numpy(np.stack([y for _, y in items])).to(dev)
    lv = torch.zeros(3, device=dev)
    opt = make_optimizer(net, lv, 0.1, None, True)
    step = make_train_step(
        net, opt, lv, np.full(1, 1e-5), cfg.n_cell_classes,
        use_uncertainty_weighting=True, class_weights=cw, rdrop=True,
        generator=torch.Generator(device=dev).manual_seed(SEED))
    step(X, lbl)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    times = []
    for _ in range(6):
        t0 = time.perf_counter()
        metrics = step(X, lbl)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_launches = {k: v / len(times) for k, v in _build.LAUNCHES.items()}
    if not all(np.isfinite(float(v)) for v in metrics.values()):
        raise AssertionError(f"step metrics {metrics}")
    step_s = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mfu = vit_train_flops_per_image(cfg) * TRAIN_BATCH / step_s / PEAK_BF16
    breakdown = traced(lambda: step(X, lbl))
    log(f"train step breakdown: {json.dumps(breakdown)}")
    del opt, step

    # one step at batch 2 without layer-drop (which may drop a block for
    # every sample), kernels against the plain versions, from the same
    # state and batch
    X2, lbl2 = X[:2].contiguous(), lbl[:2].contiguous()
    total, grads = step_grads(net, X2, lbl2, cw, cfg.n_cell_classes)
    n_attn = attention_grads_ok(grads, cfg.depth)
    restore = plain_versions()
    try:
        total_ref, grads_ref = step_grads(net, X2, lbl2, cw,
                                          cfg.n_cell_classes)
    finally:
        restore()
    # bf16 network, attention rounded differently in the two routes
    if abs(total - total_ref) > 1e-2 * abs(total_ref):
        raise AssertionError(f"step loss {total} vs plain {total_ref}")
    cos = {k: float(F.cosine_similarity(grads[k].flatten(),
                                        grads_ref[k].flatten(), 0))
           for k in grads}
    worst = min(cos, key=cos.get)
    if cos[worst] < 0.99:
        raise AssertionError(f"gradient of {worst}: cosine {cos[worst]} "
                             f"to the plain route's")
    del grads, grads_ref
    fault3 = fault3_train_step(dev, tr_d, tr_l, tr_diam)
    log(f"fault 3 train step: {json.dumps(fault3)}")
    stats = dict(
        targets_s=targets_s, target_diffusion_launches=target_launches,
        trainer_s=trainer_s, batch_load_s=batch_load_s,
        save_npz_s=save_npz_s, train_losses=train_losses.tolist(),
        final_weights=path.split("/")[-1],
        attention_params_checked=n_attn,
        step_batch=TRAIN_BATCH, step_ms_median=step_s * 1e3,
        step_ms_all=[t * 1e3 for t in times], imgs_per_s=TRAIN_BATCH / step_s,
        peak_mem_gib=peak, mfu_3x_fwd=mfu, launches_per_step=step_launches,
        plain_check_loss=[total, total_ref],
        plain_check_min_cosine=[worst, cos[worst]],
        breakdown=breakdown, fault3_step=fault3,
    )
    return launches, stats


def fault3_train_step(dev, tr_d, tr_l, tr_diam) -> dict:
    """Fault 3 in training: one bf16 step at batch 8 of 224² crops (28 × 28
    tokens, L = 784) of the training phase's images, full ViT-L width,
    seeded random weights, without layer-drop; one launch of each
    attention kernel per block; loss within 1e-2 relative and every
    parameter's gradient at cosine ≥ 0.99 against the same step with the
    plain versions swapped in."""
    cfg = ClassTransformerConfig(n_cell_classes=6, dtype="bfloat16",
                                 bsize=FAULT3_BSIZE)
    ds = ClassposeTrainingDataset(np.stack(tr_d), np.stack(tr_l),
                                  diameter_array=tr_diam, bsize=cfg.bsize,
                                  seed=SEED)
    items = [ds[i] for i in range(TRAIN_BATCH)]
    X = torch.from_numpy(np.stack([x for x, _ in items])).to(dev)
    lbl = torch.from_numpy(np.stack([y for _, y in items])).to(dev)
    net = ClassposeModel(cfg=cfg, precision="bf16", device=dev,
                         seed=SEED).net
    torch.cuda.synchronize()
    _build.reset_launches()
    total, grads = step_grads(net, X, lbl, ds.class_weights,
                              cfg.n_cell_classes)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    if any(launches[k] != cfg.depth for k in ("attention_fwd",
                                              "attention_bwd")):
        raise AssertionError(f"224² step launches {launches}")
    restore = plain_versions()
    try:
        total_ref, grads_ref = step_grads(net, X, lbl, ds.class_weights,
                                          cfg.n_cell_classes)
    finally:
        restore()
    if abs(total - total_ref) > 1e-2 * abs(total_ref):
        raise AssertionError(f"224² step loss {total} vs plain {total_ref}")
    cos = {k: float(F.cosine_similarity(grads[k].flatten(),
                                        grads_ref[k].flatten(), 0))
           for k in grads}
    worst = min(cos, key=cos.get)
    if cos[worst] < 0.99:
        raise AssertionError(f"224² step gradient of {worst}: cosine "
                             f"{cos[worst]}")
    return dict(crop=cfg.bsize, tokens=cfg.tokens_hw, batch=TRAIN_BATCH,
                launches={k: launches[k] for k in ("attention_fwd",
                                                   "attention_bwd")},
                loss=[total, total_ref], min_cosine=[worst, cos[worst]])


# ---------------------------------------------------------------- phase 6

def read_outputs(out_dir: str, base: str, labels: list[str]):
    """Parse the CLI's four outputs and check they agree: the contours
    and centroids GeoJSON, the densities CSV and the zarr store's
    centroid points. Returns (centroids (n, 2), class names)."""
    with open(f"{out_dir}/{base}_cell_contours.geojson") as f:
        contours = json.load(f)
    with open(f"{out_dir}/{base}_cell_centroids.geojson") as f:
        cents = json.load(f)
    n = len(contours["features"])
    if contours["type"] != "FeatureCollection" or len(cents["features"]) != n:
        raise AssertionError("contours and centroids disagree")
    for poly in contours["features"]:
        ring = poly["geometry"]["coordinates"][0]
        if poly["geometry"]["type"] != "Polygon" or len(ring) < 5 \
                or ring[0] != ring[-1]:
            raise AssertionError(f"bad polygon {poly['id']}")
    pts = np.array([c["geometry"]["coordinates"] for c in cents["features"]],
                   np.float64).reshape(n, 2)
    names = [c["properties"]["classification"]["name"]
             for c in cents["features"]]
    with open(f"{out_dir}/{base}_cellular_densities.csv") as f:
        rows = list(csv.DictReader(f))
    if [r["cell_class"] for r in rows] != labels \
            or sum(int(r["count"]) for r in rows) != n:
        raise AssertionError(f"densities CSV {rows} for {n} cells")
    zarr = f"{out_dir}/{base}_spatialdata.zarr"
    zx = read_zarr_array(f"{zarr}/points/cell_centroids/x")
    zc = read_zarr_array(f"{zarr}/points/cell_centroids/classification")
    if not np.array_equal(zx, pts[:, 0]) or list(zc) != names:
        raise AssertionError("zarr centroids disagree with the GeoJSON")
    return pts, names


def device_idle_share(trace_path: str) -> dict:
    """Device busy time (the union of kernel, memcpy and memset intervals
    on every stream) against the span of a torch.profiler chrome trace."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    span0 = min(e["ts"] for e in events)
    span1 = max(e["ts"] + e["dur"] for e in events)
    busy, end = 0.0, -np.inf
    for t0, t1 in sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                         if e.get("cat") in ("kernel", "gpu_memcpy",
                                             "gpu_memset")):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    span_ms = (span1 - span0) / 1e3
    return dict(traced_span_ms=span_ms, device_busy_ms=busy / 1e3,
                device_idle_share=1.0 - busy / 1e3 / span_ms)


def run_wsi(dev, work: str) -> tuple[dict, dict]:
    """The WSI CLI on a synthetic slide with the LayerNorm switch on (see
    the module docstring, step 6)."""
    os.environ["WSI_READER"] = "array"
    cfg = ClassTransformerConfig(n_cell_classes=6, dtype="bfloat16")
    labels = [f"class{i}" for i in range(1, cfg.n_cell_classes + 1)]
    t0 = time.perf_counter()
    slide, _ = synthetic_wsi(width=WSI_SIZE, height=WSI_SIZE, n_cells=4000,
                             mpp=WSI_MPP, seed=SEED)
    np.save(f"{work}/slide.npy", slide._level0)
    del slide
    slide_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_params(perturbed_structured_params(cfg, ripple=0.5, seed=SEED,
                                            attn_ripple=0.5),
                f"{work}/vitl.npz", cfg)
    ckpt_s = time.perf_counter() - t0
    with open(f"{work}/config.yaml", "w") as f:
        f.write(f"path: {work}/vitl.npz\nmpp: {WSI_MODEL_MPP}\n"
                "cell_types:\n" + "".join(f"- {c}\n" for c in labels))

    def cli(out: str, *extra):
        argv = ["--model_config", f"{work}/config.yaml",
                "--slide_path", f"{work}/slide.npy", "--output_folder", out,
                "--device", "cuda", "--precision", "bf16",
                "--batch_size", "32", "--tile_size", "1024",
                "--overlap", "64", "--mpp", str(WSI_MPP),
                "--output_type", "csv", "spatialdata", *extra]
        with ln_switch(True):
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            res = main_with_args(argv)[0]
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0, dict(_build.LAUNCHES)

    res, wall, launches = cli(f"{work}/out")
    log(f"WSI launches: {launches}")
    missing = [k for k in WSI_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the WSI path: "
                             f"{missing}")
    pts, names = read_outputs(f"{work}/out", "slide", labels)
    # the design field: one cell per 32² model pixels over the 5×5 tile
    # grid's 4864² (tile origins are multiples of the period, so
    # overlapping tiles find the same cells and dedup keeps one)
    n_design = (4 * 960 + TILE) ** 2 // PERIOD ** 2
    if res["n_tiles"] != 25 or not (0.9 * n_design <= len(pts)
                                    <= 1.05 * n_design):
        raise AssertionError(f"{res['n_tiles']} tiles, {len(pts)} cells "
                             f"(design {n_design})")

    traced_res, _, _ = cli(f"{work}/out_traced", "--profile",
                           f"{work}/trace")
    idle = device_idle_share(f"{work}/trace/trace.json")

    restore = plain_versions()
    try:
        ref, plain_wall, _ = cli(f"{work}/out_plain")
    finally:
        restore()
    ref_pts, ref_names = read_outputs(f"{work}/out_plain", "slide", labels)
    from scipy.spatial import cKDTree

    dist, idx = cKDTree(ref_pts).query(pts, distance_upper_bound=1.0)
    hit = np.isfinite(dist)
    same = np.array([h and names[i] == ref_names[j]
                     for i, (h, j) in enumerate(zip(hit, idx))])
    count_diff = abs(len(pts) - len(ref_pts)) / len(ref_pts)
    if count_diff > 0.005 or same.mean() < 0.99:
        raise AssertionError(f"WSI vs plain: {len(pts)} vs {len(ref_pts)} "
                             f"cells, {same.mean():.4f} matched")
    stats = dict(
        slide_px=WSI_SIZE, slide_mpp=WSI_MPP, model_mpp=WSI_MODEL_MPP,
        make_slide_s=slide_s, make_checkpoint_s=ckpt_s,
        cli_wall_s=wall, pipeline_s=res["seconds"],
        slide_tiles_per_s=res["n_tiles"] / res["seconds"],
        n_tiles=res["n_tiles"], n_cells=res["n_cells"], n_design=n_design,
        stage_seconds=res["stage_seconds"],
        traced_pipeline_s=traced_res["seconds"], **idle,
        plain_cli_wall_s=plain_wall, plain_pipeline_s=ref["seconds"],
        plain_n_cells=ref["n_cells"], matched_share=float(same.mean()),
    )
    return launches, stats


# ---------------------------------------------------------------- phase 7

def design_dataset(rng) -> tuple[np.ndarray, np.ndarray]:
    """The evaluate phase's dataset: images (N, 3, S, S) float32 in
    [0, 255] (darker discs on a noisy background) and labels (N, 2, S, S)
    [instance, class]: the design field's cells (period 32, radius 13,
    centres at 16 + 32·k, what the structured checkpoint draws) as
    instances, all of the checkpoint's dominant class 1."""
    S = EVAL_SIZE
    yy, xx = np.mgrid[:S, :S]
    cy = (yy // PERIOD) * PERIOD + PERIOD // 2
    cx = (xx // PERIOD) * PERIOD + PERIOD // 2
    inside = (yy - cy) ** 2 + (xx - cx) ** 2 <= RADIUS ** 2
    inst = np.where(inside, (yy // PERIOD) * (S // PERIOD) + xx // PERIOD
                    + 1, 0).astype(np.float32)
    lab = np.stack([inst, (inst > 0).astype(np.float32)])
    imgs = 200 + rng.normal(0, 8, (EVAL_IMAGES, 3, S, S)) - 60 * inside
    return (np.clip(imgs, 0, 255).astype(np.float32),
            np.repeat(lab[None], EVAL_IMAGES, axis=0))


def pq_rows_equal(a: list[dict], b: list[dict], keys) -> None:
    for ra, rb in zip(a, b):
        for k in keys:
            if abs(float(ra[k]) - float(rb[k])) > 1e-6:
                raise AssertionError(f"class {ra['class_id']} {k}: "
                                     f"{ra[k]} vs {rb[k]}")


PQ_KEYS = ("pq", "dq", "sq", "tp", "fp", "fn", "precision", "recall", "f1",
           "iou_sum")


def run_evaluate(dev, work: str) -> tuple[dict, dict]:
    """The evaluate CLI, the metrics CLI and the per-image API (see the
    module docstring, step 7), with the WSI phase's checkpoint."""
    cfg = ClassTransformerConfig(n_cell_classes=6)
    ckpt = f"{work}/vitl.npz"
    data = f"{work}/conic"
    os.makedirs(data)
    images, labels = design_dataset(np.random.default_rng(SEED))
    np.save(f"{data}/images.npy", images)
    np.save(f"{data}/labels.npy", labels)
    grid = compute_tile_grid(EVAL_SIZE, EVAL_SIZE, cfg.bsize)
    chunks = chunk_plan(grid.ny * grid.nx, EVAL_BATCH)[0]

    def cli(out: str):
        argv = ["--data_path", data, "--model_path", ckpt, "--output_dir",
                out, "--device", "cuda", "--precision", "fp32",
                "--batch_size", str(EVAL_BATCH)]
        printed = io.StringIO()
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            res = evaluate_cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        preds = np.load(f"{out}/predictions.npy")
        with open(f"{out}/metrics.csv") as f:
            rows = list(csv.DictReader(f))
        if preds.shape != (EVAL_IMAGES, EVAL_SIZE, EVAL_SIZE, 2) \
                or preds.dtype != np.int32 or "pq" not in printed.getvalue():
            raise AssertionError(f"evaluate outputs {preds.shape} "
                                 f"{preds.dtype}")
        pq_rows_equal(rows, res["metrics"], PQ_KEYS)
        return res, wall, dict(_build.LAUNCHES), preds, printed.getvalue()

    res, wall, launches, preds, table = cli(f"{work}/eval")
    log(f"evaluate launches: {launches}\n{table}")
    want = cfg.depth * chunks * EVAL_IMAGES
    if launches["flash_attention_relpos"] != want:
        raise AssertionError(f"head-major attention launches "
                             f"{launches['flash_attention_relpos']}, want "
                             f"{want} ({cfg.depth} per crop chunk)")
    missing = [k for k in EVALUATE_KERNELS if launches[k] == 0]
    if missing or launches["masked_diffusion"] or launches["attention_fwd"]:
        raise AssertionError(f"evaluate path launches {launches}")
    n_design = (EVAL_SIZE // PERIOD) ** 2
    counts = [int(len(np.unique(p[..., 0])) - 1) for p in preds]
    cls1 = res["metrics"][0]
    if not all(0.95 * n_design <= c <= n_design for c in counts) \
            or cls1["class_id"] != 1 or cls1["pq"] < 0.8:
        raise AssertionError(f"instances {counts} (design {n_design}), "
                             f"class 1 {cls1}")

    restore = plain_versions()
    try:
        res_plain, plain_wall, _, preds_plain, _ = cli(f"{work}/eval_plain")
    finally:
        restore()
    worst = compare_slices([(p[..., 0], p[..., 1]) for p in preds],
                           [(p[..., 0], p[..., 1]) for p in preds_plain])

    # the metrics CLI on the evaluate CLI's outputs: the GT's classes are
    # 1 only, so its table has class 1 where the evaluate CLI's has the
    # model's six; class 1 must agree
    np.save(f"{work}/gt.npy",
            np.stack([labels[:, 0], labels[:, -1]], -1).astype(np.int32))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rows = metrics_cli(["--gt_path", f"{work}/gt.npy", "--pred_path",
                            f"{work}/eval/predictions.npy", "--output",
                            f"{work}/cm/metrics.csv"])
    metrics_cli_s = time.perf_counter() - t0
    pq_rows_equal(rows[:1], res["metrics"][:1], PQ_KEYS)

    # the per-image API: one 448² image under the profiler, one 256² image
    # (aligned: kernel 4, not kernel 7)
    model = ClassposeModel(pretrained_model=ckpt, nclasses=6,
                           precision="fp32", device=dev)
    x = images[0].transpose(1, 2, 0)
    model.eval(x, batch_size=EVAL_BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.eval(x, batch_size=EVAL_BATCH)
    torch.cuda.synchronize()
    image_s = time.perf_counter() - t0
    breakdown = traced(lambda: model.eval(x, batch_size=EVAL_BATCH))
    log(f"eval breakdown: {json.dumps(breakdown)}")
    _build.reset_launches()
    m256 = model.eval(np.ascontiguousarray(x[:256, :256]),
                      batch_size=EVAL_BATCH)[0]
    l256 = dict(_build.LAUNCHES)
    if l256["masked_diffusion"] == 0 or l256["diffuse_blocked"] \
            or l256["flash_attention_relpos"] != cfg.depth \
            or len(np.unique(m256)) - 1 < 0.95 * (256 // PERIOD) ** 2:
        raise AssertionError(f"256² eval: launches {l256}, "
                             f"{len(np.unique(m256)) - 1} instances")
    del model

    # eval's 3D branch in bf16 (kernel 1), against the plain versions
    model3 = ClassposeModel(pretrained_model=ckpt, nclasses=6,
                            precision="bf16", device=dev)
    stack = np.random.default_rng(SEED).integers(
        0, 256, size=STACK_SHAPE + (3,)).astype(np.float32)
    _build.reset_launches()
    t0 = time.perf_counter()
    m3, flows3, c3, _ = model3.eval(stack, do_3D=True,
                                    batch_size=EVAL_BATCH)
    torch.cuda.synchronize()
    stack_s = time.perf_counter() - t0
    l3 = dict(_build.LAUNCHES)
    restore = plain_versions()
    try:
        m3_ref = model3.eval(stack, do_3D=True, batch_size=EVAL_BATCH)[0]
    finally:
        restore()
    n3, n3_ref = int(m3.max()), int(m3_ref.max())
    fg3 = float(((m3 > 0) == (m3_ref > 0)).mean())
    if m3.shape != STACK_SHAPE or m3.dtype != np.int32 \
            or l3["attention_fwd"] == 0 or l3["flash_attention_relpos"] \
            or not np.isfinite(flows3[1]).all() or n3 == 0 \
            or abs(n3 - n3_ref) > max(2, 0.05 * n3_ref) or fg3 < 0.98:
        raise AssertionError(f"3D eval: {m3.shape} {m3.dtype}, launches "
                             f"{l3}, {n3} vs {n3_ref} instances, fg "
                             f"agreement {fg3}")
    del model3

    stats = dict(
        images=EVAL_IMAGES, size=EVAL_SIZE, crops_per_image=grid.ny * grid.nx,
        cli_wall_s=wall, inference_s=res["inference_s"],
        images_per_s=EVAL_IMAGES / res["inference_s"],
        pq_s=res["metrics_s"], metrics_cli_s=metrics_cli_s,
        pq_class1=cls1["pq"], instances=counts, n_design=n_design,
        plain_cli_wall_s=plain_wall,
        plain_inference_s=res_plain["inference_s"],
        worst_iou_vs_plain=worst, one_image_eval_s=image_s,
        eval_breakdown=breakdown, launches_256=l256,
        stack=dict(shape=STACK_SHAPE, eval_s=stack_s, launches=l3,
                   instances=n3, plain_instances=n3_ref,
                   fg_agreement=fg3),
    )
    return launches, stats


def run_fault3_eval(dev, bsize: int = FAULT3_BSIZE,
                    S: int = FAULT3_SIZE) -> dict:
    """Fault 3 at inference: a full-width ViT-L whose config has crops of
    ``bsize`` (224: 28 × 28 tokens; 1024: 128 × 128, L = 16384) with a
    live structured checkpoint (``perturbed_structured_params``, attention
    ripple 0.5), ``eval`` on one design-field image of S² (480²: 3 × 3
    crops, 2 chunks of 8; 1024²: one crop) in fp32 (kernel 8) and bf16
    (kernel 1), each on the kernel route and with the plain versions
    swapped in (one head at a time past L = 4096: the plain attention's
    (L, L) fp32 intermediates): one launch per block and crop chunk; masks
    compared as masks (equal counts, worst IoU ≥ 0.95, equal classes) and
    the network's flows and cell probability (the blended output) within
    1e-3·max|ref| at fp32 and 5e-2·max|ref| at bf16."""
    cfg = ClassTransformerConfig(n_cell_classes=6, bsize=bsize)
    params = perturbed_structured_params(cfg, ripple=0.5, seed=SEED,
                                         attn_ripple=0.5)
    by_head = cfg.tokens_hw ** 2 > 4096
    yy, xx = np.mgrid[:S, :S]
    inside = ((yy % PERIOD - PERIOD // 2) ** 2
              + (xx % PERIOD - PERIOD // 2) ** 2 <= RADIUS ** 2)
    x = np.clip(200 + np.random.default_rng(SEED).normal(0, 8, (S, S, 3))
                - 60 * inside[..., None], 0, 255).astype(np.float32)
    grid = compute_tile_grid(S, S, cfg.bsize)
    chunks = chunk_plan(grid.ny * grid.nx, EVAL_BATCH)[0]
    out = {}
    for precision, kernel, tol in (("fp32", "flash_attention_relpos", 1e-3),
                                   ("bf16", "attention_fwd", 5e-2)):
        model = ClassposeModel(cfg=cfg, params=params, precision=precision,
                               device=dev)
        model.eval(x, batch_size=EVAL_BATCH)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        m, flows, c, _ = model.eval(x, batch_size=EVAL_BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        if launches[kernel] != cfg.depth * chunks:
            raise AssertionError(f"bsize {bsize} {precision} eval: "
                                 f"{launches}, want {cfg.depth * chunks} of "
                                 f"{kernel}")
        restore = plain_versions(by_head)
        try:
            m_ref, flows_ref, c_ref, _ = model.eval(x, batch_size=EVAL_BATCH)
        finally:
            restore()
        worst = compare_slices([(m, c)], [(m_ref, c_ref)])
        rel_err = {}
        for name, i in (("flows", 1), ("cellprob", 2)):
            a, r = np.asarray(flows[i], np.float64), np.asarray(
                flows_ref[i], np.float64)
            if a.shape != r.shape or not np.isfinite(a).all():
                raise AssertionError(f"bsize {bsize} {precision} {name}")
            rel_err[name] = float(np.abs(a - r).max() / np.abs(r).max())
            if rel_err[name] > tol:
                raise AssertionError(f"bsize {bsize} {precision} {name}: "
                                     f"max|Δ|/max|ref| {rel_err[name]}")
        n_design = (S // PERIOD) ** 2
        if not 0.95 * n_design <= int(m.max()) <= n_design:
            raise AssertionError(f"bsize {bsize} {precision}: {m.max()} "
                                 f"cells (design {n_design})")
        out[precision] = dict(eval_s=wall, kernel_launches=launches[kernel],
                              instances=int(m.max()), n_design=n_design,
                              worst_iou_vs_plain=worst,
                              rel_err_vs_plain=rel_err)
        del model
    return dict(bsize=cfg.bsize, tokens=cfg.tokens_hw, image=S,
                crops=grid.ny * grid.nx, chunks=chunks,
                plain_by_head=by_head, **out)


def big_crop_train_step(dev) -> dict:
    """Fault 3 at the largest crop: one bf16 train step on the kernel
    route at batch 1 of a 1024² crop (128 × 128 tokens, L = 16384) of one
    1024² disc image (~240 discs, flow targets by kernel 4), full ViT-L
    width and depth, seeded random weights, without layer-drop: a finite
    loss, finite gradients and ``depth`` launches each of kernels 1 and 5.
    Cut: no plain step beside it (the plain vjp keeps several (L, L) fp32
    tensors per head and block, ~1 GiB each); kernel 5's arithmetic at
    128 × 128 is held against the plain vjp in ``check_fault3_grids``."""
    cfg = ClassTransformerConfig(n_cell_classes=6, dtype="bfloat16",
                                 bsize=BIG_BSIZE)
    rng = np.random.default_rng(SEED)
    images, labels = disc_images(rng, 1, BIG_SIZE, 240, cfg.n_cell_classes)
    tr_d, tr_l, tr_diam, *_ = process_train_test(images, labels, device=dev)
    ds = ClassposeTrainingDataset(np.stack(tr_d), np.stack(tr_l),
                                  diameter_array=tr_diam, bsize=cfg.bsize,
                                  seed=SEED)
    x, y = ds[0]
    X = torch.from_numpy(x[None]).to(dev)
    lbl = torch.from_numpy(y[None]).to(dev)
    net = ClassposeModel(cfg=cfg, precision="bf16", device=dev,
                         seed=SEED).net
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    total, grads = step_grads(net, X, lbl, ds.class_weights,
                              cfg.n_cell_classes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: _build.LAUNCHES[k] for k in ("attention_fwd",
                                                "attention_bwd")}
    if any(v != cfg.depth for v in launches.values()):
        raise AssertionError(f"bsize {BIG_BSIZE} step launches {launches}")
    if not np.isfinite(total) or not all(bool(torch.isfinite(g).all())
                                         for g in grads.values()):
        raise AssertionError(f"bsize {BIG_BSIZE} step: loss {total}")
    return dict(crop=cfg.bsize, tokens=cfg.tokens_hw, batch=1, loss=total,
                launches=launches, step_s=wall,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ab", action="store_true",
                    help=f"also A/B the kernels against the bodies of "
                    f"{AB_PARENT} (phase 8)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {smi}")

    t0 = time.perf_counter()
    per_source = _build.build_all()
    log(f"build {time.perf_counter() - t0:.1f} s: {per_source}")
    for name in _build.SOURCES:
        _build.lib(name)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernels = []
    for check in (lambda: check_attention(gen, dev),
                  lambda: check_attention_bwd(gen, dev),
                  lambda: check_sampler(gen, dev),
                  lambda: check_histogram(gen, dev),
                  lambda: check_diffusion(dev),
                  lambda: check_layernorm(gen, dev),
                  lambda: check_diffuse_blocked(gen, dev),
                  lambda: check_flash_attention(gen, dev)):
        k = check()
        torch.cuda.synchronize()
        log(f"{k['name']}: max|Δ| {k['max_abs_err']:.3g}, "
            f"{k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, library "
            f"{k['library_ms']}, bound {k['bound_ms']:.4f} by "
            f"{k['bound_by']})")
        kernels.append(k)
    sampling_shapes = check_sampling_shapes(gen, dev)
    log(f"sampler/histogram at other shapes: {sampling_shapes}")
    fault3_grids = check_fault3_grids(gen, dev)
    log(f"fault 3 grids: {json.dumps(fault3_grids)}")

    launches, stats, path_landing = run_slice(dev)
    log(f"slice: {json.dumps(stats)}")
    with tempfile.TemporaryDirectory() as out_dir:
        train_launches, train_stats = run_training(dev, out_dir)
    log(f"training: {json.dumps(train_stats)}")
    with tempfile.TemporaryDirectory() as work:
        wsi_launches, wsi_stats = run_wsi(dev, work)
        log(f"wsi: {json.dumps(wsi_stats)}")
        ev_launches, ev_stats = run_evaluate(dev, work)
    log(f"evaluate: {json.dumps(ev_stats)}")
    fault3_eval = run_fault3_eval(dev)
    log(f"fault 3 eval: {json.dumps(fault3_eval)}")
    big_eval = run_fault3_eval(dev, BIG_BSIZE, BIG_SIZE)
    log(f"bsize {BIG_BSIZE} eval: {json.dumps(big_eval)}")
    big_step = big_crop_train_step(dev)
    log(f"bsize {BIG_BSIZE} train step: {json.dumps(big_step)}")
    ab = None
    if args.ab:
        ab = dict(old=AB_PARENT, **run_ab(
            parent_sources(AB_PARENT), BUILD / "ab_ptxas.txt", path_landing))
        log(f"A/B: {json.dumps(ab)}")
    for k in kernels:
        # each kernel's count from the phase whose path runs it: the
        # eval slice, training for the attention backward, the WSI path
        # (its switch on) for the LayerNorm, the evaluate CLI for the
        # head-major attention and the halo-blocked diffusion
        name = k["name"]
        k["launches"] = (launches[name] if name in EVAL_KERNELS
                         else wsi_launches[name] if name == "layernorm"
                         else ev_launches[name]
                         if name in ("flash_attention_relpos",
                                     "diffuse_blocked")
                         else train_launches[name])
    order = ["name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms"]
    by_name = {k["name"]: k for k in kernels}
    print(smi)
    print(json.dumps({"kernels": [{key: k[key] for key in order}
                                  for k in kernels],
                      "slice": stats, "training": train_stats,
                      "wsi": wsi_stats, "evaluate": ev_stats,
                      "layernorm_neck": by_name["layernorm"]["neck"],
                      "diffuse_blocked_shapes": by_name["diffuse_blocked"][
                          "shapes"],
                      "landing_histogram_inputs": by_name[
                          "landing_histogram"]["inputs"],
                      "flash_attention_relpos_bf16": by_name[
                          "flash_attention_relpos"]["bf16"],
                      "attention_detail": {
                          name: {key: v for key, v in by_name[name].items()
                                 if key not in order and key != "bf16"}
                          for name in ("attention_fwd",
                                       "flash_attention_relpos")},
                      "sampling_shapes": sampling_shapes,
                      "bilinear_sample_spread": by_name["bilinear_sample"][
                          "spread"],
                      "bilinear_sample_library_spread": by_name[
                          "bilinear_sample"]["library_spread"],
                      "fault3_grids": fault3_grids,
                      "fault3_eval": fault3_eval,
                      "bsize1024": dict(eval=big_eval, train_step=big_step),
                      "diffusion_detail": {
                          k: by_name["masked_diffusion"][k]
                          for k in ("launches_per_call", "target_512")},
                      "ab": ab}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
