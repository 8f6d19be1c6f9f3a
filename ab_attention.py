#!/usr/bin/env python3
"""A/B of kernel bodies against a previous version of their sources, in
one process on one card.

    python3 ab_attention.py --rev <rev>       # or --old <csrc directory>
    python3 ab_attention.py --windows         # the diffusion's windows

With ``--rev`` the previous sources are ``_archive/<rev>`` (git-ignored;
unpacked there with ``git archive`` when missing, see
:func:`parent_sources`). Builds ``attention.cu`` (kernel 1, token-major),
``attention_hm.cu`` (kernel 8: its bf16 variant shares kernel 1's body,
its fp32 body is its own), ``attention_bwd.cu`` (kernel 5), ``sample.cu``
(kernels 2 and 3) and ``diffusion.cu`` (kernels 4 and 7; an old version's
``diffusion_blocked.cu`` for its kernel 7) from the old directory and
from the package's ``csrc`` with the package's nvcc flags plus ``-Xptxas
-v`` (registers, shared memory and spills of every instantiation go to
the file ``--log`` names). Both are held against the plain versions, then
timed in turns (old, new, new, old; each pass the median of CUDA-event
timings over back-to-back launches) at the main paths' shapes: kernel 1
at 25 crops × 16 heads × 1024 tokens × 64 (one inference layer, the
32 × 32 grid) and 1 × 16 × 1024 × 64 (one chunk of eval's 3D branch:
fewer tiles than SMs); kernel 8 in bf16 and in fp32 at 8 × 16 × 1024 × 64
(one evaluate layer); kernel 5 at 8 × 16 × 1024 × 64 (one train-step
layer) and 2 × 16 × 784 × 64 (28 × 28 tokens, bsize 224); kernel 2 at
8 × 2 × 1024² (one follow-flows pass); kernel 3 at 8 × 1024² on a
uniform input (each pixel lands within ±8 px of itself) and a converged
one (every foreground pixel of the design field on its cell's centre),
and on a masks-path call's own input when the caller passes one; kernel
4 on 8 tiles of 1024² of the design field with counts 40/80/120 (one QC
call); kernel 7 at :data:`KERNEL7_SHAPES` (the evaluate QC of one 448²
image at niter 80, a 500² target at 100, 8 × 448² at 40/80/120, a 2048²
target at 120, 8 × 1024² at 40/80/120), each with its launches per call.
Entry points an old version has and the package does not are bound from
``OLD_SIGNATURES``. Beside them the one-call yardsticks (for the
attention forwards the fastest SDPA backend that takes the float mask;
for kernel 2 ``grid_sample``, for kernel 3 ``bincount``), each with its
spread, achieved TFLOP/s where it applies and the share of the bound.
Prints the card's name and power limit, then one JSON line.

``--grids`` A/Bs the attention kernels instead at the grids where they
pick a body by the grid's shape (:func:`run_grids`), with ``--old`` a copy
of ``csrc`` whose branch to one body is taken out. ``--windows`` times
the windows of ``diffusion.cu`` against each other at kernel 7's shapes
(:func:`run_windows`): which one ``ops/diffusion.py`` should pick there.

The timing helpers and yardsticks here are also ``chip_smoke.py``'s,
which runs :func:`run_ab` under ``--ab``. The old sources are a
git-ignored copy, never a route of the package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch

import torch.nn.functional as F

from classpose_tpu_torch import _build
from classpose_tpu_torch.nn.attention import (
    attention_relpos_bwd_plain,
    attention_relpos_plain,
    flash_attention_relpos_plain,
)
from classpose_tpu_torch.ops.diffusion import (
    WINDOW_WIDTH,
    WINDOWS,
    diffuse_blocked_plain,
    diffusion_plan,
    masked_diffusion_plain,
    run_kernel,
)
from classpose_tpu_torch.ops.sample import (
    bilinear_sample_plain,
    landing_histogram_plain,
)

# published H100 SXM peaks (dense): bf16 tensor cores, fp32 outside them,
# HBM bandwidth
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

BUILD = Path("_archive") / "ab_build"  # git-ignored


SOURCES = ("attention", "attention_hm", "attention_bwd", "sample",
           "diffusion")
# sources an earlier version has and the package does not, with the
# package source whose flags build them: kernel 7's own stencil (before
# it shared kernel 4's body)
OLD_SOURCES = {"diffusion_blocked": "diffusion"}
P, I = ctypes.c_void_p, ctypes.c_int
# entry points of earlier bodies that the package no longer has: kernel
# 4's rounds driven from the host, kernel 7's halo-blocked rounds
OLD_SIGNATURES = {
    "diffusion_resident_round": ("diffusion",
                                 [P, P, P, P, P, I, I, I, I, P]),
    "diffusion_resident_depth": ("diffusion", []),
    "diffusion_blocked_round": ("diffusion_blocked",
                                [P, P, P, P, P, I, I, I, I, P]),
    "diffusion_blocked_depth": ("diffusion_blocked", []),
}


def time_runs(fn, reps: int = 5, inner: int = 1) -> list[float]:
    """``reps`` CUDA-event timings (ms per call) of ``fn()`` after a
    warm-up, each over ``inner`` calls back to back: for a kernel of tens
    of µs, ``inner`` > 1 keeps the host's launch latency out of the
    time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return times


def time_ms(fn, reps: int = 5, inner: int = 1) -> float:
    """Median of :func:`time_runs`."""
    return statistics.median(time_runs(fn, reps, inner))


def spread(prefix: str, runs: list[float]) -> dict:
    """``{prefix}ms``: the median of ``runs``; ``{prefix}spread``: their
    (min, max)."""
    return {f"{prefix}ms": statistics.median(runs),
            f"{prefix}spread": [min(runs), max(runs)]}


# SDPA backends that take a float mask (FlashAttention's does not)
SDPA_BACKENDS = ("EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")


def sdpa_yardstick(q, k, v, mask, scale, reps: int = 15,
                   inner: int = 3) -> dict:
    """The attention kernels' one-call yardstick: SDPA with the
    materialized float bias, timed under each backend that accepts it
    (one refusing raises and is left out); the fastest backend's median,
    its name and its spread (min, max over ``reps``), and every accepted
    backend's median."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              scale=scale)

    runs = {}
    for name in SDPA_BACKENDS:
        with sdpa_kernel(getattr(SDPBackend, name)):
            try:
                call()
                torch.cuda.synchronize()
            except RuntimeError:
                continue
            runs[name] = time_runs(call, reps, inner)
    best = min(runs, key=lambda n: statistics.median(runs[n]))
    return dict(library_ms=statistics.median(runs[best]),
                library_backend=best,
                library_spread=[min(runs[best]), max(runs[best])],
                library_backends={n: statistics.median(r)
                                  for n, r in runs.items()})

def grid_sample_yardstick(u, py, px, reps: int = 15, inner: int = 3) -> dict:
    """Kernel 2's one-call yardstick: ``grid_sample`` computes the same
    bilinear function for in-image positions (``align_corners=True``);
    its median and spread (min, max over ``reps``) as ``library_*``."""
    H, W = u.shape[-2:]
    grid = torch.stack([px / (W - 1) * 2 - 1, py / (H - 1) * 2 - 1], -1)
    return spread("library_", time_runs(lambda: F.grid_sample(
        u, grid, mode="bilinear", padding_mode="border",
        align_corners=True), reps, inner))


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def positions(gen, dev, spread: float, B: int, H: int, W: int):
    """Sampling positions for a (B, H, W) field: each pixel's own
    coordinates moved by up to ±``spread`` px, clamped into the image."""
    gy = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    gx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    d = lambda: (torch.rand(B, H, W, generator=gen, device=dev) * 2 - 1) \
        * spread  # noqa: E731
    py = torch.clamp(gy + d(), 0, H - 1).contiguous()
    px = torch.clamp(gx + d(), 0, W - 1).contiguous()
    return py, px


def build(csrc: Path, tag: str, log_path: Path, sources=SOURCES,
          defines: tuple[str, ...] = ()) -> dict[str, ctypes.CDLL]:
    """nvcc ``sources`` of ``csrc`` with the package's flags, ``-Xptxas
    -v`` and ``-D`` of each of ``defines``, all at once; returns the
    loaded libraries, their ptxas output appended to ``log_path``."""
    BUILD.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, {}
    for name in sources:
        if not (csrc / f"{name}.cu").exists():
            continue  # a source of another version
        out = BUILD / f"lib{name}_{tag}.so"
        cmd = _build._cmd(OLD_SOURCES.get(name, name), out)
        cmd[-1] = str(csrc / f"{name}.cu")
        cmd[1:1] = ["-Xptxas=-v"] + [f"-D{d}" for d in defines]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), out)
    with open(log_path, "a") as f:
        for name, (proc, out) in procs.items():
            log, _ = proc.communicate()
            f.write(f"==== {tag} {name}\n{log}\n")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc {tag} {name}:\n{log}")
            lib = ctypes.CDLL(str(out))
            for fn, (owner, argtypes) in {**_build._SIGNATURES,
                                          **OLD_SIGNATURES}.items():
                if owner == name and hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            libs[name] = lib
    return libs


def fwd_tm(lib, qkv, rel, out, G, n, scale):
    B, L, _ = qkv.shape
    _build.check(lib.attn_fwd_bf16(
        qkv.data_ptr(), rel.data_ptr(), out.data_ptr(), None, None, B, L, n,
        G, G, scale, _build.stream_ptr(qkv.device)), "attn_fwd_bf16")


def fwd_hm(lib, q, k, v, rh, rw, out, G, scale):
    B, n, L, _ = q.shape
    fn = "attn_hm_f32" if q.dtype == torch.float32 else "attn_hm_bf16"
    _build.check(getattr(lib, fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rh.data_ptr(),
        rw.data_ptr(), out.data_ptr(), B, L, n, G, G, scale,
        _build.stream_ptr(q.device)), fn)


def sample(lib, u, py, px, out):
    B, C, H, W = u.shape
    _build.check(lib.bilinear_sample_f32(
        u.data_ptr(), py.data_ptr(), px.data_ptr(), out.data_ptr(), B, C, H,
        W, _build.stream_ptr(u.device)), "bilinear_sample_f32")


def bwd(lib, qkv, rel, out32, lse, dout, delta, dqkv, drel, G, n, scale):
    B, L, _ = qkv.shape
    _build.check(lib.attn_bwd_bf16(
        qkv.data_ptr(), rel.data_ptr(), out32.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), drel.data_ptr(),
        B, L, n, G, G, scale, _build.stream_ptr(qkv.device)),
        "attn_bwd_bf16")


def ab(calls: dict, flops: float, bound: float) -> dict:
    """Time old and new in turns (old, new, new, old); per version the
    median over its passes, the passes themselves, TFLOP/s (where
    ``flops``) and share of the bound."""
    passes = {"old": [], "new": []}
    for tag in ("old", "new", "new", "old"):
        passes[tag].append(statistics.median(time_runs(calls[tag], 10, 10)))
    res = {}
    for tag, ms in passes.items():
        m = statistics.median(ms)
        res[tag] = dict(ms=m, passes=ms, bound_share=bound / m)
        if flops:
            res[tag]["tflops"] = flops / m / 1e9
    res["speedup"] = res["old"]["ms"] / res["new"]["ms"]
    return res


def ab_token_major(libs, gen, dev, B, n, G, scale) -> dict:
    """Kernel 1, old and new, at (B, n, G*G tokens, 64) against the
    plain version, then timed in turns beside the SDPA yardstick."""
    hd, L = 64, G * G
    qkv = torch.randn(B, L, 3 * n * hd, generator=gen, device=dev).to(
        torch.bfloat16)
    rel = torch.randn(B, L, n, 2 * G, generator=gen, device=dev).to(
        torch.bfloat16)
    ref = attention_relpos_plain(qkv, rel, scale, (G, G), n).float()
    outs = {t: torch.empty(B, L, n * hd, dtype=torch.bfloat16, device=dev)
            for t in libs}
    errs = {}
    for tag, lib in libs.items():
        fwd_tm(lib["attention"], qkv, rel, outs[tag], G, n, scale)
        torch.cuda.synchronize()
        err = (outs[tag].float() - ref).abs()
        if not bool((err <= 1e-2 + 1e-2 * ref.abs()).all()):
            raise AssertionError(f"kernel 1 {tag}: max|Δ| {float(err.max())}")
        errs[tag] = float(err.max())
    del ref
    flops = 4.0 * B * n * L * L * hd
    b, _ = bound_ms((qkv.numel() + rel.numel() + outs["new"].numel()) * 2,
                    flops, PEAK_BF16)
    res = ab({t: (lambda t=t: fwd_tm(libs[t]["attention"], qkv, rel,
                                     outs[t], G, n, scale)) for t in libs},
             flops, b)
    q, k, v = (qkv[..., i * n * hd:(i + 1) * n * hd].reshape(B, L, n, hd)
               .transpose(1, 2).contiguous() for i in range(3))
    mask = (rel[..., :G].transpose(1, 2)[..., :, None]
            + rel[..., G:].transpose(1, 2)[..., None, :]).reshape(B, n, L, L)
    res.update(bound_ms=b, max_abs_err=errs,
               **sdpa_yardstick(q, k, v, mask, scale))
    return res


def ab_head_major(libs, gen, dev, dtype, B, n, G, scale) -> dict:
    """Kernel 8 in ``dtype``, old and new, at (B, n, G*G, 64) against the
    plain version (fp32 1e-4 + 1e-4·|ref|, bf16 1e-2 + 1e-2·|ref|), then
    timed in turns beside the SDPA yardstick in the same dtype."""
    hd, L = 64, G * G
    q, k, v = (torch.randn(B, n, L, hd, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    rh, rw = ((2 * torch.randn(B, n, L, G, generator=gen, device=dev))
              .to(dtype) for _ in range(2))
    ref = flash_attention_relpos_plain(q, k, v, rh, rw, scale).float()
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    outs = {t: torch.empty_like(q) for t in libs}
    errs = {}
    for tag, lib in libs.items():
        fwd_hm(lib["attention_hm"], q, k, v, rh, rw, outs[tag], G, scale)
        torch.cuda.synchronize()
        err = (outs[tag].float() - ref).abs()
        if not bool((err <= tol + tol * ref.abs()).all()):
            raise AssertionError(f"kernel 8 {dtype} {tag}: max|Δ| "
                                 f"{float(err.max())}")
        errs[tag] = float(err.max())
    del ref
    flops = 4.0 * B * n * L * L * hd
    b, _ = bound_ms((q.numel() * 4 + rh.numel() * 2) * q.element_size(),
                    flops, PEAK_FP32 if dtype == torch.float32 else PEAK_BF16)
    res = ab({t: (lambda t=t: fwd_hm(libs[t]["attention_hm"], q, k, v, rh,
                                     rw, outs[t], G, scale)) for t in libs},
             flops, b)
    mask = (rh[..., :, None] + rw[..., None, :]).reshape(B, n, L, L)
    res.update(bound_ms=b, max_abs_err=errs,
               **sdpa_yardstick(q, k, v, mask, scale))
    return res


def ab_sampler(libs, gen, dev, B, C, S) -> dict:
    """Kernel 2, old and new, at (B, C, S, S) with positions spread ±20 px
    (1e-6 of the plain version at C = 2, as chip_smoke.py holds it), timed
    in turns beside ``grid_sample`` (15 × 3 calls, with its spread)."""
    u = (torch.randn(B, C, S, S, generator=gen, device=dev) * 2).contiguous()
    py, px = positions(gen, dev, 20.0, B, S, S)
    ref = bilinear_sample_plain(u, py, px)
    outs = {t: torch.empty_like(u) for t in libs}
    errs = {}
    for tag, lib in libs.items():
        sample(lib["sample"], u, py, px, outs[tag])
        torch.cuda.synchronize()
        errs[tag] = float((outs[tag] - ref).abs().max())
        if errs[tag] > 1e-6:
            raise AssertionError(f"kernel 2 {tag}: max|Δ| {errs[tag]}")
    npx = B * S * S
    b, _ = bound_ms(npx * (2 * C * 4 + 2 * 4), npx * (6 * C + 4), PEAK_FP32)
    res = ab({t: (lambda t=t: sample(libs[t]["sample"], u, py, px, outs[t]))
              for t in libs}, 0.0, b)
    res.update(bound_ms=b, max_abs_err=errs,
               **grid_sample_yardstick(u, py, px))
    return res


def ab_backward(libs, gen, dev, B, n, G, scale) -> dict:
    """Kernel 5, old and new, at (B, n, G*G, 64) against the plain vjp
    (2e-2·max|ref| + 2e-2·|ref|), timed in turns; the forward's
    statistics come from the package's kernel 1."""
    from classpose_tpu_torch.nn.attention import _fwd_kernel

    hd, L = 64, G * G
    qkv = torch.randn(B, L, 3 * n * hd, generator=gen, device=dev).to(
        torch.bfloat16)
    rel = torch.randn(B, L, n, 2 * G, generator=gen, device=dev).to(
        torch.bfloat16)
    dout = torch.randn(B, L, n * hd, generator=gen, device=dev).to(
        torch.bfloat16)
    _, lse, out32 = _fwd_kernel(qkv, rel, scale, (G, G), n, True)
    ref = attention_relpos_bwd_plain(qkv, rel, dout, scale, (G, G), n)
    delta = torch.empty_like(lse)
    outs = {t: (torch.empty_like(qkv), torch.empty_like(rel)) for t in libs}
    errs = {}
    for tag, lib in libs.items():
        bwd(lib["attention_bwd"], qkv, rel, out32, lse, dout, delta,
            *outs[tag], G, n, scale)
        torch.cuda.synchronize()
        errs[tag] = 0.0
        for a, r in zip(outs[tag], ref):
            a, r = a.float(), r.float()
            err = (a - r).abs()
            if not bool((err <= 2e-2 * r.abs().max() + 2e-2 * r.abs()).all()):
                raise AssertionError(f"kernel 5 {tag}: max|Δ| "
                                     f"{float(err.max())}")
            errs[tag] = max(errs[tag], float(err.max()))
    del ref
    flops = 10.0 * B * n * L * L * hd
    nbytes = (2 * (qkv.numel() + rel.numel() + dout.numel())
              + 4 * (out32.numel() + lse.numel())
              + 2 * (qkv.numel() + rel.numel()))
    b, _ = bound_ms(nbytes, flops, PEAK_BF16)
    res = ab({t: (lambda t=t: bwd(libs[t]["attention_bwd"], qkv, rel, out32,
                                  lse, dout, delta, *outs[t], G, n, scale))
              for t in libs}, flops, b)
    res.update(bound_ms=b, max_abs_err=errs)
    return res


def design_labels(dev, B: int, H: int, W: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) instance ids and centre maps of the synthetic design
    (``nn/synthetic.py``: a period-32 grid of radius-13 cells, one centre
    pixel each), the QC diffusion's input."""
    from classpose_tpu_torch.nn.synthetic import PERIOD, RADIUS

    yy, xx = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    cy = (yy // PERIOD) * PERIOD + PERIOD // 2
    cx = (xx // PERIOD) * PERIOD + PERIOD // 2
    inside = (yy - cy) ** 2 + (xx - cx) ** 2 <= RADIUS ** 2
    cell = (yy // PERIOD) * -(-W // PERIOD) + xx // PERIOD + 1
    ids = torch.where(inside, cell, 0).to(torch.int32)
    cen = ((yy == cy) & (xx == cx)).to(torch.float32)
    return (ids[None].repeat(B, 1, 1).contiguous(),
            cen[None].repeat(B, 1, 1).contiguous())


def diffusion_ops(ids: torch.Tensor, niter: torch.Tensor) -> float:
    """Operations a diffusion run needs on this data: per iteration and
    foreground pixel, two adds per matching 3×3 neighbour (centre
    included) and one multiply."""
    ip = F.pad(ids, (1, 1, 1, 1))
    H, W = ids.shape[1:]
    match = sum((ip[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W] == ids)
                for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    per_it = ((2 * match + 1) * (ids > 0)).sum(dim=(1, 2)).double()
    return float((per_it * niter.double()).sum())


# kernel 7's shapes: (name, B, side or (H, W), counts), the design field
# from zero at k = 1 as the routed QC and targets call it. The evaluate
# QC of one 448² image (niter 80 from its cells' extent), an unaligned
# training target, eight evaluate images at once, a target past the
# residency gate, and kernel 4's QC inputs (8 tiles of 1024²)
QC_COUNTS = [40, 80, 120, 40, 80, 120, 40, 80]
KERNEL7_SHAPES = (
    ("eval_1x448_80", 1, (448, 448), [80]),
    ("target_1x500_100", 1, (500, 500), [100]),
    ("qc_8x448", 8, (448, 448), QC_COUNTS),
    ("gate_1x2048_120", 1, (2048, 2048), [120]),
    ("qc_8x1024", 8, (1024, 1024), QC_COUNTS),
)
# and kernel 4's training target, for the choice of window
WINDOW_SHAPES = KERNEL7_SHAPES + (("target_1x512_1200", 1, (512, 512),
                                   [1200]),)


def kernel7_inputs(dev, B, hw, counts):
    """Design-field ids and centres, a zero start and the counts of one
    :data:`KERNEL7_SHAPES` entry, with the largest count."""
    ids, cen = design_labels(dev, B, *hw)
    n = torch.tensor(counts, dtype=torch.int32, device=dev)
    return ids, cen, torch.zeros_like(cen), n, max(counts)


def blocked_rounds(lib, T0, ids, cen, n_eff, nmax, bufs) -> torch.Tensor:
    """Kernel 7 through an earlier library's halo-blocked rounds
    (``diffusion_blocked_round``), as its wrapper drove them, with the
    count given from the host; ``bufs`` two scratch planes."""
    B, H, W = ids.shape
    stream = _build.stream_ptr(ids.device)
    depth = lib.diffusion_blocked_depth()
    src = T0
    for r in range(-(-nmax // depth)):
        dst = bufs[r % 2]
        _build.check(lib.diffusion_blocked_round(
            src.data_ptr(), dst.data_ptr(), ids.data_ptr(), cen.data_ptr(),
            n_eff.data_ptr(), B, H, W, r * depth, stream),
            "diffusion_blocked_round")
        src = dst
    return src


def resident_rounds(lib, ids, cen, niter, nmax, cenm, mask, bufs
                    ) -> torch.Tensor:
    """Kernel 4 through an earlier library's entry points: pack once, then
    the blocked rounds (``diffusion_resident_round``) from the host, up to
    ``nmax`` = max(niter); ``cenm``, ``mask`` and the two ``bufs`` are
    scratch of ids' shape."""
    B, H, W = ids.shape
    stream = _build.stream_ptr(ids.device)
    _build.check(lib.diffusion_pack_nbr(
        ids.data_ptr(), cen.data_ptr(), cenm.data_ptr(), mask.data_ptr(), B,
        H, W, stream), "diffusion_pack_nbr")
    T, T2 = bufs
    T.zero_()
    for s0 in range(0, nmax, lib.diffusion_resident_depth()):
        _build.check(lib.diffusion_resident_round(
            T.data_ptr(), T2.data_ptr(), cenm.data_ptr(), mask.data_ptr(),
            niter.data_ptr(), B, H, W, s0, stream), "diffusion round")
        T, T2 = T2, T
    return T


def ab_diffusion(libs, dev) -> dict:
    """Kernel 4, old and new (through whichever entry points each library
    has), on one QC call's inputs (8 tiles of 1024² of the design field,
    counts 40/80/120) against the plain version (bitwise), timed in
    turns, with each version's launches per call."""
    ids, cen, _, niter, nmax = kernel7_inputs(dev, 8, (1024, 1024),
                                              QC_COUNTS)
    ref = masked_diffusion_plain(ids, cen, niter)
    scratch = (torch.empty_like(cen),
               torch.empty(ids.shape, dtype=torch.int16, device=dev),
               (torch.empty_like(cen), torch.empty_like(cen)))
    calls, launches = {}, {}
    for tag in libs:
        lib = libs[tag]["diffusion"]
        if hasattr(lib, "diffusion_rounds"):
            calls[tag] = (lambda lib=lib: run_kernel(lib, ids, cen, niter,
                                                     nmax, None)[0])
            launches[tag] = run_kernel(lib, ids, cen, niter, nmax, None)[1]
        else:
            calls[tag] = (lambda lib=lib: resident_rounds(
                lib, ids, cen, niter, nmax, *scratch))
            launches[tag] = 1 + -(-nmax // lib.diffusion_resident_depth())
    for tag, call in calls.items():
        if not torch.equal(call(), ref):
            raise AssertionError(f"kernel 4 {tag}: not bitwise equal")
    b, _ = bound_ms(ids.numel() * 12, diffusion_ops(ids, niter), PEAK_FP32)
    res = ab(calls, 0.0, b)
    res.update(bound_ms=b, launches=launches)
    return res


def ab_blocked(libs, dev) -> dict:
    """Kernel 7, old (its own halo-blocked stencil where the old version
    has one) and new (kernel 4's body in the window :func:`diffusion_plan`
    picks), at every :data:`KERNEL7_SHAPES` entry against the plain
    version (bitwise), timed in turns with the launches per call of each;
    both get the count from the host."""
    res = {}
    for name, B, hw, counts in KERNEL7_SHAPES:
        ids, cen, zero, n, nmax = kernel7_inputs(dev, B, hw, counts)
        ref = diffuse_blocked_plain(zero, ids, cen, n, k=1)
        bufs = (torch.empty_like(cen), torch.empty_like(cen))
        calls, launches = {}, {}
        for tag in libs:
            lib = libs[tag].get("diffusion_blocked")
            if lib is not None:
                calls[tag] = (lambda lib=lib: blocked_rounds(
                    lib, zero, ids, cen, n, nmax, bufs))
                launches[tag] = -(-nmax // lib.diffusion_blocked_depth())
            else:
                lib = libs[tag]["diffusion"]
                calls[tag] = (lambda lib=lib: run_kernel(lib, ids, cen, n,
                                                         nmax, zero)[0])
                launches[tag] = run_kernel(lib, ids, cen, n, nmax, zero)[1]
        for tag, call in calls.items():
            if not torch.equal(call(), ref):
                raise AssertionError(f"kernel 7 {tag} at {name}: not "
                                     f"bitwise equal")
        plan = diffusion_plan(B, *hw, nmax)
        b, _ = bound_ms(ids.numel() * 12, diffusion_ops(ids, n), PEAK_FP32)
        res[name] = ab(calls, 0.0, b)
        res[name].update(bound_ms=b, window=WINDOWS[plan.window],
                         launches=launches)
    return res


def run_windows(log: Path) -> dict:
    """Every window ``csrc/diffusion.cu`` offers, timed in turns (each
    window, then the same in reverse order) at every
    :data:`WINDOW_SHAPES` entry, each checked bitwise against the plain
    version first: whether the window :func:`diffusion_plan` picks for a
    shape is the fastest there."""
    dev = torch.device("cuda")
    log.parent.mkdir(parents=True, exist_ok=True)
    log.write_text("")
    lib = build(_build.CSRC, "new", log, ("diffusion",))["diffusion"]
    res = {}
    for name, B, hw, counts in WINDOW_SHAPES:
        ids, cen, zero, n, nmax = kernel7_inputs(dev, B, hw, counts)
        ref = diffuse_blocked_plain(zero, ids, cen, n, k=1)
        calls = {w: (lambda w=w: run_kernel(lib, ids, cen, n, nmax, zero,
                                            w)[0])
                 for w in range(len(WINDOWS))}
        passes = {w: [] for w in calls}
        for w, call in calls.items():
            if not torch.equal(call(), ref):
                raise AssertionError(f"window {WINDOWS[w]} at {name}: not "
                                     f"bitwise equal")
        for w in list(calls) + list(calls)[::-1]:
            passes[w].append(statistics.median(time_runs(calls[w], 10, 10)))
        plans = {w: diffusion_plan(B, *hw, nmax, w) for w in calls}
        res[name] = dict(
            plan=WINDOWS[diffusion_plan(B, *hw, nmax).window],
            windows={f"{WINDOWS[w][0]}x{WINDOW_WIDTH}/{WINDOWS[w][1]}": dict(
                ms=statistics.median(p), passes=p,
                ctas=math.prod(plans[w].grid), launches=plans[w].launches,
                overlap=plans[w].overlap)
                for w, p in passes.items()})
    return res


def uniform_landing(gen, dev, B, H, W):
    """Landing positions of kernel 3's uniform input: each pixel's own
    moved by up to ±8 px (rounded, clamped), cell 1 on ~60% of pixels."""
    py, px = positions(gen, dev, 8.0, B, H, W)
    return (torch.round(py).to(torch.int32).contiguous(),
            torch.round(px).to(torch.int32).contiguous(),
            (torch.rand(B, H, W, generator=gen, device=dev) < 0.6).float())


def converged_landing(dev, B, H, W):
    """Kernel 3's converged input, where the flow steps leave the masks
    path: every foreground pixel of the design field lands on its cell's
    centre (clamped into the image) with cell = 1, background pixels stay
    where they are with cell = 0."""
    from classpose_tpu_torch.nn.synthetic import PERIOD

    ids, _ = design_labels(dev, B, H, W)
    yy, xx = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    cy = torch.clamp(yy // PERIOD * PERIOD + PERIOD // 2, max=H - 1)
    cx = torch.clamp(xx // PERIOD * PERIOD + PERIOD // 2, max=W - 1)
    fg = ids > 0
    return (torch.where(fg, cy, yy).to(torch.int32).contiguous(),
            torch.where(fg, cx, xx).to(torch.int32).contiguous(),
            fg.float().contiguous())


def histogram(lib, fy, fx, cell, out):
    B, H, W = fy.shape
    _build.check(lib.landing_histogram_f32(
        fy.data_ptr(), fx.data_ptr(), cell.data_ptr(), out.data_ptr(), B, H,
        W, _build.stream_ptr(fy.device)), "landing_histogram_f32")


def bincount_yardstick(fy, fx, cell, reps: int = 15, inner: int = 3) -> dict:
    """Kernel 3's one-call yardstick: ``bincount`` of the flat bins with
    the cells as weights; its median and spread as ``library_*``."""
    B, H, W = fy.shape
    flat = (torch.arange(B, device=fy.device)[:, None, None] * H * W
            + fy.long() * W + fx.long()).reshape(-1)
    w = cell.reshape(-1)
    return spread("library_", time_runs(lambda: torch.bincount(
        flat, weights=w, minlength=B * H * W), reps, inner))


def ab_histogram(libs, fy, fx, cell) -> dict:
    """Kernel 3, old and new, on one input against the plain version
    (bitwise), timed in turns beside ``bincount``."""
    ref = landing_histogram_plain(fy, fx, cell)
    outs = {t: torch.empty_like(cell) for t in libs}
    for tag, lib in libs.items():
        histogram(lib["sample"], fy, fx, cell, outs[tag])
        if not torch.equal(outs[tag], ref):
            raise AssertionError(f"kernel 3 {tag}: not bitwise equal")
    b, _ = bound_ms(fy.numel() * 16, float(cell.sum()), PEAK_FP32)
    res = ab({t: (lambda t=t: histogram(libs[t]["sample"], fy, fx, cell,
                                        outs[t])) for t in libs}, 0.0, b)
    res.update(bound_ms=b, **bincount_yardstick(fy, fx, cell))
    return res


def run_ab(old: Path, log: Path, path_landing=None) -> dict:
    """Build the old and the package's sources and A/B them at every
    shape of the module docstring (kernel 3 also on ``path_landing``, the
    (fy, fx, cell) of a masks-path call, when given); returns the results
    by shape."""
    dev = torch.device("cuda")
    log.parent.mkdir(parents=True, exist_ok=True)
    log.write_text("")
    libs = {"old": build(old, "old", log, SOURCES + tuple(OLD_SOURCES)),
            "new": build(_build.CSRC, "new", log)}
    gen = torch.Generator(device=dev).manual_seed(0)
    G, scale = 32, 64 ** -0.5
    result = {}
    # kernel 1: one inference layer (25 crops x 16 heads), and one
    # single-plane chunk of eval's 3D branch (1 crop: 128 tiles, fewer
    # than the card's 132 SMs)
    for B in (25, 1):
        result[f"attention_fwd_{B}x16x1024"] = ab_token_major(
            libs, gen, dev, B, 16, G, scale)
    # kernel 8: one evaluate layer, 8 crops x 16 heads, in both dtypes
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        result[f"flash_attention_relpos_{tag}_8x16x1024"] = ab_head_major(
            libs, gen, dev, dtype, 8, 16, G, scale)
    result["attention_bwd_8x16x1024"] = ab_backward(libs, gen, dev, 8, 16, G,
                                                    scale)
    # kernel 5 at bsize 224's 28 x 28 tokens, two crops x 16 heads
    result["attention_bwd_2x16x784"] = ab_backward(libs, gen, dev, 2, 16, 28,
                                                   scale)
    result["bilinear_sample_8x2x1024x1024"] = ab_sampler(libs, gen, dev, 8,
                                                         2, 1024)
    # kernel 3 at 8 x 1024², on the uniform and the converged input, and
    # on the masks path's own input where the caller captured one
    inputs = dict(uniform=uniform_landing(gen, dev, 8, 1024, 1024),
                  converged=converged_landing(dev, 8, 1024, 1024))
    if path_landing is not None:
        inputs["path"] = path_landing
    for tag, args in inputs.items():
        result[f"landing_histogram_{tag}"] = ab_histogram(libs, *args)
    result["masked_diffusion_8x1024x1024"] = ab_diffusion(libs, dev)
    result["diffuse_blocked"] = ab_blocked(libs, dev)
    return result


def run_grids(old: Path, log: Path) -> dict:
    """Build the old and the package's attention sources and A/B them at
    the grids that decide between a special body and the general one:
    kernel 5 at 8 × 16 heads on the square grids of side 32, 16 and 8
    (register dq bodies at 32 and 16, the one-hot body at 8), kernels 1
    and 8 bf16 at 2 × 16 on 28² and 64² (the generic body's bias
    buffering), kernel 8 fp32 at 8 × 16 on 32² and 2 × 16 on 64² (whole
    bias rows; per-key-block staging past H + W = 128). Which body each
    side runs is its copy's choice: hold a copy with the branch to one
    body taken out against the package."""
    dev = torch.device("cuda")
    log.parent.mkdir(parents=True, exist_ok=True)
    log.write_text("")
    sources = ("attention", "attention_hm", "attention_bwd")
    libs = {"old": build(old, "old", log, sources),
            "new": build(_build.CSRC, "new", log, sources)}
    gen = torch.Generator(device=dev).manual_seed(0)
    scale = 64 ** -0.5
    result = {}
    for G in (32, 16, 8):
        result[f"attention_bwd_8x16x{G}x{G}"] = ab_backward(
            libs, gen, dev, 8, 16, G, scale)
    for G in (28, 64):
        result[f"attention_fwd_2x16x{G}x{G}"] = ab_token_major(
            libs, gen, dev, 2, 16, G, scale)
        result[f"flash_attention_relpos_bf16_2x16x{G}x{G}"] = ab_head_major(
            libs, gen, dev, torch.bfloat16, 2, 16, G, scale)
    for B, G in ((8, 32), (2, 64)):
        result[f"flash_attention_relpos_f32_{B}x16x{G}x{G}"] = ab_head_major(
            libs, gen, dev, torch.float32, B, 16, G, scale)
    return result


def parent_sources(rev: str) -> Path:
    """The ``csrc`` of commit ``rev``, unpacked under ``_archive/<rev>``
    (git-ignored): the copy there when there is one, else ``git archive``
    of the commit from the top of the enclosing git repository; raises
    when neither gives it."""
    csrc = Path("_archive") / rev / "classpose_tpu_torch" / "csrc"
    if csrc.is_dir():
        return csrc
    top = subprocess.run(["git", "rev-parse", "--show-toplevel"],
                         capture_output=True, text=True)
    if top.returncode != 0:
        raise RuntimeError(f"no copy {csrc} and no git repository to "
                           f"archive {rev} from: {top.stderr.strip()}")
    csrc.parent.parent.mkdir(parents=True, exist_ok=True)
    git = subprocess.run(
        f"git -C {top.stdout.strip()} archive {rev} classpose_tpu_torch/csrc"
        f" | tar -x -C {csrc.parent.parent}", shell=True,
        capture_output=True, text=True)
    if git.returncode != 0 or not csrc.is_dir():
        raise RuntimeError(f"git archive {rev} failed: {git.stderr.strip()}")
    return csrc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    what = ap.add_mutually_exclusive_group()
    what.add_argument("--old", type=Path,
                      help="csrc directory of the previous version")
    what.add_argument("--rev", help="git revision of the previous version "
                      "(see parent_sources)")
    ap.add_argument("--grids", action="store_true",
                    help="A/B at the grids where a kernel picks its body "
                    "by the grid's shape (run_grids), in place of the main "
                    "shapes")
    ap.add_argument("--windows", action="store_true",
                    help="time the diffusion's windows against each other "
                    "at kernel 7's shapes (run_windows), in place of the "
                    "A/B; needs no previous version")
    ap.add_argument("--log", type=Path,
                    default=BUILD / "ab_attention_ptxas.txt",
                    help="file for nvcc's and ptxas's output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_attention: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    if args.windows:
        result = run_windows(args.log)
    elif args.old or args.rev:
        result = (run_grids if args.grids else run_ab)(
            args.old or parent_sources(args.rev), args.log)
    else:
        ap.error("one of --old, --rev or --windows is needed")
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
