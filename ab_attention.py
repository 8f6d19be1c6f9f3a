#!/usr/bin/env python3
"""A/B of kernel bodies against a previous version of their sources, in
one process on one card.

    python3 ab_attention.py --rev <rev>       # or --old <csrc directory>
    python3 ab_attention.py --bwd-instantiations

With ``--rev`` the previous sources are ``_archive/<rev>`` (git-ignored;
unpacked there with ``git archive`` when missing, see
:func:`parent_sources`). Builds ``attention.cu`` (kernel 1, token-major),
``attention_hm.cu`` (kernel 8: its bf16 variant shares kernel 1's body,
its fp32 body is its own), ``attention_bwd.cu`` (kernel 5) and
``sample.cu`` (kernel 2) from the old directory and from the package's
``csrc`` with the package's nvcc flags plus ``-Xptxas -v`` (registers,
shared memory and spills of every instantiation go to the file ``--log``
names). Both are held against the plain versions, then timed in turns
(old, new, new, old; each pass the median of CUDA-event timings over
back-to-back launches) at the main paths' shapes: kernel 1 at 25 crops ×
16 heads × 1024 tokens × 64 (one inference layer, the 32 × 32 grid) and
1 × 16 × 1024 × 64 (one chunk of eval's 3D branch: fewer tiles than
SMs); kernel 8 in bf16 and in fp32 at 8 × 16 × 1024 × 64 (one evaluate
layer); kernel 5 at 8 × 16 × 1024 × 64 (one train-step layer); kernel 2
at 8 × 2 × 1024² (one follow-flows pass). Beside them the one-call
yardsticks (for the attention forwards the fastest SDPA backend that
takes the float mask; for kernel 2 ``grid_sample``), each with its
spread, achieved TFLOP/s where it applies and the share of the bound.
``--bwd-instantiations`` instead times kernel 5's square-grid register
paths against its generic instantiation (:func:`run_bwd_instantiations`).
Prints the card's name and power limit, then one JSON line.

The timing helpers and yardsticks here are also ``chip_smoke.py``'s,
which runs :func:`run_ab` under ``--ab``. The old sources are a
git-ignored copy, never a route of the package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
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
from classpose_tpu_torch.ops.sample import bilinear_sample_plain

# published H100 SXM peaks (dense): bf16 tensor cores, fp32 outside them,
# HBM bandwidth
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

BUILD = Path("_archive") / "ab_build"  # git-ignored


SOURCES = ("attention", "attention_hm", "attention_bwd", "sample")


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
        out = BUILD / f"lib{name}_{tag}.so"
        cmd = _build._cmd(name, out)
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
            for fn, (owner, argtypes) in _build._SIGNATURES.items():
                if owner == name:
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


def run_ab(old: Path, log: Path) -> dict:
    """Build the old and the package's sources and A/B them at every
    shape of the module docstring; returns the results by shape."""
    dev = torch.device("cuda")
    log.parent.mkdir(parents=True, exist_ok=True)
    log.write_text("")
    libs = {"old": build(old, "old", log),
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
    result["bilinear_sample_8x2x1024x1024"] = ab_sampler(libs, gen, dev, 8,
                                                         2, 1024)
    return result


def run_bwd_instantiations(log: Path) -> dict:
    """Kernel 5's register reduction of the bias gradients (squares of side
    8, 16, 32, 64) against its generic instantiation (any grid) on the same
    grids: the package's ``attention_bwd.cu`` built with
    ``ATTN_BWD_GENERIC_ONLY`` as "old" and as it is as "new", timed in
    turns at one train-step layer (8 crops × 16 heads) of bsize 64, 128
    and 256, and at 2 × 16 × 64² for bsize 512 (two crops: the plain
    vjp's L × L intermediates)."""
    dev = torch.device("cuda")
    log.parent.mkdir(parents=True, exist_ok=True)
    log.write_text("")
    libs = {"old": build(_build.CSRC, "generic", log, ("attention_bwd",),
                         ("ATTN_BWD_GENERIC_ONLY",)),
            "new": build(_build.CSRC, "new", log, ("attention_bwd",))}
    gen = torch.Generator(device=dev).manual_seed(0)
    scale = 64 ** -0.5
    return {f"attention_bwd_{B}x16x{G * G}": ab_backward(libs, gen, dev, B,
                                                         16, G, scale)
            for B, G in ((8, 8), (8, 16), (8, 32), (2, 64))}


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
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--old", type=Path,
                      help="csrc directory of the previous version")
    what.add_argument("--rev", help="git revision of the previous version "
                      "(see parent_sources)")
    what.add_argument("--bwd-instantiations", action="store_true",
                      help="kernel 5's register reduction against its "
                      "generic instantiation (run_bwd_instantiations)")
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
    if args.bwd_instantiations:
        result = run_bwd_instantiations(args.log)
    else:
        result = run_ab(args.old or parent_sources(args.rev), args.log)
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
