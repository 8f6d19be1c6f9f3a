#!/usr/bin/env python3
"""A/B of the bf16 attention forward against a previous version of its
sources, in one process on one card.

    git archive <rev> classpose_tpu_torch/csrc | tar -x -C _archive/<rev>
    python3 ab_attention.py --old _archive/<rev>/classpose_tpu_torch/csrc

Builds ``attention.cu`` (kernel 1, token-major) and ``attention_hm.cu``
(kernel 8, whose bf16 variant shares kernel 1's body) from the old
directory and from the package's ``csrc`` with the package's nvcc flags
plus ``-Xptxas -v`` (registers, shared memory and spills of every
instantiation go to the file ``--log`` names). Both are held
against the plain versions, then timed in turns (old, new, new, old; each
pass the median of CUDA-event timings over back-to-back launches) at the
main paths' shapes: kernel 1 at 25 crops × 16 heads × 1024 tokens × 64
(one inference layer) and 1 × 16 × 1024 × 64 (one chunk of eval's 3D
branch: fewer tiles than SMs), kernel 8 in bf16 at 8 × 16 × 1024 × 64.
Beside them: the SDPA yardstick of ``chip_smoke.py`` (the fastest backend
that takes the float mask), achieved TFLOP/s at 4·B·n·L²·hd and the
share of the operations bound. Prints the card's name and power limit, then one
JSON line. The old sources are a git-ignored copy, never a route of the
package.
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

from chip_smoke import PEAK_BF16, bound_ms, sdpa_yardstick, time_runs
from classpose_tpu_torch import _build
from classpose_tpu_torch.nn.attention import (
    attention_relpos_plain,
    flash_attention_relpos_plain,
)

BUILD = Path("_archive") / "ab_build"  # git-ignored


def build(csrc: Path, tag: str, log_path: Path) -> dict[str, ctypes.CDLL]:
    """nvcc the two attention sources of ``csrc`` with the package's flags
    and ``-Xptxas -v``; returns the loaded libraries, their ptxas output
    appended to ``log_path``."""
    BUILD.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, {}
    for name in ("attention", "attention_hm"):
        out = BUILD / f"lib{name}_{tag}.so"
        cmd = _build._cmd(name, out)
        cmd[-1] = str(csrc / f"{name}.cu")
        cmd.insert(1, "-Xptxas=-v")
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
    _build.check(lib.attn_hm_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rh.data_ptr(),
        rw.data_ptr(), out.data_ptr(), B, L, n, G, G, scale,
        _build.stream_ptr(q.device)), "attn_hm_bf16")


def ab(calls: dict, flops: float, bound: float) -> dict:
    """Time old and new in turns (old, new, new, old); per version the
    median over its passes, the passes themselves, TFLOP/s and share of
    the bound."""
    passes = {"old": [], "new": []}
    for tag in ("old", "new", "new", "old"):
        passes[tag].append(statistics.median(time_runs(calls[tag], 10, 10)))
    res = {}
    for tag, ms in passes.items():
        m = statistics.median(ms)
        res[tag] = dict(ms=m, passes=ms, tflops=flops / m / 1e9,
                        bound_share=bound / m)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="csrc directory of the previous version")
    ap.add_argument("--log", type=Path,
                    default=BUILD / "ab_attention_ptxas.txt",
                    help="file for nvcc's and ptxas's output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_attention: no CUDA device")
    dev = torch.device("cuda")
    BUILD.mkdir(parents=True, exist_ok=True)
    args.log.parent.mkdir(parents=True, exist_ok=True)
    args.log.write_text("")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    libs = {"old": build(args.old, "old", args.log),
            "new": build(_build.CSRC, "new", args.log)}
    gen = torch.Generator(device=dev).manual_seed(0)
    hd, G, scale = 64, 32, 64 ** -0.5
    L = G * G
    result = {}

    # kernel 1: one inference layer (25 crops x 16 heads), and one
    # single-plane chunk of eval's 3D branch (1 crop: 128 tiles, fewer
    # than the card's 132 SMs)
    for B in (25, 1):
        result[f"attention_fwd_{B}x16x1024"] = ab_token_major(
            libs, gen, dev, B, 16, G, scale)

    # kernel 8, bf16: one evaluate layer, 8 crops x 16 heads
    B, n = 8, 16
    q, k, v = (torch.randn(B, n, L, hd, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    rh, rw = ((2 * torch.randn(B, n, L, G, generator=gen, device=dev))
              .to(torch.bfloat16) for _ in range(2))
    ref = flash_attention_relpos_plain(q, k, v, rh, rw, scale).float()
    outs = {t: torch.empty_like(q) for t in libs}
    errs = {}
    for tag, lib in libs.items():
        fwd_hm(lib["attention_hm"], q, k, v, rh, rw, outs[tag], G, scale)
        torch.cuda.synchronize()
        err = (outs[tag].float() - ref).abs()
        if not bool((err <= 1e-2 + 1e-2 * ref.abs()).all()):
            raise AssertionError(f"kernel 8 {tag}: max|Δ| {float(err.max())}")
        errs[tag] = float(err.max())
    flops = 4.0 * B * n * L * L * hd
    b, _ = bound_ms((q.numel() * 4 + rh.numel() * 2) * 2, flops, PEAK_BF16)
    k8 = ab({t: (lambda t=t: fwd_hm(libs[t]["attention_hm"], q, k, v, rh,
                                    rw, outs[t], G, scale)) for t in libs},
            flops, b)
    mask = (rh[..., :, None] + rw[..., None, :]).reshape(B, n, L, L)
    k8.update(bound_ms=b, max_abs_err=errs,
              **sdpa_yardstick(q, k, v, mask, scale))
    result["flash_attention_relpos_bf16_8x16x1024"] = k8

    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
