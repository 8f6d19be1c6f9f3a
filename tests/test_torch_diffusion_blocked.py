"""Kernel 7's plain version (``diffuse_blocked`` on the CPU) against the
JAX halo-blocked Pallas kernel ``diffuse_pallas`` in interpret mode, and
the routed ``_diffuse_dyn`` against the JAX XLA stencil.

What holds, bit for bit: the port's plain version equals
``diffuse_pallas(interpret=True)`` (zero or nonzero ``T0``, mixed
horizons, the ``ceil(niters/k)·k`` rounding, unaligned shapes) once
subnormal values are flushed to zero, which XLA does on the CPU and
PyTorch does not (a nonzero ``T0`` far from any source decays through the
subnormal range; from ``T0 = 0`` none arises here). The port's
``_diffuse_dyn`` equals the JAX ``_diffuse_dyn`` on either side of the
residency gate, unflushed. The JAX package's own kernel test holds the
Pallas kernel against ``_diffuse_dyn`` to 1e-6; it is also bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classpose_tpu.dynamics.flows import _diffuse_dyn as jax_diffuse
from classpose_tpu.dynamics.flows import instance_center_map
from classpose_tpu.ops.diffusion_pallas import diffuse_pallas
from classpose_tpu.ops.diffusion_pallas import (
    resident_diffusion_supported as jax_gate,
)
from classpose_tpu_torch.dynamics.flows import _diffuse_dyn
from classpose_tpu_torch.ops import diffusion as port
from classpose_tpu_torch.ops.diffusion import (
    diffuse_blocked,
    diffuse_blocked_plain,
    resident_diffusion_supported,
)


def _fixture(B=3, H=96, W=96, seed=0):
    """``test_diffusion_pallas.py``'s inputs: raw (non-dense) labels of
    random discs and their centre maps."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((B, H, W), np.int32)
    yy, xx = np.mgrid[:H, :W]
    for b in range(B):
        for _ in range(6):
            cy, cx = rng.integers(10, min(H, W) - 11, 2)
            m = (yy - cy) ** 2 + (xx - cx) ** 2 <= rng.integers(25, 100)
            masks[b][m] = cy * W + cx + 1
    cms = np.stack([instance_center_map(m) for m in masks])
    return masks, cms


def _ftz(a):
    """Subnormal float32 values flushed to zero, as XLA's CPU backend
    does."""
    return np.where(np.abs(a) < np.finfo(np.float32).tiny, 0.0, a)


def _both(T0, masks, cms, niters, k, bs):
    ref = np.asarray(diffuse_pallas(
        jnp.asarray(T0), jnp.asarray(masks), jnp.asarray(cms),
        jnp.asarray(niters), k=k, bs=bs, interpret=True))
    got = diffuse_blocked(torch.from_numpy(T0), torch.from_numpy(masks),
                          torch.from_numpy(cms), torch.from_numpy(niters),
                          k=k, bs=bs).numpy()
    return ref, got


@pytest.mark.parametrize("T0_kind", ["zero", "nonzero"])
def test_matches_pallas_interpret_bitwise(T0_kind):
    masks, cms = _fixture()
    niters = np.array([40, 120, 80], np.int32)
    T0 = np.zeros(masks.shape, np.float32)
    if T0_kind == "nonzero":
        T0 = np.random.default_rng(5).uniform(0, 3, masks.shape).astype(
            np.float32)
    ref, got = _both(T0, masks, cms, niters, k=40, bs=32)
    np.testing.assert_array_equal(_ftz(got), ref)
    assert ref.max() > 0


def test_rounds_up_to_a_multiple_of_k():
    """niters=50 with k=40 runs 80 iterations (the active flag is read
    once per round of k), pinned against the Pallas kernel and against
    80 plain iterations."""
    masks, cms = _fixture(B=1, seed=1)
    T0 = np.zeros(masks.shape, np.float32)
    ref, got = _both(T0, masks, cms, np.array([50], np.int32), k=40, bs=32)
    np.testing.assert_array_equal(got, ref)
    eighty = diffuse_blocked_plain(
        torch.from_numpy(T0), torch.from_numpy(masks), torch.from_numpy(cms),
        torch.tensor([80], dtype=torch.int32), k=1).numpy()
    fifty = diffuse_blocked_plain(
        torch.from_numpy(T0), torch.from_numpy(masks), torch.from_numpy(cms),
        torch.tensor([50], dtype=torch.int32), k=1).numpy()
    np.testing.assert_array_equal(got, eighty)
    assert not np.array_equal(got, fifty)


def test_unaligned_non_square_and_block_size():
    """A 70 × 150 field (neither dimension a multiple of the TPU block),
    nonzero T0, horizons 0 / 7 / 33 with k = 8; ``bs`` does not change the
    result."""
    masks, cms = _fixture(B=3, H=70, W=150, seed=2)
    T0 = np.random.default_rng(3).uniform(0, 1, masks.shape).astype(
        np.float32)
    niters = np.array([0, 7, 33], np.int32)
    ref, got = _both(T0, masks, cms, niters, k=8, bs=64)
    np.testing.assert_array_equal(_ftz(got), ref)
    np.testing.assert_array_equal(got[0], T0[0])  # no iteration: T0 back
    other_bs = diffuse_blocked(
        torch.from_numpy(T0), torch.from_numpy(masks), torch.from_numpy(cms),
        torch.from_numpy(niters), k=8, bs=16).numpy()
    np.testing.assert_array_equal(other_bs, got)


@pytest.mark.parametrize("H,W", [(64, 128), (70, 96), (448, 448)])
def test_routed_diffuse_dyn_matches_xla_stencil(H, W):
    """Both sides of the residency gate (64×128 passes it, 70×96 and
    448² do not) give the JAX XLA stencil's bits."""
    assert resident_diffusion_supported(H, W) == jax_gate(H, W)
    masks, cms = _fixture(B=1, H=H, W=W, seed=4)
    for niter in (1, 40):
        ref = np.asarray(jax_diffuse(jnp.asarray(masks[0]),
                                     jnp.asarray(cms[0]), jnp.int32(niter)))
        got = _diffuse_dyn(torch.from_numpy(masks[0]),
                           torch.from_numpy(cms[0]), niter).numpy()
        np.testing.assert_array_equal(got, ref)


def test_routing_by_the_gate(monkeypatch):
    """Aligned geometries take kernel 4's wrapper, the others kernel 7's,
    and both give the same bits."""
    calls = []
    for name in ("masked_diffusion", "diffuse_blocked"):
        fn = getattr(port, name)
        monkeypatch.setattr(
            "classpose_tpu_torch.dynamics.flows." + name,
            lambda *a, _fn=fn, _n=name, **kw: calls.append(_n) or _fn(*a, **kw))
    masks, cms = _fixture(B=2, H=64, W=128, seed=6)
    ids, cen = torch.from_numpy(masks), torch.from_numpy(cms)
    n = torch.tensor([40, 80], dtype=torch.int32)
    aligned = _diffuse_dyn(ids, cen, n)
    unaligned = _diffuse_dyn(ids[:, :, :120].contiguous(),
                             cen[:, :, :120].contiguous(), n)
    assert calls == ["masked_diffusion", "diffuse_blocked"]
    via_blocked = diffuse_blocked(torch.zeros_like(cen), ids, cen, n, k=1)
    assert torch.equal(aligned, via_blocked)
    assert unaligned.shape == (2, 64, 120)


def test_bad_inputs_raise():
    ids = torch.zeros((1, 8, 8), dtype=torch.int32)
    f = torch.zeros((1, 8, 8))
    n = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        diffuse_blocked(f, ids, f, n, k=0)
    with pytest.raises(TypeError):
        diffuse_blocked(f.double(), ids, f, n)
    with pytest.raises(ValueError):
        diffuse_blocked(f[:, :4], ids, f, n)
