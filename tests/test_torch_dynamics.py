"""Port dynamics stages against the JAX package at 256²: flow following
to 1e-4, then the histogram/seed/basin labels and the scatter QC exactly,
on the same positions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classpose_tpu.dynamics import masks as jm
from classpose_tpu.dynamics.flows import grad_from_T as jax_grad
from classpose_tpu.dynamics.flows import masks_to_flows
from classpose_tpu.nn.synthetic import design_field
from classpose_tpu_torch.dynamics import masks as tm
from classpose_tpu_torch.dynamics.flows import grad_from_T

S = 256


def _disks():
    yy, xx = np.mgrid[:S, :S]
    gt = np.zeros((S, S), np.int32)
    for i, (cy, cx, r) in enumerate(
            [(60, 60, 22), (180, 200, 22), (200, 70, 18), (120, 130, 9),
             (20, 230, 14)], start=1):
        gt[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = i
    return gt


@pytest.fixture(scope="module")
def flows():
    """Two tiles: the synthetic design field and flows of disk labels."""
    f = design_field(S)
    dP0, iscell0 = f[:2], f[2] > 0
    gt = _disks()
    dP1 = 5.0 * np.asarray(masks_to_flows(gt)).astype(np.float32)
    dP = np.stack([dP0, dP1]).astype(np.float32)
    iscell = np.stack([iscell0, gt > 0])
    p = np.array(jm.follow_flows_batched(jnp.asarray(dP),
                                           jnp.asarray(iscell), niter=40))
    return dP, iscell, p


def test_follow_flows_positions(flows, monkeypatch):
    """Held against JAX with its Pallas sampler (interpret mode) on every
    pass, i.e. the same factored lerp order as the port's sampler. The
    JAX CPU default below 384² is the flat four-corner ``_bilinear2``,
    whose last-bit differences the composition amplifies at basin
    boundaries."""
    dP, iscell, _ = flows
    monkeypatch.setenv("CLASSPOSE_PALLAS_SAMPLER", "interpret")
    jax.clear_caches()
    try:
        ref = np.asarray(jm.follow_flows_batched(
            jnp.asarray(dP), jnp.asarray(iscell), niter=40,
            shift_min_size=0))
    finally:
        jax.clear_caches()
    got = tm.follow_flows_batched(torch.from_numpy(dP),
                                  torch.from_numpy(iscell), niter=40)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


def test_get_masks_exact(flows):
    dP, iscell, p = flows
    ref, ref_seeds = jm.get_masks_from_positions_batched(
        jnp.asarray(p), jnp.asarray(iscell), return_seeds=True)
    got, seeds = tm.get_masks_from_positions_batched(
        torch.from_numpy(p), torch.from_numpy(iscell), return_seeds=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(seeds.numpy(), np.asarray(ref_seeds))
    assert int(seeds[0].max()) == 64 and int(seeds[1].max()) == 5


def test_scatter_qc_exact(flows):
    dP, iscell, p = flows
    raw = np.asarray(jm.get_masks_from_positions_batched(
        jnp.asarray(p), jnp.asarray(iscell)))
    # one instance with wrong flows, so the QC has something to remove
    dP = dP.copy()
    dP[1][:, raw[1] == raw[1][120, 130]] *= -1.0
    prep = jax.vmap(lambda r: jm.qc_prepare(r, 0.4))(jnp.asarray(raw))
    ids, cen, niter = tm.qc_prepare(torch.from_numpy(raw), 0.4)
    for a, b in zip((ids, cen, niter), prep):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ref = jax.vmap(lambda r, d: jm.qc_filter_masks(r, d, 0.4, 0.4))(
        jnp.asarray(raw), jnp.asarray(dP))
    got = tm.qc_filter_masks(torch.from_numpy(raw), torch.from_numpy(dP),
                             0.4, 0.4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    n_before = len(np.unique(raw[1])) - 1
    assert len(np.unique(got[1].numpy())) - 1 == n_before - 1


def test_grad_from_T_matches():
    rng = np.random.default_rng(0)
    ids = (rng.uniform(size=(32, 48)) < 0.8).astype(np.int32)
    T = rng.uniform(0, 3, size=(32, 48)).astype(np.float32)
    ref = np.asarray(jax_grad(jnp.asarray(ids), jnp.asarray(T)))
    got = grad_from_T(torch.from_numpy(ids), torch.from_numpy(T)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)


def test_host_finish_matches():
    from classpose_tpu.runner.model import (
        compute_class_masks_from_pixels as jax_vote,
    )
    from classpose_tpu_torch.runner.model import (
        compute_class_masks_from_pixels,
    )

    rng = np.random.default_rng(3)
    raw = _disks() * 7
    raw[100:103, 100:103] = 999          # a tiny instance to drop
    raw[55:58, 55:58] = 0                # a hole to fill
    m_ref = jm.fill_holes_and_remove_small_masks(jm.densify_labels(raw), 15)
    m = tm.fill_holes_and_remove_small_masks(tm.densify_labels(raw), 15)
    np.testing.assert_array_equal(m, m_ref)
    cls = rng.integers(0, 4, size=raw.shape).astype(np.int8)
    np.testing.assert_array_equal(compute_class_masks_from_pixels(m, cls, 4),
                                  jax_vote(m, cls, 4))
