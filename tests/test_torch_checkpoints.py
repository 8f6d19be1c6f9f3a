"""Published ``.pt`` checkpoints in the port: the name map onto the port's
``state_dict``, the config and structure read off the tensors, the
refusals, the ViT-L manifest, and the forward and ``eval_batch`` of a
model loaded from a ``.pt``, each against the JAX package.

Checkpoints are the JAX package's torch replica with seeded random
weights, saved with ``torch.save`` at a small size. A ``.pt`` whose
weights give cells is the JAX ``perturbed_structured_params`` written in
the published layout (:func:`published_state_dict`)."""

import argparse
import logging

import numpy as np
import pytest
import torch

from classpose_tpu.nn import convert as jconv
from classpose_tpu.nn import manifest as jman
from classpose_tpu.nn.torch_replica import RefClassTransformer
from classpose_tpu_torch.nn import convert as pconv
from classpose_tpu_torch.nn import manifest as pman
from classpose_tpu_torch.nn.vit_sam import (
    JAX_ONLY_FIELDS,
    ClassTransformer,
    ClassTransformerConfig,
)
from golden.jax_native import jax_native_geometry  # noqa: F401

TINY = dict(ps=4, bsize=32, embed_dim=32, depth=2, num_heads=2, neck_dim=16)
# name → (n_cell_classes, UNet ladder or None)
HEADS = {"conv6": (6, None), "unet4": (4, (8, 16)), "cpsam": (1, None)}


def replica(n_classes, structure, seed=0, **kw):
    """A replica with every trainable tensor drawn at std 0.2 (W2/W3 stay
    the identity, diam_* at 30)."""
    net = RefClassTransformer(n_cell_classes=n_classes, structure=structure,
                              **{**TINY, **kw})
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            if p.requires_grad:
                p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    return net.eval()


def published_state_dict(sd: dict, n_classes: int, ps: int,
                         nout: int = 3) -> dict:
    """A port ``state_dict`` → the published layout: the renamed keys back,
    the identity W2/W3 and the diam buffers."""
    back = {v: k for k, v in pconv._RENAMED.items()}
    out = {back.get(k, k): v.clone() for k, v in sd.items()}
    out["diam_mean"] = torch.full((1,), 30.0)
    out["diam_labels"] = torch.full((1,), 30.0)
    for name, c in (("W2", nout), ("W3", n_classes)):
        if name == "W2" or n_classes > 1:
            n = c * ps * ps
            out[name] = torch.eye(n).reshape(n, c, ps, ps)
    return out


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """name → path of a saved replica state dict; ``wrapped`` holds the
    1×1 head under ``model_state_dict``."""
    d = tmp_path_factory.mktemp("pt")
    paths = {}
    for i, (name, (n, st)) in enumerate(HEADS.items()):
        paths[name] = str(d / f"{name}.pt")
        torch.save(replica(n, st, seed=i).state_dict(), paths[name])
    paths["wrapped"] = str(d / "wrapped.pt")
    torch.save({"model_state_dict": torch.load(paths["conv6"]),
                "epoch": 3}, paths["wrapped"])
    return paths


@pytest.mark.parametrize("name", ["conv6", "unet4", "cpsam", "wrapped"])
def test_pt_loads_bitwise_as_jax(checkpoints, name):
    ref = pconv.params_from_jax(jconv.load_params(checkpoints[name]))
    got = pconv.load_params(checkpoints[name])
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("name", ["conv6", "unet4", "cpsam"])
def test_mapped_state_dict_loads_strictly(checkpoints, name):
    sd, cfg = pconv.load_checkpoint(checkpoints[name])
    net = ClassTransformer(cfg)
    pconv.load_into(net, sd)  # strict: every key present, every shape right
    assert net.state_dict().keys() == sd.keys()


def _fields(cfg) -> dict:
    return {k: v for k, v in cfg.__dict__.items()
            if k not in JAX_ONLY_FIELDS}


@pytest.mark.parametrize("name", ["conv6", "unet4", "cpsam"])
def test_config_and_structure_match_jax(checkpoints, name):
    path = checkpoints[name]
    sd = torch.load(path)
    jsd = {k: v.numpy() for k, v in sd.items()}
    got = pconv.infer_config_from_state_dict(sd)
    ref = jconv.infer_config_from_state_dict(jsd)
    assert _fields(got) == _fields(ref)
    n, st = HEADS[name]
    assert (got.n_cell_classes, got.feature_transformation_structure,
            got.depth, got.bsize) == (n, st, TINY["depth"], TINY["bsize"])
    assert pconv.infer_structure(path) == jconv.infer_structure(path) \
        == (list(st) if st else None, n)


@pytest.mark.parametrize("name", ["conv6", "unet4"])
def test_structure_of_npz_without_meta(checkpoints, tmp_path, name):
    """The class head of an ``.npz`` without ``__meta__`` from its keys.
    The ladder equals the JAX package's; the JAX package reads the class
    count only off a 1×1 head's kernel and gives 1 for a UNet head, the
    port off the UNet's last upconv too."""
    path = str(tmp_path / "ck.npz")
    jconv.save_params(jconv.load_params(checkpoints[name]), path)
    n, st = HEADS[name]
    got = pconv.infer_structure(path)
    ref = jconv.infer_structure(path)
    assert got[0] == ref[0] == (list(st) if st else None)
    assert got[1] == n
    assert ref[1] == (n if st is None else 1)


def _sd(path):
    return {k: v.clone() for k, v in torch.load(path).items()}


@pytest.mark.parametrize("fault", ["w3_not_identity", "w2_not_identity",
                                   "extra_key"])
def test_refusals_raise_in_both(checkpoints, fault):
    sd = _sd(checkpoints["conv6"])
    if fault == "extra_key":
        sd["encoder.blocks.0.attn.extra"] = torch.zeros(3)
        match = "did not map"
    else:
        w = sd["W3" if fault == "w3_not_identity" else "W2"]
        w.view(w.shape[0], -1)[0, 1] = 1.0
        match = "identity pixel-shuffle"
    with pytest.raises(ValueError, match=match):
        pconv.state_dict_from_published(sd)
    with pytest.raises(ValueError, match=match):
        jconv.convert_state_dict({k: v.numpy() for k, v in sd.items()})


def test_loose_flags_accept_what_strict_refuses(checkpoints):
    sd = _sd(checkpoints["conv6"])
    sd["encoder.extra"] = torch.zeros(3)
    sd["W3"].view(sd["W3"].shape[0], -1)[0, 1] = 1.0
    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    h = Keep()
    pconv.logger.addHandler(h)
    try:
        got = pconv.state_dict_from_published(
            sd, strict_readout=False, strict_consume=False)
    finally:
        pconv.logger.removeHandler(h)
    assert any("did not map: ['encoder.extra']" in m for m in seen)
    assert "encoder.extra" not in got and "W3" not in got
    ref = pconv.params_from_jax(jconv.convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, strict_readout=False,
        strict_consume=False))
    assert got.keys() == ref.keys()


def test_missing_key_raises(checkpoints):
    sd = _sd(checkpoints["conv6"])
    del sd["encoder.neck.2.weight"]
    with pytest.raises(KeyError, match="neck.2"):
        pconv.state_dict_from_published(sd)


def test_pickle_of_other_objects_refused(tmp_path):
    path = tmp_path / "obj.pt"
    torch.save({"model_state_dict": {"a": torch.zeros(1)},
                "args": argparse.Namespace(lr=1e-3)}, path)
    with pytest.raises(Exception, match="[Ww]eights"):
        pconv.load_torch_checkpoint(str(path))


def test_classification_head_graft_matches_jax(checkpoints, tmp_path):
    base = pconv.load_params(checkpoints["conv6"])
    sd2 = _sd(checkpoints["conv6"])
    for k in sd2:
        if k.startswith(("out.", "out_class.")):
            sd2[k] = sd2[k] + 1.0
    donor = str(tmp_path / "donor.pt")
    torch.save(sd2, donor)
    got = pconv.load_classification_head(base, donor)
    ref = pconv.params_from_jax(jconv.load_classification_head(
        jconv.load_params(checkpoints["conv6"]), donor))
    assert got.keys() == ref.keys() == base.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    assert torch.equal(got["out.bias"], base["out.bias"] + 1.0)
    assert torch.equal(got["encoder.pos_embed"], base["encoder.pos_embed"])


@pytest.mark.parametrize("n", [1, 6, 9])
def test_vit_l_manifest_matches_jax(n):
    assert pman.vit_l_manifest(n) == jman.vit_l_manifest(n)


@pytest.mark.parametrize("n", [1, 6, 9])
def test_manifest_maps_onto_vit_l(n):
    """Every key of the published ViT-L manifest maps onto a key of the
    port's ViT-L (built on the meta device: no storage) with the shape it
    has there; the ignored keys are the only ones left over."""
    man = pman.vit_l_manifest(n)
    with torch.device("meta"):
        net = ClassTransformer(ClassTransformerConfig(n_cell_classes=n))
    own = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    names = pconv.published_names(man)
    assert set(names.values()) == set(own)
    for pub, port in names.items():
        assert tuple(man[pub]) == own[port], pub
    assert set(man) - set(names) <= pconv.IGNORED_CHECKPOINT_KEYS
    cfg = pconv.infer_config_from_state_dict(
        {k: torch.empty(s, device="meta") for k, s in man.items()})
    assert cfg == ClassTransformerConfig(n_cell_classes=n)


def test_manifest_diff_matches_jax():
    man = pman.vit_l_manifest(6)
    sd = {k: np.empty(s, np.float32) for k, s in list(man.items())[:40]}
    sd["encoder.pos_embed"] = np.empty((1, 16, 16, 1024), np.float32)
    sd["extra"] = np.empty(2, np.float32)
    got = pman.manifest_diff(sd, man)
    assert got == jman.manifest_diff(sd, man)
    assert not got["match"] and got["unexpected"] == ["extra"]
    assert got["shape_mismatch"][0]["key"] == "encoder.pos_embed"


@pytest.mark.parametrize("name", ["conv6", "unet4", "cpsam"])
def test_logits_match_replica(checkpoints, name):
    """The port's net from the ``.pt`` against the replica's forward on
    the same file, fp32: within 1e-5 + 1e-5·|ref| (the replica's SDPA and
    the port's attention sum in another order)."""
    from classpose_tpu_torch.runner import ClassposeModel

    path = checkpoints[name]
    n, st = HEADS[name]
    ref_net = RefClassTransformer(n_cell_classes=n, structure=st, **TINY)
    ref_net.load_state_dict(torch.load(path))
    model = ClassposeModel(pretrained_model=path, device="cpu")
    assert model.nclasses == n
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        ref = ref_net.eval()(x)
        got = model.net(x)[0]
    assert got.shape == ref.shape == (2, n + 3 if n > 1 else 3, 32, 32)
    assert ref.abs().max() > 0.1
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


CELL_CFG = dict(n_cell_classes=6, ps=4, embed_dim=64, depth=2, num_heads=4,
                neck_dim=64, bsize=64)


def structured_pt(path, seed=0, **cfg_kw) -> None:
    """The JAX ``perturbed_structured_params`` (weights that give cells)
    saved as a published ``.pt``."""
    from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
    from classpose_tpu.nn.synthetic import perturbed_structured_params

    cfg = JaxCfg(**{**CELL_CFG, **cfg_kw})
    sd = pconv.params_from_jax(perturbed_structured_params(
        cfg, ripple=0.5, seed=seed))
    torch.save(published_state_dict(sd, cfg.n_cell_classes, cfg.ps),
               str(path))


def test_eval_batch_from_pt_matches_jax(tmp_path):
    """``eval_batch`` from a ``.pt`` against the JAX model on the same
    file's converted params: 2 × 128² uint8 tiles, fp32, niter 40; masks
    and classes as ``test_torch_slice.py`` holds them."""
    from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
    from classpose_tpu.runner import ClassposeModel as JaxModel
    from classpose_tpu_torch.runner import ClassposeModel
    from test_torch_slice import _match

    path = str(tmp_path / "cells.pt")
    structured_pt(path)
    tiles = np.random.default_rng(1).uniform(
        0, 255, size=(2, 128, 128, 3)).astype(np.uint8)
    kw = dict(batch_size=8, niter=40)
    ref = JaxModel(cfg=JaxCfg(**CELL_CFG), params=jconv.load_params(path),
                   precision="fp32").eval_batch(tiles, **kw)
    got = ClassposeModel(pretrained_model=path, precision="fp32",
                         device="cpu").eval_batch(tiles, **kw)
    for (m_ref, c_ref), (m, c) in zip(ref, got):
        assert m_ref.max() >= 10 and m.max() == m_ref.max()
        pairs = _match(m_ref, m)
        assert min(iou for _, _, iou in pairs) >= 0.95
        assert ((m > 0) == (m_ref > 0)).mean() >= 0.995
        for a, b, _ in pairs:
            assert c_ref[m_ref == a][0] == c[m == b][0]
