"""Port network against the flax ClassTransformer: weights carried with
``params_from_jax``, fp32 forward to 1e-4, rel-pos interpolation, the
structured synthetic checkpoint, and the .npz reader."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classpose_tpu.nn import ClassTransformer as JaxNet
from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
from classpose_tpu.nn.convert import flatten_params, save_params
from classpose_tpu.nn.synthetic import structured_params as jax_structured
from classpose_tpu_torch.nn import ClassTransformer, ClassTransformerConfig
from classpose_tpu_torch.nn.convert import (
    load_into,
    load_npz_checkpoint,
    params_from_jax,
)
from classpose_tpu_torch.nn.synthetic import structured_params

TINY = dict(embed_dim=128, depth=2, num_heads=2, neck_dim=32, bsize=64,
            n_cell_classes=4)


def _random_jax_params(cfg, seed=0, rel_rows=None):
    """flax init, then every leaf replaced by seeded noise (rel-pos
    tables and pos_embed included, which init leaves at ~0)."""
    net = JaxNet(cfg)
    params = net.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 3, cfg.bsize, cfg.bsize)))
    rng = np.random.default_rng(seed)

    def noise(path, v):
        name = jax.tree_util.keystr(path)
        shape = v.shape
        if rel_rows is not None and "rel_pos" in name:
            shape = (rel_rows, shape[1])
        scale = 0.5 if "rel_pos" in name else 0.05
        return jnp.asarray(rng.normal(size=shape) * scale, jnp.float32)

    return net, jax.tree_util.tree_map_with_path(noise, params)


def _forward_pair(cfg_kw, rel_rows=None):
    cfg = JaxCfg(**cfg_kw)
    net, params = _random_jax_params(cfg, rel_rows=rel_rows)
    x = np.random.default_rng(1).uniform(
        0, 1, size=(2, 3, cfg.bsize, cfg.bsize)).astype(np.float32)
    ref, style = net.apply(params, jnp.asarray(x))
    tnet = ClassTransformer(ClassTransformerConfig(**cfg_kw))
    load_into(tnet, params_from_jax(params))
    with torch.no_grad():
        got, tstyle = tnet(torch.from_numpy(x))
    assert tuple(tstyle.shape) == tuple(style.shape)
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("fts", [None, (8, 16)])
def test_forward_matches_flax_fp32(fts):
    got, ref = _forward_pair({**TINY, "feature_transformation_structure": fts})
    assert got.shape == ref.shape == (2, 4 + 3, 64, 64)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("rows", [9, 15, 27])
def test_rel_pos_interpolation_from_other_length(rows):
    """Tables of another length than 2·8−1 are resized linearly at use;
    a checkpoint carrying one loads into the port and runs as if it held
    the resized table."""
    from classpose_tpu.nn.vit_sam import get_rel_pos as jax_get_rel_pos
    from classpose_tpu_torch.nn.vit_sam import get_rel_pos, interp_rel_pos

    tab = np.random.default_rng(rows).normal(size=(rows, 64)).astype(
        np.float32)
    ref = np.asarray(jax_get_rel_pos(8, 8, jnp.asarray(tab)))
    got = get_rel_pos(8, 8, torch.from_numpy(tab)).numpy()
    # the two linspace implementations differ in the last bits
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)

    cfg = ClassTransformerConfig(**dict(TINY, depth=1))
    net = ClassTransformer(cfg)
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    sd["encoder.blocks.0.attn.rel_pos_h"] = torch.from_numpy(tab)
    resized = dict(sd)
    resized["encoder.blocks.0.attn.rel_pos_h"] = interp_rel_pos(
        torch.from_numpy(tab), 15)
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    outs = []
    for weights in (sd, resized):
        m = ClassTransformer(cfg)
        load_into(m, weights)
        with torch.no_grad():
            outs.append(m(x)[0])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_structured_params_equal_jax():
    kw = dict(n_cell_classes=6, ps=4, embed_dim=64, depth=2, num_heads=4,
              neck_dim=64, bsize=64)
    ref = params_from_jax(jax_structured(JaxCfg(**kw)))
    got = structured_params(ClassTransformerConfig(**kw))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(),
                                      err_msg=k)


def test_npz_reader_reads_jax_checkpoint(tmp_path):
    cfg = JaxCfg(**{**TINY, "feature_transformation_structure": (8, 16)})
    _, params = _random_jax_params(cfg)
    path = str(tmp_path / "ck.npz")
    save_params(params, path, cfg=cfg)
    flat, meta = load_npz_checkpoint(path)
    assert meta["feature_transformation_structure"] == [8, 16]
    assert sorted(flat) == sorted(flatten_params(params))
    sd = params_from_jax(flat)
    assert sd["encoder.blocks.1.attn.qkv.weight"].shape == (3 * 128, 128)
    from classpose_tpu_torch.nn.vit_sam import JAX_ONLY_FIELDS

    net = ClassTransformer(ClassTransformerConfig(
        **{k: v for k, v in meta.items() if k not in JAX_ONLY_FIELDS}))
    load_into(net, sd)  # strict: every key present, every shape right
