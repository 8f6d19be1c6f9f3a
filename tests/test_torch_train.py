"""Port trainer against the JAX package: losses, the layer-drop ramp, two
whole train steps from the same weights and batch, and the trainer and
CLI smoke runs (tests/test_training.py's strategy) on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classpose_tpu.nn import ClassTransformer as JaxNet
from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
from classpose_tpu.train import losses as jax_losses
from classpose_tpu.train.train import _make_optimizer as jax_optimizer
from classpose_tpu.train.train import make_train_step as jax_train_step
from classpose_tpu_torch.nn import ClassTransformer, ClassTransformerConfig
from classpose_tpu_torch.nn.convert import load_into, params_from_jax
from classpose_tpu_torch.runner import ClassposeModel
from classpose_tpu_torch.train import losses as port_losses
from classpose_tpu_torch.train.dataset import ClassposeTrainingDataset
from classpose_tpu_torch.train.train import (
    build_lr_schedule,
    make_optimizer,
    make_train_step,
    train_class_seg,
)
from classpose_tpu_torch.train.train_utils import process_train_test

from test_torch_data import disc_sample
from test_torch_nn import _random_jax_params

NC = 4
SMALL = dict(embed_dim=64, depth=2, num_heads=1, neck_dim=16, bsize=64,
             n_cell_classes=NC)


def _batch(B=2, H=64, W=64, seed=0):
    """Predictions (B, NC+3, H, W) and labels (B, 4, H, W) [class with
    −100 holes, binary, flow_y, flow_x]."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(B, NC + 3, H, W)).astype(np.float32)
    lbl = np.zeros((B, 4, H, W), np.float32)
    lbl[:, 0] = rng.integers(0, NC, size=(B, H, W))
    lbl[:, 0][rng.random((B, H, W)) < 0.1] = -100
    lbl[:, 1] = rng.random((B, H, W)) > 0.5
    ang = rng.uniform(0, 2 * np.pi, size=(B, H, W))
    lbl[:, 2] = np.sin(ang) * lbl[:, 1]
    lbl[:, 3] = np.cos(ang) * lbl[:, 1]
    return y, lbl


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match_jax(weighted):
    y, lbl = _batch()
    cw = np.array([0.5, 1.0, 2.0, 1.5], np.float32) if weighted else None
    ty, tl = torch.from_numpy(y), torch.from_numpy(lbl)
    jy, jl = jnp.asarray(y), jnp.asarray(lbl)
    tcw = None if cw is None else torch.from_numpy(cw)
    pairs = [
        (port_losses.loss_fn_seg(tl, ty), jax_losses.loss_fn_seg(jl, jy)),
        (port_losses.loss_fn_class(tl, ty, tcw),
         jax_losses.loss_fn_class(jl, jy, cw)),
        (port_losses.loss_fn_tversky(tl, ty, NC, tcw),
         jax_losses.loss_fn_tversky(jl, jy, NC, cw)),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    lv = np.array([0.3, -0.2, 0.1], np.float32)
    losses = np.array([float(r) for _, r in pairs], np.float32)
    for opt in (False, True):
        np.testing.assert_allclose(
            float(port_losses.aggregate_losses(
                torch.from_numpy(lv), torch.from_numpy(losses), opt)),
            float(jax_losses.aggregate_losses(
                jnp.asarray(lv), jnp.asarray(losses), opt)), rtol=1e-6)
    for seg in (True, False):
        assert port_losses.uncertainty_factors(torch.from_numpy(lv), seg) \
            == jax_losses.uncertainty_factors(lv, seg)


# -------------------------------------------------------------- layer-drop

def test_layer_drop_matches_jax():
    """The JAX package draws the (B, depth) mask from its key as
    ``uniform(key, (B, depth)) < linspace(0, rdrop, depth)``; the test
    draws the same mask and feeds it to the port (``jax.random`` and a
    ``torch.Generator`` give different bits from one seed)."""
    kw = {**SMALL, "depth": 3, "rdrop": 0.9}
    cfg = JaxCfg(**kw)
    net, params = _random_jax_params(cfg, seed=2)
    B = 4
    x = np.random.default_rng(3).uniform(
        0, 1, (B, 3, 64, 64)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    mask = np.asarray(jax.random.uniform(key, (B, cfg.depth))
                      < jnp.linspace(0.0, cfg.rdrop, cfg.depth))
    assert mask.any() and not mask.all() and not mask[:, 0].any()
    ref, _ = net.apply(params, jnp.asarray(x), train=True, rdrop_rng=key)
    tnet = ClassTransformer(ClassTransformerConfig(**kw))
    load_into(tnet, params_from_jax(params))
    with torch.no_grad():
        got, _ = tnet(torch.from_numpy(x), train=True,
                      drop_mask=torch.from_numpy(mask))
        full, _ = tnet(torch.from_numpy(x), train=False,
                       drop_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    ref_full, _ = net.apply(params, jnp.asarray(x))
    np.testing.assert_allclose(full.numpy(), np.asarray(ref_full),
                               rtol=1e-4, atol=1e-4)


def test_layer_drop_generator_ramp():
    """Drawn from a generator, block i is dropped with probability
    linspace(0, rdrop, depth)[i]: never the first, ~rdrop the last."""
    cfg = ClassTransformerConfig(**{**SMALL, "embed_dim": 16, "depth": 3,
                                    "rdrop": 0.5, "bsize": 16})
    net = ClassTransformer(cfg)
    B = 512
    x = torch.rand(B, 3, 16, 16, generator=torch.Generator().manual_seed(1))
    mask = torch.rand((B, 3), generator=torch.Generator().manual_seed(0)) \
        < torch.linspace(0.0, 0.5, 3)
    rate = mask.float().mean(0)
    assert rate[0] == 0 and abs(float(rate[2]) - 0.5) < 0.06
    with torch.no_grad():
        got, _ = net(x, train=True,
                     generator=torch.Generator().manual_seed(0))
        ref, _ = net(x, train=True, drop_mask=mask)
        full, _ = net(x)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert not torch.equal(got, full)


# -------------------------------------------------------------- whole step

def test_two_train_steps_match_jax():
    """Two AdamW steps from the same weights on the same batch, fp32,
    uncertainty weighting and class weights on, no layer-drop, a constant
    learning rate of 1e-3 (the schedule's epoch 0 has lr 0 and would
    move nothing). Losses and total agree to rtol 1e-5, ``log_var`` to
    rtol 1e-4 / atol 1e-6: fp32 sums in another order. Parameters: Adam
    normalizes each gradient element by its own size, so an element whose
    gradient is a sum with heavy cancellation carries its larger relative
    rounding error into an update of full size (lr). So ≥ 99.99% of all
    parameter elements agree to rtol 1e-4 / atol 1e-6 and every one to
    atol 5e-6, 0.25% of the two steps' 2·lr."""
    kw = {**SMALL, "rdrop": 0.0, "feature_transformation_structure": (8,)}
    cfg = JaxCfg(**kw)
    net, params = _random_jax_params(cfg, seed=6)
    sd0 = params_from_jax(params)
    rng = np.random.default_rng(7)
    X = rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    _, lbl = _batch(seed=8)
    cw = np.array([0.5, 1.0, 2.0, 1.5], np.float32)
    lr = np.full(4, 1e-3)

    tx = jax_optimizer(lr, 0.1, params, None, True)
    log_var = jnp.zeros(3, jnp.float32)
    state = [params, log_var, tx.init((params, log_var)),
             jax.random.PRNGKey(0)]
    step = jax_train_step(net, tx, NC, use_uncertainty_weighting=True,
                          class_weights=cw, rdrop=False)
    ref_metrics = []
    for _ in range(2):
        *state, m = step(*state, jnp.asarray(X), jnp.asarray(lbl))
        ref_metrics.append({k: float(v) for k, v in m.items()})

    tnet = ClassTransformer(ClassTransformerConfig(**kw))
    load_into(tnet, sd0)
    tlv = torch.zeros(3)
    opt = make_optimizer(tnet, tlv, 0.1, None, True)
    tstep = make_train_step(tnet, opt, tlv, lr, NC,
                            use_uncertainty_weighting=True,
                            class_weights=cw, rdrop=False)
    for i in range(2):
        m = tstep(torch.from_numpy(X), torch.from_numpy(lbl))
        for k, v in ref_metrics[i].items():
            np.testing.assert_allclose(float(m[k]), v, rtol=1e-5, err_msg=k)
    assert tstep.step == 2
    np.testing.assert_allclose(tlv.detach().numpy(), np.asarray(state[1]),
                               rtol=1e-4, atol=1e-6)
    ref_sd = params_from_jax(state[0])
    moved, close, total = 0, 0, 0
    for k, p in tnet.state_dict().items():
        got, ref = p.numpy(), ref_sd[k].numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=5e-6,
                                   err_msg=k)
        close += int(np.isclose(got, ref, rtol=1e-4, atol=1e-6).sum())
        total += got.size
        moved += int(not torch.equal(p, sd0[k]))
    assert close >= 0.9999 * total
    assert moved == len(sd0)


def test_freeze_and_schedule():
    net = ClassTransformer(ClassTransformerConfig(
        **{**SMALL, "feature_transformation_structure": (8,)}))
    lv = torch.zeros(2)
    opt = make_optimizer(net, lv, 0.1, {"backbone": True,
                                        "instance_classification": True})
    trainable = {k for k, p in net.named_parameters() if p.requires_grad}
    assert "encoder.neck_conv1.weight" in trainable
    assert "out_class.encoder_blocks.0.block.conv1.weight" in trainable
    assert "encoder.blocks.0.attn.qkv.weight" not in trainable
    assert "out.weight" not in trainable and not lv.requires_grad
    assert len(opt.param_groups) == 1
    assert sum(p.numel() for p in opt.param_groups[0]["params"]) == sum(
        net.state_dict()[k].numel() for k in trainable)
    from classpose_tpu.train.train import build_lr_schedule as jax_lr

    for n_epochs in (5, 120, 400):
        np.testing.assert_array_equal(build_lr_schedule(1e-3, n_epochs),
                                      jax_lr(1e-3, n_epochs))


# ------------------------------------------------------------- smoke runs

def _dataset(n, bsize=64):
    data, labels = zip(*[disc_sample(i, n_classes=3) for i in range(n)])
    tr_d, tr_l, tr_diam, *_ = process_train_test(
        list(data), list(labels), min_train_masks=1, device="cpu")
    return ClassposeTrainingDataset(np.stack(tr_d), np.stack(tr_l),
                                    diameter_array=tr_diam, bsize=bsize)


def test_train_class_seg_smoke(tmp_path):
    """tests/test_training.py's trainer smoke with the port on the CPU:
    files, finite losses, resume, and the exhausted-resume error."""
    ds = _dataset(8)
    cfg = ClassTransformerConfig(n_cell_classes=3, embed_dim=32, depth=1,
                                 num_heads=2, neck_dim=16, bsize=64)
    model = ClassposeModel(cfg=cfg, precision="fp32", device="cpu")
    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    path, tl, vl = train_class_seg(
        model, ds, test_dataset=ds.subset(range(2)), batch_size=8,
        n_epochs=2, learning_rate=1e-4, save_path=str(tmp_path),
        model_name="toy", use_uncertainty_weighting=True,
        validate_every_epoch=True, config_snapshot={"note": "smoke"})
    assert path == str(tmp_path / "toy" / "toy.npz")
    assert (tmp_path / "toy" / "toy.npz").exists()
    for ck in ("checkpoint_last.train", "checkpoint_best.train"):
        assert (tmp_path / "toy" / ck / "meta.json").exists()
        assert (tmp_path / "toy" / ck / "state.pt").exists()
    assert np.isfinite(tl[:2]).all() and np.isfinite(vl[:2]).all()
    after = model.net.state_dict()
    assert any(not torch.equal(after[k], before[k]) for k in before)

    model2 = ClassposeModel(cfg=cfg, precision="fp32", device="cpu")
    _, tl2, _ = train_class_seg(
        model2, ds, batch_size=8, n_epochs=3, learning_rate=1e-4,
        save_path=str(tmp_path), model_name="toy_resumed",
        resume_checkpoint=str(tmp_path / "toy" / "checkpoint_last.train"),
        use_uncertainty_weighting=True)
    np.testing.assert_array_equal(tl2[:2], tl[:2])
    assert np.isfinite(tl2[2])
    with pytest.raises(ValueError, match="no training steps"):
        train_class_seg(
            ClassposeModel(cfg=cfg, precision="fp32", device="cpu"), ds,
            batch_size=8, n_epochs=2, save_path=str(tmp_path),
            model_name="toy_bad",
            resume_checkpoint=str(tmp_path / "toy" /
                                  "checkpoint_last.train"),
            use_uncertainty_weighting=True)


def test_cli_tiny_model(tmp_path):
    """One ``--tiny_model`` run of the CLI on the CPU; its final weights
    load into the JAX package."""
    from classpose_tpu.runner import ClassposeModel as JaxModel
    from classpose_tpu_torch.entrypoints.run_training import main_with_args

    data, labels = zip(*[disc_sample(i, n_classes=3) for i in range(6)])
    d = tmp_path / "data"
    d.mkdir()
    np.save(d / "images.npy", np.stack(data))
    np.save(d / "labels.npy", np.stack(labels))
    path = main_with_args([
        "--data_path", str(d), "--output_dir", str(tmp_path / "models"),
        "--model_name", "cli", "--tiny_model", "--device", "cpu",
        "--epochs", "2", "--batch_size", "2", "--bsize", "64",
        "--min_train_masks", "1", "--train_fraction", "0.67"])
    assert path == str(tmp_path / "models" / "cli" / "cli.npz")
    jm = JaxModel(pretrained_model=path, precision="fp32")
    assert jm.cfg.embed_dim == 32 and jm.cfg.n_cell_classes == 3
    assert isinstance(jm.net, JaxNet)
