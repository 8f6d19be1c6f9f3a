"""Several devices on the CPU, the port against the JAX package.

Tile-parallel WSI inference: ``get_devices`` (the JAX ``get_device``
rules on CUDA cards, with a monkeypatched card count), the replicas,
``ShardedTileRunner`` against JAX's on a two-device mesh at a batch that
is not a multiple of two, ``DeviceWorker``'s dealing of whole batches,
and the port's ``main`` on two CPU replicas against one replica (the
same features) and against JAX ``main`` with ``--device cpu:0,1`` on the
virtual mesh (cells compared as ``tests/test_torch_pipeline.py`` compares
them).

Data-parallel training: two gloo ranks under ``python -m
torch.distributed.run --standalone --nproc_per_node 2``, each process
group with a short timeout and each subprocess with a ``timeout``:

- ``tests/test_torch_multicard_worker.py`` (``train_class_seg`` at global
  batch 8 on unaugmented items, uneven −100 class pixels under class
  weights): without layer-drop against the same at world size 1 and
  against JAX ``train_class_seg``, within the tolerance of
  ``tests/test_torch_train.py::test_two_train_steps_match_jax``; the two
  shares of the first batch hold different numbers of −100 pixels, so
  the global class CE differs from the mean of the shares' (asserted);
  with layer-drop against world size 1; bitwise-equal rank weights, the
  rank-0 checkpoint, per-rank RNG states and resume;
- ``classpose_tpu_torch.entrypoints.run_training`` (tiny model, global
  batch 8): each rank draws its own augmentation, as in the JAX package,
  so the run is held to what does not depend on it: both ranks' weights
  bitwise equal and equal to rank 0's ``.npz``, one RNG state per rank.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from classpose_tpu_torch.nn.convert import load_checkpoint, save_params
from classpose_tpu_torch.nn.vit_sam import (
    ClassTransformer,
    ClassTransformerConfig,
    draw_drop_mask,
)
from classpose_tpu_torch.parallel import get_mesh, local_device_count
from classpose_tpu_torch.parallel.inference import ShardedTileRunner
from classpose_tpu_torch.pipeline.predict_wsi import DeviceWorker
from classpose_tpu_torch.runner import ClassposeModel
from classpose_tpu_torch.utils import get_device, get_devices
from golden.jax_native import jax_native_geometry  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import test_torch_multicard_worker as worker  # noqa: E402

CPU = torch.device("cpu")
RUN_TIMEOUT = 300  # seconds for one torchrun launch
DIST_TIMEOUT = "90"  # seconds a rank waits in a collective
TINY = dict(embed_dim=32, depth=2, num_heads=2, neck_dim=16, bsize=64)


def _cards(monkeypatch, count: int) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)


def _cuda(*idx):
    return [torch.device("cuda", i) for i in idx]


# ------------------------------------------------------------ device lists

def test_get_devices_follows_the_jax_rules(monkeypatch):
    _cards(monkeypatch, 3)
    assert get_devices(None) == get_devices("") == _cuda(0)
    assert get_devices("cuda") == get_devices("GPU") == _cuda(0, 1, 2)
    assert get_devices("cuda:2,0") == get_devices("gpu:2,0") == _cuda(2, 0)
    assert get_devices(" cuda:1 ") == _cuda(1)
    assert get_devices("cpu") == get_devices("cpu:0") == [CPU]
    assert get_device("cuda") == get_device("cuda:0,1") == _cuda(0)[0]
    for spec, match in (("cuda:3", "has 3"), ("cuda:0,3", "no card 3"),
                        ("gpu:1,1", "twice"), ("cuda:0,1,0", "twice"),
                        ("cpu:1", "one CPU"), ("cpu:0,1", "one CPU"),
                        ("tpu", "TPU"), ("tpu:0,1", "TPU"),
                        ("npu:0", "unknown"), ("cuda:x", "bad")):
        with pytest.raises(ValueError, match=match):
            get_devices(spec)
    assert local_device_count() == 3
    assert get_mesh() == _cuda(0, 1, 2)
    assert get_mesh(["cuda:1", CPU]) == [torch.device("cuda", 1), CPU]


def test_get_devices_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for spec in (None, "cuda", "cuda:0,1", "gpu:1"):
        with pytest.raises(RuntimeError, match="has none"):
            get_devices(spec)


def test_jax_reads_a_list_as_these_devices():
    """The rule the port follows: a list is those devices, in order."""
    import jax

    from classpose_tpu.utils import get_device as jax_get_device

    devs = jax_get_device("cpu:1,0")
    assert devs == [jax.devices("cpu")[1], jax.devices("cpu")[0]]
    assert len(jax_get_device(None)) == 1


# ---------------------------------------------------------------- replicas

def _tiny_model_of(cfg: dict):
    return ClassposeModel(cfg=ClassTransformerConfig(**cfg),
                          precision="fp32", device=CPU, seed=0)


def test_replicas_share_nothing():
    model = _tiny_model_of(dict(n_cell_classes=3, **TINY))
    a, b, c = model.replicate([CPU, CPU, "cpu"])
    assert a is model and b is not model and c is not b
    for r in (b, c):
        assert r.device == CPU and r.timing is not model.timing
        for (k, p), q in zip(model.net.state_dict().items(),
                             r.net.state_dict().values()):
            assert torch.equal(p, q) and p.data_ptr() != q.data_ptr(), k
    with torch.no_grad():
        next(b.net.parameters()).add_(1.0)
    assert not torch.equal(next(model.net.parameters()),
                           next(b.net.parameters()))


def test_sharded_tile_runner_matches_jax():
    """N = 5 tiles on two devices: both pad to 6 and run 3 per device."""
    import jax
    from jax.sharding import Mesh

    from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
    from classpose_tpu.parallel.inference import (
        ShardedTileRunner as JaxRunner,
    )
    from classpose_tpu_torch.nn.convert import load_into, params_from_jax
    from test_torch_nn import _random_jax_params

    kw = dict(n_cell_classes=4, **TINY)
    net, params = _random_jax_params(JaxCfg(**kw), seed=3)
    tiles = np.random.default_rng(4).uniform(
        0, 1, (5, 3, 64, 64)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:2]), ("tiles",))
    ref = JaxRunner(lambda t: net.apply(params, t), mesh=mesh)(tiles)
    tnet = ClassTransformer(ClassTransformerConfig(**kw))
    load_into(tnet, params_from_jax(params))
    runner = ShardedTileRunner(tnet.eval(), [CPU, CPU])
    try:
        got = runner(tiles)
    finally:
        runner.close()
    assert runner.n_dev == 2 and runner.nets[0] is tnet
    assert got.shape == ref.shape == (5, 7, 64, 64)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)


class _Oracle:
    """A model for the dealing: ``eval_batch`` records its replica and
    batch size, holds its thread a little, and finds no cells."""

    def __init__(self, log, name="r0"):
        self.device, self.nclasses = CPU, 1
        self.log, self.name = log, name

    def replicate(self, devices):
        return [self] + [_Oracle(self.log, f"r{i}")
                         for i in range(1, len(devices))]

    def eval_batch(self, tiles, **kw):
        self.log.append((self.name, len(tiles), threading.get_ident()))
        time.sleep(0.05)
        z = np.zeros(tiles.shape[1:3], np.int32)
        return [(z, z) for _ in range(len(tiles))]


def test_device_worker_deals_whole_batches():
    log = []
    w = DeviceWorker(_Oracle(log), None, 1.0, tile_batch=3,
                     devices=[CPU, CPU])
    tile = np.zeros((256, 256, 3), np.uint8)
    for i in range(14):
        w.submit(tile, (0, 256 * i), 256)
    assert w.collect() == []
    sizes = sorted(n for _, n, _ in log)
    assert sizes == [2, 3, 3, 3, 3]  # whole batches, the last partial
    assert sorted(w.batches_per_device) == [2, 3]
    assert {r for r, _, _ in log} == {"r0", "r1"}
    # each replica's batches ran on its own two threads
    threads = {r: {t for rr, _, t in log if rr == r} for r in ("r0", "r1")}
    assert not threads["r0"] & threads["r1"]
    with pytest.raises(ValueError, match="replicate"):
        DeviceWorker(type("M", (), {"device": CPU})(), None, 1.0,
                     devices=[CPU, CPU])


# -------------------------------------------------------------------- WSI

LABELS = ["A", "B", "C", "D", "E", "F"]
WSI_CFG = dict(n_cell_classes=6, ps=4, embed_dim=64, depth=2, num_heads=4,
               neck_dim=64, bsize=64)


def _wsi_args(tmp, out, device):
    return type("Args", (), dict(
        model_config=str(tmp / "config.yaml"),
        slide_path=str(tmp / "slide.npy"), output_folder=str(out),
        tile_size=256, overlap=64, batch_size=8, precision="fp32",
        tta=False, roi_geojson=None, output_type=None,
        tissue_detection_model_path=None,
        artefact_detection_model_path=None, filter_artefacts=False,
        roi_class_priority=None, min_area=0, mpp=0.4, device=device,
        inference_threads=2, tile_batch=2,
    ))()


@pytest.fixture(scope="module")
def wsi_runs(tmp_path_factory):
    from classpose_tpu.io.array_reader import synthetic_wsi
    from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
    from classpose_tpu.nn.convert import save_params as jax_save
    from classpose_tpu.nn.synthetic import perturbed_structured_params
    from classpose_tpu.pipeline.predict_wsi import main as jax_main
    from classpose_tpu_torch.pipeline.predict_wsi import main as port_main

    tmp = tmp_path_factory.mktemp("wsi2")
    slide, _ = synthetic_wsi(width=1100, height=900, n_cells=80, seed=4,
                             mpp=0.4)
    np.save(tmp / "slide.npy", slide._level0)
    cfg = JaxCfg(**WSI_CFG)
    jax_save(perturbed_structured_params(cfg, ripple=0.5, seed=0),
             str(tmp / "ckpt.npz"), cfg=cfg)
    (tmp / "config.yaml").write_text(
        f"path: {tmp}/ckpt.npz\nmpp: 0.5\ncell_types:\n"
        + "".join(f"- {c}\n" for c in LABELS))
    old = os.environ.get("WSI_READER")
    os.environ["WSI_READER"] = "array"
    try:
        runs = {
            "jax": jax_main(_wsi_args(tmp, tmp / "jax", "cpu:0,1")),
            "one": port_main(_wsi_args(tmp, tmp / "one", "cpu")),
            "two": port_main(_wsi_args(tmp, tmp / "two", "cpu"),
                             devices=[CPU, CPU]),
        }
    finally:
        if old is None:
            os.environ.pop("WSI_READER")
        else:
            os.environ["WSI_READER"] = old
    return tmp, runs


def test_two_replicas_give_one_replicas_features(wsi_runs):
    tmp, runs = wsi_runs
    one, two = runs["one"], runs["two"]
    assert two["devices"] == ["cpu", "cpu"] and one["devices"] == ["cpu"]
    assert sum(two["batches_per_device"]) == one["batches_per_device"][0] \
        == 6 and min(two["batches_per_device"]) > 0
    assert two["n_tiles"] == one["n_tiles"] == 12
    # the same features (sorted: the reader threads hand tiles over in
    # the order they finish; each run draws its own feature ids)
    for name in ("slide_cell_contours.geojson",
                 "slide_cell_centroids.geojson"):
        a, b = (_sorted_features(tmp / run / name) for run in ("two", "one"))
        same = a == b
        assert same and len(a) == one["n_cells"], name


def _sorted_features(path: Path) -> list[str]:
    with open(path) as f:
        feats = json.load(f)["features"]
    return sorted(json.dumps({k: v for k, v in f.items() if k != "id"},
                             sort_keys=True) for f in feats)


def test_two_replicas_match_jax_on_two_devices(wsi_runs):
    from scipy.spatial import cKDTree

    tmp, runs = wsi_runs
    ref, got = runs["jax"], runs["two"]
    assert got["n_tiles"] == ref["n_tiles"]
    assert ref["n_cells"] >= 100
    assert abs(got["n_cells"] - ref["n_cells"]) <= 0.005 * ref["n_cells"]

    def centroids(run):
        with open(tmp / run / "slide_cell_centroids.geojson") as f:
            feats = json.load(f)["features"]
        return (np.array([f["geometry"]["coordinates"] for f in feats]),
                [f["properties"]["classification"]["name"] for f in feats])

    ref_pts, ref_names = centroids("jax")
    pts, names = centroids("two")
    dist, idx = cKDTree(ref_pts).query(pts, distance_upper_bound=1.0)
    same = [np.isfinite(d) and names[i] == ref_names[j]
            for i, (d, j) in enumerate(zip(dist, idx))]
    assert np.mean(same) >= 0.99


# --------------------------------------------------------------- training

def _torchrun(args: list[str]) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(ROOT),
           "CLASSPOSE_DIST_TIMEOUT_S": DIST_TIMEOUT, "OMP_NUM_THREADS": "2"}
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", *args], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=RUN_TIMEOUT)
    assert p.returncode == 0, (p.stdout[-3000:], p.stderr[-6000:])
    return p


def _assert_params_close(got: dict, ref: dict) -> None:
    """The tolerance of ``test_two_train_steps_match_jax``: every element
    to rtol 1e-4 / atol 5e-6, ≥ 99.99% to rtol 1e-4 / atol 1e-6."""
    close = total = 0
    assert got.keys() == ref.keys()
    for k in ref:
        a, b = got[k].numpy(), ref[k].numpy()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=5e-6, err_msg=k)
        close += int(np.isclose(a, b, rtol=1e-4, atol=1e-6).sum())
        total += a.size
    assert close >= 0.9999 * total


EPOCHS = 3


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The training data as an ``.h5``, seed-0 tiny weights, and the CLI
    under torchrun at world size 2 (through the worker's ``--cli``)."""
    from classpose_tpu_torch.entrypoints import dataset_to_hdf5
    from test_torch_data import disc_sample

    d = tmp_path_factory.mktemp("mc_cli")
    imgs, labs = [], []
    for i in range(10):
        img, (inst, cls) = disc_sample(i, H=64, W=64, n=5, n_classes=3)
        imgs.append(img)
        labs.append(np.stack([inst, cls]))
    np.save(d / "images.npy", np.stack(imgs))
    np.save(d / "labels.npy", np.stack(labs))
    dataset_to_hdf5.main_with_args([
        "--data_path", str(d), "--output", str(d / "t.h5"),
        "--min_train_masks", "1", "--device", "cpu"])
    cfg = ClassTransformerConfig(n_cell_classes=3, **TINY)
    torch.manual_seed(0)
    save_params(ClassTransformer(cfg).state_dict(), str(d / "init.npz"),
                cfg)
    _torchrun([str(ROOT / "tests" / "test_torch_multicard_worker.py"),
               "--cli", str(d),
               "--data_path", str(d / "t.h5"), "--device", "cpu",
               "--tiny_model", "--batch_size", "8",
               "--epochs", str(EPOCHS), "--bsize", "64", "--seed", "0",
               "--learning_rate", "1e-3", "--validate_every_epoch",
               "--pretrained_model", str(d / "init.npz"),
               "--output_dir", str(d / "two"), "--model_name", "m"])
    return d


def _meta(run_dir: Path) -> dict:
    return json.loads((run_dir / "m" / "checkpoint_last.train" /
                       "meta.json").read_text())


def test_torchrun_cli_ranks_hold_rank0_weights(cli_runs):
    """Each rank trained on its own augmented share, yet both hold the
    same weights after the last step, and rank 0 wrote them."""
    d = cli_runs
    (sha0,), (sha1,) = (json.loads((d / f"cli_rank{r}.json").read_text())[
        "sha"] for r in (0, 1))
    assert sha0 == sha1
    sd2, _ = load_checkpoint(str(d / "two" / "m" / "m.npz"))
    assert worker.weights_sha(sd2) == sha0
    sd0, _ = load_checkpoint(str(d / "init.npz"))
    assert sum(not torch.equal(sd2[k], sd0[k]) for k in sd0) == len(sd0)


def test_torchrun_cli_checkpoint_and_rng_states(cli_runs):
    meta = _meta(cli_runs / "two")
    assert meta["epoch"] == EPOCHS - 1
    assert len(meta["train_losses"]) == EPOCHS
    assert np.isfinite(meta["train_losses"]).all()
    states = meta["rng_state_by_rank"]
    assert len(states) == 2 and states[0] != states[1]


def test_world_two_matches_one_process(worker_runs, tmp_path):
    """Without layer-drop, world 2 takes world 1's steps: per-step totals
    and CEs and the epochs' losses to rtol 1e-5, the final weights to the
    two-step test's tolerance."""
    out, (r0, _) = worker_runs
    ref = worker.train(str(tmp_path), "plain", 3, cfg=worker.PLAIN_CFG)
    got = r0["plain"]
    assert [s for s, _, _ in got["steps"]] == list(range(6))
    np.testing.assert_allclose(np.array(got["steps"]),
                               np.array(ref["steps"]), rtol=1e-5)
    np.testing.assert_allclose(got["train"], ref["train"], rtol=1e-5)
    np.testing.assert_allclose(got["val"], ref["val"], rtol=1e-5)
    _assert_params_close(load_checkpoint(got["path"])[0],
                         load_checkpoint(ref["path"])[0])


def test_world_two_matches_jax(worker_runs, tmp_path):
    """JAX ``train_class_seg`` on the worker's data, class weights and
    seed-0 weights, at the same global batch."""
    from classpose_tpu.runner import ClassposeModel as JaxModel
    from classpose_tpu.train.dataset import (
        ClassposeTrainingDataset as JaxDataset,
    )
    from classpose_tpu.train.train import train_class_seg

    _, (r0, _) = worker_runs
    cfg = ClassTransformerConfig(**worker.PLAIN_CFG)
    init = tmp_path / "init.npz"
    save_params(_tiny_model_of(worker.PLAIN_CFG).net.state_dict(),
                str(init), cfg)
    imgs, labs = worker.make_data(worker.N_TRAIN + worker.N_VAL, seed=1)
    kw = dict(augment=False, bsize=worker.SIZE, seed=0)
    path, tl, vl = train_class_seg(
        JaxModel(pretrained_model=str(init), precision="fp32"),
        JaxDataset(imgs[:worker.N_TRAIN], labs[:worker.N_TRAIN], **kw),
        test_dataset=JaxDataset(imgs[worker.N_TRAIN:],
                                labs[worker.N_TRAIN:], **kw),
        batch_size=worker.GLOBAL_BATCH, learning_rate=1e-3, n_epochs=3,
        save_path=str(tmp_path), model_name="jax",
        class_weights=worker.CLASS_WEIGHTS, use_uncertainty_weighting=True,
        validate_every_epoch=True, random_seed=0)
    got = r0["plain"]
    np.testing.assert_allclose(got["train"], tl, rtol=1e-5)
    np.testing.assert_allclose(got["val"], vl, rtol=1e-5)
    _assert_params_close(load_checkpoint(got["path"])[0],
                         load_checkpoint(path)[0])


def test_first_step_ce_is_the_global_one(worker_runs):
    """The worker's first global batch: its two shares hold different
    numbers of −100 pixels under class weights, so the mean of the
    shares' CEs differs from the global CE by far more than the world-2
    step's CE differs from the global one."""
    from classpose_tpu_torch.train.dataset import ClassposeTrainingDataset
    from classpose_tpu_torch.train.losses import loss_fn_class
    from classpose_tpu_torch.train.samplers import DistributedEpochSampler

    _, (r0, _) = worker_runs
    imgs, labs = worker.make_data(worker.N_TRAIN + worker.N_VAL, seed=1)
    ds = ClassposeTrainingDataset(imgs[:worker.N_TRAIN],
                                  labs[:worker.N_TRAIN], augment=False,
                                  bsize=worker.SIZE, seed=0)
    batch = DistributedEpochSampler(len(ds), 8, seed=0).local_indices(0)[:8]
    items = [ds[int(i)] for i in batch]
    X = torch.from_numpy(np.stack([x for x, _ in items]))
    lbl = torch.from_numpy(np.stack([y for _, y in items]))
    halves = (slice(0, 4), slice(4, 8))
    n_ignored = [int((lbl[h, 0] == -100).sum()) for h in halves]
    assert n_ignored[0] != n_ignored[1] and min(n_ignored) > 0
    model = _tiny_model_of(worker.CFG)
    cw = torch.from_numpy(worker.CLASS_WEIGHTS)
    with torch.no_grad():
        # step 0's layer-drop mask: the first (8, depth) draw of seed 0
        y = model.net(X, train=True,
                      generator=torch.Generator().manual_seed(0))[0].float()
        whole = float(loss_fn_class(lbl, y, cw))
        naive = np.mean([float(loss_fn_class(lbl[h], y[h], cw))
                         for h in halves])
    step0 = r0["drop"]["steps"][0]
    assert step0[0] == 0
    np.testing.assert_allclose(step0[2], whole, rtol=1e-6)
    assert abs(naive - whole) > 50 * 1e-6 * whole


def test_share_ce_averages_to_the_global_ce():
    """``world · Σ(picked·w) / Σw_global`` per share (the step's CE at
    world > 1) averages to the global CE, and its gradient too."""
    from classpose_tpu_torch.train.losses import (
        class_weight_sum,
        loss_fn_class,
    )
    from test_torch_train import _batch

    y, lbl = _batch(B=4, seed=5)
    y *= 5.0  # confident logits: per-pixel CEs far apart
    lbl[2:, 0][np.random.default_rng(6).random(lbl[2:, 0].shape) < 0.5] \
        = -100
    cw = torch.tensor([0.5, 1.0, 2.0, 1.5])
    ty = torch.from_numpy(y).requires_grad_()
    tl = torch.from_numpy(lbl)
    whole = loss_fn_class(tl, ty, cw)
    (g_whole,) = torch.autograd.grad(whole, ty)
    wsum = sum(class_weight_sum(tl[s], cw) for s in (slice(0, 2),
                                                     slice(2, 4)))
    parts = [2 * loss_fn_class(tl[s], ty[s], cw, weight_sum=wsum)
             for s in (slice(0, 2), slice(2, 4))]
    mean = (parts[0] + parts[1]) / 2
    (g_mean,) = torch.autograd.grad(mean, ty)
    torch.testing.assert_close(mean, whole, rtol=1e-6, atol=0)
    torch.testing.assert_close(g_mean, g_whole, rtol=1e-5, atol=1e-9)
    with torch.no_grad():
        naive = np.mean([float(loss_fn_class(tl[s], ty[s], cw))
                         for s in (slice(0, 2), slice(2, 4))])
    whole = float(whole.detach())
    assert abs(naive - whole) > 1e-3 * whole


@pytest.fixture(scope="module")
def worker_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mc_worker")
    _torchrun([str(ROOT / "tests" / "test_torch_multicard_worker.py"),
               str(out)])
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in (0, 1)]
    return out, ranks


def test_ranks_hold_equal_weights_and_losses(worker_runs):
    _, (r0, r1) = worker_runs
    for key in ("plain", "drop", "straight4", "first2", "resumed"):
        assert r0[key]["sha"] == r1[key]["sha"], key
        assert r0[key]["train"] == r1[key]["train"], key
        assert r0[key]["val"] == r1[key]["val"], key
        assert r0[key]["steps"] == r1[key]["steps"], key


def test_layer_drop_at_world_two_matches_world_one(worker_runs, tmp_path):
    """Layer-drop (depth 3, rdrop 0.9) draws the global batch's mask, so
    world 2 takes world 1's steps: per-step totals and CEs to rtol 1e-5,
    the final weights to the two-step test's tolerance."""
    from classpose_tpu_torch.nn.convert import load_checkpoint as load

    out, (r0, _) = worker_runs
    ref = worker.train(str(tmp_path), "drop", 3)
    got = r0["drop"]
    assert [s for s, _, _ in got["steps"]] == list(range(6))
    np.testing.assert_allclose(np.array(got["steps"]),
                               np.array(ref["steps"]), rtol=1e-5)
    np.testing.assert_allclose(got["val"], ref["val"], rtol=1e-5)
    _assert_params_close(load(got["path"])[0], load(ref["path"])[0])
    mask = draw_drop_mask(ClassTransformerConfig(**worker.CFG), 8,
                          torch.Generator().manual_seed(0))
    assert mask.any() and not mask[:, 0].any()


def test_rank0_checkpoint_rng_states_and_resume(worker_runs):
    out, (r0, _) = worker_runs
    # resumed at epoch 2 of 4: its epochs are the straight run's, exactly
    assert r0["resumed"]["train"] == r0["straight4"]["train"]
    assert r0["resumed"]["steps"] == r0["straight4"]["steps"][4:]
    assert r0["resumed"]["sha"] == r0["straight4"]["sha"]
    assert r0["first2"]["train"] == r0["straight4"]["train"][:2]
    ckpt = out / "resumable" / "r" / "checkpoint_last.train"
    assert sorted(p.name for p in ckpt.iterdir()) == ["meta.json",
                                                      "state.pt"]
    meta = json.loads((ckpt / "meta.json").read_text())
    assert meta["epoch"] == 3
    states = meta["rng_state_by_rank"]
    assert len(states) == 2 and states[0] != states[1]
    assert (out / "drop" / "drop.npz").is_file()
