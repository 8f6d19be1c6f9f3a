"""WSI inference pipeline (counterpart of
``classpose_tpu/pipeline/predict_wsi.py``), on one or several CUDA cards
or the CPU:

  reader thread pool (SlideLoader.stream)                     [host]
    → tile-size-bucketed batches, dealt whole to the cards,
      pinned and copied ahead                                 [host → card]
    → ClassposeModel.eval_batch on two inference threads per
      card, each on its own CUDA stream                       [card]
    → polygon extraction thread pool                          [host]
    → dedup → ROI / tissue / artefact filters
    → GeoJSON / CSV / zarr export                             [host]

With ``--tissue_detection_model_path`` the GrandQC tissue model runs
first, on the slide's MPP-10 thumbnail; only tiles that meet a tissue
region are read, and only cells inside one are kept. With
``--artefact_detection_model_path`` the artefact model runs after the
tiles, on the MPP-1 thumbnail, and ``--filter_artefacts`` drops the cells
inside an artefact; the artefact area corrects the densities. Both nets
run on the first card, outside the inference threads.

``--device cuda:0,1`` (``cuda``: every visible card) runs tile-parallel:
the model is copied once onto each card, and each full batch of
``--tile_batch`` tiles goes whole to the card with the fewest batches in
flight. The JAX package instead splits each batch over its device mesh;
whole batches keep an H100 full and make every batch the program it is
on one card. Features are gathered in the order their tiles were
submitted, whichever card ran them, so several cards find one card's
cells (in the order the reader threads hand the tiles over).

Two inference threads per card let batch i+1's device work run while
batch i's host finish (labels, holes, class vote) runs. Each thread
launches on a CUDA stream of its own: on one shared stream, one thread's
readback would wait for the other thread's program. A batch is uploaded
from pinned memory on its card's copy stream as soon as it fills; the
inference stream waits on the copy's event before using it.

Weights are a published ``.pt`` (the built-in configs) or a native
``.npz``. ``--fast_qc`` runs ``eval_batch`` with ``qc_downsample=2`` and
``percentile_subsample=2``. Slides are read by the reader ``WSI_READER``
selects (by default the package's TIFF/SVS reader; ``array`` for
``.npy``; ``czi`` for Zeiss ``.czi``).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from classpose_tpu_torch.geometry import STRtree, deduplicate, \
    intersection_area
from classpose_tpu_torch.io import get_wsi_reader
from classpose_tpu_torch.log import get_logger
from classpose_tpu_torch.model_configs import (
    ModelConfig,
    resolve_model_config,
)
from classpose_tpu_torch.pipeline.outputs import (
    apply_bounds_offset_to_feature,
    calculate_cellular_densities,
    create_spatialdata_output,
    filter_cells_by_tree,
    load_roi_polygons,
    map_cells_to_roi_classes,
    polygons_to_centroids,
    to_geojson_polygon,
    write_densities_csv,
    write_feature_collection,
)
from classpose_tpu_torch.pipeline.postprocess import process_tile
from classpose_tpu_torch.pipeline.slide_loader import (
    DEFAULT_OVERLAP,
    DEFAULT_TILE_SIZE,
    SlideLoader,
)
from classpose_tpu_torch.pipeline.tile_filter import filter_tile
from classpose_tpu_torch.utils import (
    get_device,
    get_devices,
    get_geojson_output_filename,
)

logger = get_logger(__name__)

TILE_BUCKETS = (256, 384, 512, 640, 768, 896, 1024)


def _bucket_size(n: int) -> int:
    for b in TILE_BUCKETS:
        if n <= b:
            return b
    return int(256 * np.ceil(n / 256))


class _Replica:
    """One device's part of a :class:`DeviceWorker`: its model, its pinned
    copy stream, two inference threads whose current CUDA device is its
    card, and its batches (in flight now, and in all)."""

    def __init__(self, model):
        self.model = model
        self.device = model.device
        cuda = self.device.type == "cuda"
        self.copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self.pool = ThreadPoolExecutor(
            max_workers=2, initializer=_set_card,
            initargs=(self.device if cuda else None,))
        self.in_flight = 0
        self.batches = 0


def _set_card(device) -> None:
    """Make ``device`` the calling inference thread's current card, once:
    every launch also sets its tensors' card (``_build.call``)."""
    if device is not None:
        torch.cuda.set_device(device)


class DeviceWorker:
    """Tile consumer: ``eval_batch`` on the device(s) for each full bucket
    of same-sized tiles, mask → polygon extraction on a host thread pool.

    ``tile_batch`` (default 8) tiles make one ``eval_batch`` call, on one
    device. ``devices`` (default: the model's) lists the devices; the
    model is replicated once per entry (``ClassposeModel.replicate``), and
    each replica has a pinned copy stream and two inference threads, each
    thread with its own CUDA stream (:meth:`_stream`). Whole batches are
    dealt: the next one goes to the replica with the fewest batches in
    flight (the first such), so every batch runs the program it runs on
    one device."""

    def __init__(
        self,
        model,
        labels: list[str] | None,
        prediction_to_slide_scale: float,
        batch_size: int = 8,
        augment: bool = False,
        niter: int = 200,
        n_post_threads: int = 4,
        flow_threshold: float = 0.4,
        cellprob_threshold: float = 0.0,
        min_size: int = 15,
        tile_batch: int | None = None,
        qc_downsample: int = 1,
        percentile_subsample: int = 1,
        devices: list | None = None,
    ):
        self.labels = labels
        self.scale = prediction_to_slide_scale
        self.batch_size = batch_size
        self.augment = augment
        self.niter = niter
        self.flow_threshold = flow_threshold
        self.cellprob_threshold = cellprob_threshold
        self.min_size = min_size
        self.qc_downsample = qc_downsample
        self.percentile_subsample = percentile_subsample
        devices = [model.device] if devices is None else list(devices)
        if devices == [model.device]:
            models = [model]
        elif hasattr(model, "replicate"):
            models = model.replicate(devices)
        else:
            raise ValueError(f"{type(model).__name__} has no replicate(); "
                             "it runs on its own device only")
        self.replicas = [_Replica(m) for m in models]
        self.model = models[0]
        self.device = self.replicas[0].device
        self.tile_batch = max(1, int(tile_batch)) if tile_batch else 8
        self._pending: dict[int, list] = {}
        self._pool = ThreadPoolExecutor(max_workers=n_post_threads)
        self._futures = []
        self._tls = threading.local()
        self.n_tiles = 0
        self.n_invalid = 0
        self.infer_seconds = 0.0  # cumulative seconds in eval_batch
        # live-progress and stage counters
        self.n_done = 0           # tiles through the device path
        self.n_cells_found = 0    # cells extracted so far (may lag)
        self.post_seconds = 0.0   # cumulative host polygon CPU-seconds
        self._stats_lock = threading.Lock()

    @property
    def batches_per_device(self) -> list[int]:
        return [r.batches for r in self.replicas]

    def _timed_process_tile(self, *a, **kw):
        """process_tile + GeoJSON feature conversion + stage counters, in
        the post pool."""
        t0 = time.time()
        cells, inv = process_tile(*a, **kw)
        feats = [to_geojson_polygon(c) for c in cells]
        with self._stats_lock:
            self.post_seconds += time.time() - t0
            self.n_cells_found += len(feats)
            self.n_done += 1
        return feats, inv

    def submit(self, tile: np.ndarray, coords, out_size: int):
        """Queue one tile; a full bucket goes to the card."""
        b = _bucket_size(max(tile.shape[:2]))
        if tile.shape[0] != b or tile.shape[1] != b:
            # edge-replicate to the bucket size: zero padding would skew
            # the percentile normalization computed over the canvas (the
            # pad region is cropped from the masks afterwards)
            tile = np.pad(
                tile, ((0, b - tile.shape[0]), (0, b - tile.shape[1]),
                       (0, 0)), mode="edge")
        self.n_tiles += 1
        self._pending.setdefault(b, []).append((tile, coords, out_size))
        if len(self._pending[b]) >= self.tile_batch:
            self._flush_bucket(b)

    def _flush_bucket(self, b: int):
        """Stack a bucket (a partial one at the end), deal it to the
        replica with the fewest batches in flight and, on a card, start
        its upload from pinned memory on that replica's copy stream; the
        inference thread waits on the copy's event."""
        items = self._pending.pop(b, [])
        if not items:
            return
        tiles = np.stack([t for t, _, _ in items])
        with self._stats_lock:
            rep = min(self.replicas, key=lambda r: r.in_flight)
            rep.in_flight += 1
            rep.batches += 1
        ready = None
        if rep.copy_stream is not None:
            host = torch.from_numpy(tiles).pin_memory()
            with torch.cuda.device(rep.device), \
                    torch.cuda.stream(rep.copy_stream):
                tiles = host.to(rep.device, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(rep.copy_stream)
        self._futures.append(
            rep.pool.submit(self._run_batch, rep, tiles, ready, items))

    def _stream(self, device) -> torch.cuda.Stream:
        """This inference thread's own CUDA stream (on its replica's
        card: a thread serves one replica)."""
        s = getattr(self._tls, "stream", None)
        if s is None:
            s = self._tls.stream = torch.cuda.Stream(device)
        return s

    def _run_batch(self, rep, tiles, ready, items):
        """One ``eval_batch`` for a bucket on replica ``rep``; returns its
        post-proc futures."""
        t0 = time.time()
        kw = dict(batch_size=self.batch_size, augment=self.augment,
                  niter=self.niter, flow_threshold=self.flow_threshold,
                  cellprob_threshold=self.cellprob_threshold,
                  min_size=self.min_size, qc_downsample=self.qc_downsample,
                  percentile_subsample=self.percentile_subsample)
        try:
            if ready is not None:
                stream = self._stream(rep.device)
                with torch.cuda.stream(stream):
                    stream.wait_event(ready)
                    tiles.record_stream(stream)
                    results = rep.model.eval_batch(tiles, **kw)
            else:
                results = rep.model.eval_batch(tiles, **kw)
        finally:
            with self._stats_lock:
                rep.in_flight -= 1
                self.infer_seconds += time.time() - t0
        return [
            self._pool.submit(
                self._timed_process_tile,
                masks[:out_size, :out_size],
                cm[:out_size, :out_size] if self.labels is not None
                else None,
                (float(coords[0]), float(coords[1])),
                self.scale,
                self.labels,
            )
            for (_, coords, out_size), (masks, cm) in zip(items, results)
        ]

    def collect(self) -> list[dict]:
        """Flush the partial buckets, wait for every batch and polygon
        job, and return the GeoJSON features."""
        for b in list(self._pending):
            self._flush_bucket(b)
        cells = []
        try:
            for fut in self._futures:
                for post in fut.result():
                    c, inv = post.result()
                    cells.extend(c)
                    self.n_invalid += inv
        finally:
            for rep in self.replicas:
                rep.pool.shutdown(wait=True)
            self._pool.shutdown(wait=True)
        return cells


class ProgressReporter:
    """Live progress off the worker's counters: one daemon thread writes
    carriage-return updates to stderr; on when stderr is a TTY or
    ``CLASSPOSE_PROGRESS=1``, silent otherwise (log lines still flow)."""

    def __init__(self, worker, n_total: int | None, enabled=None):
        if enabled is None:
            env = os.environ.get("CLASSPOSE_PROGRESS")
            enabled = env == "1" or (env != "0" and sys.stderr.isatty())
        self.worker = worker
        self.n_total = n_total
        self.enabled = bool(enabled)
        self._stop = threading.Event()
        self._t0 = time.time()
        self._thread = None

    def _line(self) -> str:
        w = self.worker
        el = max(time.time() - self._t0, 1e-6)
        total = f"/{self.n_total}" if self.n_total else ""
        return (
            f"\rtiles {w.n_done}{total} predicted "
            f"({w.n_tiles} read) | {w.n_cells_found} cells "
            f"({w.n_invalid} invalid) | {w.n_done / el:.2f} tiles/s "
            f"| device {w.infer_seconds:.1f}s host {w.post_seconds:.1f}s"
        )

    def _run(self):
        while not self._stop.wait(0.5):
            print(self._line(), end="", file=sys.stderr, flush=True)

    def __enter__(self):
        if self.enabled:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if self.enabled:
            print(self._line(), file=sys.stderr, flush=True)
        return False


def check_supported(args) -> None:
    """Raise before any slide is read or any model built: for a
    ``--device`` that names no card of this machine, a card twice or
    another CPU (``ValueError`` from ``get_devices``)."""
    get_wsi_reader()
    get_devices(getattr(args, "device", None))


def build_model_from_config(model_config: ModelConfig,
                            precision: str = "bf16",
                            n_config_labels: int | None = None,
                            device=None):
    """The ClassposeModel of a resolved ModelConfig, ``.pt`` or ``.npz``
    (class head and count from the checkpoint), on ``device`` (default:
    the card). Reusable across slides."""
    from classpose_tpu_torch.nn.convert import infer_structure
    from classpose_tpu_torch.runner import ClassposeModel

    path = model_config.path
    # a .pt (or an .npz with __meta__) gives its model the config of its
    # own tensors; an .npz without __meta__ needs the head from its keys
    structure, n_classes = (infer_structure(path) if path.endswith(".npz")
                            else (None, None))
    model = ClassposeModel(
        pretrained_model=path, nclasses=n_classes,
        feature_transformation_structure=structure, precision=precision,
        device=get_device(None) if device is None else device)
    n_classes = model.nclasses
    logger.info("Inferred model structure: unet=%s n_classes=%d",
                model.cfg.feature_transformation_structure, n_classes)
    if n_config_labels is not None and n_classes > 1 \
            and n_config_labels != n_classes:
        logger.warning("Model has %d classes but config lists %d cell types",
                       n_classes, n_config_labels)
    return model


def main(args, model_override=None, devices=None) -> dict:
    """Run the full WSI pipeline on one slide; returns a small summary.

    ``model_override`` is a model built once for several slides (or a
    test's model) with ``eval_batch`` and ``nclasses``. ``devices``
    replaces the list ``--device`` gives, so that a check can run two
    replicas on one card (``[cuda:0, cuda:0]``) or on the CPU; the flag
    itself never takes a device twice."""
    t_start = time.time()
    model_config = (args.model_config
                    if isinstance(args.model_config, ModelConfig)
                    else resolve_model_config(args.model_config))
    check_supported(args)
    devices = (get_devices(getattr(args, "device", None)) if devices is None
               else [torch.device(d) for d in devices])
    device = devices[0]
    os.makedirs(args.output_folder, exist_ok=True)
    base_name = Path(args.slide_path).name.rsplit(".", 1)[0]
    if model_override is None:
        model_config.download_if_necessary()
    labels = model_config.cell_types

    roi_tree = None
    roi_class_dict = None
    output_types = list(getattr(args, "output_type", None) or [])
    if getattr(args, "roi_geojson", None):
        need_classes = "csv" in output_types or "spatialdata" in output_types
        loaded = load_roi_polygons(args.roi_geojson,
                                   group_by_class=need_classes)
        if need_classes:
            roi_tree, roi_class_dict = loaded
        else:
            roi_tree = loaded

    if model_override is not None:
        model = model_override
    else:
        model = build_model_from_config(
            model_config, precision=getattr(args, "precision", "bf16"),
            n_config_labels=len(labels), device=device)
    if model.nclasses <= 1:
        labels = None

    # ------------------------------------------------ tissue detection (QC)
    tissue = None
    tissue_polygons = None
    tissue_features = None
    tissue_area = 0.0
    if getattr(args, "tissue_detection_model_path", None):
        from classpose_tpu_torch.grandqc import detect_tissue_wsi

        tissue = detect_tissue_wsi(
            args.slide_path, model_path=args.tissue_detection_model_path,
            min_area=getattr(args, "min_area", 0), device=device)
        tissue_polygons = tissue["polygons"]  # level-0 coordinates
        tissue_features = tissue["geojson"]["features"]
        tissue_area = sum(p.area for p in tissue_polygons)  # level-0 px²
        if not tissue_polygons:
            logger.warning("No tissue detected in slide. Skipping "
                           "inference.")
            return {"n_cells": 0}

    # --------------------------------------------------------------- slide
    loader = SlideLoader(
        slide_path=args.slide_path,
        train_mpp=model_config.mpp,
        tile_size=getattr(args, "tile_size", DEFAULT_TILE_SIZE),
        overlap=getattr(args, "overlap", DEFAULT_OVERLAP),
        roi_tree=roi_tree,
        tissue_polygons=tissue_polygons,
        mpp_override=getattr(args, "mpp", None),
    ).open()
    worker = DeviceWorker(
        model, labels,
        prediction_to_slide_scale=loader.prediction_to_slide_scale,
        batch_size=getattr(args, "batch_size", 8),
        augment=bool(getattr(args, "tta", False)),
        n_post_threads=getattr(args, "inference_threads", None) or 4,
        tile_batch=getattr(args, "tile_batch", None),
        qc_downsample=2 if getattr(args, "fast_qc", False) else 1,
        percentile_subsample=2 if getattr(args, "fast_qc", False) else 1,
        devices=devices,
    )
    if len(devices) > 1:
        logger.info("Tile-parallel inference over %d devices (%s), whole "
                    "batches of %d tiles", len(devices),
                    ", ".join(map(str, devices)), worker.tile_batch)

    profile_dir = getattr(args, "profile", None)
    prof = None
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
        logger.info("torch profiler trace → %s", profile_dir)

    tile_filter = filter_tile if getattr(args, "filter_background_tiles",
                                         False) else None
    n_streamed = 0
    t_stream0 = time.time()
    with ProgressReporter(worker, len(loader.coords) or None,
                          enabled=getattr(args, "progress", None)):
        for tile, coords, out_size in loader.stream(tile_filter=tile_filter):
            worker.submit(tile, coords, out_size)
            n_streamed += 1
            if n_streamed % 50 == 0:
                logger.info(
                    "tiles: %d submitted (%.2f tiles/s, device %.1fs)",
                    n_streamed, n_streamed / (time.time() - t_stream0),
                    worker.infer_seconds)
        t_stream = time.time() - t_stream0
        logger.info("Processed %d tiles", n_streamed)
        # drain: in-flight batches and polygon jobs after the last submit
        t_drain0 = time.time()
        features = worker.collect()
        t_drain = time.time() - t_drain0
    if prof is not None:
        prof.__exit__(None, None, None)
        Path(profile_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(profile_dir) / "trace.json"))
    logger.info(
        "Detected %d cells (%d invalid polygons dropped); stage timers: "
        "read+infer %.1fs drain %.1fs (device-path %.1fs, host polygons "
        "%.1fs)", len(features), worker.n_invalid, t_stream, t_drain,
        worker.infer_seconds, worker.post_seconds)

    t_dedup0 = time.time()
    features = deduplicate(features)
    t_dedup = time.time() - t_dedup0
    t_export0 = time.time()

    if roi_tree is not None:
        features = filter_cells_by_tree(features, roi_tree, keep_inside=True)
    if tissue_polygons:
        features = filter_cells_by_tree(features, STRtree(tissue_polygons),
                                        keep_inside=True)

    artefact_features = None
    artefact_area = 0.0
    artefact_polygons_l0: list = []
    if getattr(args, "artefact_detection_model_path", None):
        from classpose_tpu_torch.grandqc import detect_artefacts_wsi

        # the artefact stage's tissue mask has no area filter: the tissue
        # stage's mask before its filter is that mask
        art = detect_artefacts_wsi(
            args.slide_path, model_path=args.artefact_detection_model_path,
            tissue_model_path=getattr(args, "tissue_detection_model_path",
                                      None),
            tissue_result=(None if tissue is None
                           else {"mask": tissue["mask_unfiltered"]}),
            device=device)
        artefact_features = art["geojson"]["features"]
        artefact_polygons_l0 = art["polygons_level0"]
        artefact_area = sum(p.area for p in art["polygons"])  # level-0 px²
        if getattr(args, "filter_artefacts", False) and art["polygons"]:
            features = filter_cells_by_tree(
                features, STRtree(art["polygons_level0"]), keep_inside=False)

    centroids = polygons_to_centroids(features)

    bx, by = loader.bounds_x, loader.bounds_y
    if bx or by:
        features = [apply_bounds_offset_to_feature(f, bx, by)
                    for f in features]
        centroids = [apply_bounds_offset_to_feature(f, bx, by)
                     for f in centroids]
        if tissue_features:
            tissue_features = [apply_bounds_offset_to_feature(f, bx, by)
                               for f in tissue_features]
        if artefact_features:
            artefact_features = [apply_bounds_offset_to_feature(f, bx, by)
                                 for f in artefact_features]

    out = Path(args.output_folder)
    write_feature_collection(
        features, out / get_geojson_output_filename("cell_contours",
                                                    base_name))
    write_feature_collection(
        centroids, out / get_geojson_output_filename("cell_centroids",
                                                     base_name))
    if tissue_features is not None:
        write_feature_collection(
            tissue_features,
            out / get_geojson_output_filename("tissue_contours", base_name))
    if artefact_features is not None:
        write_feature_collection(
            artefact_features,
            out / get_geojson_output_filename("artefact_contours",
                                              base_name))

    densities = None
    if output_types and labels is not None:
        if roi_class_dict:
            cells_by_roi = map_cells_to_roi_classes(
                features, roi_class_dict,
                getattr(args, "roi_class_priority", None))
            tissue_by_roi = {k: sum(p.area for p in v)
                             for k, v in roi_class_dict.items()}
            # per-ROI artefact correction: effective area = ROI − ROI ∩
            # artefact
            artefact_by_roi = {
                k: sum(intersection_area(ap, rp)
                       for ap in artefact_polygons_l0 for rp in v)
                for k, v in roi_class_dict.items()}
            densities = calculate_cellular_densities(
                cells_by_roi, tissue_by_roi, artefact_by_roi, loader.mpp[0],
                loader.mpp[1], labels)
        else:
            W, H = loader.slide.level_dimensions[0]
            densities = calculate_cellular_densities(
                features, tissue_area or float(W) * float(H), artefact_area,
                loader.mpp[0], loader.mpp[1], labels)
        if "csv" in output_types:
            write_densities_csv(
                densities, out / f"{base_name}_cellular_densities.csv")
    if "spatialdata" in output_types:
        roi_features = None
        if getattr(args, "roi_geojson", None):
            with open(args.roi_geojson) as f:
                roi_features = json.load(f).get("features")
        create_spatialdata_output(
            out / f"{base_name}_spatialdata.zarr", features,
            tissue_features, artefact_features, roi_features, densities,
            metadata={
                "slide": str(args.slide_path),
                "mpp": loader.mpp,
                "model_config": str(args.model_config),
                "n_cells": len(features),
                "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
            })

    loader.close()
    dt = time.time() - t_start
    logger.info("Pipeline finished: %d cells in %.1fs (%.2f tiles/s)",
                len(features), dt, n_streamed / dt if dt > 0 else 0)
    return {
        "n_cells": len(features),
        "n_tiles": n_streamed,
        "seconds": dt,
        "features": features,
        "devices": [str(d) for d in devices],
        "batches_per_device": worker.batches_per_device,
        # stream = read+submit wall and drain = post-submit finish wall,
        # both walls over overlapped device and host work; device = the
        # inference threads' cumulative seconds in eval_batch (two threads
        # overlap, so it over-counts card-serial time); host_post = the
        # post pool's cumulative polygon + feature CPU-seconds; dedup and
        # export are the single-threaded tail
        "stage_seconds": {
            "stream": round(t_stream, 3),
            "drain": round(t_drain, 3),
            "device": round(worker.infer_seconds, 3),
            "host_post": round(worker.post_seconds, 3),
            "dedup": round(t_dedup, 3),
            "export": round(time.time() - t_export0, 3),
        },
    }
