"""Slide loading: pyramid-level/MPP math, tile enumeration, streamed reads
(counterpart of ``classpose_tpu/pipeline/slide_loader.py``).

- level = get_best_level_for_downsample(train_mpp / slide_mpp);
- residual resize factor = level_downsample / (train_mpp / slide_mpp);
- read_tile_size = round(tile_size / resize_factor); tiles are read at
  the chosen level and resized bilinearly to model MPP
  (:func:`resize_linear_u8`, OpenCV's ``INTER_LINEAR`` arithmetic on
  uint8);
- full grid: steps of (read_tile - read_overlap) over the level's
  dimensions, dropping tiles that overhang the edge;
- ROI grid: per-polygon bbox with adaptive tile size
  min(max(min_span, 256), tile_size);
- QuPath bounds offset, tissue/ROI pre-filters, and a reader thread pool
  feeding a bounded queue.
"""

from __future__ import annotations

import hashlib
import queue
import threading
from dataclasses import dataclass, field

import numpy as np

from classpose_tpu_torch.geometry import Polygon, STRtree
from classpose_tpu_torch.io import WSIReader
from classpose_tpu_torch.log import get_logger
from classpose_tpu_torch.tracing import span
from classpose_tpu_torch.utils import (
    download_if_unavailable,
    get_slide_resolution,
)

logger = get_logger(__name__)

DEFAULT_TILE_SIZE = 1024
DEFAULT_OVERLAP = 64
MIN_TILE_SIZE = 256


def _linear_coeffs(n_src: int, n_dst: int):
    """Source indices and 11-bit fixed-point weights of one axis, as
    OpenCV's ``INTER_LINEAR`` computes them: half-pixel centres, float32
    fractions, clamped at both edges, each weight rounded on its own."""
    f = ((np.arange(n_dst) + 0.5) * (n_src / n_dst) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    lo = s < 0
    f[lo], s[lo] = 0, 0
    hi = s >= n_src - 1
    f[hi], s[hi] = 0, n_src - 1
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int32)
    w1 = np.rint(f * np.float32(2048)).astype(np.int32)
    return s, np.minimum(s + 1, n_src - 1), w0, w1


def resize_linear_u8(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Bilinear resize of an (h, w, c) uint8 image to (out_h, out_w, c)
    in OpenCV's ``INTER_LINEAR`` integer arithmetic: a horizontal pass
    with 11-bit weights, then its vectorized vertical pass
    (``((b0·(r0 >> 4)) >> 16) + ((b1·(r1 >> 4)) >> 16) + 2) >> 2``). It
    equals ``cv2.resize`` except where OpenCV finishes a row with its
    scalar loop, which rounds once (at most 1 grey level apart)."""
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _linear_coeffs(w, out_w)
    y0, y1, b0, b1 = _linear_coeffs(h, out_h)
    S = img.astype(np.int32)
    rows = S[:, x0] * a0[None, :, None] + S[:, x1] * a1[None, :, None]
    r0, r1 = rows[y0] >> 4, rows[y1] >> 4
    out = (((b0[:, None, None] * r0) >> 16)
           + ((b1[:, None, None] * r1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _polygon_min_span(poly: Polygon) -> float:
    x0, y0, x1, y1 = poly.bounds
    return min(x1 - x0, y1 - y0)


@dataclass
class SlideLoader:
    slide_path: str
    train_mpp: float = 0.5
    tile_size: int = DEFAULT_TILE_SIZE
    overlap: int = DEFAULT_OVERLAP
    roi_tree: STRtree | None = None
    tissue_polygons: list[Polygon] | None = None
    n_read_threads: int = 4
    queue_size: int = 256
    mpp_override: float | None = None

    # filled by open()
    slide: object = field(default=None, init=False)
    mpp: tuple[float, float] = field(default=None, init=False)
    bounds_x: float = field(default=0.0, init=False)
    bounds_y: float = field(default=0.0, init=False)
    level: int = field(default=0, init=False)
    ts: float = field(default=1.0, init=False)
    resize_factor: float = field(default=1.0, init=False)
    coords: list = field(default_factory=list, init=False)

    def open(self):
        path = self.slide_path
        if path.startswith(("http://", "https://")):
            local = f".tmp/{hashlib.md5(path.encode()).hexdigest()}_" + \
                path.rsplit("/", 1)[-1]
            path = download_if_unavailable(local, path)
        self.slide = WSIReader(path)
        if self.mpp_override is not None:
            self.mpp = (float(self.mpp_override), float(self.mpp_override))
        else:
            self.mpp = get_slide_resolution(self.slide)
        if self.mpp is None:
            raise ValueError(
                f"Could not resolve slide MPP for {self.slide_path}; "
                "pass --mpp to override."
            )
        bx = self.slide.properties.get("openslide.bounds-x")
        by = self.slide.properties.get("openslide.bounds-y")
        self.bounds_x = float(bx) if bx is not None else 0.0
        self.bounds_y = float(by) if by is not None else 0.0
        if self.roi_tree is not None and (self.bounds_x or self.bounds_y):
            self._shift_roi_tree()

        scale = min(self.train_mpp / self.mpp[0],
                    self.train_mpp / self.mpp[1])
        self.prediction_to_slide_scale = scale
        self.level = self.slide.get_best_level_for_downsample(scale)
        self.slide_dim = self.slide.level_dimensions[self.level]
        self.ts = float(self.slide.level_downsamples[self.level])
        self.resize_factor = self.ts / scale
        read_tile = max(1, round(self.tile_size / self.resize_factor))
        read_overlap = max(0, round(self.overlap / self.resize_factor))
        if self.roi_tree is not None:
            self.coords = list(self._coords_roi(read_tile, read_overlap))
        else:
            self.coords = list(self._coords_full(read_tile, read_overlap))
        logger.info(
            "Slide MPP %s, model MPP %s, level %d (ds %.3f), resize %.4f, "
            "%d candidate tiles",
            self.mpp, self.train_mpp, self.level, self.ts,
            self.resize_factor, len(self.coords),
        )
        if not self.coords:
            logger.warning(
                "0 tiles: read tile %d px exceeds level-%d dims %s "
                "(slide smaller than --tile_size at model MPP); "
                "reduce --tile_size to process this slide",
                read_tile, self.level, self.slide_dim,
            )
        return self

    def _shift_roi_tree(self):
        off = np.array([self.bounds_x, self.bounds_y])
        self.roi_tree = STRtree([
            Polygon(g.exterior + off, holes=[h + off for h in g.holes])
            for g in self.roi_tree.geoms
        ])

    def _coords_full(self, read_tile: int, read_overlap: int):
        """Full-grid enumeration (level coords scaled back to level 0)."""
        W, H = self.slide_dim
        step = max(1, read_tile - read_overlap)
        for i in range(0, W, step):
            if i + read_tile > W:
                break
            for j in range(0, H, step):
                if j + read_tile > H:
                    break
                yield ((int(i * self.ts), int(j * self.ts)), read_tile)

    def _coords_roi(self, read_tile: int, read_overlap: int):
        """Per-ROI-polygon adaptive grid."""
        adj = self.overlap // 2
        for geom in self.roi_tree.geoms:
            coords = (geom.exterior / self.ts).astype(int)
            cmin = coords.min(axis=0) - adj
            cmax = coords.max(axis=0) + adj
            min_span = int(_polygon_min_span(geom) / self.ts)
            cts = min(max(min_span, MIN_TILE_SIZE), read_tile)
            step = max(1, cts - read_overlap)
            i = cmin[0]
            while i < cmax[0]:
                ii = cmax[0] - cts if (i + cts) > cmax[0] else i
                j = cmin[1]
                while j < cmax[1]:
                    jj = cmax[1] - cts if (j + cts) > cmax[1] else j
                    yield ((int(ii * self.ts), int(jj * self.ts)), int(cts))
                    j += step
                i += step

    # ------------------------------------------------------------ filtering
    def _tile_intersects(self, coords, tile_size_level, tree: STRtree):
        size0 = tile_size_level * self.ts
        x, y = coords
        return tree.intersects_bbox((x, y, x + size0, y + size0))

    def filtered_coords(self):
        """The candidate tiles that pass the tissue/ROI pre-filters."""
        tissue_tree = (
            STRtree(self.tissue_polygons) if self.tissue_polygons else None
        )
        out = []
        for coords, tsize in self.coords:
            if tissue_tree is not None and not self._tile_intersects(
                    coords, tsize, tissue_tree):
                continue
            if self.roi_tree is not None and not self._tile_intersects(
                    coords, tsize, self.roi_tree):
                continue
            out.append((coords, tsize))
        logger.info("Tiles after tissue/ROI pre-filter: %d", len(out))
        return out

    # ------------------------------------------------------------- streaming
    def stream(self, coords_list=None, tile_filter=None):
        """Yield (tile_rgb_at_model_mpp, level0_coords, out_size) from a
        reader thread pool (order not guaranteed). Spans: each reader's
        ``wsi.read`` and ``wsi.resize``, and the caller's ``wsi.read_wait``
        for the next tile."""
        coords_list = coords_list if coords_list is not None \
            else self.filtered_coords()
        q: queue.Queue = queue.Queue(maxsize=self.queue_size)
        idx_lock = threading.Lock()
        state = {"i": 0}

        def work():
            while True:
                with idx_lock:
                    if state["i"] >= len(coords_list):
                        break
                    k = state["i"]
                    state["i"] += 1
                try:
                    (x, y), tsize = coords_list[k]
                    with span("wsi.read"):
                        region = self.slide.read_region(
                            (int(x), int(y)), self.level, (tsize, tsize))
                        tile = np.asarray(region)[..., :3]
                    out_size = int(round(tsize * self.resize_factor))
                    if tile.shape[0] != out_size:
                        with span("wsi.resize"):
                            tile = resize_linear_u8(tile, out_size, out_size)
                    if tile_filter is not None and not tile_filter(tile):
                        q.put(None)
                        continue
                    q.put((tile, (x, y), out_size))
                except BaseException as e:
                    # propagate: a dead reader must not hang the pipeline
                    q.put(("__error__", e))

        threads = [threading.Thread(target=work, daemon=True)
                   for _ in range(self.n_read_threads)]
        for t in threads:
            t.start()
        for _ in range(len(coords_list)):
            with span("wsi.read_wait"):
                item = q.get()
            if item is None:
                continue
            if len(item) == 2 and item[0] == "__error__":
                raise RuntimeError("slide reader thread failed") from item[1]
            yield item

    def close(self):
        if self.slide is not None:
            self.slide.close()
