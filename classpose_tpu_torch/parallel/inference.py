"""Tile-parallel inference over several devices (counterpart of
``classpose_tpu/parallel/inference.py``).

The JAX package pads a batch of net tiles to a multiple of its mesh size
and shards it on the leading axis of one partitioned program. Here each
device holds a replica of the network and runs one contiguous share of
the padded batch, in a thread and on a CUDA stream of its own.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from classpose_tpu_torch.parallel.mesh import get_mesh, replicate


class ShardedTileRunner:
    """Run batches of same-sized tiles over ``devices`` (default: every
    visible card). ``net(x (B, C, b, b)) -> (y, style)``; it is copied
    once onto each device (:func:`replicate`)."""

    def __init__(self, net: torch.nn.Module, devices=None):
        self.devices = get_mesh(devices)
        self.n_dev = len(self.devices)
        self.nets = replicate(net, self.devices)
        self._streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                         for d in self.devices]
        self._pool = ThreadPoolExecutor(max_workers=self.n_dev)

    def _share(self, i: int, tiles: np.ndarray) -> np.ndarray:
        dev, net, stream = self.devices[i], self.nets[i], self._streams[i]
        with torch.no_grad():
            if stream is None:
                y, _ = net(torch.from_numpy(tiles).to(dev))
                return y.float().numpy()
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                y, _ = net(torch.from_numpy(tiles).to(dev))
                return y.float().cpu().numpy()

    def __call__(self, tiles: np.ndarray) -> np.ndarray:
        """tiles (N, C, b, b) → net outputs (N, C_out, b, b) float32."""
        tiles = np.ascontiguousarray(tiles)
        n = tiles.shape[0]
        pad = (-n) % self.n_dev
        if pad:
            tiles = np.concatenate(
                [tiles, np.zeros((pad,) + tiles.shape[1:], tiles.dtype)])
        m = tiles.shape[0] // self.n_dev
        futures = [self._pool.submit(self._share, i, tiles[i * m:(i + 1) * m])
                   for i in range(self.n_dev)]
        return np.concatenate([f.result() for f in futures])[:n]

    def close(self) -> None:
        self._pool.shutdown(wait=True)
