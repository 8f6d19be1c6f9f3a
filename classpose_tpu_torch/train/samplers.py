"""Deterministic distributed samplers, numpy only (a copy of
``classpose_tpu/train/samplers.py``; the indices are identical).

Seeded per-epoch global permutation, or a weighted choice when
oversampling, truncated to whole global batches and sharded by
``reshape(-1, replicas, batch)[:, rank]`` (deterministic, overlap-free,
full coverage); contiguous sequential shards for validation.
"""

from __future__ import annotations

import numpy as np


class DistributedEpochSampler:
    def __init__(
        self,
        dataset_length: int,
        batch_size: int,
        train_probs: np.ndarray | None = None,
        nimg_per_epoch: int | None = None,
        rank: int = 0,
        num_replicas: int = 1,
        seed: int = 0,
    ):
        if dataset_length <= 0:
            raise ValueError("dataset_length must be positive")
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if num_replicas <= 0:
            raise ValueError("num_replicas must be positive")
        if rank < 0 or rank >= num_replicas:
            raise ValueError("rank must be in [0, num_replicas)")

        self.dataset_length = dataset_length
        self.batch_size = batch_size
        self.train_probs = None
        if train_probs is not None:
            train_probs = np.asarray(train_probs, dtype=np.float64)
            if train_probs.shape[0] != dataset_length:
                raise ValueError(
                    "train_probs must have the same length as the dataset"
                )
            if np.any(train_probs < 0):
                raise ValueError("train_probs must be non-negative")
            if float(train_probs.sum()) <= 0.0:
                raise ValueError("train_probs must sum to a positive value")
            self.train_probs = train_probs / train_probs.sum()

        self.nimg_per_epoch = (
            dataset_length if nimg_per_epoch is None else int(nimg_per_epoch)
        )
        if self.nimg_per_epoch <= 0:
            raise ValueError("nimg_per_epoch must be positive")
        if self.train_probs is None and self.nimg_per_epoch > dataset_length:
            raise ValueError(
                "nimg_per_epoch cannot exceed the dataset size without "
                "oversampling"
            )

        self.rank = rank
        self.num_replicas = num_replicas
        self.seed = seed
        self.epoch = 0
        self.global_batch_size = self.num_replicas * self.batch_size
        self._local_num_samples = self._build_local_indices(epoch=0).shape[0]

    def _build_global_indices(self, epoch: int | None = None) -> np.ndarray:
        epoch = self.epoch if epoch is None else epoch
        rng = np.random.default_rng(self.seed + epoch)
        all_indices = np.arange(self.dataset_length, dtype=np.int64)
        if self.train_probs is None:
            global_indices = rng.permutation(all_indices)[
                : self.nimg_per_epoch
            ]
        else:
            global_indices = rng.choice(
                all_indices, size=self.nimg_per_epoch, p=self.train_probs
            )
        usable = global_indices.shape[0] - (
            global_indices.shape[0] % self.global_batch_size
        )
        if usable == 0:
            raise ValueError(
                "The epoch does not contain enough samples for even one "
                f"full distributed batch. Lower batch_size "
                f"({self.batch_size}), lower world_size "
                f"({self.num_replicas}), or increase nimg_per_epoch "
                f"({self.nimg_per_epoch})."
            )
        return np.asarray(global_indices[:usable], dtype=np.int64)

    def _build_local_indices(self, epoch: int | None = None) -> np.ndarray:
        g = self._build_global_indices(epoch=epoch)
        return g.reshape(-1, self.num_replicas, self.batch_size)[
            :, self.rank, :
        ].reshape(-1)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def local_indices(self, epoch: int | None = None) -> np.ndarray:
        return self._build_local_indices(epoch=epoch)

    def __iter__(self):
        return iter(self._build_local_indices().tolist())

    def __len__(self) -> int:
        return self._local_num_samples


class SequentialDistributedSampler:
    def __init__(
        self, dataset_length: int, rank: int = 0, num_replicas: int = 1
    ):
        if dataset_length < 0:
            raise ValueError("dataset_length must be non-negative")
        if num_replicas <= 0:
            raise ValueError("num_replicas must be positive")
        if rank < 0 or rank >= num_replicas:
            raise ValueError("rank must be in [0, num_replicas)")
        self.dataset_length = dataset_length
        self.rank = rank
        self.num_replicas = num_replicas
        base = dataset_length // num_replicas
        remainder = dataset_length % num_replicas
        self.start_index = rank * base + min(rank, remainder)
        self.end_index = (
            self.start_index + base + (1 if rank < remainder else 0)
        )

    def indices(self) -> list[int]:
        return list(range(self.start_index, self.end_index))

    def __iter__(self):
        return iter(self.indices())

    def __len__(self) -> int:
        return self.end_index - self.start_index
