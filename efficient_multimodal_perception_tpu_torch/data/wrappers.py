"""Dataset wrappers: repeat, concatenate, class-balanced resampling (copy
of the JAX package's ``data/wrappers.py``).

The reference's CBGSDataset and mmdet's Repeat / Concat wrappers.  They
compose over any object with ``__len__``, ``sample(i)`` and
``batch(idx)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.geometry import CameraAug
from .batch import Batch


class RepeatDataset:
    """Repeat a dataset ``times`` times (epoch lengthening)."""

    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times

    def __len__(self):
        return len(self.dataset) * self.times

    def sample(self, i):
        return self.dataset.sample(i % len(self.dataset))

    def batch(self, idx):
        return self.dataset.batch([i % len(self.dataset) for i in idx])


def concat_batches(batches) -> Batch:
    """:class:`Batch` es joined along the batch axis, field by field (the
    camera augmentation's too); a field that is None stays None."""

    def cat(values):
        return None if values[0] is None else torch.cat(values, 0)

    kw = {f.name: cat([getattr(b, f.name) for b in batches])
          for f in dataclasses.fields(Batch) if f.name != "cam_aug"}
    aug = CameraAug(*(cat([getattr(b.cam_aug, k) for b in batches])
                      for k in ("resize", "crop", "flip")))
    return Batch(cam_aug=aug, **kw)


class ConcatDataset:
    """Concatenate datasets with compatible sample schemas."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def _locate(self, i):
        d = int(np.searchsorted(self.offsets, i, side="right")) - 1
        return self.datasets[d], i - int(self.offsets[d])

    def sample(self, i):
        d, j = self._locate(i)
        return d.sample(j)

    def batch(self, idx):
        located = [self._locate(i) for i in idx]
        first_ds = located[0][0]
        if all(d is first_ds for d, _ in located):
            return first_ds.batch([j for _, j in located])
        # the batch spans a dataset boundary: one-sample batches, joined
        return concat_batches([d.batch([j]) for d, j in located])


class CBGSDataset:
    """Class-balanced grouping and sampling (CBGS): sample indices
    duplicated so that every category's frequency approaches
    ``1 / num_classes``.  The wrapped dataset exposes
    ``get_cat_ids(i) -> set[int]`` and ``num_classes``.
    """

    def __init__(self, dataset, seed: int = 0):
        self.dataset = dataset
        self.sample_indices = self._balanced_indices(seed)

    def _balanced_indices(self, seed):
        n_cls = self.dataset.num_classes
        class_sample_idxs = {c: [] for c in range(n_cls)}
        for i in range(len(self.dataset)):
            for c in self.dataset.get_cat_ids(i):
                class_sample_idxs[c].append(i)
        duplicated = sum(len(v) for v in class_sample_idxs.values())
        frac = 1.0 / n_cls
        ratios = [
            frac / (len(v) / duplicated) if v else 0.0
            for v in class_sample_idxs.values()
        ]
        rng = np.random.default_rng(seed)
        out = []
        for (c, idxs), r in zip(class_sample_idxs.items(), ratios):
            if idxs:
                out += list(rng.choice(idxs, int(len(idxs) * r)))
        return out

    def __len__(self):
        return len(self.sample_indices)

    def sample(self, i):
        return self.dataset.sample(self.sample_indices[i])

    def batch(self, idx):
        return self.dataset.batch([self.sample_indices[i] for i in idx])
