"""Host-side eval batching and normalisation (pure numpy; same contract
as `lgteun_tpu/data/pipeline.py:33-156`).

Normalisation divides by 2**bit_depth - 0.5 (reference
dataset/utils.py:232-249). The train iterator, augmentation, prefetch
and the PSDataset/TIFF readers come with the data slice.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["data_normalize", "data_denormalize", "eval_batches"]


def data_normalize(batch: dict, bit_depth: int = 11) -> dict:
    """/ (2**bit_depth - 0.5) on every array entry."""
    max_value = 2.0 ** bit_depth - 0.5
    return {k: (v if k == "image_id" else v / max_value)
            for k, v in batch.items()}


def data_denormalize(img, bit_depth: int = 11):
    """* (2**bit_depth - 0.5)."""
    return img * (2.0 ** bit_depth - 0.5)


def eval_batches(dataset, batch_size: int, *, bit_depth: int = 11,
                 normalize: bool = True) -> Iterator[tuple[dict, int]]:
    """Ordered batches for evaluation; yields (batch, n_valid). The last
    batch is padded by repeating its last sample (every batch has one
    shape); n_valid says how many rows are real. `dataset` is indexable,
    has a length, yields dicts of NHWC arrays and has `pairs` (ids)."""
    n = len(dataset)
    keys = [k for k in dataset[0] if k != "image_id"]
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        n_valid = len(idx)
        idx += [idx[-1]] * (batch_size - n_valid)
        batch = {k: np.stack([dataset[i][k] for i in idx]) for k in keys}
        if normalize:
            batch = data_normalize(batch, bit_depth)
        batch["image_id"] = [dataset.pairs[i][0] for i in idx]
        yield batch, n_valid
