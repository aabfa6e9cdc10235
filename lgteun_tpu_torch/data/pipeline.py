"""Host-side batching, normalisation and augmentation (numpy; a copy of
`lgteun_tpu/data/pipeline.py:33-156` without its device prefetch).

Normalisation divides by 2**bit_depth - 0.5 (reference
dataset/utils.py:232-249). `train_iterator` draws the same batches and
augmentation decisions as the JAX package's for one seed, and
fast-forwards to `start_iter` without loading data, so a resumed run
sees the batches an uninterrupted one would. Flips follow the
reference's `data_augmentation` (dataset/utils.py:155-229); its crops
resize with the port's bicubic (`ops/resize.py`, torch on the CPU).
`prefetch_to_device`, a TPU round-trip workaround, is not ported.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["data_normalize", "data_denormalize", "train_iterator",
           "eval_batches"]


def data_normalize(batch: dict, bit_depth: int = 11) -> dict:
    """/ (2**bit_depth - 0.5) on every array entry."""
    max_value = 2.0 ** bit_depth - 0.5
    return {k: (v if k == "image_id" else v / max_value)
            for k, v in batch.items()}


def data_denormalize(img, bit_depth: int = 11):
    """* (2**bit_depth - 0.5)."""
    return img * (2.0 ** bit_depth - 0.5)


_FLIP_KEYS = ("input_lr", "input_pan", "input_pan_l", "target")
_LR_KEYS = ("input_lr", "input_pan_l")  # crop offsets at 1x (others 4x)


def _crop_resize(imgs: np.ndarray, crop_st: tuple[int, int],
                 n: int) -> np.ndarray:
    """Crop NHWC `imgs` to (n-1)/n size at crop_st and resize back,
    bicubic with align_corners=True (reference dataset/utils.py:178-191)."""
    import torch

    from lgteun_tpu_torch.ops.resize import resize_bicubic

    _, h, w, _ = imgs.shape
    ch, cw = h // n * (n - 1), w // n * (n - 1)
    cropped = np.ascontiguousarray(
        imgs[:, crop_st[0]:crop_st[0] + ch, crop_st[1]:crop_st[1] + cw, :])
    out = resize_bicubic(torch.from_numpy(cropped).permute(0, 3, 1, 2),
                         (h, w), align_corners=True)
    return out.permute(0, 2, 3, 1).numpy()


def _draw_aug(rng: np.random.Generator, aug: dict | None):
    """This iteration's augmentation draws -> the decisions (split from
    `_augment` so the stream replays without loading data)."""
    if not aug:
        return None
    ud = rng.random() < aug.get("ud_flip", 0.0)
    lr = rng.random() < aug.get("lr_flip", 0.0)
    crops = []
    for key, n in (("r4_crop", 4), ("r2_crop", 2)):
        if rng.random() < aug.get(key, 0.0):
            crops.append((n, rng.random(), rng.random()))
    return ud, lr, crops


def _augment(batch: dict, decisions) -> dict:
    """Flips and random crops of every image key of `batch`."""
    if not decisions:
        return batch
    ud, lr, crops = decisions
    out = dict(batch)
    if ud:
        for k in _FLIP_KEYS:
            if k in out:
                out[k] = out[k][:, ::-1, :, :]
    if lr:
        for k in _FLIP_KEYS:
            if k in out:
                out[k] = out[k][:, :, ::-1, :]
    for n, u0, u1 in crops:
        d0 = int(out["input_lr"].shape[1] // n * u0)
        d1 = int(out["input_lr"].shape[2] // n * u1)
        for k in _FLIP_KEYS:
            if k in out:
                st = (d0, d1) if k in _LR_KEYS else (d0 * 4, d1 * 4)
                out[k] = _crop_resize(out[k], st, n)
    return out


def train_iterator(dataset, batch_size: int, *, bit_depth: int = 11,
                   normalize: bool = True, aug_dict: dict | None = None,
                   seed: int = 19971118,
                   start_iter: int = 0) -> Iterator[dict]:
    """Infinite shuffled batches of a PSDataset (the reference's
    epoch-less `while iter < max_iter` loop): a queue of indices refilled
    with fresh permutations, so any batch size works."""
    rng = np.random.default_rng(seed)
    n = len(dataset)
    keys = [k for k in dataset[0] if k != "image_id"]
    queue: list[int] = []
    for _ in range(start_iter):
        while len(queue) < batch_size:
            queue.extend(rng.permutation(n).tolist())
        queue = queue[batch_size:]
        _draw_aug(rng, aug_dict)
    while True:
        while len(queue) < batch_size:
            queue.extend(rng.permutation(n).tolist())
        idx, queue = queue[:batch_size], queue[batch_size:]
        batch = {k: np.stack([dataset[i][k] for i in idx]) for k in keys}
        batch = _augment(batch, _draw_aug(rng, aug_dict))
        if normalize:
            batch = data_normalize(batch, bit_depth)
        yield {k: np.ascontiguousarray(v) for k, v in batch.items()}


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
