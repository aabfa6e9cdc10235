"""Pan-sharpening dataset: directory scan and eagerly cached samples (a
copy of `lgteun_tpu/data/dataset.py`, numpy and scipy only). TIFFs are
read by the native codec (`lgteun_tpu_torch/native`) where it builds and
takes the file, else by the Python codec (`data/tiff.py`); `CODEC_READS`
counts the files each read.

A directory holds `{id}_lr.tif` [h, w, C], `{id}_pan.tif` [H, W] and
optionally `{id}_mul.tif` [H, W, C] ground truth; samples are keyed by
the `*_pan.tif` files (reference ps_dataset.py:38-42). Each sample:

    input_lr    [h, w, C]      float32, HWC
    input_pan   [H, W, 1]      float32
    input_pan_l [H/4, W/4, 1]  float32, two cv2.pyrDown passes
                               (reference ps_dataset.py:57)
    target      [H, W, C]      float32 (when present)
    image_id    str
"""

from __future__ import annotations

import collections
import os
from dataclasses import dataclass, field

import numpy as np

from lgteun_tpu_torch.data.tiff import read_tiff as read_tiff_python
from lgteun_tpu_torch.native import read_tiff_native

__all__ = ["PSDataset", "scan_pairs", "read_tiff", "CODEC_READS"]

# files read by each codec ("native", "python") since the process began
CODEC_READS: collections.Counter = collections.Counter()


def read_tiff(path: str) -> np.ndarray:
    """The native codec's decode of `path` where the library builds and
    takes the file (uint16), else the Python codec's."""
    arr = read_tiff_native(path)
    if arr is not None:
        CODEC_READS["native"] += 1
        return arr
    CODEC_READS["python"] += 1
    return read_tiff_python(path)


def scan_pairs(image_dirs: list[str]) -> list[tuple[str, str]]:
    """[(image_id, path prefix)] for every `*_pan.tif` found."""
    pairs = []
    for d in image_dirs:
        for name in sorted(os.listdir(d)):
            if name.endswith("pan.tif"):
                image_id = name.split("_")[0]
                pairs.append((image_id, os.path.join(d, image_id)))
    return pairs


def _pyr_down_np(img: np.ndarray) -> np.ndarray:
    """cv2.pyrDown of a 2-D array: 5x5 binomial blur (mirror border),
    every second row and column."""
    from scipy import ndimage

    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    blurred = ndimage.correlate(img.astype(np.float64), np.outer(k, k),
                                mode="mirror")
    return blurred[::2, ::2]


@dataclass
class PSDataset:
    """Eagerly cached pan-sharpening split."""

    image_dirs: list[str]
    bit_depth: int = 11
    norm_input: bool = False
    _samples: list[dict] = field(default_factory=list, repr=False)

    def __post_init__(self):
        self.pairs = scan_pairs(self.image_dirs)
        has_target_dir = len(self.image_dirs) == 1
        max_value = 2.0 ** self.bit_depth - 0.5
        for image_id, prefix in self.pairs:
            lr = read_tiff(f"{prefix}_lr.tif").astype(np.float32)
            pan = read_tiff(f"{prefix}_pan.tif").astype(np.float32)
            if lr.ndim == 2:
                lr = lr[:, :, None]
            sample = {
                "input_lr": lr,
                "input_pan": pan[:, :, None],
                "input_pan_l": _pyr_down_np(_pyr_down_np(pan)).astype(
                    np.float32)[:, :, None],
                "image_id": image_id,
            }
            mul_path = f"{prefix}_mul.tif"
            if has_target_dir and os.path.exists(mul_path):
                tgt = read_tiff(mul_path).astype(np.float32)
                sample["target"] = tgt[:, :, None] if tgt.ndim == 2 else tgt
            if self.norm_input:
                for k, v in sample.items():
                    if k != "image_id":
                        sample[k] = v / max_value
            self._samples.append(sample)

    def __len__(self) -> int:
        return len(self._samples)

    def __getitem__(self, idx: int) -> dict:
        return self._samples[idx]

    @property
    def ms_chans(self) -> int:
        return self._samples[0]["input_lr"].shape[-1]
