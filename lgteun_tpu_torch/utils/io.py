""".mat round trips (reference dataset/utils.py:88-94; a copy of
`lgteun_tpu/utils/io.py`)."""

from __future__ import annotations

import scipy.io as sio

__all__ = ["load_mat", "save_mat"]


def load_mat(path: str, name: str):
    """Variable `name` of the .mat file at `path`."""
    return sio.loadmat(path)[name]


def save_mat(path: str, name: str, data) -> None:
    """Write `data` as variable `name` of a .mat file at `path`."""
    sio.savemat(path, {name: data})
