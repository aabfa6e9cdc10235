"""The float64 oracle of the no-reference metrics of one image, as the
checks against it use it: `numpy_ref.d_lambda` and `numpy_ref.d_s`, and
QNR formed from those two as `numpy_ref.qnr` forms it at alpha = beta =
1 (the same bits, without computing both again).

`numpy_ref` filters a band, and its square, once more for every band
pair the band enters (28 pairs at 8 bands). While `shared_window_stats`
is open, `numpy_ref._filter_valid` is memoised by the array's bytes, so
each of these window statistics is filtered once. The results keep
every bit; an 8-band image at 128^2 takes about 3 s on one CPU core
where it took about 9 s.
"""

from __future__ import annotations

import contextlib
import hashlib

import numpy as np

from lgteun_tpu_torch.metrics import numpy_ref

__all__ = ["shared_window_stats", "no_ref_scores"]


@contextlib.contextmanager
def shared_window_stats():
    plain = numpy_ref._filter_valid
    done = {}

    def memoised(img, window, crop_before, crop_after):
        key = (img.dtype.str, img.shape, window.tobytes(), crop_before,
               crop_after, hashlib.sha1(np.ascontiguousarray(img)).digest())
        if key not in done:
            done[key] = plain(img, window, crop_before, crop_after)
        return done[key]

    numpy_ref._filter_valid = memoised
    try:
        yield
    finally:
        numpy_ref._filter_valid = plain


def no_ref_scores(pred: np.ndarray, lrms: np.ndarray,
                  pan: np.ndarray) -> dict:
    """{"d_lambda", "d_s", "qnr"} of one image at the defaults of
    `numpy_ref.no_ref_evaluate`: pred [H, W, C], lrms [H/4, W/4, C], pan
    [H, W, 1], each cast to float64."""
    pred, lrms, pan = (np.asarray(x, np.float64) for x in (pred, lrms, pan))
    with shared_window_stats():
        dl = numpy_ref.d_lambda(pred, lrms)
        ds = numpy_ref.d_s(pred, lrms, pan)
    return {"d_lambda": dl, "d_s": ds, "qnr": (1.0 - dl) * (1.0 - ds)}
