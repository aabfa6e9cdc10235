"""Self-contained baseline-TIFF codec (uint8/uint16/float, no deps).

A copy of `lgteun_tpu/data/tiff.py` (numpy and `struct` only), so the
port imports nothing of the JAX package. The reference reads `.tif`
rasters with tifffile and writes uint16 GTiffs through GDAL with a fake
georeference (reference: dataset/utils.py:29-39 `load_image`, :42-86
`save_image`):

- read: baseline TIFF, little/big endian, uncompressed (compression 1),
  contiguous planar config, single or multiple strips, 8/16/32-bit
  unsigned or 32-bit float samples. Returns [H, W] or [H, W, C] numpy.
- write: little-endian, uncompressed, single-strip, contiguous,
  uint16 by default (the reference's GDT_UInt16 convention), with
  [H, W] or [H, W, C] input.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["read_tiff", "write_tiff", "REFERENCE_GEO"]

_II = b"II"  # little-endian magic
_MM = b"MM"

# tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_PLANAR_CONFIG = 284
_SAMPLE_FORMAT = 339
_MODEL_TRANSFORMATION = 34264  # GeoTIFF raster->model 4x4 transform
_GEO_KEY_DIRECTORY = 34735     # GeoTIFF key directory

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8}


def _read_entry_values(data: bytes, entry: bytes, bo: str):
    tag, typ, count = struct.unpack(bo + "HHI", entry[:8])
    size = _TYPE_SIZES.get(typ, 1) * count
    if size <= 4:
        raw = entry[8:8 + size]
    else:
        (offset,) = struct.unpack(bo + "I", entry[8:12])
        raw = data[offset:offset + size]
    fmt = {1: "B", 3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d"}.get(typ)
    if fmt is None:
        return tag, ()
    values = struct.unpack(bo + fmt * count, raw)
    return tag, values


def read_tiff(path: str) -> np.ndarray:
    """Decode the first IFD of a baseline TIFF into [H,W] or [H,W,C]."""
    with open(path, "rb") as f:
        data = f.read()
    magic = data[:2]
    if magic == _II:
        bo = "<"
    elif magic == _MM:
        bo = ">"
    else:
        raise ValueError(f"{path}: not a TIFF file")
    (version,) = struct.unpack(bo + "H", data[2:4])
    if version != 42:
        raise ValueError(f"{path}: unsupported TIFF version {version}")
    (ifd_offset,) = struct.unpack(bo + "I", data[4:8])

    (n_entries,) = struct.unpack(bo + "H", data[ifd_offset:ifd_offset + 2])
    tags: dict[int, tuple] = {}
    for i in range(n_entries):
        off = ifd_offset + 2 + 12 * i
        tag, values = _read_entry_values(data, data[off:off + 12], bo)
        tags[tag] = values

    width = tags[_IMAGE_WIDTH][0]
    height = tags[_IMAGE_LENGTH][0]
    spp = tags.get(_SAMPLES_PER_PIXEL, (1,))[0]
    bits = tags.get(_BITS_PER_SAMPLE, (1,) * spp)
    compression = tags.get(_COMPRESSION, (1,))[0]
    planar = tags.get(_PLANAR_CONFIG, (1,))[0]
    sample_format = tags.get(_SAMPLE_FORMAT, (1,) * spp)

    if compression != 1:
        raise ValueError(f"{path}: only uncompressed TIFF supported "
                         f"(compression={compression})")
    if planar != 1:
        raise ValueError(f"{path}: only contiguous planar config supported")
    if len(set(bits)) != 1:
        raise ValueError(f"{path}: mixed bits-per-sample unsupported")
    bps = bits[0]
    sf = sample_format[0]
    dtype = {
        (1, 8): np.uint8, (1, 16): np.uint16, (1, 32): np.uint32,
        (2, 8): np.int8, (2, 16): np.int16, (2, 32): np.int32,
        (3, 32): np.float32, (3, 64): np.float64,
    }.get((sf, bps))
    if dtype is None:
        raise ValueError(f"{path}: unsupported sample format {sf}/{bps}bit")

    offsets = tags[_STRIP_OFFSETS]
    counts = tags[_STRIP_BYTE_COUNTS]
    raw = b"".join(data[o:o + c] for o, c in zip(offsets, counts))
    arr = np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder(bo))
    arr = arr.reshape(height, width, spp) if spp > 1 else arr.reshape(height, width)
    return np.ascontiguousarray(arr.astype(dtype))


# The reference stamps every saved raster with this fake georeference
# (dataset/utils.py:50-53: raster_origin (-123.25745, 45.43013), pixel
# size 2.4x2.4, EPSG:4326) — "Meaningless Default Value" per its own
# comment, but GIS-aware IQA tools see the tags. (geotransform, epsg).
REFERENCE_GEO = ((-123.25745, 2.4, 0.0, 45.43013, 0.0, 2.4), 4326)


def write_tiff(path: str, array: np.ndarray, dtype=np.uint16,
               geo: tuple | None = None) -> None:
    """Encode [H,W] or [H,W,C] as a single-strip little-endian TIFF.

    Default uint16 matches the reference's output convention
    (reference dataset/utils.py:63 GDT_UInt16); float32 is also
    supported for lossless intermediate storage.

    `geo=(geotransform, epsg)` adds GeoTIFF tags: a GDAL-style 6-tuple
    geotransform (originX, pxW, rotX, originY, rotY, pxH) written as
    ModelTransformationTag — the representation GDAL itself uses for
    the reference's south-up (pxH > 0) fake georeference — plus a
    GeoKeyDirectoryTag declaring a geographic CRS with the given EPSG
    code. Pass `REFERENCE_GEO` for the reference's exact values
    (reference dataset/utils.py:42-72 `save_image`).
    """
    arr = np.asarray(array)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ValueError("array must be [H,W] or [H,W,C]")
    arr = arr.astype(dtype)
    h, w, c = arr.shape
    bps = arr.dtype.itemsize * 8
    sample_format = 3 if np.issubdtype(arr.dtype, np.floating) else 1
    payload = arr.tobytes()

    entries = []  # (tag, type, count, packed little-endian values)

    def add(tag, typ, count, raw):
        entries.append((tag, typ, count, raw))

    add(_IMAGE_WIDTH, 4, 1, struct.pack("<I", w))
    add(_IMAGE_LENGTH, 4, 1, struct.pack("<I", h))
    add(_BITS_PER_SAMPLE, 3, c, struct.pack("<" + "H" * c, *([bps] * c)))
    add(_COMPRESSION, 3, 1, struct.pack("<H", 1))
    add(_PHOTOMETRIC, 3, 1, struct.pack("<H", 1))  # BlackIsZero
    add(_STRIP_OFFSETS, 4, 1, struct.pack("<I", 8))  # payload after header
    add(_SAMPLES_PER_PIXEL, 3, 1, struct.pack("<H", c))
    add(_ROWS_PER_STRIP, 4, 1, struct.pack("<I", h))
    add(_STRIP_BYTE_COUNTS, 4, 1, struct.pack("<I", len(payload)))
    add(_PLANAR_CONFIG, 3, 1, struct.pack("<H", 1))
    add(_SAMPLE_FORMAT, 3, 1, struct.pack("<H", sample_format))
    if geo is not None:
        gt, epsg = geo
        # row-major 4x4 raster->model transform equivalent to the
        # geotransform (GeoTIFF spec B.6; what GDAL writes when the
        # geotransform can't be a positive PixelScale + Tiepoint pair)
        mat = (gt[1], gt[2], 0.0, gt[0],
               gt[4], gt[5], 0.0, gt[3],
               0.0, 0.0, 0.0, 0.0,
               0.0, 0.0, 0.0, 1.0)
        add(_MODEL_TRANSFORMATION, 12, 16, struct.pack("<16d", *mat))
        keys = ((1024, 0, 1, 2),     # GTModelTypeGeoKey = geographic
                (1025, 0, 1, 1),     # GTRasterTypeGeoKey = PixelIsArea
                (2048, 0, 1, epsg))  # GeographicTypeGeoKey
        vals = (1, 1, 0, len(keys)) + tuple(v for k in keys for v in k)
        add(_GEO_KEY_DIRECTORY, 3, len(vals),
            struct.pack("<%dH" % len(vals), *vals))
    entries.sort(key=lambda e: e[0])

    # layout: header | payload | out-of-line values (word-aligned) | IFD
    extra_base = 8 + len(payload)
    extra = b""
    final = []
    for tag, typ, count, raw in entries:
        if len(raw) <= 4:
            final.append((tag, typ, count, raw + b"\0" * (4 - len(raw))))
        else:
            if (extra_base + len(extra)) % 2:
                extra += b"\0"
            final.append((tag, typ, count,
                          struct.pack("<I", extra_base + len(extra))))
            extra += raw
    ifd_offset = extra_base + len(extra)
    if ifd_offset % 2:
        extra += b"\0"
        ifd_offset += 1

    ifd = struct.pack("<H", len(final))
    for tag, typ, count, value in final:
        ifd += struct.pack("<HHI", tag, typ, count) + value
    ifd += struct.pack("<I", 0)  # no next IFD

    with open(path, "wb") as f:
        f.write(_II + struct.pack("<H", 42) + struct.pack("<I", ifd_offset))
        f.write(payload)
        f.write(extra)
        f.write(ifd)
