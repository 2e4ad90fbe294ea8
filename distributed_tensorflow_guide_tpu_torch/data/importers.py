"""Real-dataset importers → the framework's fixed-record format.

The JAX package's ``data/importers.py``, for the port (byte-equal IDX and
record files).

Every example family in the reference trains on *real* MNIST pulled through
TF's dataset machinery (⚠ `Non-Distributed-Setup/` … `Synchronous-SGD/`,
SURVEY.md §2a R2–R7: `input_data.read_data_sets(...)`, which parses the
LeCun IDX files — optionally gzipped — into numpy arrays). This module is
the framework's equivalent of that parser, with one architectural difference:
instead of holding a numpy mother-array in the Python process and slicing
feed_dicts from it, it converts once into the mmap-friendly fixed-record
file that the native C++ loader (`data/native/dataloader.cpp`) streams with
per-epoch global shuffle and background prefetch.

IDX format (the canonical spec from the MNIST distribution):

    magic: 2 zero bytes, 1 dtype byte, 1 ndim byte
    ndim big-endian uint32 dimension sizes
    row-major payload in the encoded dtype (multi-byte types big-endian)

No network access is assumed anywhere: ``import_mnist`` consumes an
already-downloaded directory (the same files TF's reader consumed), and the
tests synthesize byte-exact IDX fixtures.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

from distributed_tensorflow_guide_tpu_torch.data.native_loader import (
    Field,
    make_fields,
    write_records,
)

# IDX dtype byte → (numpy dtype, big-endian wire dtype)
_IDX_DTYPES = {
    0x08: np.dtype(np.uint8),
    0x09: np.dtype(np.int8),
    0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"),
    0x0D: np.dtype(">f4"),
    0x0E: np.dtype(">f8"),
}


def read_idx(path: str | Path) -> np.ndarray:
    """Parse one IDX file (``.gz`` transparently) into a native-endian array."""
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        raw = f.read()
    if len(raw) < 4 or raw[0] != 0 or raw[1] != 0:
        raise ValueError(f"{path}: not an IDX file (bad magic {raw[:4]!r})")
    code, ndim = raw[2], raw[3]
    if code not in _IDX_DTYPES:
        raise ValueError(f"{path}: unknown IDX dtype byte 0x{code:02x}")
    dt = _IDX_DTYPES[code]
    header = 4 + 4 * ndim
    dims = struct.unpack(f">{ndim}I", raw[4:header])
    expect = int(np.prod(dims)) * dt.itemsize
    payload = raw[header:]
    if len(payload) != expect:
        raise ValueError(
            f"{path}: payload {len(payload)} B != expected {expect} B "
            f"for dims {dims} dtype {dt}"
        )
    arr = np.frombuffer(payload, dtype=dt).reshape(dims)
    # native byte order for downstream consumers
    return arr.astype(dt.newbyteorder("="), copy=False)


def write_idx(path: str | Path, arr: np.ndarray) -> None:
    """Inverse of :func:`read_idx` — used by tests to build byte-exact
    fixtures (and handy for exporting back to the interchange format)."""
    codes = {v.newbyteorder("="): k for k, v in _IDX_DTYPES.items()}
    dt = np.dtype(arr.dtype).newbyteorder("=")
    if dt not in codes:
        raise ValueError(f"dtype {arr.dtype} has no IDX encoding")
    wire = arr.astype(_IDX_DTYPES[codes[dt]])
    with open(path, "wb") as f:
        f.write(bytes([0, 0, codes[dt], arr.ndim]))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(np.ascontiguousarray(wire).tobytes())


def _find_idx(data_dir: Path, stem: str) -> Path:
    """Locate ``stem`` in ``data_dir`` accepting the plain and ``.gz`` forms
    (the MNIST distribution ships ``.gz``; TF's reader accepted both)."""
    for cand in (data_dir / stem, data_dir / f"{stem}.gz"):
        if cand.exists():
            return cand
    raise FileNotFoundError(
        f"{stem}[.gz] not found in {data_dir} — expected the standard MNIST "
        "IDX files (train-images-idx3-ubyte, train-labels-idx1-ubyte, ...)"
    )


MNIST_FIELDS = make_fields({
    "image": (np.uint8, (28, 28, 1)),
    "label": (np.int32, ()),
})


def import_idx_pair(images_path: str | Path, labels_path: str | Path,
                    out_path: str | Path) -> tuple[int, list[Field]]:
    """images IDX (N, H, W) uint8 + labels IDX (N,) → one record file.

    Images are stored as raw uint8 (mmap-dense: 784 B/record for MNIST, vs
    3136 B as float32); normalization to [0, 1] float happens on the host
    hot path (:func:`decode_mnist_batch`) right before device transfer —
    the same place TF's ``read_data_sets(normalize=True)`` did it.
    """
    images = read_idx(images_path)
    labels = read_idx(labels_path)
    if images.ndim != 3:
        raise ValueError(f"images IDX must be (N, H, W), got {images.shape}")
    if labels.shape != (images.shape[0],):
        raise ValueError(
            f"labels {labels.shape} do not pair with images {images.shape}"
        )
    fields = make_fields({
        "image": (np.uint8, (*images.shape[1:], 1)),
        "label": (np.int32, ()),
    })
    n = write_records(
        out_path,
        {"image": images[..., None], "label": labels.astype(np.int32)},
        fields,
    )
    return n, fields


def import_mnist(data_dir: str | Path, out_dir: str | Path,
                 split: str = "train") -> Path:
    """Convert a downloaded MNIST IDX directory into record files.

    Returns the record path; skips conversion when the record file already
    exists and is newer than its sources (idempotent re-runs).
    """
    data_dir, out_dir = Path(data_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    stems = {
        "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }
    if split not in stems:
        raise ValueError(f"split must be 'train' or 'test', got {split!r}")
    img_p = _find_idx(data_dir, stems[split][0])
    lbl_p = _find_idx(data_dir, stems[split][1])
    out = out_dir / f"mnist_{split}.records"
    src_mtime = max(img_p.stat().st_mtime, lbl_p.stat().st_mtime)
    if out.exists() and out.stat().st_mtime >= src_mtime:
        return out
    n, _ = import_idx_pair(img_p, lbl_p, out)
    if split == "train" and n != 60_000:  # the canonical sizes, warn-only
        import logging

        logging.getLogger("dtg.data").warning(
            "mnist train split has %d records (canonical: 60000)", n)
    return out


def decode_mnist_batch(batch: dict) -> dict:
    """Record batch → model batch: uint8 [0,255] → float32 [0,1], the
    normalization TF's reader applied (SURVEY §2a R2)."""
    return {
        "image": batch["image"].astype(np.float32) / 255.0,
        "label": batch["label"],
    }
