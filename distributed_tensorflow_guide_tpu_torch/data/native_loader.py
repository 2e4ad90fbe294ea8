"""Python surface of the native (C++) record loader.

The JAX package's ``data/native_loader.py``, for the port. The split is
the same: ``native/dataloader.cpp`` (the port's own copy) does mmap +
per-epoch global shuffle + multi-threaded batch gather (with the
train-time crop and flip of :class:`ImageAugment` done in the gather copy)
+ a background prefetch ring behind a C ABI, and this file compiles it
with ``g++`` at first use and binds it with ctypes, as an iterator of
numpy batches. The batches keep the records' dtypes (``int32`` tokens,
``uint8`` pixels); ``data/prefetch.DevicePrefetchIterator`` takes them to
the card, where any widening happens.

The build goes to ``build/native/`` at the root of the checkout (beside
``ops/_build.py``'s ``build/kernels/``; ``$DTG_TORCH_BUILD_DIR/native``
where that is set), named by a hash of the source and the flags, so an
edited source rebuilds and no library built from another copy (the JAX
package caches its own under ``~/.cache/dtg_native``) is ever loaded. It is
built under a temporary name and renamed into place, so processes that
build at once race harmlessly.

``PyRecordLoader`` is the bit-identical pure-Python twin: same
xoshiro256** RNG, same Fisher–Yates, same contiguous shard blocks, same
augmentation draws. It is the oracle of the tests, and
:func:`open_record_loader` falls back to it only where the library cannot
be built (with a warning that says why).

Every batch owns its memory: :meth:`NativeRecordLoader.next_batch` copies
out of the reused ctypes buffer, because a consumer such as the device
prefetch holds several batches at once.

Records are fixed-size; structured samples are described by a ``fields``
spec (name → dtype/shape) packed back-to-back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Iterator, Mapping, Sequence

import numpy as np

log = logging.getLogger("dtg.data")

_SRC = Path(__file__).resolve().parent / "native" / "dataloader.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_LIB_CACHE: dict[str, ctypes.CDLL] = {}
# why the last build failed (None: it did not fail, or none was tried)
_BUILD_ERROR: str | None = None

MASK64 = (1 << 64) - 1


# -- build + bind ------------------------------------------------------------


def native_build_dir() -> Path:
    """``build/native/`` at the root of the checkout, or
    ``$DTG_TORCH_BUILD_DIR/native``."""
    env = os.environ.get("DTG_TORCH_BUILD_DIR")
    if env:
        return Path(env) / "native"
    return Path(__file__).resolve().parents[2] / "build" / "native"


def source_digest() -> str:
    """The library's cache key: a hash of the flags and the source."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0")
    h.update(_SRC.read_bytes())
    return h.hexdigest()


def build_native_lib() -> Path:
    """Compile ``native/dataloader.cpp`` with ``g++`` unless a library of
    this source and these flags exists; returns its path. Raises where
    ``g++`` is missing or fails."""
    out = native_build_dir() / f"libdataloader_{source_digest()[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {_SRC.name} "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    log.info("built native dataloader: %s", out)
    return out


def load_native_lib() -> ctypes.CDLL | None:
    """Compile (cached) and bind the C ABI; None, with a warning that
    says why, where the library cannot be built."""
    global _BUILD_ERROR
    try:
        so = build_native_lib()
    except (RuntimeError, OSError) as e:  # g++ failed, or is missing
        _BUILD_ERROR = str(e)
        log.warning("native dataloader unavailable (%s); using the Python "
                    "twin", e)
        return None
    key = str(so)
    if key not in _LIB_CACHE:
        lib = ctypes.CDLL(key)
        lib.dl_open.restype = ctypes.c_void_p
        lib.dl_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
            ctypes.c_int,
        ]
        lib.dl_open_aug.restype = ctypes.c_void_p
        lib.dl_open_aug.argtypes = lib.dl_open.argtypes + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # in_h/in_w/chan
            ctypes.c_int64, ctypes.c_int64,                  # crop_h/crop_w
            ctypes.c_int64, ctypes.c_int,                    # extra, hflip
        ]
        lib.dl_next.restype = ctypes.c_int64
        lib.dl_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.dl_batches_per_epoch.restype = ctypes.c_int64
        lib.dl_batches_per_epoch.argtypes = [ctypes.c_void_p]
        lib.dl_num_records.restype = ctypes.c_int64
        lib.dl_num_records.argtypes = [ctypes.c_void_p]
        lib.dl_record_bytes_out.restype = ctypes.c_int64
        lib.dl_record_bytes_out.argtypes = [ctypes.c_void_p]
        lib.dl_close.argtypes = [ctypes.c_void_p]
        _LIB_CACHE[key] = lib
    return _LIB_CACHE[key]


# -- the shared RNG/shuffle spec (python twin of the C++) --------------------


class _Xoshiro256ss:
    """Exact Python port of the C++ Rng (xoshiro256** + splitmix64 seeding +
    Lemire bounded draw). Keep in lockstep with native/dataloader.cpp."""

    def __init__(self, seed: int):
        self.s = []
        seed &= MASK64
        for _ in range(4):
            seed = (seed + 0x9E3779B97F4A7C15) & MASK64
            z = seed
            z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
            self.s.append(z ^ (z >> 31))

    @staticmethod
    def _rotl(x: int, k: int) -> int:
        return ((x << k) | (x >> (64 - k))) & MASK64

    def next(self) -> int:
        s = self.s
        result = (self._rotl((s[1] * 5) & MASK64, 7) * 9) & MASK64
        t = (s[1] << 17) & MASK64
        s[2] ^= s[0]
        s[3] ^= s[1]
        s[1] ^= s[2]
        s[0] ^= s[3]
        s[2] ^= t
        s[3] = self._rotl(s[3], 45)
        return result

    def bounded(self, n: int) -> int:
        x = self.next()
        m = x * n
        low = m & MASK64
        if low < n:
            t = (1 << 64) % n
            while low < t:
                x = self.next()
                m = x * n
                low = m & MASK64
        return m >> 64


def epoch_permutation(n_records: int, seed: int, epoch: int) -> np.ndarray:
    """The global shuffle both implementations use: seeded Fisher–Yates."""
    rng = _Xoshiro256ss((seed * 0x9E3779B97F4A7C15 + epoch + 1) & MASK64)
    idx = np.arange(n_records, dtype=np.int64)
    for i in range(n_records - 1, 0, -1):
        j = rng.bounded(i + 1)
        idx[i], idx[j] = idx[j], idx[i]
    return idx


# -- image augmentation (shared spec: C++ does it in the gather copy) --------


def _aug_seed(seed: int, epoch: int, idx: int) -> int:
    """Per-record augmentation seed — keep in lockstep with aug_seed() in
    native/dataloader.cpp. Pure in (seed, epoch, record index): the same
    record gets the same crop/flip in a given epoch no matter the shuffle
    order, shard layout, or loader implementation."""
    return (seed * 0x9E3779B97F4A7C15
            + (epoch + 1) * 0xBF58476D1CE4E5B9 + idx) & MASK64


@dataclasses.dataclass(frozen=True)
class ImageAugment:
    """Deterministic train-time crop+flip, applied by the loader tier.

    Records store a slightly-larger-than-train image, e.g. (256, 256, 3)
    uint8, cropped to (224, 224) per epoch — the classic ImageNet recipe's
    geometry without JPEG. The C++ loader augments DURING the gather copy
    (one pass over the bytes); the Python twin mirrors it bit-exactly.
    Draws: y0, x0, flip — in that order — from
    ``Rng(_aug_seed(seed, epoch, index))``.
    """

    in_shape: tuple[int, int, int]   # (h, w, c) as stored
    crop: tuple[int, int]            # (crop_h, crop_w) as trained
    hflip: bool = True

    def __post_init__(self):
        h, w, c = self.in_shape
        ch, cw = self.crop
        if not (0 < ch <= h and 0 < cw <= w and c > 0):
            raise ValueError(
                f"crop {self.crop} must fit inside in_shape {self.in_shape}")

    @property
    def image_bytes_in(self) -> int:
        h, w, c = self.in_shape
        return h * w * c

    def out_fields(self, fields: "Sequence[Field]") -> list["Field"]:
        """The batch layout after augmentation: the leading image field
        shrinks to the crop; everything after it passes through."""
        img = fields[0]
        if img.dtype != np.uint8 or tuple(img.shape) != self.in_shape:
            raise ValueError(
                f"augmentation needs a leading uint8 image field of shape "
                f"{self.in_shape}; got {img.dtype} {img.shape}")
        ch, cw = self.crop
        return [Field(img.name, img.dtype, (ch, cw, self.in_shape[2])),
                *fields[1:]]

    def apply_one(self, record: np.ndarray, rng: "_Xoshiro256ss") -> np.ndarray:
        """Python-twin augmentation of one packed record (uint8 row)."""
        h, w, c = self.in_shape
        ch, cw = self.crop
        img = record[: h * w * c].reshape(h, w, c)
        y0 = rng.bounded(h - ch + 1)
        x0 = rng.bounded(w - cw + 1)
        flip = self.hflip and (rng.next() & 1)
        crop = img[y0:y0 + ch, x0:x0 + cw]
        if flip:
            crop = crop[:, ::-1]
        return np.concatenate(
            [np.ascontiguousarray(crop).reshape(-1), record[h * w * c:]])


# -- record/field plumbing ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: np.dtype
    shape: tuple[int, ...]

    @property
    def nbytes(self) -> int:
        return int(np.dtype(self.dtype).itemsize * np.prod(self.shape or (1,)))


def make_fields(spec: Mapping[str, tuple]) -> list[Field]:
    """spec: name -> (dtype, shape). Order defines the packed layout."""
    return [Field(n, np.dtype(d), tuple(s)) for n, (d, s) in spec.items()]


def record_bytes(fields: Sequence[Field]) -> int:
    return sum(f.nbytes for f in fields)


def write_records(path: str | Path, columns: Mapping[str, np.ndarray],
                  fields: Sequence[Field], *, append: bool = False) -> int:
    """Pack columns (leading dim = record index) into the flat record file.

    ``append=True`` extends an existing file (records are headerless and
    fixed-size, so concatenation is the file format's only structure), so
    large datasets can be written in bounded-memory chunks.
    """
    n = len(next(iter(columns.values())))
    rb = record_bytes(fields)
    buf = np.zeros((n, rb), np.uint8)
    off = 0
    for f in fields:
        col = np.ascontiguousarray(columns[f.name], dtype=f.dtype)
        if len(col) != n:
            raise ValueError(f"column {f.name} length {len(col)} != {n}")
        flat = col.reshape(n, -1).view(np.uint8).reshape(n, f.nbytes)
        buf[:, off:off + f.nbytes] = flat
        off += f.nbytes
    if append:
        # appending another field layout would interleave two record sizes
        # and show only as garbled batches much later; the one check the
        # headerless format admits is a whole number of this layout's
        # records
        try:
            existing = os.path.getsize(path)
        except OSError:
            existing = 0  # no file yet: append degenerates to a fresh write
        if existing % rb:
            raise ValueError(
                f"append to {path}: existing size {existing} is not a "
                f"multiple of record_bytes={rb} — field layout mismatch?")
    with open(path, "ab" if append else "wb") as fh:
        fh.write(buf.tobytes())
    return n


def _split_batch(raw: np.ndarray, fields: Sequence[Field]) -> dict:
    """raw (B, record_bytes) uint8 -> {name: (B, *shape) typed array}."""
    out = {}
    off = 0
    b = raw.shape[0]
    for f in fields:
        chunk = raw[:, off:off + f.nbytes]
        out[f.name] = np.ascontiguousarray(chunk).view(f.dtype).reshape(
            (b,) + f.shape)
        off += f.nbytes
    return out


# -- loaders -----------------------------------------------------------------


class NativeRecordLoader:
    """Iterator of field-dict batches backed by the C++ prefetch ring.

    Raises ``RuntimeError`` where the library cannot be built (the message
    carries the compiler's reason)."""

    def __init__(self, path: str | Path, fields: Sequence[Field],
                 batch_size: int, *, shard_id: int = 0, num_shards: int = 1,
                 shuffle: bool = True, seed: int = 0, prefetch: int = 4,
                 n_threads: int = 4, augment: ImageAugment | None = None):
        self.fields = list(fields)
        self.batch_size = batch_size
        self._rb = record_bytes(self.fields)
        lib = load_native_lib()
        if lib is None:
            raise RuntimeError(f"native loader unavailable ({_BUILD_ERROR}); "
                               "use PyRecordLoader")
        self._lib = lib
        if augment is None:
            self._h = lib.dl_open(str(path).encode(), self._rb, batch_size,
                                  shard_id, num_shards, prefetch, n_threads,
                                  ctypes.c_uint64(seed & MASK64),
                                  int(shuffle))
        else:
            self.fields = augment.out_fields(self.fields)  # batch layout
            h, w, c = augment.in_shape
            ch, cw = augment.crop
            self._h = lib.dl_open_aug(
                str(path).encode(), self._rb, batch_size, shard_id,
                num_shards, prefetch, n_threads,
                ctypes.c_uint64(seed & MASK64), int(shuffle),
                h, w, c, ch, cw, self._rb - augment.image_bytes_in,
                int(augment.hflip))
        if not self._h:
            raise ValueError(
                f"dl_open failed for {path} (record_bytes={self._rb}, "
                f"batch={batch_size}, shard {shard_id}/{num_shards} — file "
                "must be a whole number of records and >= one batch/shard)")
        if augment is not None:
            self._rb = int(lib.dl_record_bytes_out(self._h))
            if self._rb != record_bytes(self.fields):
                # the C++ out-record size against the Python out-field
                # view: a mismatch would reinterpret misaligned bytes
                raise ValueError(
                    f"native loader out-record size {self._rb} != Python "
                    f"field layout {record_bytes(self.fields)} bytes")
        self._buf = ctypes.create_string_buffer(batch_size * self._rb)

    @property
    def batches_per_epoch(self) -> int:
        return int(self._lib.dl_batches_per_epoch(self._h))

    @property
    def num_records(self) -> int:
        return int(self._lib.dl_num_records(self._h))

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> dict:
        seq = self._lib.dl_next(self._h, self._buf)
        if seq < 0:
            raise RuntimeError("dl_next failed")
        # a copy: the ctypes buffer is reused by the next call
        raw = np.frombuffer(self._buf, np.uint8).reshape(
            self.batch_size, self._rb).copy()
        return _split_batch(raw, self.fields)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dl_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            # at interpreter shutdown the ctypes handle may already be
            # gone, and raising from __del__ only prints noise; the OS
            # reclaims the mmap and threads either way
            pass


class PyRecordLoader:
    """Pure-Python twin: same files, same order, no threads. Oracle for the
    native loader's tests and fallback when g++ is missing."""

    def __init__(self, path: str | Path, fields: Sequence[Field],
                 batch_size: int, *, shard_id: int = 0, num_shards: int = 1,
                 shuffle: bool = True, seed: int = 0,
                 augment: ImageAugment | None = None):
        self.fields = list(fields)
        self.batch_size = batch_size
        self._rb = record_bytes(self.fields)
        self.augment = augment
        if augment is not None:
            self.fields = augment.out_fields(self.fields)
        data = np.fromfile(str(path), np.uint8)
        if data.size == 0 or data.size % self._rb:
            raise ValueError(f"{path}: not a whole number of records")
        self._records = data.reshape(-1, self._rb)
        self.num_records = len(self._records)
        self.shard_id, self.num_shards = shard_id, num_shards
        self.shuffle, self.seed = shuffle, seed
        self._epoch = -1
        self._indices: np.ndarray | None = None
        self._advance_epoch()
        if self.batches_per_epoch == 0:
            raise ValueError("shard smaller than one batch")
        self._pos = 0

    def _advance_epoch(self) -> None:
        self._epoch += 1
        shard_len = self.num_records // self.num_shards
        if self.shuffle:
            perm = epoch_permutation(self.num_records, self.seed, self._epoch)
            self._indices = perm[self.shard_id * shard_len:
                                 (self.shard_id + 1) * shard_len]
        else:
            self._indices = np.arange(self.shard_id * shard_len,
                                      (self.shard_id + 1) * shard_len)
        self.batches_per_epoch = shard_len // self.batch_size
        self._pos = 0

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> dict:
        if self._pos >= self.batches_per_epoch:
            self._advance_epoch()
        idx = self._indices[self._pos * self.batch_size:
                            (self._pos + 1) * self.batch_size]
        self._pos += 1
        raw = self._records[idx]
        if self.augment is not None:
            raw = np.stack([
                self.augment.apply_one(
                    raw[r],
                    _Xoshiro256ss(_aug_seed(self.seed, self._epoch,
                                            int(idx[r]))),
                )
                for r in range(raw.shape[0])
            ])
        return _split_batch(raw, self.fields)

    def close(self) -> None:
        # interface parity with NativeRecordLoader: nothing to release
        pass


def open_record_loader(path, fields, batch_size, **kw):
    """The native loader; the Python twin only where the library cannot
    be built (``load_native_lib`` has logged why)."""
    try:
        return NativeRecordLoader(path, fields, batch_size, **kw)
    except RuntimeError as e:
        log.warning("open_record_loader: %s", e)
        kw.pop("prefetch", None)
        kw.pop("n_threads", None)
        return PyRecordLoader(path, fields, batch_size, **kw)
