"""ctypes bindings for the native (C++) data pipeline (PyTorch port of
``shiftedscalequantization_tpu/data/native_loader.py``).

``native/dataloader.cc`` (a threaded, double-buffered batch producer with
normalization and deterministic shard-aware shuffling, and a libjpeg
ImageFolder pipeline) is compiled at first use into
``build/native/libssq_native.so`` at the repository root, which
``.gitignore`` lists: ``g++ -O3 -std=c++17 -fPIC -Wall -pthread -shared
... -ljpeg``, the flags of ``native/Makefile``. The build is cached by a
hash of the source and the flags; nothing is written under ``native/``
and no prebuilt library is loaded. Where the build fails (no compiler, no
libjpeg), ``native_available()`` is False and ``build_error()`` holds the
compiler's message, which the loaders raise with.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "dataloader.cc"
BUILD_DIR = _ROOT / "build" / "native"
LIB_NAME = "libssq_native.so"
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]
LIBS = ["-ljpeg"]

_lock = threading.Lock()
_lib = None
_error: Optional[str] = None


def _digest(cxx: str) -> str:
    h = hashlib.sha256(" ".join([cxx, *CXXFLAGS, *LIBS]).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the library unless a build of the same source exists; raise
    RuntimeError with the compiler's output if it fails."""
    cxx = os.environ.get("CXX", "g++")
    digest = _digest(cxx)
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "source.sha256"
    if lib_path.exists() and stamp.exists() \
            and stamp.read_text().strip() == digest:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stderr.strip()}")
    os.replace(tmp, lib_path)
    stamp.write_text(digest)
    return lib_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, p = ctypes.c_int64, ctypes.c_void_p
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.ssq_loader_create_u8.restype = p
    lib.ssq_loader_create_u8.argtypes = [
        u8p, i32p, i64, i64, i64, i64, f32p, f32p, i64, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.ssq_loader_create_f32.restype = p
    lib.ssq_loader_create_f32.argtypes = [
        f32p, i32p, i64, i64, i64, i64, i64, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ssq_loader_num_batches.restype = i64
    lib.ssq_loader_num_batches.argtypes = [p]
    lib.ssq_loader_next.restype = i64
    lib.ssq_loader_next.argtypes = [p, f32p, i32p]
    lib.ssq_loader_destroy.argtypes = [p]
    lib.ssq_jpeg_loader_create.restype = p
    lib.ssq_jpeg_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), i32p, i64, ctypes.c_int,
        ctypes.c_int, f32p, f32p, i64, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.ssq_jpeg_loader_num_batches.restype = i64
    lib.ssq_jpeg_loader_num_batches.argtypes = [p]
    lib.ssq_jpeg_loader_next.restype = i64
    lib.ssq_jpeg_loader_next.argtypes = [p, f32p, i32p]
    lib.ssq_jpeg_loader_destroy.argtypes = [p]
    return lib


def _ensure_built() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None (and ``build_error()`` set)
    if it cannot be built. A failed build is not retried."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (RuntimeError, OSError) as e:
                _error = str(e)
    return _lib


def build_error() -> Optional[str]:
    """Why the library could not be built or loaded (None if it was)."""
    _ensure_built()
    return _error


def native_available() -> bool:
    return _ensure_built() is not None


def jpeg_available() -> bool:
    # dataloader.cc compiles its JPEG pipeline unconditionally: the library
    # exists only where libjpeg does
    return native_available()


def _require() -> ctypes.CDLL:
    lib = _ensure_built()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_error}")
    return lib


class NativeLoader:
    """Iterable of (images NHWC float32, labels int32) batches produced by
    the C++ pipeline. Keeps the source arrays alive for the loader's
    lifetime (the native side reads them zero-copy)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, shuffle: bool = False, seed: int = 0,
                 shard=(0, 1), drop_last: bool = False,
                 mean: Optional[np.ndarray] = None,
                 std: Optional[np.ndarray] = None, prefetch: int = 2):
        self._lib = _require()
        n, h, w, c = images.shape
        self._shape = (h, w, c)
        self.batch_size = batch_size
        self._labels = np.ascontiguousarray(labels, np.int32)
        self._rank, self._world = shard
        self._shuffle, self._seed = shuffle, seed
        self._drop_last, self._prefetch = drop_last, prefetch
        self._u8 = images.dtype == np.uint8
        if self._u8:
            self._images = np.ascontiguousarray(images)
            self._mean = np.ascontiguousarray(
                mean if mean is not None else np.zeros(c), np.float32)
            self._std = np.ascontiguousarray(
                std if std is not None else np.ones(c), np.float32)
        else:
            self._images = np.ascontiguousarray(images, np.float32)
        self._epoch = 0

    def _make(self):
        """Fresh native handle (the producer is single-epoch); the shuffle
        seed advances per epoch for training-style feeds."""
        lib = self._lib
        n = self._images.shape[0]
        h, w, c = self._shape
        i32p = self._labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        seed = self._seed + (self._epoch if self._shuffle else 0)
        if self._u8:
            return lib.ssq_loader_create_u8(
                self._images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                i32p, n, h, w, c,
                self._mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self._std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.batch_size, int(self._shuffle), seed, self._rank,
                self._world, int(self._drop_last), self._prefetch)
        return lib.ssq_loader_create_f32(
            self._images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            i32p, n, h, w, c, self.batch_size, int(self._shuffle), seed,
            self._rank, self._world, int(self._drop_last), self._prefetch)

    def __len__(self):
        handle = self._make()
        try:
            return self._lib.ssq_loader_num_batches(handle)
        finally:
            self._lib.ssq_loader_destroy(handle)

    def __iter__(self):
        h, w, c = self._shape
        handle = self._make()
        self._epoch += 1
        try:
            while True:
                imgs = np.empty((self.batch_size, h, w, c), np.float32)
                labs = np.empty((self.batch_size,), np.int32)
                got = self._lib.ssq_loader_next(
                    handle,
                    imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    labs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
                if got == 0:
                    return
                yield imgs[:got], labs[:got]
        finally:
            self._lib.ssq_loader_destroy(handle)


class NativeJpegLoader:
    """Iterable of (images NHWC f32 normalized, labels i32) batches decoded
    and preprocessed in C++ (libjpeg decode, PIL-BILINEAR-matching
    triangle resample of the shorter side to ``resize``, center crop,
    normalize: the reference's val transform, data/imagenet.py:27-32), with
    a threaded decode pool behind a double-buffered prefetch queue. The
    native twin of ``imagenet_io.ImageFolderLoader``'s val path."""

    def __init__(self, paths, labels, batch_size: int, input_size: int = 224,
                 resize: int = 256, mean=None, std=None,
                 shuffle: bool = False, seed: int = 0, shard=(0, 1),
                 drop_last: bool = False, prefetch: int = 2,
                 threads: int = 4):
        self._lib = _require()
        self._paths = [os.fsencode(p) for p in paths]
        self._labels = np.ascontiguousarray(labels, np.int32)
        self._argv = (ctypes.c_char_p * len(self._paths))(*self._paths)
        from .datasets import IMAGENET_MEAN, IMAGENET_STD
        self._mean = np.ascontiguousarray(
            IMAGENET_MEAN if mean is None else mean, np.float32)
        self._std = np.ascontiguousarray(
            IMAGENET_STD if std is None else std, np.float32)
        self.batch_size = batch_size
        self._crop, self._resize = input_size, resize
        self._shuffle, self._seed = shuffle, seed
        self._rank, self._world = shard
        self._drop_last, self._prefetch = drop_last, prefetch
        self._threads = threads
        self._epoch = 0

    def _make(self):
        seed = self._seed + (self._epoch if self._shuffle else 0)
        return self._lib.ssq_jpeg_loader_create(
            self._argv,
            self._labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(self._paths), self._resize, self._crop,
            self._mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.batch_size, int(self._shuffle), seed, self._rank,
            self._world, int(self._drop_last), self._prefetch,
            self._threads)

    def __len__(self):
        handle = self._make()
        try:
            return self._lib.ssq_jpeg_loader_num_batches(handle)
        finally:
            self._lib.ssq_jpeg_loader_destroy(handle)

    def __iter__(self):
        s = self._crop
        handle = self._make()
        self._epoch += 1
        try:
            while True:
                imgs = np.empty((self.batch_size, s, s, 3), np.float32)
                labs = np.empty((self.batch_size,), np.int32)
                got = self._lib.ssq_jpeg_loader_next(
                    handle,
                    imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    labs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
                if got == 0:
                    return
                yield imgs[:got], labs[:got]
        finally:
            self._lib.ssq_jpeg_loader_destroy(handle)
