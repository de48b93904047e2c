"""Real ImageNet ingestion (PyTorch port of
``shiftedscalequantization_tpu/data/imagenet_io.py``): ImageFolder JPEG
decoding and preprocessed arrays.

The reference's torchvision pipeline (data/imagenet.py:7-47) without
torchvision:

  * val transform: Resize(shorter side 256, bilinear) -> CenterCrop(224)
    -> /255 -> normalize (data/imagenet.py:27-32);
  * train transform: RandomResizedCrop(224, scale .08-1, ratio 3/4-4/3)
    -> RandomHorizontalFlip -> normalize (data/imagenet.py:19-25);
    calibration samples come from the train loader (common.py:144-150);
  * ImageFolder layout: {root}/{split}/{wnid}/*.JPEG, classes = sorted
    directory names (torchvision.datasets.ImageFolder semantics).

Preprocessed arrays: ``{root}/{split}.npz`` (keys: images, labels) or a
directory ``{root}/{split}/`` of .npz / .npy shards. uint8 arrays get the
val transform's arithmetic (resize, crop, normalize) in PyTorch on the
host CPU; float32 arrays are taken as already normalized NHWC. Pillow is
imported only where JPEGs are decoded.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .datasets import IMAGENET_MEAN, IMAGENET_STD

_IMG_EXTS = (".jpeg", ".jpg", ".png", ".bmp", ".webp")


# ---------------------------------------------------------------------------
# Transforms (Pillow, torchvision's arithmetic)
# ---------------------------------------------------------------------------

def _shorter_side_to(h: int, w: int, size: int) -> Tuple[int, int]:
    """(height, width) after resizing the shorter side to ``size``."""
    if w <= h:
        return max(round(h * size / w), size), size
    return size, max(round(w * size / h), size)


def _resize_shorter(img, size: int):
    from PIL import Image
    w, h = img.size
    nh, nw = _shorter_side_to(h, w, size)
    return img.resize((nw, nh), Image.BILINEAR)


def _center_crop(img, size: int):
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def _normalize(arr_u8: np.ndarray) -> np.ndarray:
    x = arr_u8.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def val_transform(img, input_size: int = 224) -> np.ndarray:
    """Resize(256) -> CenterCrop(input_size) -> normalize. Returns HWC f32."""
    img = img.convert("RGB")
    img = _resize_shorter(img, 256)
    img = _center_crop(img, input_size)
    return _normalize(np.asarray(img))


def train_transform(img, rng: np.random.Generator,
                    input_size: int = 224) -> np.ndarray:
    """RandomResizedCrop(input_size) + RandomHorizontalFlip + normalize
    (torchvision's sampling: log-uniform aspect in (3/4, 4/3), uniform
    area scale in (0.08, 1.0), 10 tries then a center-crop fallback)."""
    from PIL import Image
    img = img.convert("RGB")
    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(0.08, 1.0)
        aspect = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = int(rng.integers(0, w - cw + 1))
            top = int(rng.integers(0, h - ch + 1))
            img = img.resize((input_size, input_size), Image.BILINEAR,
                             box=(left, top, left + cw, top + ch))
            break
    else:
        img = _center_crop(_resize_shorter(img, input_size), input_size)
    arr = np.asarray(img)
    if rng.random() < 0.5:
        arr = arr[:, ::-1]
    return _normalize(arr)


# ---------------------------------------------------------------------------
# ImageFolder (JPEG) loader
# ---------------------------------------------------------------------------

def _index_image_folder(split_dir: str):
    classes = sorted(d for d in os.listdir(split_dir)
                     if os.path.isdir(os.path.join(split_dir, d)))
    samples = []
    for ci, cls in enumerate(classes):
        cdir = os.path.join(split_dir, cls)
        for fn in sorted(os.listdir(cdir)):
            if fn.lower().endswith(_IMG_EXTS):
                samples.append((os.path.join(cdir, fn), ci))
    return classes, samples


class ImageFolderLoader:
    """Batched JPEG loader over {split}/{class}/*.JPEG with the reference's
    transforms. Decodes lazily per batch (Pillow), shards deterministically
    (the DistributedSampler role, data/imagenet.py:34-36)."""

    def __init__(self, split_dir: str, batch_size: int, train: bool,
                 input_size: int = 224, shuffle: Optional[bool] = None,
                 seed: int = 0, shard: Tuple[int, int] = (0, 1)):
        self.classes, samples = _index_image_folder(split_dir)
        if not samples:
            raise FileNotFoundError(f"no images under {split_dir}")
        rank, world = shard
        idx = np.arange(len(samples))
        shuffle = train if shuffle is None else shuffle
        if shuffle:
            idx = np.random.default_rng(seed).permutation(idx)
        self.samples = [samples[i] for i in idx[rank::world]]
        self.batch_size = batch_size
        self.train = train
        self.input_size = input_size
        self.seed = seed

    def __len__(self):
        return -(-len(self.samples) // self.batch_size)

    def __iter__(self) -> Iterator:
        from PIL import Image
        rng = np.random.default_rng(self.seed)
        bs = self.batch_size
        for i in range(0, len(self.samples), bs):
            chunk = self.samples[i:i + bs]
            xs, ys = [], []
            for path, label in chunk:
                with Image.open(path) as img:
                    if self.train:
                        xs.append(train_transform(img, rng, self.input_size))
                    else:
                        xs.append(val_transform(img, self.input_size))
                ys.append(label)
            yield (np.stack(xs).astype(np.float32),
                   np.asarray(ys, np.int32))


# ---------------------------------------------------------------------------
# Preprocessed-array ingestion
# ---------------------------------------------------------------------------

RESIZE_CHUNK = 64          # images resized at a time (bounds host memory)


def _resize_crop_u8_batch(x_u8: np.ndarray, input_size: int) -> np.ndarray:
    """The val transform's arithmetic on uint8 NHWC batches: resize the
    shorter side to 256 (bilinear, antialiased when it shrinks: the
    triangle filter widened by the shrink factor, weights normalized per
    output pixel, as ``jax.image.resize`` computes them) then center-crop
    and normalize, in f32 on the host CPU."""
    n, h, w = x_u8.shape[:3]
    if (h, w) == (input_size, input_size):
        return _normalize(x_u8)
    nh, nw = _shorter_side_to(h, w, 256)
    top, left = (nh - input_size) // 2, (nw - input_size) // 2
    out = np.empty((n, input_size, input_size, x_u8.shape[3]), np.float32)
    for i in range(0, n, RESIZE_CHUNK):
        x = torch.from_numpy(x_u8[i:i + RESIZE_CHUNK]).to(torch.float32)
        if (nh, nw) != (h, w):
            x = F.interpolate(x.permute(0, 3, 1, 2), size=(nh, nw),
                              mode="bilinear", align_corners=False,
                              antialias=True).permute(0, 2, 3, 1)
        out[i:i + RESIZE_CHUNK] = \
            x[:, top:top + input_size, left:left + input_size].numpy()
    return ((out / 255.0) - IMAGENET_MEAN) / IMAGENET_STD


def load_array_split(root: str, split: str, input_size: int = 224):
    """Load {root}/{split}.npz or shards under {root}/{split}/. Returns
    (images NHWC f32 normalized, labels int32)."""
    single = os.path.join(root, f"{split}.npz")
    files = []
    if os.path.isfile(single):
        files = [single]
    else:
        sdir = os.path.join(root, split)
        if os.path.isdir(sdir):
            files = sorted(
                os.path.join(sdir, f) for f in os.listdir(sdir)
                if f.endswith((".npz", ".npy")))
    if not files:
        raise FileNotFoundError(
            f"no {split}.npz or {split}/*.np[yz] under {root}")
    xs, ys = [], []
    for f in files:
        if f.endswith(".npy"):
            x, y = np.load(f), None
        else:
            with np.load(f) as z:
                x = z["images"]
                y = z["labels"] if "labels" in z else None
        if x.dtype == np.uint8:
            x = _resize_crop_u8_batch(x, input_size)
        else:
            x = x.astype(np.float32)
        xs.append(x)
        ys.append(np.zeros(len(x), np.int32) if y is None
                  else np.asarray(y, np.int32))
    return np.concatenate(xs), np.concatenate(ys)


def has_image_folder(root: str) -> bool:
    for split in ("train", "val"):
        d = os.path.join(root, split)
        if not os.path.isdir(d):
            return False
        if not any(os.path.isdir(os.path.join(d, c)) for c in os.listdir(d)):
            return False
    return True


def has_arrays(root: str) -> bool:
    try:
        for split in ("train", "val"):
            if not (os.path.isfile(os.path.join(root, f"{split}.npz"))
                    or os.path.isdir(os.path.join(root, split))):
                return False
        return True
    except OSError:
        return False
