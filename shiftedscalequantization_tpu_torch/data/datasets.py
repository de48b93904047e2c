"""Data pipelines (PyTorch port of
``shiftedscalequantization_tpu/data/datasets.py``): CIFAR-10, digits,
synth10 and synthetic ImageNet.

Batches are NHWC numpy arrays, as in the JAX package; the calibration and
eval code moves them to the device. Shuffles and synthetic data come from
``numpy.random.default_rng`` and are bit-identical to the JAX package's.

Not ported yet (ROADMAP.md, 'Open items', queue 1, item 11: import and
data): the native C++ loader (``use_native=True`` raises) and real ImageNet
(an ImageFolder or npz arrays under ``data_path`` raise); a missing
ImageNet root gives the synthetic set, as in the JAX package.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

DATA_ITEM = ("is not ported yet (ROADMAP.md, 'Open items', queue 1, "
             "item 11: import and data)")


class ArrayLoader:
    """Minimal batched loader over in-memory arrays (NHWC)."""

    def __init__(self, images, labels, batch_size: int, shuffle: bool = False,
                 seed: int = 0, shard: Tuple[int, int] = (0, 1),
                 drop_last: bool = False):
        rank, world = shard
        n = images.shape[0]
        idx = np.arange(n)
        if shuffle:
            idx = np.random.default_rng(seed).permutation(n)
        idx = idx[rank::world]  # deterministic shard (DistributedSampler role)
        self.images, self.labels = images, labels
        self.idx = idx
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self) -> Iterator:
        bs = self.batch_size
        n = len(self.idx)
        end = n - (n % bs) if self.drop_last else n
        for i in range(0, end, bs):
            sel = self.idx[i:i + bs]
            yield self.images[sel], self.labels[sel]

    def __len__(self):
        n = len(self.idx)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)


def _synthetic(n, hw, num_classes, seed):
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 1, size=(n, hw, hw, 3)).astype(np.float32)
    labels = rng.integers(0, num_classes, size=(n,)).astype(np.int32)
    return images, labels


def _make_loader(images, labels, batch_size, shuffle, seed, shard,
                 use_native: Optional[bool] = None):
    """An ArrayLoader; ``use_native=True`` (the JAX package's C++
    pipeline) raises."""
    if use_native:
        raise NotImplementedError(f"the native loader {DATA_ITEM}")
    return ArrayLoader(images, labels, batch_size=batch_size,
                       shuffle=shuffle, seed=seed, shard=shard)


def build_cifar10_data(batch_size: int = 64, data_path: str = "~/dataset/cifar10",
                       seed: int = 1005, shard=(0, 1), synthetic: Optional[bool] = None,
                       synthetic_n: int = 2048, use_native: Optional[bool] = None):
    """Returns (train_loader, test_loader) of normalized NHWC float32."""
    data_path = os.path.expanduser(data_path)
    if synthetic is None:
        synthetic = not os.path.exists(data_path)
    if synthetic:
        tr = _synthetic(synthetic_n, 32, 10, seed)
        te = _synthetic(synthetic_n // 2, 32, 10, seed + 1)
    else:
        tr, te = _load_cifar10_dir(data_path)
        tr = ((tr[0] / 255.0 - CIFAR_MEAN) / CIFAR_STD, tr[1])
        te = ((te[0] / 255.0 - CIFAR_MEAN) / CIFAR_STD, te[1])
    train = _make_loader(*tr, batch_size=batch_size, shuffle=True, seed=seed,
                         shard=shard, use_native=use_native)
    test = _make_loader(*te, batch_size=batch_size, shuffle=False, seed=seed,
                        shard=shard, use_native=use_native)
    return train, test


def _load_cifar10_dir(path):
    """Load the standard cifar-10-batches-py pickle format."""
    import pickle

    def load_batch(fn):
        with open(fn, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x.astype(np.float32), np.array(d[b"labels"], np.int32)

    base = os.path.join(path, "cifar-10-batches-py")
    xs, ys = zip(*[load_batch(os.path.join(base, f"data_batch_{i}"))
                   for i in range(1, 6)])
    test = load_batch(os.path.join(base, "test_batch"))
    return (np.concatenate(xs), np.concatenate(ys)), test


def build_digits_data(batch_size: int = 64, seed: int = 1005, shard=(0, 1),
                      use_native: Optional[bool] = None, **_):
    """Real handwritten digits (sklearn's bundled 1797-sample set),
    upsampled to 32x32 RGB (data/realdata.py)."""
    from .realdata import digits_arrays
    x_tr, y_tr, x_te, y_te = digits_arrays()
    train = _make_loader(x_tr, y_tr, batch_size=batch_size, shuffle=True,
                         seed=seed, shard=shard, use_native=use_native)
    test = _make_loader(x_te, y_te, batch_size=batch_size, shuffle=False,
                        seed=seed, shard=shard, use_native=use_native)
    return train, test


def build_synth10_data(batch_size: int = 64, seed: int = 1005, shard=(0, 1),
                       n_train: int = 4096, n_test: int = 2048,
                       use_native: Optional[bool] = None, **_):
    """Procedural 10-class shape dataset (data/realdata.py). The 'train'
    loader is a fixed pool drawn from a different seed than the test set:
    it feeds calibration-sample extraction, never training."""
    from .realdata import synth10_test_arrays
    x_tr, y_tr = synth10_test_arrays(n_train, seed=seed + 123)
    x_te, y_te = synth10_test_arrays(n_test, seed=7)
    train = _make_loader(x_tr, y_tr, batch_size=batch_size, shuffle=True,
                         seed=seed, shard=shard, use_native=use_native)
    test = _make_loader(x_te, y_te, batch_size=batch_size, shuffle=False,
                        seed=seed, shard=shard, use_native=use_native)
    return train, test


def _has_real_imagenet(root: str) -> bool:
    """An ImageFolder ({root}/{train,val}/) or npz arrays
    ({root}/{train,val}.npz) under ``root``."""
    return all(os.path.isfile(os.path.join(root, f"{split}.npz"))
               or os.path.isdir(os.path.join(root, split))
               for split in ("train", "val"))


def build_imagenet_data(batch_size: int = 64, data_path: str = "~/dataset/imagenet",
                        seed: int = 1005, shard=(0, 1),
                        synthetic: Optional[bool] = None, synthetic_n: int = 512,
                        input_size: int = 224):
    """Synthetic ImageNet loaders, (N, 224, 224, 3) with 1000 classes, as
    the JAX package makes them when ``data_path`` holds no dataset. A real
    dataset there raises (its readers are not ported yet)."""
    data_path = os.path.expanduser(data_path)
    real = _has_real_imagenet(data_path)
    if synthetic is None:
        synthetic = not real
    if not synthetic:
        raise NotImplementedError(f"reading ImageNet from {data_path!r} "
                                  f"{DATA_ITEM}")
    tr = _synthetic(synthetic_n, input_size, 1000, seed)
    te = _synthetic(synthetic_n // 2, input_size, 1000, seed + 1)
    train = ArrayLoader(*tr, batch_size=batch_size, shuffle=True, seed=seed,
                        shard=shard)
    test = ArrayLoader(*te, batch_size=batch_size, shard=shard)
    return train, test
