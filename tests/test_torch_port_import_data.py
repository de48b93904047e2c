"""PyTorch port vs the JAX package: the import and data path, on the CPU
(``utils/torch_import.py``, ``data/imagenet_io.py``,
``data/native_loader.py`` and the loader preference of
``data/datasets.py``).

Files are synthesized in the test: torchvision-layout state dicts drawn
with numpy, JPEG ImageFolders and npz array roots. Tolerances:
checkpoint arrays, loader batches, shuffles, labels and the JPEG
pipelines bit-equal. The uint8 array resize is ``F.interpolate``
(bilinear, antialiased) against ``jax.image.resize``: both compute the
triangle filter widened by the shrink factor, normalized per output
pixel, in f32. After normalization they differ by up to 1.1e-6 on
320x480 (shrunk), 0 on 200x300 (enlarged), 7.5e-6 on 300x280 and 1.6e-5
on 180x256: there the JAX package's own CPU contraction is 9e-4 grey
levels off the same weights contracted in float64 and the port 1.5e-5,
so the tolerance is atol 2e-5 against JAX and 1e-6 (0.06 grey levels)
against the float64 contraction. Folded params from a ``--pretrained
x.pth.tar`` CLI setup: rtol 1e-6 (the same f32 expressions in two
libraries).
"""
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from shiftedscalequantization_tpu import cli as JCLI
from shiftedscalequantization_tpu import quantize as JQZ
from shiftedscalequantization_tpu.data import datasets as JDS
from shiftedscalequantization_tpu.data import imagenet_io as JIO
from shiftedscalequantization_tpu.data import native_loader as JNL
from shiftedscalequantization_tpu.data import realdata as JRD
from shiftedscalequantization_tpu.models import zoo as JZ
from shiftedscalequantization_tpu.utils import config as JCFG
from shiftedscalequantization_tpu.utils import torch_import as JTI
from shiftedscalequantization_tpu_torch import cli as TCLI
from shiftedscalequantization_tpu_torch import quantize as TQZ
from shiftedscalequantization_tpu_torch.data import datasets as TDS
from shiftedscalequantization_tpu_torch.data import imagenet_io as TIO
from shiftedscalequantization_tpu_torch.data import native_loader as TNL
from shiftedscalequantization_tpu_torch.data import realdata as TRD
from shiftedscalequantization_tpu_torch.models import zoo as TZ
from shiftedscalequantization_tpu_torch.utils import checkpoint as TCK
from shiftedscalequantization_tpu_torch.utils import config as TCFG
from shiftedscalequantization_tpu_torch.utils import torch_import as TTI

ROOT = Path(__file__).resolve().parents[1]
RESIZE_ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the same
    cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _batches(loader):
    return [(np.array(x), np.array(y)) for x, y in loader]


def _assert_same_batches(a, b, atol=0.0):
    assert len(a) == len(b)
    for (xa, ya), (xb, yb) in zip(a, b):
        assert xa.dtype == xb.dtype and xa.shape == xb.shape
        if atol:
            np.testing.assert_allclose(xa, xb, atol=atol, rtol=0)
        else:
            np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


# ---------------------------------------------------------------------------
# the loader preference and the native loader
# ---------------------------------------------------------------------------

def test_default_loader_matches_jax(monkeypatch):
    """Both packages' build_synth10_data at the default ``use_native``, on
    the same arrays: the same loader kind and the same shuffled labels.
    numpy's ArrayLoader (the port's only loader before the native one was
    ported) shuffles differently wherever the native library builds."""
    x, y = JRD.synth10_test_arrays(40, seed=3)
    x, y = np.asarray(x), np.asarray(y)
    monkeypatch.setattr(JRD, "synth10_test_arrays", lambda n, seed: (x, y))
    monkeypatch.setattr(TRD, "synth10_test_arrays", lambda n, seed: (x, y))
    kw = dict(batch_size=8, seed=3, n_train=40, n_test=40)
    jtr, jte = JDS.build_synth10_data(**kw)
    ttr, tte = TDS.build_synth10_data(**kw)
    assert type(ttr).__name__ == type(jtr).__name__
    _assert_same_batches(_batches(ttr), _batches(jtr))
    _assert_same_batches(_batches(tte), _batches(jte))
    old, _ = TDS.build_synth10_data(use_native=False, **kw)
    assert type(old) is TDS.ArrayLoader
    if TNL.native_available():
        assert type(ttr) is TNL.NativeLoader
        assert not np.array_equal(np.concatenate([b for _, b in old]),
                                  np.concatenate([b for _, b in jtr]))
    else:
        assert type(ttr) is TDS.ArrayLoader


def _broken_build(monkeypatch, tmp_path):
    """The port's native loader pointed at a source that cannot compile,
    building into tmp_path."""
    src = tmp_path / "broken.cc"
    src.write_text("#include <no_such_header_for_ssq.h>\n")
    monkeypatch.setattr(TNL, "SOURCE", src)
    monkeypatch.setattr(TNL, "BUILD_DIR", tmp_path / "build" / "native")
    monkeypatch.setattr(TNL, "_lib", None)
    monkeypatch.setattr(TNL, "_error", None)


def test_use_native_raises_with_compiler_message(monkeypatch, tmp_path):
    """Where the library cannot be built, ``use_native=True`` raises with
    the compiler's message and the default falls back to ArrayLoader; the
    loader never passes for native."""
    _broken_build(monkeypatch, tmp_path)
    assert not TNL.native_available() and not TNL.jpeg_available()
    assert "no_such_header_for_ssq.h" in TNL.build_error()
    x, y = np.zeros((4, 2, 2, 3), np.float32), np.arange(4, dtype=np.int32)
    with pytest.raises(RuntimeError, match="no_such_header_for_ssq.h"):
        TDS._make_loader(x, y, 2, True, 0, (0, 1), use_native=True)
    with pytest.raises(RuntimeError, match="native loader unavailable"):
        TNL.NativeLoader(x, y, 2)
    assert type(TDS._make_loader(x, y, 2, True, 0, (0, 1))) \
        is TDS.ArrayLoader
    assert not (tmp_path / "build" / "native" / TNL.LIB_NAME).exists()


def _tree(path):
    return {p: p.stat().st_mtime_ns for p in sorted(path.rglob("*"))}


def test_native_build_writes_only_under_build_native(monkeypatch, tmp_path):
    """The library is compiled from ``native/dataloader.cc`` into
    ``build/native/`` (here a fresh one), nothing under ``native/``
    changes, and the committed library is never what the port loads."""
    assert TNL.BUILD_DIR == ROOT / "build" / "native"
    assert TNL.SOURCE == ROOT / "native" / "dataloader.cc"
    if TNL.native_available():
        assert Path(TNL._lib._name).parent == TNL.BUILD_DIR
    native_before = _tree(ROOT / "native")
    out = tmp_path / "build" / "native"
    monkeypatch.setattr(TNL, "BUILD_DIR", out)
    monkeypatch.setattr(TNL, "_lib", None)
    monkeypatch.setattr(TNL, "_error", None)
    if not TNL.native_available():
        pytest.fail(f"the native library does not build: "
                    f"{TNL.build_error()}")
    assert Path(TNL._lib._name) == out / TNL.LIB_NAME
    assert sorted(p.name for p in tmp_path.rglob("*") if p.is_file()) == \
        [TNL.LIB_NAME, "source.sha256"]
    assert _tree(ROOT / "native") == native_before
    # a second load reuses the build
    mtime = (out / TNL.LIB_NAME).stat().st_mtime_ns
    TNL.build()
    assert (out / TNL.LIB_NAME).stat().st_mtime_ns == mtime


@pytest.mark.parametrize("kind,kw", [
    ("f32", dict()), ("f32", dict(shuffle=True, seed=3)),
    ("f32", dict(shuffle=True, seed=3, shard=(1, 3))),
    ("f32", dict(shuffle=True, seed=7, drop_last=True)),
    ("u8", dict(shuffle=True, seed=11, shard=(0, 2)))])
def test_native_loader_matches_jax(kind, kw):
    """The port's NativeLoader against the JAX package's: the same batches
    bit for bit (two epochs: the shuffle seed advances per epoch), the
    same length; sequential batches equal ArrayLoader's."""
    rng = np.random.default_rng(0)
    if kind == "u8":
        x = rng.integers(0, 256, (37, 5, 4, 3), dtype=np.uint8)
        kw = dict(kw, mean=JIO.IMAGENET_MEAN, std=JIO.IMAGENET_STD)
    else:
        x = rng.normal(size=(37, 5, 4, 3)).astype(np.float32)
    y = rng.integers(0, 10, 37).astype(np.int32)
    if not TNL.native_available():
        pytest.fail(f"the native library does not build: "
                    f"{TNL.build_error()}")
    t = TNL.NativeLoader(x, y, 8, **kw)
    j = JNL.NativeLoader(x, y, 8, **kw)
    assert len(t) == len(j)
    for _ in range(2):
        _assert_same_batches(_batches(t), _batches(j))
    if not kw:
        _assert_same_batches(_batches(t),
                             _batches(TDS.ArrayLoader(x, y, 8)))


@pytest.fixture(scope="module")
def jpeg_root(tmp_path_factory):
    """An ImageFolder of 2 classes x 3 JPEGs a split, odd sizes (both
    shorter sides, shrunk and enlarged to 256)."""
    from PIL import Image
    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        for ci, cls in enumerate(("n01440764", "n01443537")):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(3):
                h, w = 200 + 57 * i + 30 * ci, 300 - 41 * i
                arr = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
                Image.fromarray(arr).save(d / f"img_{i}.JPEG", quality=90)
    return str(root)


def test_native_jpeg_loader_matches_jax(jpeg_root):
    """The native JPEG val pipeline: port and JAX package bit-equal,
    sharded and shuffled too."""
    if not TNL.jpeg_available():
        pytest.fail(f"the native library does not build: "
                    f"{TNL.build_error()}")
    _, samples = JIO._index_image_folder(os.path.join(jpeg_root, "val"))
    assert TIO._index_image_folder(os.path.join(jpeg_root, "val"))[1] \
        == samples
    paths = [p for p, _ in samples]
    labels = np.asarray([c for _, c in samples], np.int32)
    for kw in (dict(), dict(shuffle=True, seed=5, shard=(1, 2))):
        t = TNL.NativeJpegLoader(paths, labels, 4, input_size=64, resize=96,
                                 threads=2, **kw)
        j = JNL.NativeJpegLoader(paths, labels, 4, input_size=64, resize=96,
                                 threads=2, **kw)
        assert len(t) == len(j)
        _assert_same_batches(_batches(t), _batches(j))


# ---------------------------------------------------------------------------
# imagenet_io
# ---------------------------------------------------------------------------

def test_image_folder_matches_jax(jpeg_root):
    """build_imagenet_data on a JPEG ImageFolder: the train split
    (RandomResizedCrop and flips drawn from the same generator, Pillow)
    and the val split (the native JPEG pipeline where it builds) equal the
    JAX package's; the Pillow val loader too."""
    assert TIO.has_image_folder(jpeg_root) and not TIO.has_arrays(
        os.path.join(jpeg_root, "val"))
    jtr, jte = JDS.build_imagenet_data(batch_size=4, data_path=jpeg_root)
    ttr, tte = TDS.build_imagenet_data(batch_size=4, data_path=jpeg_root)
    assert type(tte).__name__ == type(jte).__name__
    assert type(ttr) is TIO.ImageFolderLoader
    _assert_same_batches(_batches(ttr), _batches(jtr))
    _assert_same_batches(_batches(tte), _batches(jte))
    val = os.path.join(jpeg_root, "val")
    t = TIO.ImageFolderLoader(val, 4, train=False, shard=(0, 2))
    j = JIO.ImageFolderLoader(val, 4, train=False, shard=(0, 2))
    assert t.classes == j.classes and len(t) == len(j)
    _assert_same_batches(_batches(t), _batches(j))
    xb, yb = _batches(tte)[0]
    assert xb.shape == (4, 224, 224, 3) and yb.dtype == np.int32


def _triangle_weights(m, n):
    """(m, n) weights of a bilinear resize of m pixels to n, antialiased
    when it shrinks (the filter widened by m / n), normalized per output
    pixel, computed in f32 step by step as ``jax.image.resize`` computes
    them."""
    f32 = np.float32
    inv = f32(m / n)
    sample = (np.arange(n, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None]) \
        / max(inv, f32(1.0))
    w = np.maximum(f32(0.0), f32(1.0) - x)
    return w / w.sum(0, keepdims=True)


@pytest.mark.parametrize("hw", [(200, 300), (320, 480), (180, 256),
                                (256, 320), (224, 224)],
                         ids=["enlarged", "shrunk", "both", "crop-only",
                              "as-is"])
def test_resize_crop_matches_jax(hw):
    x = np.random.default_rng(1).integers(0, 256, (3, *hw, 3), np.uint8)
    got = TIO._resize_crop_u8_batch(x, 224)
    want = JIO._resize_crop_u8_batch(x, 224)
    assert got.dtype == np.float32 and got.shape == (3, 224, 224, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=RESIZE_ATOL,
                               rtol=0)
    if hw == (224, 224):
        return
    nh, nw = TIO._shorter_side_to(*hw, 256)
    exact = np.einsum("bhwc,hH->bHwc", x.astype(np.float64),
                      _triangle_weights(hw[0], nh).astype(np.float64))
    exact = np.einsum("bHwc,wW->bHWc", exact,
                      _triangle_weights(hw[1], nw).astype(np.float64))
    top, left = (nh - 224) // 2, (nw - 224) // 2
    exact = exact[:, top:top + 224, left:left + 224]
    exact = (exact / 255.0 - JIO.IMAGENET_MEAN) / JIO.IMAGENET_STD
    np.testing.assert_allclose(got, exact, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def npz_root(tmp_path_factory):
    """uint8 train.npz (shrunk and cropped on load) and a val/ directory of
    float32 224 shards, one without labels (.npy)."""
    root = tmp_path_factory.mktemp("npz")
    rng = np.random.default_rng(2)
    np.savez(root / "train.npz",
             images=rng.integers(0, 256, (11, 300, 280, 3), np.uint8),
             labels=rng.integers(0, 1000, 11))
    (root / "val").mkdir()
    for i in range(2):
        np.savez(root / "val" / f"shard{i}.npz",
                 images=rng.normal(size=(3, 224, 224, 3)).astype(np.float32),
                 labels=np.arange(3) + i)
    np.save(root / "val" / "shard2.npy",
            rng.normal(size=(2, 224, 224, 3)).astype(np.float32))
    return str(root)


def test_array_root_matches_jax(npz_root):
    assert TIO.has_arrays(npz_root) and not TIO.has_image_folder(npz_root)
    for split in ("train", "val"):
        tx, ty = TIO.load_array_split(npz_root, split)
        jx, jy = JIO.load_array_split(npz_root, split)
        assert tx.dtype == np.float32 and tx.shape == jx.shape
        np.testing.assert_allclose(tx, jx, atol=RESIZE_ATOL, rtol=0)
        np.testing.assert_array_equal(ty, jy)
    jtr, jte = JDS.build_imagenet_data(batch_size=4, data_path=npz_root)
    ttr, tte = TDS.build_imagenet_data(batch_size=4, data_path=npz_root)
    assert type(ttr).__name__ == type(jtr).__name__
    _assert_same_batches(_batches(ttr), _batches(jtr), atol=RESIZE_ATOL)
    _assert_same_batches(_batches(tte), _batches(jte))
    with pytest.raises(FileNotFoundError):
        TIO.load_array_split(npz_root, "test")


# ---------------------------------------------------------------------------
# torch_import and the CLI's --pretrained *.pth(.tar)
# ---------------------------------------------------------------------------

LAYOUTS = {"flat": lambda sd: sd,
           "state_dict+module": lambda sd: {
               "state_dict": {f"module.{k}": v for k, v in sd.items()},
               "epoch": 90},
           "brecq_model": lambda sd: {"model": sd}}


@pytest.fixture(scope="module")
def r50_sd():
    graph, km = TZ.build("resnet50", num_classes=1000)
    return graph, km(graph), TTI.random_state_dict(graph, km(graph))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_torch_import_matches_jax(r50_sd, layout, tmp_path):
    """ResNet-50 (Bottleneck keys: bn3, downsample.1) from a .pth(.tar) in
    each checkpoint layout: the port's tensors equal the JAX package's
    arrays bit for bit, on the device asked for."""
    graph, key_map, sd = r50_sd
    path = str(tmp_path / ("ck.pth.tar" if layout != "flat" else "ck.pth"))
    torch.save(LAYOUTS[layout](sd), path)
    tsd, jsd = TTI.load_state_dict(path), JTI.load_state_dict(path)
    assert set(tsd) == set(jsd) == set(sd)
    for k, v in jsd.items():
        assert isinstance(tsd[k], torch.Tensor) and tsd[k].device.type == \
            "cpu"
        np.testing.assert_array_equal(tsd[k].numpy(), v)
    gj, _ = JZ.build("resnet50", num_classes=1000)
    tp = TTI.params_from_state_dict(graph, key_map, tsd, device="cpu")
    jp = JTI.params_from_state_dict(gj, key_map, jsd)
    assert set(tp) == set(jp) and len(tp) == 54
    for name, p in jp.items():
        assert set(tp[name]) == set(p), name
        for k, v in p.items():
            pairs = v.items() if k == "bn" else [(None, v)]
            for bk, arr in pairs:
                got = tp[name][k][bk] if bk else tp[name][k]
                assert got.dtype == torch.float32 and got.device.type == "cpu"
                np.testing.assert_array_equal(got.numpy(), np.asarray(arr))


class _NotWeights:
    """An object a weights-only unpickler refuses."""


def test_torch_import_refuses_non_weights(tmp_path):
    """A checkpoint that pickles an arbitrary object is refused with an
    error naming --pretrained, not unpickled."""
    path = str(tmp_path / "ck.pth")
    torch.save({"state_dict": {"fc.weight": torch.zeros(2, 2)},
                "extra": _NotWeights()}, path)
    with pytest.raises(ValueError, match="--pretrained .*weights_only"):
        TTI.load_state_dict(path)


def test_cli_pretrained_pth_tar_matches_jax(tmp_path):
    """``--pretrained x.pth.tar`` (a BRECQ {'model': sd} checkpoint of
    the digits ResNet-18): both CLIs' setups give the same folded params,
    and the port's CLI runs on it to its initialized checkpoint."""
    graph, km = TZ.build("resnet18", dataset="digits")
    path = str(tmp_path / "r18.pth.tar")
    sd = TTI.random_state_dict(graph, km(graph), 4)
    torch.save({"model": sd}, path)
    argv = ["--arch", "resnet18", "--dataset", "digits", "--pretrained",
            path, "--n_bits_w", "4", "--n_bits_a", "8", "--w_scale_method",
            "max", "--platform", "cpu"]
    jg, jraw, jcfg = JCLI.build_everything(JCFG.load_args(argv))
    tg, traw, tcfg = TCLI.build_everything(TCFG.load_args(argv),
                                           device="cpu")
    jparams, _ = JQZ.prepare_model(jg, jraw, jcfg)
    tparams, _ = TQZ.prepare_model(tg, traw, tcfg, device="cpu")
    assert set(tparams) == set(jparams)
    for name, p in jparams.items():
        for k in ("w", "b"):
            np.testing.assert_allclose(tparams[name][k].numpy(),
                                       np.asarray(p[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{name} {k}")
    ck = tmp_path / "ck"
    TCLI.main(argv + ["--num_samples", "16", "--batch_size", "16",
                      "--make_checkpoint", "true", "--checkpoint_dir",
                      str(ck), "--log_path", str(tmp_path / "run.log")])
    assert (ck / "digits_QNN_CW_W4_A8.pkl").exists()
    qs, _ = TCK.load_qstate(str(ck / "digits_QNN_CW_W4_A8"), device="cpu")
    assert set(qs) >= set(tparams)
