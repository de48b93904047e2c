"""PyTorch port vs the JAX package: the data pipelines (``data/``), the
raw-params npz IO (``train.py``), the eval harness (``utils/eval.py``),
checkpoints (``utils/checkpoint.py``) and run logging
(``utils/logging.py``), on the CPU.

Loader batches, shuffles and synthetic data must be bit-equal, each
package at its default loader (the native C++ one wherever it builds,
else numpy's). The digits resize is ``F.interpolate`` against
``jax.image.resize``: atol 1e-6. synth10 rendered from the JAX package's
own draws against ``synth10_batch``: atol 1e-5 (sigmoid and cos in f32,
two libraries). Accuracies on the same state and batches: equal; logits
within rtol 1e-5; a golden file written by either package reads in the
other with MSE <= 1e-8. Checkpoints round-trip exactly.
"""
import dataclasses
import os
import pickle

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import shiftedscalequantization_tpu as ssq
from shiftedscalequantization_tpu import graph as JG
from shiftedscalequantization_tpu import quantize as JQZ
from shiftedscalequantization_tpu import train as JT
from shiftedscalequantization_tpu.data import datasets as JDS
from shiftedscalequantization_tpu.data import realdata as JRD
from shiftedscalequantization_tpu.utils import eval as JEV
from shiftedscalequantization_tpu.utils import logging as JLOG
from shiftedscalequantization_tpu_torch import graph as TG
from shiftedscalequantization_tpu_torch import quantize as TQZ
from shiftedscalequantization_tpu_torch import train as TT
from shiftedscalequantization_tpu_torch.data import datasets as TDS
from shiftedscalequantization_tpu_torch.data import realdata as TRD
from shiftedscalequantization_tpu_torch.ops import wquant as TW
from shiftedscalequantization_tpu_torch.ops.quant import QParams
from shiftedscalequantization_tpu_torch.utils import checkpoint as TCK
from shiftedscalequantization_tpu_torch.utils import eval as TEV
from shiftedscalequantization_tpu_torch.utils import jax_import as JI
from shiftedscalequantization_tpu_torch.utils import logging as TLOG
from test_torch_port_recon import _np, _state


def _batches(loader):
    return [(np.asarray(x), np.asarray(y)) for x, y in loader]


def _assert_same_batches(a, b):
    assert len(a) == len(b)
    for (xa, ya), (xb, yb) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


# ---------------------------------------------------------------------------
# loaders and datasets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(shuffle=True, seed=3),
                                dict(shuffle=True, seed=3, shard=(1, 3)),
                                dict(drop_last=True)])
def test_array_loader_and_synthetic_match_jax(kw):
    x, y = JDS._synthetic(37, 4, 10, 11)
    tx, ty = TDS._synthetic(37, 4, 10, 11)
    np.testing.assert_array_equal(x, tx)
    np.testing.assert_array_equal(y, ty)
    assert tx.dtype == np.float32 and ty.dtype == np.int32
    jl, tl = JDS.ArrayLoader(x, y, 8, **kw), TDS.ArrayLoader(x, y, 8, **kw)
    assert len(tl) == len(jl)
    _assert_same_batches(_batches(tl), _batches(jl))


def test_builders_match_jax(tmp_path):
    """Synthetic CIFAR-10 and ImageNet, and a CIFAR-10 pickle directory,
    give the JAX package's batches, each package at its default loader
    (the native one wherever it builds); an ImageNet root that holds no
    dataset gives the synthetic set."""
    for build in ("build_cifar10_data", "build_imagenet_data"):
        kw = dict(batch_size=16, seed=5, synthetic=True, synthetic_n=40)
        if build == "build_imagenet_data":
            kw["input_size"] = 12
        jtr, jte = getattr(JDS, build)(**kw)
        ttr, tte = getattr(TDS, build)(**kw)
        _assert_same_batches(_batches(ttr), _batches(jtr))
        _assert_same_batches(_batches(tte), _batches(jte))
    base = tmp_path / "cifar" / "cifar-10-batches-py"
    base.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (6, 3072), np.uint8),
                         b"labels": list(rng.integers(0, 10, 6))}, f)
    j = JDS.build_cifar10_data(batch_size=8, data_path=str(tmp_path / "cifar"))
    t = TDS.build_cifar10_data(batch_size=8, data_path=str(tmp_path / "cifar"))
    for a, b in zip(t, j):
        _assert_same_batches(_batches(a), _batches(b))
    tr, te = TDS.build_imagenet_data(data_path=str(tmp_path / "none"),
                                     synthetic_n=4, input_size=8)
    assert next(iter(tr))[0].shape == (4, 8, 8, 3)
    assert next(iter(te))[0].shape == (2, 8, 8, 3)


def test_digits_match_jax():
    pytest.importorskip("sklearn")
    j, t = JRD.digits_arrays(), TRD.digits_arrays()
    assert [a.shape[0] for a in t] == [1438, 1438, 359, 359]
    assert t[0].shape == (1438, 32, 32, 3) and t[0].dtype == np.float32
    for a, b in zip(t, j):
        assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_allclose(t[0], j[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(t[2], j[2], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(t[3], j[3])
    jtr, jte = JDS.build_digits_data(batch_size=64, seed=9)
    ttr, tte = TDS.build_digits_data(batch_size=64, seed=9)
    for a, b in ((ttr, jtr), (tte, jte)):
        tb, jb = _batches(a), _batches(b)
        assert len(tb) == len(jb)
        for (xa, ya), (xb, yb) in zip(tb, jb):
            np.testing.assert_allclose(xa, xb, atol=1e-6, rtol=0)
            np.testing.assert_array_equal(ya, yb)


def _jax_synth10_draws(key, n, size):
    """The random numbers of ``synth10_batch(key, n, size)``, drawn exactly
    as it draws them."""
    ks = jax.random.split(key, 14)

    def u(k, lo, hi, shape=(n, 1, 1)):
        return jax.random.uniform(k, shape, minval=lo, maxval=hi)

    d = dict(y=jax.random.randint(ks[0], (n,), 0, 10),
             cx=u(ks[1], -5, 5), cy=u(ks[2], -5, 5),
             scale=u(ks[3], 0.75, 1.25), rot_full=u(ks[4], 0.0, 2 * np.pi),
             rot_lim=u(ks[5], -0.35, 0.35), phase=u(ks[6], 0.0, 2 * np.pi),
             fg=u(ks[7], 0.45, 1.0, (n, 1, 1, 3)),
             f1=u(ks[8], 0.1, 0.5), f2=u(ks[9], 0.1, 0.5),
             p1=u(ks[10], 0, 2 * np.pi), p2=u(ks[11], 0, 2 * np.pi),
             noise=jax.random.normal(ks[12], (n, size, size, 3)))
    return {k: np.asarray(v) for k, v in d.items()}


def test_synth10_render_matches_jax():
    n, size = 64, 32
    key = jax.random.PRNGKey(7)
    jx, jy = (np.asarray(a) for a in JRD.synth10_batch(key, n, size))
    tx, ty = TRD.synth10_render(_jax_synth10_draws(key, n, size), size)
    assert tx.dtype == torch.float32 and ty.dtype == torch.int32
    np.testing.assert_array_equal(ty.numpy(), jy)
    assert len(set(jy.tolist())) >= 8
    np.testing.assert_allclose(tx.numpy(), jx, atol=1e-5, rtol=0)
    # the port's own draws: same shapes and value ranges, seeded
    a = TRD.synth10_test_arrays(n, seed=3)
    b = TRD.synth10_test_arrays(n, seed=3)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[0].shape == (n, size, size, 3) and a[1].max() <= 9
    assert abs(float(a[0].mean()) - float(jx.mean())) < 0.5
    tr, te = TDS.build_synth10_data(batch_size=16, n_train=32, n_test=16)
    assert len(tr) == 2 and len(te) == 1


# ---------------------------------------------------------------------------
# raw params, eval, golden logits
# ---------------------------------------------------------------------------

def test_raw_params_npz_roundtrip(tmp_path):
    st = _state()
    raw = JI.params_from_numpy(_np(dict(ssq.models.resnet.init_params(
        jax.random.PRNGKey(0), st["g"]))), "cpu")
    path = str(tmp_path / "raw.npz")
    TT.save_raw_params(path, raw)
    got = TT.load_raw_params(path, device="cpu")
    want = JT.load_raw_params(path)
    assert set(got) == set(want) == set(raw)
    for name, p in raw.items():
        assert set(got[name]) == set(p)
        torch.testing.assert_close(got[name]["w"], p["w"], rtol=0, atol=0)
        np.testing.assert_array_equal(got[name]["w"].numpy(),
                                      np.asarray(want[name]["w"]))
        for k, v in p.get("bn", {}).items():
            np.testing.assert_array_equal(got[name]["bn"][k].numpy(),
                                          v.numpy())


@pytest.fixture(scope="module")
def sim_state():
    """The tiny model calibrated in the JAX package and carried across,
    with a few labelled batches."""
    st = _state()
    cfg = ssq.QuantConfig(n_bits_w=2, n_bits_a=4, w_scale_method="max",
                          use_8bit_head_stem=False)
    wflags = JG.Flags().all_weights(st["g"])
    st["qs"] = ssq.calibrate_acts(st["g"], st["params"], st["qs"],
                                  jnp.asarray(st["cali"][:32]), cfg,
                                  flags=wflags)
    st["tqs"] = JI.qstate_from_numpy(_np(st["qs"]), "cpu")
    st["jflags"] = JQZ.act_flags(st["g"], cfg, base=wflags)
    st["tflags"] = TG.Flags(weight_on=st["jflags"].weight_on,
                            act_on=st["jflags"].act_on)
    rng = np.random.default_rng(2)
    st["data"] = [(rng.normal(size=(n, 8, 8, 3)).astype(np.float32),
                   rng.integers(0, 4, n).astype(np.int32))
                  for n in (24, 24, 13)]
    return st


def test_validate_model_matches_jax(sim_state):
    st = sim_state
    for flags in ("fp", "sim"):
        jf = JG.Flags() if flags == "fp" else st["jflags"]
        tf = TG.Flags() if flags == "fp" else st["tflags"]
        jacc, jlog = JEV.validate_model(st["g"], st["params"], st["qs"],
                                        st["data"], jf, topk=(1, 3),
                                        return_logits=True)
        tacc, tlog = TEV.validate_model(st["gt"], st["tparams"], st["tqs"],
                                        st["data"], tf, topk=(1, 3),
                                        return_logits=True)
        assert tacc == jacc and set(tacc) == {"top1", "top3"}
        assert isinstance(tlog, np.ndarray) and tlog.shape == (61, 4)
        np.testing.assert_allclose(tlog, np.asarray(jlog), rtol=1e-5,
                                   atol=1e-5)
    assert TEV.validate_model(st["gt"], st["tparams"], st["tqs"], st["data"],
                              st["tflags"], topk=(1, 3), max_batches=1) \
        == JEV.validate_model(st["g"], st["params"], st["qs"], st["data"],
                              st["jflags"], topk=(1, 3), max_batches=1)


def test_golden_logits_read_across_packages(sim_state, tmp_path):
    st = sim_state
    _, jlog = JEV.validate_model(st["g"], st["params"], st["qs"], st["data"],
                                 st["jflags"], topk=(1, 3),
                                 return_logits=True)
    _, tlog = TEV.validate_model(st["gt"], st["tparams"], st["tqs"],
                                 st["data"], st["tflags"], topk=(1, 3),
                                 return_logits=True)
    jpath, tpath = str(tmp_path / "j" / "g.npz"), str(tmp_path / "t" / "g.npz")
    assert JEV.golden_logit_mse(np.asarray(jlog), jpath,
                                save_if_missing=True) is None
    assert TEV.golden_logit_mse(tlog, tpath, save_if_missing=True) is None
    assert TEV.golden_logit_mse(tlog, jpath) <= 1e-8
    assert JEV.golden_logit_mse(np.asarray(jlog), tpath) <= 1e-8
    with pytest.raises(FileNotFoundError):
        TEV.golden_logit_mse(tlog, str(tmp_path / "missing.npz"))


def test_get_train_samples(sim_state):
    data = sim_state["data"]
    t = TEV.get_train_samples(data, 30, device="cpu")
    j = JEV.get_train_samples(data, 30)
    assert torch.is_tensor(t) and t.shape == (30, 8, 8, 3)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert TEV.get_train_samples(data, 100, device="cpu").shape[0] == 61


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _every_quantizer_qstate():
    g = torch.Generator().manual_seed(0)
    w = torch.randn(4, 3, 3, 3, generator=g)
    qp = QParams(delta=torch.full((4, 1), 0.5), zero_point=torch.ones(4, 1),
                 n_bits=2, sym=False)
    fused = TW.init_shifted_scale(qp, w, (0.5, 1.0), dequant="effective")
    baked = TW.shifted_to_baked(dataclasses.replace(fused, hard_targets=True))
    wqs = {"uniform": TW.UniformWQ(qp=qp),
           "adaround": TW.init_adaround(qp, w),
           "baked": baked,
           "shifted": fused,
           "twophase": TW.init_shifted_scale_twophase(qp, w, (0.5, 1.0)),
           "inp_scale": TW.init_inp_scale(qp, torch.zeros(4, 1), w)}
    qs = {n: TG.UnitQuant(wq=wq, aq=QParams(torch.tensor(0.25),
                                            torch.tensor(3.0), 4, False),
                          alpha_out=torch.rand(4, generator=g),
                          beta_out=torch.rand(4, generator=g),
                          raw_zp=torch.ones(4, 1))
          for n, wq in wqs.items()}
    qs["uniform"] = dataclasses.replace(qs["uniform"], aq=None,
                                        alpha_out=None, beta_out=None,
                                        raw_zp=None)
    qs["block"] = QParams(torch.tensor(0.125), torch.tensor(0.0), 4, False)
    qs["none"] = None
    return qs


def _assert_same_tree(a, b):
    if torch.is_tensor(b):
        assert torch.is_tensor(a) and a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    elif isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _assert_same_tree(a[k], b[k])
    elif dataclasses.is_dataclass(b):
        assert type(a) is type(b)
        for f in dataclasses.fields(b):
            _assert_same_tree(getattr(a, f.name), getattr(b, f.name))
    else:
        assert a == b


def test_checkpoint_roundtrips_every_quantizer(tmp_path):
    qs = _every_quantizer_qstate()
    path = str(tmp_path / "sub" / "QNN_W2_A4")
    assert not TCK.exists(path)
    TCK.save_qstate(path, qs, done=["a", "b"])
    assert TCK.exists(path)
    with open(path + ".pkl", "rb") as f:
        payload = pickle.load(f)
    assert set(payload) == {"qstate", "done"}
    host = TQZ.to_numpy(qs)
    stack = [payload["qstate"]]
    while stack:                 # no tensor is pickled, only numpy arrays
        v = stack.pop()
        assert not torch.is_tensor(v)
        if isinstance(v, dict):
            stack.extend(v.values())
        elif dataclasses.is_dataclass(v):
            stack.extend(getattr(v, f.name) for f in dataclasses.fields(v))
    assert isinstance(host["baked"].wq.st_index, np.ndarray)
    got, done = TCK.load_qstate(path, device="cpu")
    assert done == ["a", "b"]
    _assert_same_tree(got, qs)
    TCK.save_qstate(path, got)
    assert TCK.load_qstate(path, device="cpu")[1] == []


# ---------------------------------------------------------------------------
# logging
# ---------------------------------------------------------------------------

def test_logging_matches_jax(tmp_path, monkeypatch):
    jm, tm = JLOG.AverageMeter("loss", ":.3f"), TLOG.AverageMeter("loss",
                                                                   ":.3f")
    for v, n in ((1.0, 2), (4.0, 1)):
        jm.update(v, n)
        tm.update(v, n)
    assert str(tm) == str(jm) == "loss 4.000 (2.000)"
    log = TLOG.RunLog(str(tmp_path / "logs" / "run.log"))
    log.append("fused,resnet18,W2A4", {"top1": 1.5})
    line = open(tmp_path / "logs" / "run.log").read()
    assert line.endswith(':fused,resnet18,W2A4: {"top1": 1.5}\n')
    monkeypatch.delenv("SSQ_WEBHOOK_URL", raising=False)
    assert TLOG.notify("x") is False
    t = TLOG.Timer()
    assert 0 <= t.lap() < 60
    assert os.path.exists(tmp_path / "logs")
