"""PyTorch port vs the JAX package: the FP trainer (``train.py``) on the
CPU, on tests/test_torch_port_recon.py's tiny model (8x8 input, width 8:
stem, one basic block, gap, fc with a bias), from one set of weights
drawn by the JAX package.

Tolerances: forward logits and BN state 1e-5 (f32, summation order); the
schedule 1e-7 absolute (optax computes it in f32); the loss 1e-6
relative; five steps of ``train_model`` 1e-4 relative L2 per tensor (the
two frameworks sum the gradients in other orders); the digits
augmentation and the eval top-1 exactly.
"""
import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from shiftedscalequantization_tpu import train as JT
from shiftedscalequantization_tpu.models import resnet as JR
from shiftedscalequantization_tpu_torch import train as TT
from test_torch_port_recon import _jax_tiny_graph, _port_graph

RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _t(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _assert_trees(jtree, ttree, rtol):
    """Same keys; each leaf within rtol relative L2 of the JAX one."""
    flat_j = jax.tree_util.tree_flatten_with_path(jtree)[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda a: a.detach().numpy(), ttree))[0])
    assert {p for p, _ in flat_j} == set(flat_t)
    for path, a in flat_j:
        a, b = np.asarray(a), flat_t[path]
        err = np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)
        assert err <= rtol, (jax.tree_util.keystr(path), err)


@pytest.fixture(scope="module")
def tiny():
    g = _jax_tiny_graph()
    raw = JR.init_params(jax.random.PRNGKey(0), g)
    # a trained-looking BN state and a non-zero fc bias
    rng = np.random.default_rng(3)
    for name, p in raw.items():
        if "bn" in p:
            c = p["w"].shape[0]
            p["bn"] = {"gamma": jnp.asarray(rng.uniform(0.5, 1.5, c),
                                            jnp.float32),
                       "beta": jnp.asarray(rng.normal(0, 0.1, c), jnp.float32),
                       "mean": jnp.asarray(rng.normal(0, 0.2, c), jnp.float32),
                       "var": jnp.asarray(rng.uniform(0.5, 2.0, c),
                                          jnp.float32)}
        else:
            p["b"] = jnp.asarray(rng.normal(0, 0.1, p["w"].shape[0]),
                                 jnp.float32)
    x = rng.normal(size=(16, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, 16).astype(np.int32)
    return dict(g=g, gt=_port_graph(g), raw=raw, x=x, y=y)


def test_split_merge_round_trip(tiny):
    jtr, jbs = JT.split_params(tiny["raw"])
    ttr, tbs = TT.split_params(_t(tiny["raw"]))
    _assert_trees(jtr, ttr, 0.0)
    _assert_trees(jbs, tbs, 0.0)
    assert "b" in ttr["model.fc"] and "model.fc" not in tbs
    _assert_trees(tiny["raw"], TT.merge_params(ttr, tbs), 0.0)
    # the tensors are the raw dict's own
    traw = _t(tiny["raw"])
    assert TT.split_params(traw)[0]["model.conv1"]["w"] \
        is traw["model.conv1"]["w"]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_train_matches_jax(tiny, train):
    jtr, jbs = JT.split_params(tiny["raw"])
    jl, jns = JT.forward_train(tiny["g"], jtr, jbs, jnp.asarray(tiny["x"]),
                               train)
    ttr, tbs = TT.split_params(_t(tiny["raw"]))
    before = {k: {s: v.clone() for s, v in d.items()} for k, d in tbs.items()}
    tl, tns = TT.forward_train(tiny["gt"], ttr, tbs,
                               torch.as_tensor(tiny["x"]), train)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-5, atol=1e-5)
    _assert_trees(jns, tns, 1e-5)
    # functional: the state handed in is unchanged
    for k, d in tbs.items():
        for s, v in d.items():
            assert torch.equal(v, before[k][s])
    if train:
        assert not torch.equal(tns["model.conv1"]["mean"],
                               tbs["model.conv1"]["mean"])
        assert not tns["model.conv1"]["var"].requires_grad


@pytest.mark.parametrize("total", [2, 7, 300, 2500])
def test_schedule_matches_optax(total):
    """The rate of every step of a run, step 0 (lr 0) included and past
    the end, read back from the optimizer as train_model steps it."""
    lr = 0.1
    ref = optax.warmup_cosine_decay_schedule(
        0.0, lr, min(200, max(total // 10, 1)), total)
    counts = np.arange(total + 5)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(counts)))
    lr_at = TT.warmup_cosine(lr, total)
    np.testing.assert_allclose([lr_at(int(c)) for c in counts], want,
                               rtol=0, atol=1e-7)
    assert lr_at(0) == 0.0
    w = torch.zeros(3, requires_grad=True)
    opt, sched = TT.make_optimizer({"u": {"w": w}}, lr, total)
    seen = []
    for _ in counts:
        seen.append(opt.param_groups[0]["lr"])
        w.grad = torch.ones(3)
        opt.step()
        sched.step()
    np.testing.assert_allclose(seen, want, rtol=0, atol=1e-7)


def test_optimizer_matches_optax_chain():
    """Step 0 runs at lr 0 and still loads the momentum buffer; weight
    decay on 'w' only; Nesterov. Four steps of constant gradients against
    JAX's make_optimizer."""
    rng = np.random.default_rng(5)
    tree = {"u": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                  "b": rng.normal(size=4).astype(np.float32),
                  "gamma": rng.normal(size=4).astype(np.float32)}}
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape)
                          .astype(np.float32), tree) for _ in range(4)]
    tx = JT.make_optimizer(0.1, 20, weight_decay=0.05)
    jp = jax.tree.map(jnp.asarray, tree)
    st = tx.init(jp)
    tp = {"u": {k: torch.tensor(v, requires_grad=True)
                for k, v in tree["u"].items()}}
    opt, sched = TT.make_optimizer(tp, 0.1, 20, weight_decay=0.05)
    for i, gr in enumerate(grads):
        upd, st = tx.update(jax.tree.map(jnp.asarray, gr), st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, t in tp["u"].items():
            t.grad = torch.tensor(gr["u"][k])
        opt.step()
        sched.step()
        if i == 0:
            for k, t in tp["u"].items():
                assert np.array_equal(t.detach().numpy(), tree["u"][k])
                buf = opt.state[t]["momentum_buffer"].numpy()
                decay = 0.05 * tree["u"][k] if k == "w" else 0.0
                np.testing.assert_allclose(buf, gr["u"][k] + decay,
                                           rtol=1e-6)
        _assert_trees(jp, tp, 1e-6)


@pytest.mark.parametrize("smooth", [0.0, 0.1])
def test_loss_matches_jax(smooth):
    """The JAX trainer's loss_fn: (1-e)*CE - e*mean(log_softmax)."""
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 3, (16, 10)).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    lj = jnp.asarray(logits)
    want = optax.softmax_cross_entropy_with_integer_labels(
        lj, jnp.asarray(y)).mean()
    if smooth > 0:
        want = (1 - smooth) * want - smooth * jax.nn.log_softmax(lj).mean()
    got = TT.smoothed_cross_entropy(torch.as_tensor(logits),
                                    torch.as_tensor(y), smooth)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_train_model_matches_jax(tiny):
    """steps 5, chunk 2: both run 6 steps (the last past the schedule's
    end), log the same chunks, and end at the same params and BN state."""
    x, y = tiny["x"], tiny["y"]
    jlog, tlog = [], []
    jout = JT.train_model(tiny["g"], tiny["raw"],
                          lambda k: (jnp.asarray(x), jnp.asarray(y)), 5, 0.1,
                          jax.random.PRNGKey(1), chunk=2, log=jlog.append)
    traw = _t(tiny["raw"])
    tout = TT.train_model(tiny["gt"], traw,
                          lambda g: (torch.as_tensor(x), torch.as_tensor(y)),
                          5, 0.1, torch.Generator().manual_seed(1), chunk=2,
                          log=tlog.append, device="cpu")
    assert [s.split(" loss")[0] for s in tlog] \
        == [s.split(" loss")[0] for s in jlog] \
        == ["step 2/5", "step 4/5", "step 6/5"]
    _assert_trees(jout, tout, RTOL)
    moved = np.abs(tout["model.fc"]["b"].numpy()
                   - np.asarray(tiny["raw"]["model.fc"]["b"])).max()
    assert moved > 1e-3
    # the raw params handed in are unchanged
    _assert_trees(tiny["raw"], traw, 0.0)


def test_eval_accuracy_matches_jax(tiny):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(1100, 8, 8, 3)).astype(np.float32)
    jtr, jbs = JT.split_params(tiny["raw"])
    jl, _ = JT.forward_train(tiny["g"], jtr, jbs, jnp.asarray(x), False)
    y = np.asarray(jl).argmax(-1).astype(np.int32)
    y[::3] = (y[::3] + 1) % 4          # a third wrong: 66.63..%
    want = JT.eval_accuracy(tiny["g"], jtr, jbs, jnp.asarray(x),
                            jnp.asarray(y))
    ttr, tbs = TT.split_params(_t(tiny["raw"]))
    got = TT.eval_accuracy(tiny["gt"], ttr, tbs, x, y, device="cpu")
    assert got == want and 60 < got < 70


def test_digits_augmentation_on_jax_draws():
    """The port's digits batch from the random numbers JAX's data_fn draws
    (its split of the key in three) equals JAX's batch exactly."""
    rng = np.random.default_rng(4)
    n, batch = 40, 24
    x_tr = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    y_tr = rng.integers(0, 10, n).astype(np.int32)
    fn = JT.make_data_fn("digits", batch, (jnp.asarray(x_tr),
                                           jnp.asarray(y_tr)))
    key = jax.random.PRNGKey(11)
    jx, jy = fn(key)
    k1, k2, k3 = jax.random.split(key, 3)
    idx = jax.random.randint(k1, (batch,), 0, n)
    off = jax.random.randint(k2, (batch, 2), 0, 5)
    noise = jax.random.normal(k3, (batch, 32, 32, 3))
    tx, ty = TT.digits_apply(torch.as_tensor(x_tr), torch.as_tensor(y_tr),
                             *(torch.as_tensor(np.array(a))
                               for a in (idx, off, noise)))
    assert np.asarray(off).min() == 0 and np.asarray(off).max() == 4
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    # the port's own draws: shapes and ranges, on the generator's device
    g = torch.Generator().manual_seed(0)
    px, py = TT.make_data_fn("digits", batch, (torch.as_tensor(x_tr),
                                               torch.as_tensor(y_tr)))(g)
    assert px.shape == (batch, 32, 32, 3) and py.shape == (batch,)


def test_synth10_data_fn_draws_from_the_generator():
    """synth10 batches come from the generator handed in; the default
    CPU draws of synth10_draws are those of a generator seeded alike."""
    from shiftedscalequantization_tpu_torch.data import realdata as TRD
    fn = TT.make_data_fn("synth10", 8)
    a = fn(torch.Generator().manual_seed(5))
    b = fn(torch.Generator().manual_seed(5))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[0].shape == (8, 32, 32, 3) and a[1].dtype == torch.int32
    d0 = TRD.synth10_draws(8, seed=5)
    d1 = TRD.synth10_draws(8, generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(d0[k], d1[k]) for k in d0)
    assert torch.equal(TRD.synth10_render(d0)[0], a[0])


def test_port_trained_npz_loads_in_jax(tiny, tmp_path):
    """An npz written by the port's trainer reads in the JAX package with
    the same keys, and gives the same eval logits there."""
    x, y = tiny["x"], tiny["y"]
    tout = TT.train_model(tiny["gt"], _t(tiny["raw"]),
                          lambda g: (torch.as_tensor(x), torch.as_tensor(y)),
                          3, 0.1, torch.Generator(), chunk=3,
                          log=lambda s: None, device="cpu")
    path = tmp_path / "trained_tiny.npz"
    TT.save_raw_params(str(path), tout)
    jpath = tmp_path / "jax.npz"
    JT.save_raw_params(str(jpath), tiny["raw"])
    assert sorted(np.load(path).files) == sorted(np.load(jpath).files)
    jraw = JT.load_raw_params(str(path))
    jl, _ = JT.forward_train(tiny["g"], *JT.split_params(jraw),
                             jnp.asarray(x), False)
    tl, _ = TT.forward_train(tiny["gt"], *TT.split_params(tout),
                             torch.as_tensor(x), False)
    np.testing.assert_allclose(np.asarray(jl), tl.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    back = TT.load_raw_params(str(path), device="cpu")
    _assert_trees(jax.tree.map(lambda t: t.numpy(), tout), back, 0.0)


@pytest.mark.parametrize("dataset", ["synth10", "digits"])
def test_main_on_the_cpu(tiny, tmp_path, monkeypatch, capsys, dataset):
    """``main --platform cpu``: the JAX trainer's flags, its final JSON
    line and npz layout (the tiny graph with 10 classes, global-pooled so
    it takes 32x32 images, stands in for the model; for synth10, 64
    held-out images for the test set)."""
    from shiftedscalequantization_tpu_torch.data import realdata as TRD
    from shiftedscalequantization_tpu_torch.models import zoo as TZ
    gt = tiny["gt"][:-1] + (dataclasses.replace(tiny["gt"][-1], out_ch=10),)
    monkeypatch.setattr(TZ, "build", lambda arch, **kw: (gt, None))
    small = TRD.synth10_test_arrays(64, seed=2)
    monkeypatch.setattr(TRD, "synth10_test_arrays", lambda: small)
    out = tmp_path / "trained_{arch}_{dataset}.npz"
    top1 = TT.main(["--platform", "cpu", "--steps", "3", "--chunk", "2",
                    "--batch_size", "8", "--dataset", dataset, "--out",
                    str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("step 2/3 loss ") and len(lines) == 4
    last = json.loads(lines[-1])
    path = str(tmp_path / f"trained_resnet18_{dataset}.npz")
    assert last == {"arch": "resnet18", "dataset": dataset, "steps": 3,
                    "fp_top1": top1, "out": path}
    assert 0.0 <= top1 <= 100.0
    keys = set(np.load(path).files)
    assert keys == {f"{u}/{k}" for u in ("model.conv1", *
                                         (n.name for n in gt[1].units))
                    for k in ("w", "bn/gamma", "bn/beta", "bn/mean",
                              "bn/var")} | {"model.fc/w", "model.fc/b"}

