"""FP training: produces trained raw params for PTQ (PyTorch port of
``shiftedscalequantization_tpu/train.py``).

SGD with Nesterov momentum on a warmup-cosine schedule, batch-stats
BatchNorm, label-smoothed cross-entropy, over the same graph IR and
raw-param schema as the PTQ pipeline ({'w', 'b'?, 'bn': {gamma, beta,
mean, var}} per unit), so a trained model flows into prepare_model
unchanged. The npz layout is the JAX trainer's (``"<unit>/w"``,
``"<unit>/b"``, ``"<unit>/bn/<stat>"``): weights trained by either package
load in the other.

Training runs in float32 with TF32 off (``graph._fp32``), forward and
backward, so the card can be held to the CPU. The JAX trainer's
``lax.scan`` over a chunk of steps only amortized the TPU's dispatch
cost; here a chunk is the logging and eval interval and each step is
issued from Python.

    python -m shiftedscalequantization_tpu_torch.train --arch resnet18 \\
        --dataset synth10 --steps 6000            # on the card
    ... --platform cpu                            # on the CPU
"""
from __future__ import annotations

import json
import math

import numpy as np
import torch
import torch.nn.functional as F

from ._device import resolve_device
from .fold_bn import BN_EPS
from .graph import OpSpec, UnitSpec, _activation, _fp32, conv2d, \
    global_avg_pool, linear, max_pool

BN_MOMENTUM = 0.1    # torch default: running = (1-m)*running + m*batch


# ---------------------------------------------------------------------------
# Param partitioning: trainable leaves vs BN running stats
# ---------------------------------------------------------------------------

def split_params(raw: dict):
    """raw {unit: {'w','b'?,'bn'?}} -> (trainable, bn_state).

    trainable: w, b, bn gamma/beta. bn_state: running mean/var. The
    tensors are raw's own, not copies.
    """
    trainable, bn_state = {}, {}
    for name, p in raw.items():
        t = {"w": p["w"]}
        if "b" in p:
            t["b"] = p["b"]
        if "bn" in p:
            t["gamma"] = p["bn"]["gamma"]
            t["beta"] = p["bn"]["beta"]
            bn_state[name] = {"mean": p["bn"]["mean"], "var": p["bn"]["var"]}
        trainable[name] = t
    return trainable, bn_state


def merge_params(trainable: dict, bn_state: dict) -> dict:
    """Inverse of split_params — rebuilds the raw-param schema."""
    raw = {}
    for name, t in trainable.items():
        p = {"w": t["w"]}
        if "b" in t:
            p["b"] = t["b"]
        if name in bn_state:
            p["bn"] = {"gamma": t["gamma"], "beta": t["beta"],
                       "mean": bn_state[name]["mean"],
                       "var": bn_state[name]["var"]}
        raw[name] = p
    return raw


# ---------------------------------------------------------------------------
# Train-mode forward (batch-stats BN)
# ---------------------------------------------------------------------------

def _unit_fwd(u: UnitSpec, trainable, bn_state, new_state, x, train: bool):
    p = trainable[u.name]
    if u.kind == "conv":
        out = conv2d(x, p["w"], p.get("b"), u.stride, u.padding, u.groups)
        axes = (0, 1, 2)
    else:
        out = linear(x, p["w"], p.get("b"))
        axes = (0,)
    if u.name in bn_state:
        if train:
            mean = out.mean(axes)
            var = out.var(axes, unbiased=False)   # biased, for normalization
            cnt = int(np.prod([out.shape[a] for a in axes]))
            unbiased = var.detach() * cnt / max(cnt - 1, 1)
            old = bn_state[u.name]
            new_state[u.name] = {
                "mean": (1 - BN_MOMENTUM) * old["mean"]
                + BN_MOMENTUM * mean.detach(),
                "var": (1 - BN_MOMENTUM) * old["var"]
                + BN_MOMENTUM * unbiased}
        else:
            mean = bn_state[u.name]["mean"]
            var = bn_state[u.name]["var"]
        out = (out - mean) * torch.rsqrt(var + BN_EPS)
        out = out * p["gamma"] + p["beta"]
    return _activation(u.activation, out)


def forward_train(graph, trainable, bn_state, x, train: bool = True):
    """Returns (logits, updated bn_state). Functional: neither argument is
    changed. Convs and matmuls run in float32 with TF32 off; a caller that
    differentiates keeps ``graph._fp32()`` around its backward too."""
    new_state = dict(bn_state)
    out = x
    with _fp32():
        for node in graph:
            if isinstance(node, OpSpec):
                if node.op == "maxpool":
                    out = max_pool(out, node.window, node.stride,
                                   node.padding)
                elif node.op == "gap":
                    out = global_avg_pool(out)
                elif node.op == "flatten":
                    out = out.reshape(out.shape[0], -1)
                else:
                    raise ValueError(node.op)
            elif isinstance(node, UnitSpec):
                out = _unit_fwd(node, trainable, bn_state, new_state, out,
                                train)
            else:  # BlockSpec
                residual = out
                if node.downsample is not None:
                    residual = _unit_fwd(node.downsample, trainable,
                                         bn_state, new_state, out, train)
                h = out
                for u in node.units:
                    h = _unit_fwd(u, trainable, bn_state, new_state, h,
                                  train)
                if node.residual:
                    h = h + residual
                out = _activation(node.post_activation, h)
    return out, new_state


# ---------------------------------------------------------------------------
# Optimizer + train loop
# ---------------------------------------------------------------------------

def warmup_cosine(lr: float, total_steps: int, warmup: int = 200):
    """The learning rate at each step count, as
    ``optax.warmup_cosine_decay_schedule(0, lr, w, total_steps)`` with
    w = min(warmup, max(total_steps // 10, 1)) gives it: linear from 0 over
    w steps, then cosine to 0 at total_steps, 0 after."""
    w = min(warmup, max(total_steps // 10, 1))
    decay = total_steps - w
    if not decay > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay}.")

    def lr_at(count: int) -> float:
        if count < w:
            return (0.0 - lr) * (1 - count / w) + lr
        c = min(count - w, decay)
        return lr * (0.5 * (1 + math.cos(math.pi * c / decay)))
    return lr_at


def make_optimizer(trainable: dict, lr: float, total_steps: int,
                   momentum: float = 0.9, weight_decay: float = 5e-4,
                   warmup: int = 200):
    """SGD with Nesterov momentum over ``trainable``'s tensors, weight decay
    on the weights ('w') only, and a LambdaLR on ``warmup_cosine``.
    Returns (optimizer, scheduler); call ``scheduler.step()`` after each
    ``optimizer.step()``.

    As the JAX trainer's optax chain, the step with count c runs at the
    rate of count c, so step 0 runs at lr 0: parameters stay, while the
    momentum buffer takes that step's gradient (plus decay)."""
    decayed = [t["w"] for t in trainable.values()]
    rest = [t[k] for t in trainable.values() for k in t if k != "w"]
    opt = torch.optim.SGD(
        [{"params": decayed, "weight_decay": weight_decay},
         {"params": rest, "weight_decay": 0.0}],
        lr=lr, momentum=momentum, nesterov=True)
    lr_at = warmup_cosine(lr, total_steps, warmup)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda c: lr_at(c) / lr if lr else 0.0)
    return opt, sched


def smoothed_cross_entropy(logits, y, label_smooth: float = 0.1):
    """Mean cross-entropy with uniform label smoothing: the JAX trainer's
    ``(1-e)·CE - e·mean(log_softmax)`` over batch and classes."""
    return F.cross_entropy(logits, y.long(), label_smoothing=label_smooth)


def train_step(graph, trainable, bn_state, opt, sched, x, y,
               label_smooth: float = 0.1):
    """One optimizer step on the batch (x NHWC, y). Updates ``trainable``
    in place through ``opt``; returns (new bn_state, loss, train accuracy)
    with loss and accuracy as 0-d tensors on the device."""
    with _fp32():
        logits, new_state = forward_train(graph, trainable, bn_state, x,
                                          True)
        loss = smoothed_cross_entropy(logits, y, label_smooth)
        opt.zero_grad(set_to_none=True)
        loss.backward()
    opt.step()
    sched.step()
    acc = (logits.detach().argmax(-1) == y).float().mean()
    return new_state, loss.detach(), acc


def train_model(graph, raw_params: dict, data_fn, steps: int, lr: float,
                generator: torch.Generator, chunk: int = 100,
                weight_decay: float = 5e-4, label_smooth: float = 0.1,
                eval_fn=None, eval_every: int = 1000, log=print,
                device="cuda"):
    """Train; data_fn(generator) -> (x NHWC, y) on ``device``. Returns
    trained raw params (new tensors; ``raw_params`` is not changed).

    Runs whole chunks: ceil(steps / chunk) * chunk steps, past the
    schedule's end at lr 0 (the BN running stats keep moving), as the JAX
    trainer does."""
    dev = resolve_device(device)
    trainable, bn_state = split_params(raw_params)
    trainable = {n: {k: v.detach().to(dev, copy=True).requires_grad_()
                     for k, v in t.items()} for n, t in trainable.items()}
    bn_state = {n: {k: v.detach().to(dev, copy=True) for k, v in s.items()}
                for n, s in bn_state.items()}
    opt, sched = make_optimizer(trainable, lr, steps,
                                weight_decay=weight_decay)
    done = 0
    while done < steps:
        losses, accs = [], []
        for _ in range(chunk):
            x, y = data_fn(generator)
            bn_state, loss, acc = train_step(graph, trainable, bn_state, opt,
                                             sched, x, y, label_smooth)
            losses.append(loss)
            accs.append(acc)
        done += chunk
        mean_loss = float(torch.stack(losses).mean())
        log(f"step {done}/{steps} loss {mean_loss:.4f} "
            f"train-acc {float(torch.stack(accs).mean()) * 100:.2f}%")
        if eval_fn is not None and (done % eval_every == 0 or done >= steps):
            acc = eval_fn(trainable, bn_state)
            log(f"  test top-1: {acc:.2f}%")
    return merge_params({n: {k: v.detach() for k, v in t.items()}
                         for n, t in trainable.items()}, bn_state)


def eval_accuracy(graph, trainable, bn_state, x_test, y_test,
                  batch: int = 500, device="cuda") -> float:
    """Top-1 (percent) in eval mode (running BN stats), in batches."""
    dev = resolve_device(device)
    n = x_test.shape[0]
    correct = 0
    with torch.no_grad():
        for i in range(0, n, batch):
            xb = torch.as_tensor(x_test[i:i + batch], device=dev)
            yb = torch.as_tensor(y_test[i:i + batch], device=dev)
            logits, _ = forward_train(graph, trainable, bn_state, xb,
                                      train=False)
            correct += int((logits.argmax(-1) == yb).sum())
    return 100.0 * correct / n


# ---------------------------------------------------------------------------
# Raw-param (pre-fold) checkpoint IO
# ---------------------------------------------------------------------------

def save_raw_params(path: str, raw: dict):
    """Write a raw-params dict of tensors or arrays to ``path`` (npz)."""
    def host(a):
        return a.detach().cpu().numpy() if torch.is_tensor(a) \
            else np.asarray(a)

    flat = {}
    for name, p in raw.items():
        flat[f"{name}/w"] = host(p["w"])
        if "b" in p:
            flat[f"{name}/b"] = host(p["b"])
        if "bn" in p:
            for k, v in p["bn"].items():
                flat[f"{name}/bn/{k}"] = host(v)
    np.savez(path, **flat)


def load_raw_params(path: str, device="cuda") -> dict:
    """Read an npz of raw params into a dict of tensors on ``device``."""
    dev = resolve_device(device)
    raw: dict = {}
    with np.load(path) as f:
        for key in f.files:
            parts = key.split("/")
            name = parts[0]
            raw.setdefault(name, {})
            t = torch.as_tensor(f[key], device=dev)
            if parts[1] == "bn":
                raw[name].setdefault("bn", {})[parts[2]] = t
            else:
                raw[name][parts[1]] = t
    return raw


# ---------------------------------------------------------------------------
# Data plumbing for the two datasets
# ---------------------------------------------------------------------------

def digits_draws(generator: torch.Generator, batch: int, n: int, shape):
    """The random numbers of one augmented digits batch, on the
    generator's device: row indices, the +-2 px offsets, the noise."""
    dev = generator.device
    idx = torch.randint(0, n, (batch,), generator=generator, device=dev)
    off = torch.randint(0, 5, (batch, 2), generator=generator, device=dev)
    noise = torch.randn((batch, *shape), generator=generator, device=dev)
    return idx, off, noise


def digits_apply(x_train, y_train, idx, off, noise):
    """The digits augmentation on given draws (pure): rows ``idx``, each
    shifted by ``off - 2`` px in (h, w) with zero fill, plus 0.05 x
    ``noise``."""
    x, y = x_train[idx], y_train[idx]
    h, w = x.shape[1:3]
    xp = F.pad(x, (0, 0, 2, 2, 2, 2))
    rows = off[:, 0, None] + torch.arange(h, device=x.device)     # (B, h)
    cols = off[:, 1, None] + torch.arange(w, device=x.device)     # (B, w)
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    x = xp[b, rows[:, :, None], cols[:, None, :]]
    return x + 0.05 * noise, y


def make_data_fn(dataset: str, batch: int, train_arrays=None):
    """Returns data_fn(generator) -> (x, y) on the generator's device:
    synth10 drawn and rendered there; digits augmented from
    ``train_arrays`` (tensors on that device)."""
    if dataset == "synth10":
        from .data.realdata import synth10_draws, synth10_render
        return lambda g: synth10_render(synth10_draws(batch, generator=g))
    if dataset == "digits":
        x_train, y_train = train_arrays
        n = x_train.shape[0]

        def fn(g):
            return digits_apply(x_train, y_train,
                                *digits_draws(g, batch, n, x_train.shape[1:]))
        return fn
    raise ValueError(f"no on-device trainer for dataset {dataset!r}")


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="FP training")
    ap.add_argument("--arch", default="resnet18")
    ap.add_argument("--dataset", default="synth10",
                    choices=["synth10", "digits"])
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--weight_decay", type=float, default=5e-4)
    ap.add_argument("--seed", type=int, default=1005)
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--eval_every", type=int, default=1000)
    ap.add_argument("--out", default="trained_{arch}_{dataset}.npz")
    ap.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                    help="auto: the card (cuda:0; raises without one); cpu: "
                         "the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.platform == "cpu" else "cuda:0")

    from .models import zoo
    graph, _ = zoo.build(args.arch, num_classes=10, dataset="cifar10")
    # drawn on the CPU, as the JAX trainer does its set-up: the card and
    # the CPU start from the same weights (train_model copies them over)
    raw = zoo.init_params(graph, seed=args.seed, device="cpu")
    if args.dataset == "digits":
        from .data.realdata import digits_arrays
        x_tr, y_tr, x_te, y_te = digits_arrays()
        train_arrays = (torch.as_tensor(x_tr, device=dev),
                        torch.as_tensor(y_tr, device=dev))
    else:
        from .data.realdata import synth10_test_arrays
        x_te, y_te = synth10_test_arrays()
        train_arrays = None
    x_te_d = torch.as_tensor(x_te, device=dev)
    y_te_d = torch.as_tensor(y_te, device=dev)

    data_fn = make_data_fn(args.dataset, args.batch_size, train_arrays)
    eval_fn = lambda tr, bs: eval_accuracy(graph, tr, bs, x_te_d,  # noqa
                                           y_te_d, device=dev)
    trained = train_model(
        graph, raw, data_fn, args.steps, args.lr,
        torch.Generator(device=dev).manual_seed(args.seed + 1),
        chunk=args.chunk, weight_decay=args.weight_decay, eval_fn=eval_fn,
        eval_every=args.eval_every, device=dev)
    final = eval_fn(*split_params(trained))
    out = args.out.format(arch=args.arch, dataset=args.dataset)
    save_raw_params(out, trained)
    print(json.dumps({"arch": args.arch, "dataset": args.dataset,
                      "steps": args.steps, "fp_top1": final, "out": out}))
    return final


if __name__ == "__main__":
    main()
