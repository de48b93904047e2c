"""Block reconstruction engine (PyTorch port of
``shiftedscalequantization_tpu/recon/engine.py:48-709``).

One reconstruction optimizes a node's quantizer logits (the theta dict)
with Adam against cached FP outputs, then hardens them:

  * mode 'fused': the paper's joint shift + round reconstruction, with the
    warm-start shift pre-solve (``warmstart_frac``) and the post-harden
    rounding-only refine (``post_round_frac``) for coarse candidate sets;
  * mode 'brecq': AdaRound, the rounding logits with the relaxation
    regularizer weighted by ``weight``;
  * mode 'shift': the selection alone on full fake-quant candidates (the
    warm start's pre-solve, and phase 1 of the pipeline's two-phase mode);
  * mode 'round': phase 2 of two-phase, AdaRound on the shift phase's
    selection baked into per-(oc, ic) steps;
  * mode 'round_refine': the rounding logits of baked AdaRound units.

``reconstruct_act_delta`` learns a node's activation steps (the BRECQ act
phase) with Adam and a cosine learning-rate schedule;
``reconstruct_act_shift`` learns a per-channel selection among shifted
activation steps at every act site of a node (``ops/act_quant``).

The loss is ``rec_loss``: 'mse' (the L_p loss) or the Fisher forms
'fisher_diag' / 'fisher_full', weighted by the gradients
``recon.capture.capture_grads`` caches (``cached_grads``), whose rows are
taken with the same indices as the input and output caches.

The loop is a plain Python loop with ``torch.optim.Adam(lr=s.lr)``, which
computes optax.adam's update (the same moments and bias corrections, eps
outside the square root). ``_chunked_scan`` and ``_canonicalize`` of the
JAX engine only cut TPU dispatch and compile costs and have no
counterpart. Minibatch rows come from ``torch.randperm(n, generator=g)`` of
a CPU generator seeded per node (``seed``), so the card and the CPU draw
the same rows; the JAX engine's ``fold_in(key, 877)`` / ``(key, 991)``
sub-streams of the warm start and the refine are ``_fold_in(seed, 877)`` /
``(seed, 991)``. The whole step runs with TF32 off (``graph._fp32``), its
backward included.

Data-parallel runs (``parallel/dist``). With ``s.grad_psum_axis`` set and
a ``mesh`` (``parallel.mesh.Mesh``) given, every loop averages the step's
gradients and its traced loss over that mesh axis between ``backward()``
and ``opt.step()``, through ``parallel.collectives.pmean_tree`` with the
wire ``s.grad_wire`` (the JAX engine's ``pmean_tree`` /
``lax.pmean``). Each rank then holds its own shard of the caches and
draws its rows from it (``ddp_reconstruct``), and the first-batch losses
are data rank 0's: its first rows are the set's first rows.
``split_rows`` (``sharded_reconstruct``) instead hands every rank the
whole caches and splits each step's drawn rows over the data axis. Over a
``model`` axis of more than one rank, theta and its Adam moments are
held as out-channel slices: each rank updates its slice, and the slices
are gathered before each forward. An axis without a mesh raises, as an
unbound axis name does under JAX; with the axis unset nothing changes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..graph import BlockSpec, Flags, UnitQuant, _fp32, apply_node, \
    apply_node_multi_capture, find_node, node_unit_names
from ..ops import quant as Q
from ..ops import wquant as W
from ..ops.act_quant import init_act_shift


@dataclasses.dataclass(frozen=True)
class ReconSettings:
    """Reconstruction hyperparameters (see the JAX ReconSettings for the
    meaning of each field)."""
    mode: str = "fused"
    iters: int = 20000
    batch_size: int = 32
    lr: float = 1e-3
    act_lr: float = 4e-4
    b_range: tuple = (20, 2)
    warmup: float = 0.2
    lmda_r: float = 0.01
    lmda_s: float = 0.1
    weight: float = 0.01
    p: Optional[float] = None
    shift_targets: tuple = (1.0 - 1.0 / 32, 1.0 + 1.0 / 32, 1.0)
    # fused candidate dequant: 'unit', 'effective', or 'auto' (effective
    # when max|st - 1| > 1/8)
    fused_dequant: str = "auto"
    opt_beta: bool = True
    opt_output_affine: bool = False
    grad_psum_axis: Optional[str] = None
    grad_wire: str = "f32"
    rec_loss: str = "mse"
    auto_candidates: bool = False
    act_p: float = 2.4
    post_round_frac: float = 0.5
    warmstart_frac: float = 0.0
    warmstart_freeze: bool = True
    warmstart_lr: Optional[float] = None
    act_shift_targets: tuple = (1.0, 0.5)


def lp_loss_cl(pred, tgt, p):
    """lp_loss on channels-last tensors: sum over the channel axis, mean
    over the rest."""
    return (torch.abs(pred - tgt) ** p).sum(dim=-1).mean()


def rec_loss_fn(pred, tgt, grad, kind: str, p: float):
    """Reconstruction loss forms (reference layer_recon.py:142-150),
    channels last: 'mse' is lp_loss_cl (also the fallback when ``grad``
    is None); 'fisher_diag' weights the squared error by grad^2;
    'fisher_full' by the per-row dot of |error| and |grad|, over 100."""
    if kind == "mse" or grad is None:
        return lp_loss_cl(pred, tgt, p)
    if kind == "fisher_diag":
        return (((pred - tgt) ** 2) * (grad ** 2)).sum(dim=-1).mean()
    if kind == "fisher_full":
        a = torch.abs(pred - tgt)
        g = torch.abs(grad)
        dot = (a * g).sum(dim=tuple(range(1, a.ndim))).reshape(
            (-1,) + (1,) * (a.ndim - 1))
        return (dot * a * g).mean() / 100.0
    raise ValueError(kind)


def resolve_dequant(dequant: str, shift_targets) -> str:
    """'auto' -> 'effective' for coarse candidate sets (max|st-1| > 1/8),
    'unit' for near-1 sets; 'unit'/'effective' pass through."""
    if dequant != "auto":
        return dequant
    return ("effective"
            if max(abs(float(t) - 1.0) for t in shift_targets) > 1.0 / 8
            else "unit")


def _skip_shift(qp, targets) -> bool:
    """8-bit units take plain AdaRound, no shift selection, when the
    candidate set is coarse; near-1 sets keep their selection."""
    return qp.n_bits >= 8 and \
        max(abs(float(t) - 1.0) for t in targets) > 1.0 / 8


def _init_quantizers(params, qstate, unit_names, s: ReconSettings,
                     warm_alphas=None):
    """Swap each unit's weight quantizer for the trainable form of
    ``s.mode`` and build the theta dict {unit: {name: tensor}} of what the
    loop optimizes. ``warm_alphas`` (fused warm start): unit name -> solved
    selection logits that re-seed that unit's alpha and beta."""
    qstate = dict(qstate)
    theta = {}
    for name in unit_names:
        uq: UnitQuant = qstate[name]
        w = params[name]["w"]
        qp = uq.wq.qp
        t = {}
        warm = bool(warm_alphas) and name in warm_alphas
        if s.mode == "fused":
            targets = W.rank_shift_candidates(qp, w) if s.auto_candidates \
                else s.shift_targets
            if _skip_shift(qp, targets):
                wq = W.init_adaround(qp, w)
                t["alpha"] = wq.alpha
            else:
                wq = W.init_shifted_scale(
                    qp, w, targets,
                    dequant=resolve_dequant(s.fused_dequant, targets))
                if warm:
                    wq = W.warmstart_alpha(wq, warm_alphas[name], w)
                    if s.warmstart_freeze:
                        # selection locked at the solved argmax
                        wq = dataclasses.replace(wq, hard_targets=True)
                if not (warm and s.warmstart_freeze):
                    t["alpha"] = wq.alpha
                if s.opt_beta:
                    t["beta"] = wq.beta
        elif s.mode == "brecq":
            wq = W.init_adaround(qp, w)
            t["alpha"] = wq.alpha
        elif s.mode == "shift":
            if _skip_shift(qp, s.shift_targets):
                wq = W.init_adaround(qp, w)
            else:
                wq = W.init_shifted_scale_twophase(qp, w, s.shift_targets)
            t["alpha"] = wq.alpha
        elif s.mode == "round":
            # phase 2 of two-phase: bake a hardened 'shift' quantizer, or
            # re-open an AdaRound one (8-bit units skipped the shift phase)
            prev = qstate[name].wq
            if isinstance(prev, W.AdaRoundWQ):
                wq = dataclasses.replace(prev, soft=True)
            else:
                wq = W.bake_shift_to_adaround(prev, w)
            t["alpha"] = wq.alpha
        elif s.mode == "round_refine":
            # post-harden refinement of a baked AdaRoundWQ: the selection
            # stays frozen, the rounding logits re-open
            wq = dataclasses.replace(qstate[name].wq, soft=True)
            t["alpha"] = wq.alpha
        else:
            raise ValueError(s.mode)
        if s.opt_output_affine:
            t["alpha_out"] = uq.alpha_out
            t["beta_out"] = uq.beta_out
        qstate[name] = dataclasses.replace(uq, wq=wq)
        theta[name] = t
    return qstate, theta


def _insert_theta(qstate, theta):
    """Write the theta tensors back into the units' quantizers."""
    qstate = dict(qstate)
    for name, t in theta.items():
        uq = qstate[name]
        wq = uq.wq
        if "alpha" in t:
            wq = dataclasses.replace(wq, alpha=t["alpha"])
        if "beta" in t:
            wq = dataclasses.replace(wq, beta=t["beta"])
        uq = dataclasses.replace(uq, wq=wq)
        if "alpha_out" in t:
            uq = dataclasses.replace(uq, alpha_out=t["alpha_out"],
                                     beta_out=t["beta_out"])
        qstate[name] = uq
    return qstate


def _harden(qstate, unit_names, mode):
    """Flip quantizers to hard rounding and selection. Fused
    effective-dequant quantizers become the baked AdaRoundWQ form."""
    qstate = dict(qstate)
    for name in unit_names:
        uq = qstate[name]
        wq = uq.wq
        if isinstance(wq, W.ShiftedScaleWQ):
            if wq.codes and wq.dequant == "effective":
                wq = W.shifted_to_baked(wq)
            else:
                wq = dataclasses.replace(wq, hard_targets=True,
                                         hard_round=wq.codes)
        elif isinstance(wq, W.AdaRoundWQ):
            wq = dataclasses.replace(wq, soft=False)
        qstate[name] = dataclasses.replace(uq, wq=wq)
    return qstate


def selection_ratios(qstate, unit_names):
    """Fraction of selection groups choosing each shift candidate:
    {unit: (S,) tensor}, for units with a shift selection."""
    out = {}
    for name in unit_names:
        wq = qstate[name].wq
        if isinstance(wq, W.ShiftedScaleWQ):
            idx = torch.argmax(wq.soft_targets(), dim=-1)
            n_s = len(wq.shift_targets)
        elif isinstance(wq, W.AdaRoundWQ) and wq.st_index is not None:
            idx, n_s = wq.st_index, len(wq.shift_targets)
        else:
            continue
        counts = torch.bincount(idx.reshape(-1), minlength=n_s)
        out[name] = counts.to(torch.float32) / idx.numel()
    return out


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _reg_terms(qstate, unit_names, step: float, s: ReconSettings):
    """Temperature-scheduled regularizers at ``step`` (a float), gated off
    before ``s.iters * s.warmup``. 'fused': the rounding regularizer at
    b(step) over iters plus the selection regularizer at b2(step) over a
    3/4 horizon; 'shift': the selection's entropy (AdaRound units: the
    rounding regularizer); 'brecq', 'round' and 'round_refine': the
    rounding regularizer, weighted by ``s.weight`` for brecq and
    ``s.lmda_r`` for the others. The
    temperatures are float32, as in the JAX engine, and reach the device
    as numbers (no host-to-device copy)."""
    gate = float(step >= s.iters * s.warmup)
    b = float(Q.linear_temp_decay(step, s.iters, s.warmup, s.b_range[0],
                                  s.b_range[1]))
    r = sreg = torch.zeros((), device=qstate[unit_names[0]].wq.qp.delta
                           .device)
    if s.mode == "fused":
        b2 = float(Q.linear_temp_decay(step, s.iters * 3 / 4, s.warmup,
                                       s.b_range[0], s.b_range[1]))
        for name in unit_names:
            wq = qstate[name].wq
            if isinstance(wq, W.AdaRoundWQ):   # high-bit shift-skip unit
                r = r + Q.round_regularizer(Q.rectified_sigmoid(wq.alpha),
                                            b)
                continue
            r = r + Q.round_regularizer(Q.rectified_sigmoid(wq.beta), b)
            sreg = sreg + Q.round_regularizer(wq.soft_targets(), b2)
        return gate * (s.lmda_r * r + s.lmda_s * sreg)
    if s.mode in ("brecq", "round", "round_refine"):
        for name in unit_names:
            r = r + Q.round_regularizer(
                Q.rectified_sigmoid(qstate[name].wq.alpha), b)
        return gate * (s.weight if s.mode == "brecq" else s.lmda_r) * r
    if s.mode == "shift":
        for name in unit_names:
            wq = qstate[name].wq
            if isinstance(wq, W.AdaRoundWQ):
                r = r + s.lmda_r * Q.round_regularizer(
                    Q.rectified_sigmoid(wq.alpha), b)
                continue
            p = wq.soft_targets()
            r = r + s.lmda_s * -(p * torch.log(p + 1e-10)).sum()
        return gate * r
    raise ValueError(s.mode)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def _fold_in(seed: int, data: int) -> int:
    """A new seed from (seed, data), for the sub-streams of one node."""
    return int(np.random.SeedSequence([seed, data]).generate_state(
        1, np.uint64)[0] >> 1)


def _eval_rec(node, params, qstate, flags, xb, yb, gb, s, p_norm):
    with torch.no_grad():
        pred = apply_node(node, params, qstate, xb, flags)
        return rec_loss_fn(pred, yb, gb, s.rec_loss, p_norm)


def _rows(seed: int, n: int, batch: int, iters: int, device):
    """Every step's minibatch rows, drawn in order from a CPU generator
    seeded with ``seed`` (the card and the CPU draw the same) and copied
    to ``device`` once."""
    gen = torch.Generator().manual_seed(seed)
    return torch.stack([torch.randperm(n, generator=gen)[:batch]
                        for _ in range(iters)]).to(device)


def _grad_mean(s: ReconSettings, mesh):
    """The average over ``mesh``'s axis ``s.grad_psum_axis`` of a tree of
    gradients and losses, with the wire ``s.grad_wire``; None when the
    axis is unset."""
    if s.grad_psum_axis is None:
        if mesh is not None:
            raise ValueError("a mesh was given but s.grad_psum_axis is unset")
        return None
    if mesh is None:
        raise ValueError(f"grad_psum_axis {s.grad_psum_axis!r} is set but "
                         f"no mesh binds it")
    from ..parallel.collectives import pmean_tree
    group = mesh.group(s.grad_psum_axis)
    return lambda tree: pmean_tree(tree, group, s.grad_wire)


def _step(loss, trace_loss, leaves, mean):
    """Backward of ``loss``; with ``mean``, the gradients and the traced
    loss averaged over the ranks. Returns the traced loss to record."""
    loss.backward()
    if mean is None:
        return trace_loss.detach()
    grads, trace_loss = mean(([p.grad if p.grad is not None
                               else torch.zeros_like(p) for p in leaves],
                              trace_loss.detach()))
    for p, g in zip(leaves, grads):
        p.grad = g
    return trace_loss


def reconstruct_node(graph, params, qstate, node_name: str, cached_inp,
                     cached_out, s: ReconSettings, seed: int = 0,
                     cached_grads=None, mesh=None, split_rows: bool = False):
    """Reconstruct one node from its cached (input, FP output) rows; the
    node runs where the caches lie. ``cached_grads`` (capture_grads, one
    row per cached row) weights the Fisher loss forms; without them every
    form is 'mse'. Returns (new_qstate, metrics):
    ``rec_trace`` (the reconstruction loss of each step, a tensor),
    ``init_loss`` (the loss of the incoming quantizers), ``soft_loss`` and
    ``hard_loss`` on the first batch, ``selection_ratio`` and, when they
    ran, ``warmstart`` and the refine's ``hard_loss_prerefine`` /
    ``refine_trace``.

    ``mesh`` and ``split_rows``: the data-parallel run (module doc).
    Without ``split_rows`` this rank's caches are its shard and its
    first-batch losses are data rank 0's."""
    if s.mode not in ("fused", "brecq", "shift", "round", "round_refine"):
        raise ValueError(f"reconstruction mode {s.mode!r}")
    node = find_node(graph, node_name)
    is_block = isinstance(node, BlockSpec)
    unit_names = node_unit_names(node)
    p_norm = s.p if s.p is not None else (2.0 if is_block else 1.0)
    xb0 = cached_inp[: s.batch_size].float()
    yb0 = cached_out[: s.batch_size].float()
    gb0 = None if cached_grads is None \
        else cached_grads[: s.batch_size].float()
    mean = _grad_mean(s, mesh)
    if mesh is None or split_rows:
        def first(v):
            return v
    else:
        from ..parallel.dist import from_data_rank0

        def first(v):
            return from_data_rank0(v, mesh)
    init_loss = first(_eval_rec(node, params, qstate,
                                Flags(weight_on=frozenset(unit_names),
                                      output_affine=s.opt_output_affine),
                                xb0, yb0, gb0, s, p_norm))

    # fused warm start: a short shift pre-solve whose solved selection
    # re-seeds the fused init (coarse candidate sets only)
    warm_alphas = warm_metrics = None
    ws_iters = 0
    if (s.mode == "fused" and s.warmstart_frac > 0 and not s.auto_candidates
            and resolve_dequant(s.fused_dequant, s.shift_targets)
            == "effective"):
        ws_iters = int(s.iters * s.warmstart_frac)
        if ws_iters > 0:
            s_ws = dataclasses.replace(
                s, mode="shift", iters=ws_iters,
                lr=s.warmstart_lr if s.warmstart_lr else s.lr)
            qs_ws, warm_metrics = reconstruct_node(
                graph, params, qstate, node_name, cached_inp, cached_out,
                s_ws, _fold_in(seed, 877), cached_grads=cached_grads,
                mesh=mesh, split_rows=split_rows)
            warm_alphas = {n: qs_ws[n].wq.alpha for n in unit_names
                           if isinstance(qs_ws[n].wq, W.ShiftedScaleWQ)}
            s = dataclasses.replace(s, iters=s.iters - ws_iters)

    qstate, theta = _init_quantizers(params, qstate, unit_names, s,
                                     warm_alphas=warm_alphas)

    # effective-dequant fused runs keep post_round_frac of the budget for
    # a rounding-only refine on the hardened selection, when hardening
    # leaves every unit an AdaRoundWQ
    def _refinable(wq):
        return isinstance(wq, W.AdaRoundWQ) or (
            isinstance(wq, W.ShiftedScaleWQ) and wq.codes
            and wq.dequant == "effective")

    refine_iters = 0
    if s.mode == "fused" and s.post_round_frac > 0 and any(
            isinstance(qstate[n].wq, W.ShiftedScaleWQ)
            and qstate[n].wq.dequant == "effective" for n in unit_names) \
            and all(_refinable(qstate[n].wq) for n in unit_names):
        refine_iters = int(s.iters * s.post_round_frac)
    if refine_iters:
        s = dataclasses.replace(s, iters=s.iters - refine_iters)

    flags = Flags(weight_on=frozenset(unit_names),
                  output_affine=s.opt_output_affine)
    theta = {n: {k: v.detach().clone().requires_grad_(True)
                 for k, v in t.items()} for n, t in theta.items()}
    gather = None
    if mesh is not None and mesh.shape["model"] > 1:
        from ..parallel.dist import model_slices
        theta, gather = model_slices(theta, mesh)
    leaves = [v for t in theta.values() for v in t.values()]
    metrics = {"init_loss": init_loss}
    if s.iters > 0:
        opt = torch.optim.Adam(leaves, lr=s.lr)
        rows = _rows(seed, cached_inp.shape[0], s.batch_size, s.iters,
                     cached_inp.device)
        if split_rows:
            from ..parallel.dist import data_share
            rows = data_share(rows, mesh)
        trace = []
        with _fp32():
            for i, idx in enumerate(rows):
                xb = cached_inp[idx].float()
                yb = cached_out[idx].float()
                gb = None if cached_grads is None \
                    else cached_grads[idx].float()
                qs = _insert_theta(qstate, theta if gather is None
                                   else gather(theta))
                rec = rec_loss_fn(apply_node(node, params, qs, xb, flags),
                                  yb, gb, s.rec_loss, p_norm)
                reg = _reg_terms(qs, unit_names, float(i), s)
                opt.zero_grad(set_to_none=True)
                trace.append(_step(rec + reg, rec, leaves, mean))
                opt.step()
        metrics["rec_trace"] = torch.stack(trace)
    if gather is not None:
        theta = gather(theta)
    qstate = _insert_theta(qstate, {n: {k: v.detach() for k, v in t.items()}
                                    for n, t in theta.items()})

    # soft and hard loss on the first batch
    metrics["soft_loss"] = first(_eval_rec(node, params, qstate, flags, xb0,
                                           yb0, gb0, s, p_norm))
    qstate = _harden(qstate, unit_names, s.mode)
    metrics["hard_loss"] = first(_eval_rec(node, params, qstate, flags, xb0,
                                           yb0, gb0, s, p_norm))
    metrics["selection_ratio"] = selection_ratios(qstate, unit_names)
    if s.mode == "fused":
        for n in unit_names:
            metrics["selection_ratio"].setdefault(n, "skipped:high-bit")
    if warm_metrics is not None:
        metrics["warmstart"] = {
            "iters": ws_iters,
            "presolve_hard_loss": warm_metrics.get("hard_loss"),
            "rec_trace": warm_metrics.get("rec_trace")}

    if refine_iters and all(
            isinstance(qstate[n].wq, W.AdaRoundWQ) for n in unit_names):
        s2 = dataclasses.replace(s, mode="round_refine", iters=refine_iters,
                                 post_round_frac=0.0)
        qstate, m2 = reconstruct_node(
            graph, params, qstate, node_name, cached_inp, cached_out, s2,
            _fold_in(seed, 991), cached_grads=cached_grads, mesh=mesh,
            split_rows=split_rows)
        metrics["hard_loss_prerefine"] = metrics["hard_loss"]
        metrics["hard_loss"] = m2["hard_loss"]
        metrics["refine_trace"] = m2.get("rec_trace")
    return qstate, metrics


# ---------------------------------------------------------------------------
# the activation-delta phase
# ---------------------------------------------------------------------------

def cosine_lr(iters: int):
    """``optax.cosine_decay_schedule(lr, max(iters, 1), 0.0)`` as a
    LambdaLR factor: update k (from 0) takes
    lr * 0.5 * (1 + cos(pi * min(k, T) / T)), T = max(iters, 1)."""
    t_max = max(iters, 1)
    return lambda k: 0.5 * (1 + math.cos(math.pi * min(k, t_max) / t_max))


def reconstruct_act_delta(graph, params, qstate, node_name: str,
                          cached_inp, cached_out, s: ReconSettings,
                          seed: int = 0, p_norm: Optional[float] = None,
                          mesh=None):
    """Learn a node's act-quant deltas (reference layer_recon.py:57-61,
    --iters_a/--lr/--p defaults): the scalar delta of each unit act site
    in the node and, for a block, of its block-level site, by Adam at
    ``s.act_lr`` with a cosine decay over ``s.iters`` steps, against the
    L_p loss at ``s.act_p``. The node runs with its weights quantized and
    those sites on. Returns (new_qstate, metrics with ``rec_trace``).
    ``mesh``: the data-parallel run (module doc)."""
    p_norm = s.act_p if p_norm is None else p_norm
    mean = _grad_mean(s, mesh)
    node = find_node(graph, node_name)
    unit_names = node_unit_names(node)
    sites = [u for u in unit_names
             if isinstance(qstate[u], UnitQuant) and qstate[u].aq is not None]
    block_site = (node_name if isinstance(node, BlockSpec)
                  and qstate.get(node_name) is not None else None)
    theta = {u: qstate[u].aq.delta for u in sites}
    if block_site:
        theta[node_name] = qstate[node_name].delta
    theta = {k: v.detach().clone().requires_grad_(True)
             for k, v in theta.items()}
    flags = Flags(weight_on=frozenset(unit_names),
                  act_on=frozenset(theta.keys()))

    def insert(qs, th):
        qs = dict(qs)
        for u in sites:
            qs[u] = dataclasses.replace(
                qs[u], aq=dataclasses.replace(qs[u].aq, delta=th[u]))
        if block_site:
            qs[node_name] = dataclasses.replace(qs[node_name],
                                                delta=th[node_name])
        return qs

    metrics = {}
    if s.iters > 0 and theta:      # a node without act sites learns nothing
        leaves = list(theta.values())
        opt = torch.optim.Adam(leaves, lr=s.act_lr)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, cosine_lr(s.iters))
        rows = _rows(seed, cached_inp.shape[0], s.batch_size, s.iters,
                     cached_inp.device)
        trace = []
        with _fp32():
            for idx in rows:
                pred = apply_node(node, params, insert(qstate, theta),
                                  cached_inp[idx].float(), flags)
                loss = lp_loss_cl(pred, cached_out[idx].float(), p_norm)
                opt.zero_grad(set_to_none=True)
                trace.append(_step(loss, loss, leaves, mean))
                opt.step()
                sched.step()
        metrics["rec_trace"] = torch.stack(trace)
    return insert(qstate, {k: v.detach() for k, v in theta.items()}), \
        metrics


# ---------------------------------------------------------------------------
# the activation shifted-scale phase
# ---------------------------------------------------------------------------

def reconstruct_act_shift(graph, params, qstate, node_name: str,
                          cached_inp, cached_out, s: ReconSettings,
                          seed: int = 0, shift_targets=None, mesh=None):
    """Activation shifted-scale reconstruction (the fused act branch,
    reference layer_recon_fused_shiftedScale.py:37-57, with the intended
    ChannelQuantAct behaviour): every act site of the node (unit sites
    and the block site) becomes an ActShiftQuant over ``shift_targets``
    (default ``s.act_shift_targets``), its alpha initialized per channel
    from the first 64 cached rows run with the weights quantized and the
    act sites off; then Adam at ``s.lr`` on the alphas against the L2
    loss (no regularizer), the node's weights quantized and the sites
    on, and the selections hardened. Returns (new_qstate, metrics with
    ``rec_trace``). ``mesh``: the data-parallel run (module doc); the
    alphas start from the first 64 rows of the whole set, gathered over
    the data axis."""
    if shift_targets is None:
        shift_targets = s.act_shift_targets
    mean = _grad_mean(s, mesh)
    node = find_node(graph, node_name)
    unit_names = node_unit_names(node)
    qstate = dict(qstate)
    sites = [u for u in unit_names
             if isinstance(qstate[u], UnitQuant) and qstate[u].aq is not None]
    if isinstance(node, BlockSpec) and qstate.get(node_name) is not None:
        sites.append(node_name)
    in_unit = set(unit_names)

    # each site's captured output, with the sites off, is the tensor its
    # quantizer will see
    sample = cached_inp[: min(64, cached_inp.shape[0])].float()
    if mean is not None:
        from ..parallel.dist import global_head
        sample = global_head(sample, 64, mesh, s.grad_psum_axis)
    with torch.no_grad():
        _, site_acts = apply_node_multi_capture(
            node, params, qstate, sample,
            Flags(weight_on=frozenset(unit_names)), sites)
    for site in sites:
        qp = qstate[site].aq if site in in_unit else qstate[site]
        asq = init_act_shift(qp, site_acts[site][1], shift_targets)
        qstate[site] = dataclasses.replace(qstate[site], aq=asq) \
            if site in in_unit else asq
    del site_acts

    def insert(qs, th, **kw):
        qs = dict(qs)
        for site in sites:
            if site in in_unit:
                qs[site] = dataclasses.replace(qs[site], aq=dataclasses
                                               .replace(qs[site].aq,
                                                        alpha=th[site], **kw))
            else:
                qs[site] = dataclasses.replace(qs[site], alpha=th[site],
                                               **kw)
        return qs

    theta = {site: (qstate[site].aq if site in in_unit else qstate[site])
             .alpha.detach().clone().requires_grad_(True) for site in sites}
    flags = Flags(weight_on=frozenset(unit_names), act_on=frozenset(sites))
    metrics = {}
    if s.iters > 0 and theta:
        leaves = list(theta.values())
        opt = torch.optim.Adam(leaves, lr=s.lr)
        rows = _rows(seed, cached_inp.shape[0], s.batch_size, s.iters,
                     cached_inp.device)
        trace = []
        with _fp32():
            for idx in rows:
                pred = apply_node(node, params, insert(qstate, theta),
                                  cached_inp[idx].float(), flags)
                loss = lp_loss_cl(pred, cached_out[idx].float(), 2.0)
                opt.zero_grad(set_to_none=True)
                trace.append(_step(loss, loss, leaves, mean))
                opt.step()
        metrics["rec_trace"] = torch.stack(trace)
    return insert(qstate, {k: v.detach() for k, v in theta.items()},
                  hard_targets=True), metrics
