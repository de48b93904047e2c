"""Sequential per-node reconstruction pipeline (PyTorch port of
``shiftedscalequantization_tpu/recon/pipeline.py``).

Walk the target nodes in order; for each, capture its inputs under the
already-reconstructed prefix (asymmetric reconstruction) and its FP
outputs, reconstruct it, then keep its weight quant on for every later
capture. Capture goes through one ``CaptureSession`` (the route the JAX
CLI takes on an accelerator) on both devices: the FP outputs of every
target are cached once, within the session's cache limit. The JAX key
becomes a seed: a CPU ``torch.Generator`` seeded with it gives each node
its own seed.

Besides the engine's modes, ``mode="two_phase"`` runs a 'shift' phase and
then a 'round' phase at twice the steps on the same cache, and
``act_phase`` learns the activation side of weight-reconstructed nodes
instead: their act deltas ('delta') or a per-channel shifted-scale
selection ('shift'). A Fisher ``rec_loss`` caches each target's gradients
(``capture_grads``, the capture's batching) for its weight phases.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import torch

from .._device import resolve_device
from ..graph import Flags, Graph, find_node, node_unit_names
from .capture import CaptureSession, capture_grads
from .engine import ReconSettings, _fold_in, reconstruct_act_delta, \
    reconstruct_act_shift, reconstruct_node


def node_seeds(seed: int, n: int):
    """The seeds ``reconstruct_model`` gives its first ``n`` nodes."""
    gen = torch.Generator().manual_seed(seed)
    return [int(torch.randint(2 ** 62, (), generator=gen)) for _ in range(n)]


def reconstruct_model(graph: Graph, params, qstate,
                      targets: Sequence[str], cali_data,
                      settings: ReconSettings, seed: int = 0,
                      batch_size: int = 64,
                      base_flags: Optional[Flags] = None,
                      cache_dtype=None,
                      on_node_done: Optional[Callable] = None,
                      act_phase=False, device="cuda"):
    """Reconstruct ``targets`` in order. Returns (qstate, history,
    prefix_flags).

    ``base_flags``: the starting prefix (the units done before a resume,
    and ``output_affine``, which the capture folds into the prefix's
    weights). ``cache_dtype``: dtype of the cached activations (None keeps
    float32). ``on_node_done(name, qstate, metrics, prefix_flags)`` runs
    after each node (eval, checkpoint, logging). ``act_phase``: True or
    'delta' learns each node's act deltas (the BRECQ act phase), 'shift'
    its act shifted-scale selection (the reference's
    channelShift_wLoss_feature driver, ShiftedScaleQuant.py:288-353),
    instead of its weights, which are assumed hardened and on via
    ``base_flags``. Each node's metrics gain ``capture_s``, ``grads_s``
    (capture_grads; none run for 'mse' and the act phases) and
    ``recon_s`` (host seconds, the card synchronised) and ``wall_s``; a
    two-phase node's hold the round phase's, with the shift phase's
    under ``shift_phase``."""
    dev = resolve_device(device)
    prefix = base_flags if base_flags is not None else Flags()
    history = {}
    session = CaptureSession(graph, params, cali_data, targets,
                             batch_size=batch_size,
                             output_affine=prefix.output_affine, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for name, node_seed in zip(targets, node_seeds(seed, len(targets))):
        t0 = time.perf_counter()
        cached_inp, cached_out = session.capture(
            qstate, name, prefix.weight_on, cache_dtype=cache_dtype)
        sync()
        t1 = time.perf_counter()
        grads = None
        if not act_phase and settings.rec_loss != "mse":
            # the capture's batching, so that the rows line up
            grads = capture_grads(graph, params, qstate, name, cali_data,
                                  batch_size=batch_size, device=dev)
            sync()
        t2 = time.perf_counter()
        if act_phase == "shift":
            qstate, metrics = reconstruct_act_shift(
                graph, params, qstate, name, cached_inp, cached_out,
                settings, seed=node_seed)
        elif act_phase:
            qstate, metrics = reconstruct_act_delta(
                graph, params, qstate, name, cached_inp, cached_out,
                settings, seed=node_seed)
        elif settings.mode == "two_phase":
            # per-node shift phase, then the round phase on the same cache
            # (reference run_ShiftRecon: iters_for_round = 2 * iters)
            qstate, m1 = reconstruct_node(
                graph, params, qstate, name, cached_inp, cached_out,
                dataclasses.replace(settings, mode="shift"), seed=node_seed,
                cached_grads=grads)
            qstate, metrics = reconstruct_node(
                graph, params, qstate, name, cached_inp, cached_out,
                dataclasses.replace(settings, mode="round",
                                    iters=settings.iters * 2),
                seed=_fold_in(node_seed, 2), cached_grads=grads)
            metrics["shift_phase"] = m1
        else:
            qstate, metrics = reconstruct_node(
                graph, params, qstate, name, cached_inp, cached_out,
                settings, seed=node_seed, cached_grads=grads)
        sync()
        del cached_inp, cached_out, grads
        # keep this node quantized for the captures after it
        prefix = dataclasses.replace(
            prefix, weight_on=prefix.weight_on
            | frozenset(node_unit_names(find_node(graph, name))))
        t3 = time.perf_counter()
        metrics.update(capture_s=t1 - t0, grads_s=t2 - t1, recon_s=t3 - t2,
                       wall_s=t3 - t0)
        history[name] = metrics
        if on_node_done is not None:
            on_node_done(name, qstate, metrics, prefix)
    return qstate, history, prefix
