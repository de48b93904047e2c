"""Sequential per-node reconstruction pipeline (PyTorch port of
``shiftedscalequantization_tpu/recon/pipeline.py``).

Walk the target nodes in order; for each, capture its inputs under the
already-reconstructed prefix (asymmetric reconstruction) and its FP
outputs, reconstruct it, then keep its weight quant on for every later
capture. Capture goes through one ``CaptureSession`` (the route the JAX
CLI takes on an accelerator): the FP outputs of every target are cached
once, within the session's cache limit. The JAX key becomes a seed: a CPU
``torch.Generator`` seeded with it gives each node its own seed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import torch

from .._device import resolve_device
from ..graph import Flags, Graph, find_node, node_unit_names
from .capture import CaptureSession
from .engine import MODES_ITEM, NOT_PORTED, ReconSettings, \
    reconstruct_node


def node_seeds(seed: int, n: int):
    """The seeds ``reconstruct_model`` gives its first ``n`` nodes."""
    gen = torch.Generator().manual_seed(seed)
    return [int(torch.randint(2 ** 62, (), generator=gen)) for _ in range(n)]


def reconstruct_model(graph: Graph, params, qstate,
                      targets: Sequence[str], cali_data,
                      settings: ReconSettings, seed: int = 0,
                      batch_size: int = 64,
                      on_node_done: Optional[Callable] = None,
                      act_phase=False, device="cuda"):
    """Reconstruct ``targets`` in order, starting from no quantized
    prefix. Returns (qstate, history, prefix_flags).

    ``on_node_done(name, qstate, metrics, prefix_flags)`` runs after each
    node (eval, checkpoint, logging). Each node's metrics gain
    ``capture_s`` and ``recon_s`` (host seconds, the card synchronised)
    and ``wall_s``."""
    if act_phase or settings.mode == "two_phase":
        what = f"act_phase={act_phase!r}" if act_phase else "mode 'two_phase'"
        raise NotImplementedError(f"{what} "
                                  + NOT_PORTED.format(item=MODES_ITEM))
    dev = resolve_device(device)
    prefix = Flags()
    history = {}
    session = CaptureSession(graph, params, cali_data, targets,
                             batch_size=batch_size, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for name, node_seed in zip(targets, node_seeds(seed, len(targets))):
        t0 = time.perf_counter()
        cached_inp, cached_out = session.capture(
            qstate, name, prefix.weight_on)
        sync()
        t1 = time.perf_counter()
        qstate, metrics = reconstruct_node(
            graph, params, qstate, name, cached_inp, cached_out, settings,
            seed=node_seed)
        sync()
        del cached_inp, cached_out
        # keep this node quantized for the captures after it
        prefix = dataclasses.replace(
            prefix, weight_on=prefix.weight_on
            | frozenset(node_unit_names(find_node(graph, name))))
        t2 = time.perf_counter()
        metrics.update(capture_s=t1 - t0, recon_s=t2 - t1, wall_s=t2 - t0)
        history[name] = metrics
        if on_node_done is not None:
            on_node_done(name, qstate, metrics, prefix)
    return qstate, history, prefix
