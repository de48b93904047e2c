"""Profiling / tracing (PyTorch port of
``shiftedscalequantization_tpu/utils/profiling.py``).

  * ``trace(logdir)``: a torch.profiler context (CPU activity, and CUDA
    kernels when a card is present) that writes a Chrome trace into
    ``logdir`` (TensorBoard's profiler plugin reads the same files)
  * ``layer_timing``: per-node device time of each unit and block run alone
    on its captured input, with FLOP counts and achieved-FLOPs roofline
    fractions per node
  * ``node_flops`` / ``graph_flops``: analytic MAC*2 counts for conv/linear
    units
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from .._device import resolve_device
from ..graph import Flags, Graph, OpSpec, UnitSpec, apply_node, forward


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler context: CPU activity, plus CUDA activity when a card
    is present. On exit writes ``<worker>.<time>.pt.trace.json`` (Chrome
    trace format) into ``logdir``. Yields the profiler, whose
    ``key_averages()`` sums the events by name."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def _conv_out_hw(h, w, spec: UnitSpec):
    oh = (h + 2 * spec.padding[0] - spec.kernel[0]) // spec.stride[0] + 1
    ow = (w + 2 * spec.padding[1] - spec.kernel[1]) // spec.stride[1] + 1
    return oh, ow


def unit_flops(spec: UnitSpec, in_hw, batch: int) -> int:
    """MAC*2 count for one unit at the given input spatial size."""
    if spec.kind == "linear":
        return 2 * batch * spec.in_ch * spec.out_ch
    oh, ow = _conv_out_hw(*in_hw, spec)
    k = spec.kernel[0] * spec.kernel[1]
    return 2 * batch * oh * ow * spec.out_ch * (spec.in_ch // spec.groups) * k


def graph_flops(graph: Graph, input_hw, batch: int):
    """Total MAC*2 count walking the graph with spatial-size tracking.
    Returns (total, {node_name: flops})."""
    hw = input_hw
    per = {}
    total = 0
    for node in graph:
        if isinstance(node, OpSpec):
            if node.op == "maxpool":
                hw = ((hw[0] + 2 * node.padding[0] - node.window[0])
                      // node.stride[0] + 1,
                      (hw[1] + 2 * node.padding[1] - node.window[1])
                      // node.stride[1] + 1)
            elif node.op in ("gap", "avgpool"):
                hw = (1, 1)
            continue
        fl = node_flops(node, hw, batch)
        per[node.name] = fl
        total += fl
        if isinstance(node, UnitSpec):
            if node.kind == "conv":
                hw = _conv_out_hw(*hw, node)
        else:
            for u in node.units:
                if u.kind == "conv":
                    hw = _conv_out_hw(*hw, u)
    return total, per


def node_flops(node, in_hw, batch: int):
    if isinstance(node, UnitSpec):
        return unit_flops(node, in_hw, batch)
    if isinstance(node, OpSpec):
        return 0
    total = 0
    hw = in_hw
    for u in node.units:
        total += unit_flops(u, hw, batch)
        hw = _conv_out_hw(*hw, u) if u.kind == "conv" else hw
    if node.downsample is not None:
        total += unit_flops(node.downsample, in_hw, batch)
    return total


def _device_time(fn, x, inner: int = 20) -> float:
    """Seconds per call of ``fn(x)``: on the card, ``inner`` launches after
    one warm-up call between CUDA events; on the CPU, the host clock."""
    with torch.no_grad():
        fn(x)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn(x)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / inner
        t0 = time.perf_counter()
        for _ in range(inner):
            fn(x)
        return (time.perf_counter() - t0) / inner


def layer_timing(graph: Graph, params, qstate, x, flags: Flags = Flags(),
                 peak_flops: Optional[float] = None, inner: int = 20,
                 device="cuda"):
    """Per-node timing table: run each unit/block on its captured input.

    Returns a list of dicts: name, ms, gflop, achieved TFLOP/s, and
    roofline fraction when ``peak_flops`` is given. ``apply_node`` runs
    float32 convs and matmuls with TF32 off (``graph._fp32``), so the peak
    to pass is that of the card's CUDA cores for f32 math, not a tensor
    core rate: on an H100 SXM 67e12 (NVIDIA's data sheet; its dense tensor
    cores give 989e12 bf16 and 1979e12 int8, which no node here uses).
    The flops are a direct conv's multiply-adds; cuDNN's f32 3x3 convs
    run algorithms with fewer multiplies, so a node can show a share
    above 1 of that peak (``chip_smoke.py`` phase 45 measures one).
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    batch = x.shape[0]
    rows = []
    for node in graph:
        if isinstance(node, OpSpec):
            continue  # pool/reshape: negligible, folded into neighbors
        cin, _ = forward(graph, params, qstate, x, flags, capture=node.name,
                         device=dev)
        t = _device_time(
            lambda v: apply_node(node, params, qstate, v, flags),  # noqa
            cin, inner)
        fl = node_flops(node, (cin.shape[1], cin.shape[2])
                        if cin.ndim == 4 else (1, 1), batch)
        row = {"name": node.name, "ms": t * 1e3, "gflop": fl / 1e9,
               "tflops": fl / t / 1e12 if t > 0 else 0.0}
        if peak_flops:
            row["roofline_frac"] = fl / t / peak_flops
        rows.append(row)
    return rows


def format_timing(rows) -> str:
    lines = [f"{'node':34s} {'ms':>8s} {'GFLOP':>8s} {'TFLOP/s':>8s}"]
    for r in rows:
        lines.append(f"{r['name']:34s} {r['ms']:8.3f} {r['gflop']:8.2f} "
                     f"{r['tflops']:8.1f}"
                     + (f"  ({r['roofline_frac'] * 100:.0f}% roof)"
                        if "roofline_frac" in r else ""))
    total_ms = sum(r["ms"] for r in rows)
    total_gf = sum(r["gflop"] for r in rows)
    lines.append(f"{'TOTAL':34s} {total_ms:8.3f} {total_gf:8.2f}")
    return "\n".join(lines)
