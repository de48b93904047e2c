"""Explicit layer-graph IR and the fake-quant (sim) forward interpreter
(PyTorch port of ``shiftedscalequantization_tpu/graph.py:47-386``).

A model is ``(graph, params)``: the graph is a tuple of frozen node specs
(UnitSpec / BlockSpec / OpSpec), params a dict of tensors keyed by unit
name. Quantization state is an explicit dict (``qstate``); per-unit quant
on/off is a ``Flags`` value.

Layouts follow the JAX package at every public function: activations are
NHWC and conv weights OIHW. Convs run on an NCHW view of the NHWC tensor,
which PyTorch sees as ``channels_last`` memory, so no copy is made.

Float convs and matmuls here feed low-bit quantizers, so they run in full
float32: ``_fp32`` turns TF32 off for cuDNN and cuBLAS while the forward
runs, as the JAX package asks for ``Precision.HIGHEST``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional, Union

import torch
import torch.nn.functional as F

from ._device import resolve_device
from .ops import quant as Q
from .ops import wquant
from .ops.quant import QParams, fake_quant


# ---------------------------------------------------------------------------
# Static node specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UnitSpec:
    """A quantizable conv2d or linear layer."""
    name: str
    kind: str                      # 'conv' | 'linear'
    in_ch: int
    out_ch: int
    kernel: tuple = (1, 1)
    stride: tuple = (1, 1)
    padding: tuple = (0, 0)        # symmetric (ph, pw)
    groups: int = 1
    activation: Optional[str] = None   # fused post-op: 'relu' | 'relu6'
    disable_act_quant: bool = False
    has_bn: bool = False


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """A residual block: main-path units, optional downsample, residual add,
    post-activation, then the block-level act quantizer."""
    name: str
    units: tuple
    downsample: Optional[UnitSpec] = None
    residual: bool = True
    post_activation: Optional[str] = None
    block_act_quant: bool = True


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """A fixed non-quantized op between units (pool / flatten)."""
    name: str
    op: str                          # 'maxpool' | 'gap' | 'flatten'
    window: tuple = (1, 1)
    stride: tuple = (1, 1)
    padding: tuple = (0, 0)


Node = Union[UnitSpec, BlockSpec, OpSpec]
Graph = tuple


def iter_units(graph: Graph):
    """All quantizable units in execution order (downsample after the main
    path, matching torch module registration order)."""
    for node in graph:
        if isinstance(node, UnitSpec):
            yield node
        elif isinstance(node, BlockSpec):
            yield from node.units
            if node.downsample is not None:
                yield node.downsample


def iter_nodes(graph: Graph):
    yield from graph


def find_node(graph: Graph, name: str) -> Node:
    for node in graph:
        if node.name == name:
            return node
        if isinstance(node, BlockSpec):
            for u in node.units:
                if u.name == name:
                    return u
            if node.downsample is not None and node.downsample.name == name:
                return node.downsample
    raise KeyError(name)


# ---------------------------------------------------------------------------
# Quant state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class UnitQuant:
    """Per-unit quantization state: weight quantizer, act QParams (None
    until calibrated), and the per-out-channel output affine."""
    wq: Any
    aq: Optional[QParams]
    alpha_out: Optional[torch.Tensor]
    beta_out: Optional[torch.Tensor]
    raw_zp: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class Flags:
    """Static per-unit quant enables."""
    weight_on: frozenset = frozenset()
    act_on: frozenset = frozenset()      # unit and block names
    output_affine: bool = False

    def all_weights(self, graph: Graph) -> "Flags":
        return dataclasses.replace(
            self, weight_on=frozenset(u.name for u in iter_units(graph)))


# ---------------------------------------------------------------------------
# Primitive forward ops
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _fp32():
    """Full float32 convs and matmuls (TF32 off), restored on exit."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _activation(name: Optional[str], x):
    if name is None:
        return x
    if name == "relu":
        return torch.relu(x)
    if name == "relu6":
        return torch.clamp(x, 0.0, 6.0)
    raise ValueError(f"unknown activation {name}")


def conv2d(x_nhwc, w_oihw, b, stride, padding, groups):
    """NHWC conv with OIHW weights; returns NHWC."""
    out = F.conv2d(x_nhwc.permute(0, 3, 1, 2), w_oihw, None,
                   tuple(stride), tuple(padding), 1, groups)
    out = out.permute(0, 2, 3, 1)
    if b is not None:
        out = out + b
    return out


def linear(x, w_oi, b):
    out = x @ w_oi.T
    if b is not None:
        out = out + b
    return out


def max_pool(x, window, stride, padding):
    """NHWC max pool with -inf padding."""
    out = F.max_pool2d(x.permute(0, 3, 1, 2), tuple(window), tuple(stride),
                       tuple(padding))
    return out.permute(0, 2, 3, 1)


def global_avg_pool(x):
    return x.mean(dim=(1, 2))


# ---------------------------------------------------------------------------
# Interpreter
# ---------------------------------------------------------------------------

class _Ctx:
    """Per-pass interpreter context: 'run' or 'init_act' (calibration)."""
    __slots__ = ("flags", "mode", "act_bits", "act_sym", "act_method",
                 "new_aq")

    def __init__(self, flags, mode, act_bits=None, act_sym=False,
                 act_method="mse"):
        self.flags = flags
        self.mode = mode
        self.act_bits = act_bits
        self.act_sym = act_sym
        self.act_method = act_method
        self.new_aq = {}


def _apply_act_quant(name: str, x, aq: Optional[QParams], ctx: _Ctx):
    if ctx.mode == "init_act":
        qp = Q.init_act_qparams(x, ctx.act_bits[name], sym=ctx.act_sym,
                                scale_method=ctx.act_method)
        ctx.new_aq[name] = qp
        return fake_quant(x, qp)
    if aq is None:
        raise ValueError(f"act quantizer for {name!r} not calibrated")
    return fake_quant(x, aq)


def _unit_forward(spec: UnitSpec, p, uq: UnitQuant, x, ctx: _Ctx):
    wq_on = spec.name in ctx.flags.weight_on
    aq_on = spec.name in ctx.flags.act_on and not spec.disable_act_quant
    if ctx.mode == "init_act":
        aq_on = spec.name in ctx.act_bits and not spec.disable_act_quant
    w, b = p["w"], p.get("b")
    if wq_on:
        w = wquant.apply_weight_quant(uq.wq, w)
    if spec.kind == "conv":
        out = conv2d(x, w, b, spec.stride, spec.padding, spec.groups)
    else:
        out = linear(x, w, b)
    if wq_on and ctx.flags.output_affine and uq.alpha_out is not None:
        out = out * uq.alpha_out + uq.beta_out
    out = _activation(spec.activation, out)
    if aq_on:
        out = _apply_act_quant(spec.name, out, uq.aq, ctx)
    return out


def _node_forward(node: Node, params, qstate, x, ctx: _Ctx):
    if isinstance(node, OpSpec):
        if node.op == "maxpool":
            return max_pool(x, node.window, node.stride, node.padding)
        if node.op == "gap":
            return global_avg_pool(x)
        if node.op == "flatten":
            return x.reshape(x.shape[0], -1)
        raise ValueError(f"unknown op {node.op}")
    if isinstance(node, UnitSpec):
        return _unit_forward(node, params[node.name], qstate[node.name], x,
                             ctx)
    residual = x
    if node.downsample is not None:
        residual = _unit_forward(node.downsample,
                                 params[node.downsample.name],
                                 qstate[node.downsample.name], x, ctx)
    out = x
    for u in node.units:
        out = _unit_forward(u, params[u.name], qstate[u.name], out, ctx)
    if node.residual:
        out = out + residual
    out = _activation(node.post_activation, out)
    aq_on = node.name in ctx.flags.act_on and node.block_act_quant
    if ctx.mode == "init_act":
        aq_on = node.name in ctx.act_bits and node.block_act_quant
    if aq_on:
        out = _apply_act_quant(node.name, out, qstate.get(node.name), ctx)
    return out


def _run(graph, params, qstate, x, ctx, device):
    x = torch.as_tensor(x, device=resolve_device(device))
    with torch.no_grad(), _fp32():
        for node in graph:
            x = _node_forward(node, params, qstate, x, ctx)
    return x


def forward(graph: Graph, params, qstate, x, flags: Flags = Flags(),
            device="cuda"):
    """Run the model (NHWC input) and return its output."""
    return _run(graph, params, qstate, x, _Ctx(flags, "run"), device)


def init_act_quant(graph: Graph, params, qstate, x, flags: Flags,
                   act_bits: dict, act_sym: bool = False,
                   scale_method: str = "mse", device="cuda") -> dict:
    """Single-pass activation-scale calibration: at every site in
    ``act_bits`` (name -> n_bits), set the scale from the tensor flowing
    past it and quantize with it before going on. Returns {name: QParams}."""
    ctx = _Ctx(flags, "init_act", act_bits, act_sym, scale_method)
    _run(graph, params, qstate, x, ctx, device)
    return ctx.new_aq
