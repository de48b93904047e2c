"""Explicit layer-graph IR and the fake-quant (sim) forward interpreter
(PyTorch port of ``shiftedscalequantization_tpu/graph.py``), with the
capture API that feeds reconstruction.

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
    """Per-unit quantization state: weight quantizer, act quantizer
    (QParams, or an ActShiftQuant after the act-shift phase; None until
    calibrated), and the per-out-channel output affine."""
    wq: Any
    aq: Any
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
        return Q.clip(x, 0.0, 6.0)
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
    """Per-pass interpreter context: 'run' or 'init_act' (calibration),
    with the capture, multi-capture, dynamic weight gates and output
    injection of the JAX interpreter."""
    __slots__ = ("flags", "mode", "act_bits", "act_sym", "act_method",
                 "new_aq", "capture", "cap_in", "cap_out", "done", "dyn_wq",
                 "multi", "multi_out", "inject")

    def __init__(self, flags, mode, act_bits=None, act_sym=False,
                 act_method="mse", capture=None, dyn_wq=None, multi=None,
                 inject=None):
        self.flags = flags
        self.mode = mode
        self.act_bits = act_bits
        self.act_sym = act_sym
        self.act_method = act_method
        self.new_aq = {}
        self.capture = capture
        self.cap_in = None
        self.cap_out = None
        self.done = False
        # unit name -> bool tensor: quantize that unit's weight where true
        self.dyn_wq = dyn_wq or {}
        # node names whose (input, output) to record
        self.multi = multi
        self.multi_out = {}
        # (name, tensor): that node's output is replaced by the tensor
        self.inject = inject


def _apply_act_quant(name: str, x, aq, ctx: _Ctx):
    if ctx.mode == "init_act":
        qp = Q.init_act_qparams(x, ctx.act_bits[name], sym=ctx.act_sym,
                                scale_method=ctx.act_method)
        ctx.new_aq[name] = qp
        return fake_quant(x, qp)
    if aq is None:
        raise ValueError(f"act quantizer for {name!r} not calibrated")
    if isinstance(aq, QParams):
        return fake_quant(x, aq)
    return aq(x)   # a callable quantizer (ops/act_quant.ActShiftQuant)


def _unit_forward(spec: UnitSpec, p, uq: UnitQuant, x, ctx: _Ctx):
    wq_on = spec.name in ctx.flags.weight_on
    aq_on = spec.name in ctx.flags.act_on and not spec.disable_act_quant
    if ctx.mode == "init_act":
        aq_on = spec.name in ctx.act_bits and not spec.disable_act_quant
    w, b = p["w"], p.get("b")
    if spec.name in ctx.dyn_wq:
        w = torch.where(ctx.dyn_wq[spec.name],
                        wquant.apply_weight_quant(uq.wq, w), w)
    elif wq_on:
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


def _capture_pre(name, x, ctx: _Ctx):
    if ctx.capture == name:
        ctx.cap_in = x
    if ctx.multi is not None and name in ctx.multi:
        ctx.multi_out.setdefault(name, [None, None])[0] = x


def _capture_post(name, out, ctx: _Ctx):
    if ctx.capture == name:
        ctx.cap_out = out
        ctx.done = True
    if ctx.multi is not None and name in ctx.multi:
        ctx.multi_out.setdefault(name, [None, None])[1] = out
    if ctx.inject is not None and ctx.inject[0] == name:
        return ctx.inject[1]
    return out


def _unit_node(spec, params, qstate, x, ctx):
    _capture_pre(spec.name, x, ctx)
    out = _unit_forward(spec, params[spec.name], qstate[spec.name], x, ctx)
    return _capture_post(spec.name, out, ctx)


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
        return _unit_node(node, params, qstate, x, ctx)
    _capture_pre(node.name, x, ctx)
    residual = x
    if node.downsample is not None:
        residual = _unit_node(node.downsample, params, qstate, x, ctx)
    out = x
    for u in node.units:
        out = _unit_node(u, params, qstate, out, ctx)
        if ctx.done:
            return out
    if node.residual:
        out = out + residual
    out = _activation(node.post_activation, out)
    aq_on = node.name in ctx.flags.act_on and node.block_act_quant
    if ctx.mode == "init_act":
        aq_on = node.name in ctx.act_bits and node.block_act_quant
    if aq_on:
        out = _apply_act_quant(node.name, out, qstate.get(node.name), ctx)
    return _capture_post(node.name, out, ctx)


def _run(graph, params, qstate, x, ctx, device):
    """The whole graph without gradients; stops after a captured node."""
    out = torch.as_tensor(x, device=resolve_device(device))
    with torch.no_grad(), _fp32():
        for node in graph:
            out = _node_forward(node, params, qstate, out, ctx)
            if ctx.done:
                break
    return out


def forward(graph: Graph, params, qstate, x, flags: Flags = Flags(),
            capture: Optional[str] = None, device="cuda"):
    """Run the model (NHWC input) and return its output. If ``capture``
    names a node (a top-level node, or a unit inside a block), return that
    node's (input, output) under ``flags`` instead and skip the rest of the
    network."""
    ctx = _Ctx(flags, "run", capture=capture)
    out = _run(graph, params, qstate, x, ctx, device)
    if ctx.done:
        return ctx.cap_in, ctx.cap_out
    if capture is not None:
        raise KeyError(f"capture target {capture!r} not found in graph")
    return out


def forward_multi_capture(graph: Graph, params, qstate, x, dyn_wq: dict,
                          targets, flags: Flags = Flags(), device="cuda"):
    """Full forward recording (input, output) of every node in
    ``targets``, with per-unit weight-quant gates ``dyn_wq`` (unit name ->
    bool tensor) on top of ``flags``. Returns {name: (node_in, node_out)}."""
    ctx = _Ctx(flags, "run", dyn_wq=dyn_wq, multi=frozenset(targets))
    _run(graph, params, qstate, x, ctx, device)
    missing = set(targets) - set(ctx.multi_out)
    if missing:
        raise KeyError(f"capture targets not found: {missing}")
    return {k: (v[0], v[1]) for k, v in ctx.multi_out.items()}


def apply_node(node: Node, params, qstate, x, flags: Flags = Flags()):
    """Forward one unit or block on its own input ``x`` (a tensor, on the
    device the node runs on): the subject of a reconstruction step.
    Gradients flow; convs and matmuls run in full float32 (TF32 off) here,
    and a caller that differentiates keeps ``_fp32()`` around its backward
    too."""
    with _fp32():
        return _node_forward(node, params, qstate, x, _Ctx(flags, "run"))


def apply_node_multi_capture(node: Node, params, qstate, x, flags: Flags,
                             targets):
    """apply_node, also recording (input, output) of the named inner sites
    (units and/or the node itself). Returns (out, {name: (in, out)})."""
    ctx = _Ctx(flags, "run", multi=frozenset(targets))
    with _fp32():
        out = _node_forward(node, params, qstate, x, ctx)
    return out, {k: (v[0], v[1]) for k, v in ctx.multi_out.items()}


def forward_from(graph: Graph, params, qstate, after: str, t,
                 flags: Flags = Flags()):
    """Resume the forward from ``t``, the output of top-level node
    ``after``. Gradients flow (the input to differentiate is ``t``); for
    targets nested inside blocks use forward_inject."""
    ctx = _Ctx(flags, "run")
    seen = False
    out = t
    with _fp32():
        for node in graph:
            if not seen:
                seen = node.name == after
                continue
            out = _node_forward(node, params, qstate, out, ctx)
    if not seen:
        raise KeyError(after)
    return out


def forward_inject(graph: Graph, params, qstate, x, target: str, t,
                   flags: Flags = Flags()):
    """Full forward with ``target``'s output replaced by ``t``: downstream
    is a function of ``t``, so a loss on the result differentiates at that
    intermediate (units nested inside blocks included). Gradients flow."""
    ctx = _Ctx(flags, "run", inject=(target, t))
    out = x
    with _fp32():
        for node in graph:
            out = _node_forward(node, params, qstate, out, ctx)
    return out


def prefix_flags_till(graph: Graph, target: str, act_quant: bool = False,
                      base: Flags = Flags()) -> Flags:
    """Weight (and optionally act) quant on for every unit up to and
    including ``target``, in module-registration order: a unit target
    inside a block quantizes only the block units before it."""
    w_on, a_on = set(base.weight_on), set(base.act_on)

    def done():
        return dataclasses.replace(base, weight_on=frozenset(w_on),
                                   act_on=frozenset(a_on))

    for node in graph:
        if isinstance(node, OpSpec):
            continue
        units = [node] if isinstance(node, UnitSpec) else \
            list(node.units) + ([node.downsample] if node.downsample else [])
        for u in units:
            w_on.add(u.name)
            if act_quant:
                a_on.add(u.name)
            if u.name == target:
                return done()
        if isinstance(node, BlockSpec):
            if act_quant:
                a_on.add(node.name)
            if node.name == target:
                return done()
    return done()


def node_unit_names(node: Node):
    """Unit names inside a node (downsample last), in module-registration
    order."""
    if isinstance(node, UnitSpec):
        return [node.name]
    names = [u.name for u in node.units]
    if node.downsample is not None:
        names.append(node.downsample.name)
    return names


def init_act_quant(graph: Graph, params, qstate, x, flags: Flags,
                   act_bits: dict, act_sym: bool = False,
                   scale_method: str = "mse", device="cuda") -> dict:
    """Single-pass activation-scale calibration: at every site in
    ``act_bits`` (name -> n_bits), set the scale from the tensor flowing
    past it and quantize with it before going on. Returns {name: QParams}."""
    ctx = _Ctx(flags, "init_act", act_bits, act_sym, scale_method)
    _run(graph, params, qstate, x, ctx, device)
    return ctx.new_aq
