"""Deploy-mode (true integer) inference path (PyTorch port of
``shiftedscalequantization_tpu/deploy.py:39-560, 627-1145``).

Hardened quantizer state is converted offline into centered integer weight
codes and per-out-channel scales; inference runs integer convolutions with
a fused dequant epilogue. With centered codes x_c and w_c the fake-quant
conv is exactly ``dx * dw_oc * conv_int(x_c, w_c)``, so deploy matches the
sim forward up to float epilogue rounding. Activations travel between
units as int8 codes (centered, or biased by 128 for 8-bit unsigned sites).

Weight quantizers converted: ``UniformWQ``, hard ``AdaRoundWQ`` (with
baked shifts: ``st_index`` into ``shift_targets``) and the fused
``ShiftedScaleWQ`` (``codes=True``). A baked unit keeps its codes split
into one masked int8 tensor per shift candidate (``w_groups``) with a
per-(candidate, OC) scale table (``group_scales``):
``out = 0 + sum_s conv_int(x, w_groups[s]) * (group_scales[s] * dx)``.

Plan kinds ported: ``stem_fused``, ``packed`` and ``dw_int8``
(hand-written kernels in ``ops/cuda``), ``int8``, ``bf16_codes``,
``int8_bd`` and ``int8_pair``, ``float`` and ``float_1p``. The four
integer kinds give the same integers (the JAX bf16 sums are exact below
2^24), and all run one exact integer route here: a dense conv or linear
unit goes through ``ops/cuda/int_matmul.int8_conv`` (the implicit-GEMM
kernel on the card, its plain version on the CPU), a grouped conv through
``ops/cuda/group_conv.int8_group_conv`` (likewise), a depthwise conv
through ``ops/cuda/dw_conv.dw_conv_int8`` (likewise). ``int8_bd`` runs a
narrow grouped conv on ``int8_conv`` with its dense block-diagonal
operand (``DeployUnit.w_bd``); ``int8_pair`` (8-bit unsigned feeds) runs
the biased codes with offset 128, which computes the JAX package's
nibble-split sum ``16*hi + lo`` in one launch. No cuDNN float conv
touches act codes, since TF32 and Winograd would flip them. An
``int8_conv``, ``int8_group_conv``, ``dw_conv_int8`` or ``packed`` unit
hands its launch to its consumer (``_Deferred``): the requant onto an
int8 or biased site under none, relu or relu6 (and a residual block's
requant, for its last unit) runs in the kernel's epilogue, with the
terms ``quantize_out`` builds; ``quantize_out.unfused`` counts the
requants left to PyTorch elementwise ops. The plan still names the kinds
the JAX package would pick for other graphs; ``float_s2d`` raises
NotImplementedError when reached.

Pair transport (MNASNet's siteless residual chains): a siteless residual
block of two code grids hands on ``("pair", terms, None)``, its terms
``("codes", int8, site)`` values, while the chain stays below the term cap;
a ``float`` consumer with integer weights (not baked) runs one
``int8_conv`` per term and sums ``float(sums_i) * delta_i``; other
consumers and deeper chains take the exact f32 sum of the terms.
``pair_stats`` counts the pairs formed and consumed so in the last
forward.

A hardened ``ActShiftQuant`` site has a per-channel step: it travels as
an f32 edge and its consumers take the ``float`` kind, as in the JAX
package; an integer feed handed a per-channel step raises. A plan also
keeps, under ``__kernel_consts__``, the launch
constants of its ``stem_fused`` and ``dw_int8`` units (weight layouts,
folded scales, the grid's reciprocal), built once when the plan is made,
so a forward launches those units' kernels and nothing else for them.

Switches read, with the JAX package's meaning and defaults:
``SSQ_STEM_KERNEL``, ``SSQ_PACKED``, ``SSQ_STEM_1PASS``, ``SSQ_DW_KERNEL``
(the plan) and ``SSQ_PAIR_TERMS`` (the forward's term cap, 2; below 2 no
pair forms). The JAX package's other plan switches keep their defaults
here: units narrower than ``THIN_CHANNELS`` take ``bf16_codes`` (the same
integers as ``int8`` in the port), and ``float`` units keep the exact
route. Pair transport is always on, as the JAX package has it off the
TPU.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ._device import resolve_device
from .graph import BlockSpec, Graph, OpSpec, UnitQuant, UnitSpec, \
    _activation, _fp32, conv2d, global_avg_pool, iter_units, max_pool
from .ops import wquant as W
from .ops.act_quant import ActShiftQuant
from .ops.cuda.depthwise import dw_conv3x3_int8_prepared, prepare_dw
from .ops.cuda.dw_conv import dw_conv_int8
from .ops.cuda.group_conv import int8_group_conv
from .ops.cuda.int_matmul import int8_conv
from .ops.cuda.packed import pack_codes, packed_quant_matmul
from .ops.cuda.requant import Requant, clip as _clip, requant_plain
from .ops.cuda.stem import prepare_stem, stem_fused_prepared

UNPORTED_KINDS = ("float_s2d",)
# units narrower than this take bf16_codes over int8 (the JAX package's
# SSQ_THIN_CHANNELS default; the kinds give the same integers here)
THIN_CHANNELS = 128
# the pairs formed by siteless residual blocks and those consumed by one
# int8_conv per term, in the last deploy_forward
pair_stats = {"formed": 0, "consumed_fast": 0}


@dataclasses.dataclass
class DeployUnit:
    """Execution-ready unit parameters (weights converted offline)."""
    w_int: Optional[torch.Tensor]    # int8 centered weight codes (OIHW / OI)
    w_fp: Optional[torch.Tensor]     # f32 centered codes when |codes| > 127
    scale: torch.Tensor              # per-OC epilogue scale
    bias: torch.Tensor               # folded bias
    # baked-shift units: codes split into |S| IC/pair-masked groups, each
    # with its own per-OC scale (the per-(candidate, OC) scale table)
    w_groups: Optional[torch.Tensor] = None       # (S, OC, ...) int8
    group_scales: Optional[torch.Tensor] = None   # (S, OC) f32
    # sub-byte packed form (fc / 1x1 convs at W2/W4): raw codes packed
    # 16/8 per int32, (OC, ceil(K/f)) — ops/cuda/packed.pack_codes
    w_packed: Optional[torch.Tensor] = None
    w_pack_zp: Optional[torch.Tensor] = None   # (OC,) weight zero points
    w_pack_bits: int = 0
    # int8_conv's operand: w_int (or each of w_groups) as
    # (S, OC, KH*KW*IC) in (kh, kw, ic) order, S = 1 without groups, and
    # its (S, OC) int32 sums for offset (biased) feeds
    w_mat: Optional[torch.Tensor] = None
    w_sum: Optional[torch.Tensor] = None
    # narrow grouped conv (1 < groups < in_ch <= 128, not baked): the
    # dense block-diagonal codes as int8_conv's (1, OC, KH*KW*IC) operand,
    # for the int8_bd kind; its row sums are w_sum's
    w_bd: Optional[torch.Tensor] = None


def _hard_weight_codes(wq, w):
    """(integer codes, zp, per-OC delta) for a hardened weight quantizer."""
    if isinstance(wq, W.UniformWQ):
        delta = W._bshape(wq.qp.delta, w)
        zp = W._bshape(wq.qp.zero_point, w)
        lo, hi = wq.qp.qrange()
        codes = torch.clamp(torch.round(w / delta) + zp, lo, hi)
        return codes, zp, wq.qp.delta
    if isinstance(wq, W.AdaRoundWQ):
        # codes on the effective (baked) grid; the base per-OC delta goes
        # to the epilogue, the shifts to the scale table
        delta = wq._delta(w)
        zp = W._bshape(wq.qp.zero_point, w)
        x_int = torch.floor(w / delta) + (wq.alpha >= 0).to(w.dtype)
        lo, hi = wq._clip_range()
        return torch.clamp(x_int + zp, lo, hi), zp, wq.qp.delta
    if isinstance(wq, W.ShiftedScaleWQ) and wq.codes:
        # fused path: hard-selected floor codes + hard round, dequantized at
        # the base per-OC delta -> a plain int tensor
        zp = W._bshape(wq.qp.zero_point, w)
        onehot = F.one_hot(torch.argmax(wq.soft_targets(), dim=-1),
                           len(wq.shift_targets)).to(w.dtype)
        x_int = W._mix(wq.x_q, onehot) + (wq.beta >= 0).to(w.dtype)
        lo, hi = wq.qp.qrange()
        return torch.clamp(x_int + zp, lo, hi), zp, wq.qp.delta
    raise NotImplementedError(
        f"deploy conversion for {type(wq).__name__} (two-phase "
        "dequant-shifted state needs the per-(oc,ic) scale-table epilogue)")


def _gemm_operand(w_int: torch.Tensor) -> torch.Tensor:
    """(S, OC, IC[, KH, KW]) int8 -> (S, OC, KH*KW*IC), (kh, kw, ic)
    order: int8_conv's weight operand."""
    if w_int.ndim == 5:
        w_int = w_int.permute(0, 1, 3, 4, 2)
    return w_int.reshape(w_int.shape[0], w_int.shape[1], -1).contiguous()


def _block_diagonal(w_int: torch.Tensor, groups: int) -> torch.Tensor:
    """Grouped OIHW codes (OC, IC/G, KH, KW) -> dense (OC, IC, KH, KW),
    zero outside each conv group's block."""
    oc, cg = w_int.shape[:2]
    ocg = oc // groups
    dense = w_int.new_zeros((oc, cg * groups) + tuple(w_int.shape[2:]))
    for g in range(groups):
        dense[g * ocg:(g + 1) * ocg, g * cg:(g + 1) * cg] = \
            w_int[g * ocg:(g + 1) * ocg]
    return dense


def _st_per_weight(wq, w: torch.Tensor) -> torch.Tensor:
    """The baked unit's shift-candidate index, broadcast to w's shape."""
    idx = wq.st_index
    if idx.ndim == 1 and w.ndim == 4:          # conv: per input channel
        idx = idx.reshape(1, -1, 1, 1)
    return idx.expand(w.shape)


def build_deploy_params(graph: Graph, params, qstate,
                        output_affine: bool = False,
                        device="cuda") -> dict:
    """Convert hardened qstate + folded params into {name: DeployUnit}."""
    dev = resolve_device(device)
    out = {}
    with torch.no_grad():
        for u in iter_units(graph):
            uq = qstate[u.name]
            w = params[u.name]["w"].to(dev)
            b = params[u.name].get("b")
            b = torch.zeros((u.out_ch,), dtype=w.dtype, device=dev) \
                if b is None else b.to(dev)
            codes, zp, delta_oc = _hard_weight_codes(uq.wq, w)
            centered = codes - zp
            scale_oc = delta_oc.reshape(-1)
            a_out = uq.alpha_out if (output_affine
                                     and uq.alpha_out is not None) \
                else torch.ones((u.out_ch,), dtype=w.dtype, device=dev)
            b_out = uq.beta_out if (output_affine
                                    and uq.beta_out is not None) \
                else torch.zeros((u.out_ch,), dtype=w.dtype, device=dev)
            scale, bias = scale_oc * a_out, b * a_out + b_out
            baked = (isinstance(uq.wq, W.AdaRoundWQ)
                     and uq.wq.st_index is not None)
            if float(centered.abs().max()) > 127:
                # 8-bit asym head/stem: exact integer codes kept in f32; a
                # baked unit folds its shifts into them
                w_fp = centered
                if baked:
                    sts = W._targets(uq.wq.shift_targets, w)
                    w_fp = centered * sts[_st_per_weight(uq.wq, w)]
                out[u.name] = DeployUnit(w_int=None, w_fp=w_fp,
                                         scale=scale, bias=bias)
                continue
            w_int = centered.to(torch.int8)
            if baked:
                # grouped scale-table form: codes masked per shift candidate
                idx = _st_per_weight(uq.wq, w)
                sts = uq.wq.shift_targets
                groups = torch.stack([
                    torch.where(idx == s, centered,
                                torch.zeros_like(centered)).to(torch.int8)
                    for s in range(len(sts))])
                gscales = torch.stack([scale_oc * float(st) * a_out
                                       for st in sts])
                w_mat = _gemm_operand(groups)
                out[u.name] = DeployUnit(
                    w_int=w_int, w_fp=None, scale=scale, bias=bias,
                    w_groups=groups, group_scales=gscales, w_mat=w_mat,
                    w_sum=w_mat.sum(dim=2, dtype=torch.int32))
                continue
            w_mat = _gemm_operand(w_int[None])
            du = DeployUnit(w_int=w_int, w_fp=None, scale=scale, bias=bias,
                            w_mat=w_mat,
                            w_sum=w_mat.sum(dim=2, dtype=torch.int32))
            if u.kind == "conv" and 1 < u.groups < u.in_ch \
                    and u.in_ch <= 128:
                du.w_bd = _gemm_operand(_block_diagonal(w_int, u.groups)[None])
            n_bits_w = uq.wq.qp.n_bits
            flat_1x1 = (u.kind == "linear"
                        or (u.kind == "conv" and u.kernel == (1, 1)
                            and u.groups == 1 and u.padding == (0, 0)))
            if flat_1x1 and n_bits_w in (2, 4):
                # raw = codes - qlo maps any clip range onto [0, 2^bits)
                qlo = min(float(codes.min()), 0.0)
                raw = (codes - qlo).to(torch.int32).reshape(u.out_ch, -1)
                if float(raw.max()) < 2 ** n_bits_w:
                    du = dataclasses.replace(
                        du, w_packed=pack_codes(raw.T, n_bits_w),
                        w_pack_zp=(zp.reshape(-1) - qlo).to(torch.float32),
                        w_pack_bits=n_bits_w)
            out[u.name] = du
    return out


def act_steps_from_qstate(graph: Graph, qstate) -> dict:
    """site name -> (delta, zero_point, n_bits) for every calibrated act
    quantizer (unit sites and block sites). A hardened ActShiftQuant site
    gives its per-channel step (``effective_delta``)."""
    steps = {}
    for name, v in qstate.items():
        aq = v.aq if isinstance(v, UnitQuant) else v
        if isinstance(aq, ActShiftQuant):
            steps[name] = (aq.effective_delta(), aq.qp.zero_point,
                           aq.qp.n_bits)
        elif aq is not None:
            steps[name] = (aq.delta, aq.zero_point, aq.n_bits)
    return steps


def _scalar_step(st) -> bool:
    """True when the site's (delta, zp) are scalars. A per-channel step
    (hardened ActShiftQuant) does not factor out of the consumer's conv
    as an output scale, so such a site travels as an f32 edge."""
    delta, zp, _ = st
    return delta.numel() == 1 and zp.numel() == 1


def _scalar_feed(st, unit: str):
    """(delta, zp, n_bits) of a site feeding an integer kernel, which
    reads one step and one zero point; a per-channel step raises."""
    if not _scalar_step(st):
        raise ValueError(f"{unit}: an integer feed needs a scalar act step, "
                         f"got delta {tuple(st[0].shape)}, zero point "
                         f"{tuple(st[1].shape)}")
    return st


def _first(t) -> float:
    return float(t.reshape(-1)[0])


def _site_fits_int8_concrete(st) -> bool:
    _, zp, n_bits = st
    if not _scalar_step(st):
        return False
    zpv = _first(zp)
    return ((2 ** n_bits - 1) - zpv <= 127) and (-zpv >= -128)


def _chain_sum_sites(graph: Graph, act_steps: dict) -> dict:
    """Synthetic '<block>__sum__' sites for siteless residual blocks whose
    operand grids share one scalar step, while the summed centered codes
    fit int8. Returns {sum_site: (delta, zp0, n_bits)}."""
    out = {}
    current = None            # (site_name, centered_bound) of flowing tensor

    def bound_of(site):
        st = act_steps.get(site)
        if st is None or not _scalar_step(st):
            return None
        _, zp, nb = st
        zpv = _first(zp)
        return max(zpv, (2 ** nb - 1) - zpv)

    for node in graph:
        if isinstance(node, OpSpec):
            if node.op in ("gap", "avgpool", "flatten"):
                current = None
            continue
        if isinstance(node, UnitSpec):
            b = bound_of(node.name)
            current = (node.name, b) if b is not None else None
            continue
        entry = current
        last = node.units[-1].name
        no_site = act_steps.get(node.name) is None
        if (node.residual and node.downsample is None
                and node.post_activation is None and no_site
                and entry is not None and bound_of(last) is not None):
            e_site, e_bound = entry
            d_e = _first((out.get(e_site) or act_steps[e_site])[0])
            d_l = _first(act_steps[last][0])
            total = e_bound + bound_of(last)
            if d_e == d_l and total <= 127:
                name = f"{node.name}__sum__"
                out[name] = (act_steps[last][0],
                             torch.zeros_like(act_steps[last][1]),
                             act_steps[last][2])
                current = (name, total)
                continue
            current = None
        elif not node.residual and node.post_activation is None and no_site:
            b = bound_of(last)
            current = (last, b) if b is not None else None
        else:
            b = bound_of(node.name)
            current = (node.name, b) if b is not None else None
    return out


def _feeding_sites(graph: Graph, act_steps: dict) -> dict:
    """For each unit: the act site whose step governs the tensor feeding it
    (None = unquantized float input, e.g. the raw image)."""
    feed = {}
    current = "__input__"
    for node in graph:
        if isinstance(node, OpSpec):
            # maxpool keeps the grid; gap/avgpool leave it
            if node.op in ("gap", "avgpool"):
                current = "__offgrid__"
            continue
        if isinstance(node, UnitSpec):
            feed[node.name] = current if current in act_steps else None
            current = node.name
            continue
        if node.downsample is not None:
            feed[node.downsample.name] = current if current in act_steps \
                else None
        prev = current
        for u in node.units:
            feed[u.name] = prev if prev in act_steps else None
            prev = u.name
        if (not node.residual and node.post_activation is None
                and node.name not in act_steps):
            current = prev
        elif f"{node.name}__sum__" in act_steps \
                and node.name not in act_steps:
            current = f"{node.name}__sum__"
        else:
            current = node.name
    return feed


def _unit_in_hw(graph: Graph, input_hw) -> dict:
    """unit name -> input spatial size (downsample units see the block
    input)."""
    def conv_out(hw, u):
        return ((hw[0] + 2 * u.padding[0] - u.kernel[0]) // u.stride[0] + 1,
                (hw[1] + 2 * u.padding[1] - u.kernel[1]) // u.stride[1] + 1)

    hw = input_hw
    out = {}
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
        if isinstance(node, UnitSpec):
            out[node.name] = hw
            if node.kind == "conv":
                hw = conv_out(hw, node)
            continue
        if node.downsample is not None:
            out[node.downsample.name] = hw
        for u in node.units:
            out[u.name] = hw
            if u.kind == "conv":
                hw = conv_out(hw, u)
    return out


def make_deploy_plan(graph: Graph, dparams: dict, act_steps: dict,
                     input_hw=(224, 224)) -> dict:
    """Static execution plan: unit -> (kind, feeding site), with the kinds
    the JAX package's make_deploy_plan picks under the same ``SSQ_*``
    switches (its other switches at their defaults)."""
    sum_sites = _chain_sum_sites(graph, act_steps)
    act_steps = {**act_steps, **sum_sites}
    feed = _feeding_sites(graph, act_steps)
    int8_sites = frozenset(
        s for s in act_steps if _site_fits_int8_concrete(act_steps[s])
    ) | frozenset(sum_sites)
    # 8-bit unsigned sites (zp == 0): transported as biased (q - 128) int8
    biased_sites = frozenset(
        s for s in act_steps
        if s not in int8_sites and _scalar_step(act_steps[s])
        and act_steps[s][2] == 8 and _first(act_steps[s][1]) == 0.0)
    use_stem_kernel = os.environ.get("SSQ_STEM_KERNEL", "0") == "1"
    use_packed = os.environ.get("SSQ_PACKED", "0") == "1"
    use_dw_kernel = os.environ.get("SSQ_DW_KERNEL", "0") == "1"
    stem_1pass = os.environ.get("SSQ_STEM_1PASS", "1") != "0"
    nodes = list(graph)
    stem_unit = None
    if use_stem_kernel and len(nodes) >= 2:
        nd, nxt = nodes[0], nodes[1]
        if (isinstance(nd, UnitSpec) and nd.kind == "conv"
                and nd.kernel == (7, 7) and nd.stride == (2, 2)
                and nd.padding == (3, 3) and nd.groups == 1
                and nd.in_ch == 3 and nd.activation == "relu"
                and nd.name in act_steps
                and (nd.name in int8_sites or nd.name in biased_sites)
                and isinstance(nxt, OpSpec) and nxt.op == "maxpool"
                and nxt.window == (3, 3) and nxt.stride == (2, 2)
                and nxt.padding == (1, 1)):
            stem_unit = nd.name
    unit_hw = _unit_in_hw(graph, input_hw)
    plan = {}
    for u in iter_units(graph):
        d = dparams[u.name]
        site = feed[u.name]
        kind = "float"
        thin = min(u.out_ch, u.in_ch // u.groups) < THIN_CHANNELS
        if (u.kind == "conv" and 1 < u.groups < u.in_ch
                and site in int8_sites):
            # the JAX package densifies narrow grouped convs (int8_bd),
            # but not baked ones
            if d.w_bd is not None and d.w_groups is None:
                plan[u.name] = ("int8_bd", site)
                continue
            if d.w_int is not None and min(unit_hw[u.name]) >= 14:
                plan[u.name] = ("int8", site)
                continue
        # the depthwise kernel reads and writes centered int8 codes, so
        # the feed and the unit's own site must both fit int8
        if (use_dw_kernel and d.w_int is not None and u.kind == "conv"
                and u.groups == u.in_ch == u.out_ch
                and u.kernel == (3, 3) and u.padding == (1, 1)
                and u.stride[0] == u.stride[1] and u.stride[0] in (1, 2)
                and site in int8_sites and u.name in int8_sites
                and d.w_groups is None):
            plan[u.name] = ("dw_int8", site)
            continue
        if use_packed and d.w_packed is not None and site in int8_sites:
            plan[u.name] = ("packed", site)
            continue
        if d.w_int is not None and site is not None \
                and _scalar_step(act_steps[site]):
            _, zp, n_bits = act_steps[site]
            zpv = _first(zp)
            fits_int8 = ((2 ** n_bits - 1) - zpv <= 127) and (-zpv >= -128)
            fits_bf16 = (2 ** n_bits - 1) <= 256
            if thin and fits_bf16:
                kind = "bf16_codes"
            elif fits_int8:
                kind = "int8"
            elif n_bits == 8 and zpv == 0.0:
                kind = "int8_pair"
            elif fits_bf16:
                kind = "bf16_codes"
        if u.name == stem_unit and kind == "float" and site is None:
            kind = "stem_fused"
        if stem_1pass and kind == "float" and u.kind == "conv" \
                and u.in_ch <= 4:
            kind = "float_1p"
        plan[u.name] = (kind, site)
    plan["__fused_stem__"] = stem_unit
    plan["__int8_sites__"] = int8_sites
    plan["__biased_sites__"] = biased_sites
    plan["__sum_steps__"] = sum_sites
    plan["__kernel_consts__"] = {
        u.name: _kernel_consts(plan[u.name][0], u, dparams[u.name],
                               act_steps, plan[u.name][1], biased_sites)
        for u in iter_units(graph)
        if plan[u.name][0] in ("stem_fused", "dw_int8")}
    return plan


def _kernel_consts(kind, u: UnitSpec, d, act_steps, site, biased_sites):
    """What a ``stem_fused`` or ``dw_int8`` unit's launch reads besides its
    input, built once per plan on the deploy params' device (deploy_forward
    builds them again for an input on another device)."""
    delta_o, zp_o, n_bits_o = act_steps[u.name]
    zpv = zp_o.reshape(-1)[0].to(torch.float32)
    if kind == "stem_fused":
        coff = torch.full_like(zpv, 128.0) if u.name in biased_sites else zpv
        w_eff = d.w_int if d.w_int is not None else d.w_fp
        return prepare_stem(w_eff, d.scale, d.bias, delta_o, zpv,
                            2.0 ** n_bits_o - 1, coff)
    delta = act_steps[site][0]
    return prepare_dw(d.w_int.reshape(u.out_ch, 3, 3), d.scale * delta,
                      d.bias, delta_o, zpv, 2.0 ** n_bits_o - 1)


def _round_act(x):
    """Activation-requant rounding: floor(x + 0.5) (round-half-up), as the
    JAX deploy path rounds."""
    return torch.floor(x + 0.5)


def _quant_centered(x, delta, zp, n_bits):
    q = torch.clamp(_round_act(x / delta) + zp, 0, 2 ** n_bits - 1)
    return (q - zp).to(torch.int8)


@dataclasses.dataclass
class _Pending:
    """A unit's un-applied dequant epilogue: value = acc * scale + bias."""
    acc: torch.Tensor
    scale: Optional[torch.Tensor]
    bias: Optional[torch.Tensor]


@dataclasses.dataclass
class _Deferred:
    """A unit's kernel launch held back for its consumer, so that the
    requant runs in the kernel's epilogue: ``launch(rq)`` returns the int8
    codes of the ``Requant`` rq, ``launch(None)`` the sums, whose value is
    ``_Pending(sums, scale, bias)`` (``pending``) or the f32 sums
    themselves."""
    launch: Callable
    scale: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    pending: bool = True

    def sums(self):
        out = self.launch(None)
        return _Pending(out, self.scale, self.bias) if self.pending else out


def _finish_affine(acc, sc, b):
    y = acc if sc is None else acc * sc
    return y if b is None else y + b


def _int_launch(spec: UnitSpec, d: DeployUnit, xi, offset: int, delta,
                block_diagonal: bool = False):
    """The launch of the exact integer conv/linear of int8 feed codes
    ``xi`` whose centered value is ``xi + offset``: padding carries
    -offset (centered zero) and the offset's share comes back as offset *
    sum(w). ``launch(None)`` gives the f32 sums (a baked unit's through
    the scale table at ``delta``), ``launch(rq)`` the int8 codes of the
    ``Requant`` rq. Dense units run int8_conv, depthwise ones
    dw_conv_int8, grouped ones int8_group_conv; ``block_diagonal`` runs a
    grouped unit dense on its block-diagonal operand (int8_bd)."""
    w_mat, conv, extra = d.w_mat, int8_conv, {}
    if spec.kind == "conv":
        geom = (spec.kernel, spec.stride, spec.padding)
        x4 = xi
        if block_diagonal:
            w_mat = d.w_bd
        elif spec.groups == spec.in_ch == spec.out_ch > 1:
            conv = dw_conv_int8
        elif spec.groups != 1:
            conv, extra = int8_group_conv, {"conv_groups": spec.groups}
    else:
        geom = ((1, 1), (1, 1), (0, 0))
        x4 = xi.reshape(xi.shape[0], 1, 1, xi.shape[1])
    acc_offset = offset * d.w_sum if offset else None

    def launch(rq):
        # int32 sums, the f32 scale-table sum (baked unit), or int8 codes
        out = conv(x4.contiguous(), w_mat, *geom, pad_value=-offset,
                   group_scales=d.group_scales, act_delta=delta,
                   acc_offset=acc_offset, requant=rq, **extra)
        if rq is None and d.w_groups is None:
            out = out.to(torch.float32)
        if spec.kind != "conv":
            out = out.reshape(xi.shape[0], -1)
        return out

    return launch


def _int_unit(spec: UnitSpec, d: DeployUnit, xi, offset: int, delta,
              block_diagonal: bool = False):
    """``_int_launch``'s launch deferred to the unit's consumer, with the
    unit's epilogue pending (a baked unit's sums come through the scale
    table)."""
    scale = d.scale * delta if d.w_groups is None else None
    return _Deferred(_int_launch(spec, d, xi, offset, delta, block_diagonal),
                     scale, d.bias)


def _max_pool_codes(t, window, stride, padding):
    """NHWC max pool on int8 codes, -128 padding."""
    b, h, w, c = t.shape
    (kh, kw), (sh, sw), (ph, pw) = window, stride, padding
    ho = (h + 2 * ph - kh) // sh + 1
    wo = (w + 2 * pw - kw) // sw + 1
    tp = t.new_full((b, h + 2 * ph, w + 2 * pw, c), -128)
    tp[:, ph:ph + h, pw:pw + w, :] = t
    out = None
    for i in range(kh):
        for j in range(kw):
            s = tp[:, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw]
            out = s if out is None else torch.maximum(out, s)
    return out.contiguous()


@dataclasses.dataclass
class _Ctx:
    """What the value plumbing of one deploy forward needs: the act steps
    (with the plan's synthetic sum sites) and the transport of each site."""
    act_steps: dict
    int8_sites: frozenset
    biased_sites: frozenset

    def to_float(self, v):
        kind, t, site = v
        if kind == "f32":
            return t
        if kind == "pair":      # the terms' sum, in order
            acc = self.to_float(t[0])
            for term in t[1:]:
                acc = acc + self.to_float(term)
            return acc
        delta = self.act_steps[site][0]
        if kind == "biased":
            return (t.to(torch.float32) + 128.0) * delta
        return t.to(torch.float32) * delta

    def materialize(self, val, act=None):
        if isinstance(val, _Deferred):
            val = val.sums()
        if isinstance(val, tuple):
            return _activation(act, self.to_float(val))
        if isinstance(val, _Pending):
            return _activation(act, _finish_affine(val.acc, val.scale,
                                                   val.bias))
        return _activation(act, val)

    def affine(self, val, inv):
        """(acc, M, C) of the requant's multiply-add acc*M + C for ``val``
        onto a grid of step 1/inv; acc is None where the value is not
        there (a deferred launch, a kind-only tuple)."""
        if isinstance(val, _Pending) \
                or (isinstance(val, _Deferred) and val.pending):
            acc = val.acc if isinstance(val, _Pending) else None
            M = inv if val.scale is None else val.scale * inv
            C = 0.5 + (0.0 if val.bias is None else val.bias * inv)
            return acc, M, C
        if isinstance(val, tuple):
            kind_v, tv, site_v = val
            if kind_v == "f32":
                return tv, inv, 0.5
            acc = None if tv is None else tv.to(torch.float32)
            M = self.act_steps[site_v][0] * inv
            C = 0.5 + 128.0 * M if kind_v == "biased" else 0.5
            return acc, M, C
        return (None if isinstance(val, _Deferred) else val), inv, 0.5

    def residual(self, residual, inv, C):
        """(r, Mr, C): the residual's term r*Mr of the multiply-add, C with
        a biased residual's offset folded in."""
        kind_r, tr, site_r = residual
        if kind_r in ("f32", "pair"):
            return self.to_float(residual), inv, C
        Mr = self.act_steps[site_r][0] * inv
        return tr, Mr, (C + 128.0 * Mr if kind_r == "biased" else C)

    def clip(self, site, act, inv):
        """(zp0, lo, hi, sub, kind) of a requant onto an int8 or biased
        site after none, relu or relu6 (folded into the clip); None for
        other sites and activations."""
        delta, zp, n_bits = self.act_steps[site]
        if act not in (None, "relu", "relu6"):
            return None
        if site in self.int8_sites:
            zp0, lo, hi, sub, kind = zp, 0.0, 2.0 ** n_bits - 1, zp, "codes"
        elif site in self.biased_sites:
            zp0, lo, hi, sub, kind = (torch.zeros_like(zp), 0.0, 255.0,
                                      128.0, "biased")
        else:
            return None
        lo, hi, _ = _fold_act(act, zp0, lo, hi, inv)
        return zp0, lo, hi, sub, kind


def _fold_act(act, zp0, lo, hi, inv):
    """(lo, hi, act left to apply): relu and relu6 folded into the code
    clip of a site with zero point zp0 and step 1/inv."""
    if act not in ("relu", "relu6"):
        return lo, hi, act
    lo = torch.clamp(zp0, min=lo)                        # code(0) == zp
    if act == "relu6":
        hi = torch.clamp(torch.floor(6.0 * inv + 0.5) + zp0, max=hi)
    return lo, hi, None


def quantize_out(ctx: _Ctx, val, site, act=None, residual=None):
    """Producer-side epilogue + quantization onto the site grid, fused
    into one multiply-add in code space: q = clip(floor(acc*M [+ r*Mr]
    + C + zp), lo, hi), clamp activations folded into the clip. A deferred
    int8_conv / packed launch runs it in its kernel's epilogue (an int8 or
    biased site, none / relu / relu6); every other requant runs as PyTorch
    elementwise ops and adds one to ``quantize_out.unfused``."""
    if isinstance(val, tuple) and residual is None and val[2] == site:
        return val          # kernel output already on this site's grid
    st = ctx.act_steps.get(site)
    if st is None:
        y = ctx.materialize(val)
        if residual is not None:
            y = y + ctx.to_float(residual)
        return ("f32", _activation(act, y), None)
    delta, zp, n_bits = st
    inv = 1.0 / delta
    clip = ctx.clip(site, act, inv)
    if isinstance(val, _Deferred) and clip is None:
        val = val.sums()
    acc, M, C = ctx.affine(val, inv)
    r, Mr = None, None
    if residual is not None:
        r, Mr, C = ctx.residual(residual, inv, C)
    if clip is not None:
        zp0, lo, hi, sub, kind = clip
        rq = Requant(m1=M, c1=C + zp0, q1=(lo, hi, sub)) if r is None \
            else Requant(m2=M, c2=C + zp0, q2=(lo, hi, sub), r=r, mr=Mr)
        if isinstance(val, _Deferred):
            return (kind, val.launch(rq), site)
        quantize_out.unfused += 1
        return (kind, requant_plain(acc, rq), site)
    quantize_out.unfused += 1
    if r is not None:
        r = r.to(torch.float32)

    def codes_of(zp0, lo: float, hi: float):
        lo, hi, a = _fold_act(act, zp0, lo, hi, inv)
        arg = acc * M + (C + zp0) if r is None \
            else acc * M + r * Mr + (C + zp0)
        if a is not None:
            y = _activation(a, (arg - (0.5 + zp0)) * delta)
            return _clip(torch.floor(y * inv + 0.5) + zp0, lo, hi)
        return _clip(torch.floor(arg), lo, hi)

    if site in ctx.int8_sites:
        q = codes_of(zp, 0.0, 2.0 ** n_bits - 1)
        return ("codes", (q - zp).to(torch.int8), site)
    if site in ctx.biased_sites:
        q = codes_of(torch.zeros_like(zp), 0.0, 255.0)
        return ("biased", (q - 128).to(torch.int8), site)
    q = codes_of(zp, 0.0, 2.0 ** n_bits - 1)
    return ("f32", (q - zp) * delta, None)


quantize_out.unfused = 0


def _block_requant(ctx: _Ctx, val: _Deferred, unit: UnitSpec,
                   node: BlockSpec, res_v):
    """The block's requant (with its residual) run in the epilogue of its
    last unit's deferred launch, after that unit's own epilogue: its
    requant onto its site, or without a site the f32 affine its sums
    materialize to. None where the block's requant does not fuse."""
    bst = ctx.act_steps.get(node.name)
    if bst is None:
        return None
    binv = 1.0 / bst[0]
    bclip = ctx.clip(node.name, node.post_activation, binv)
    if bclip is None:
        return None
    ust = ctx.act_steps.get(unit.name)
    if ust is None:
        if unit.activation is not None:
            return None
        m1, c1, q1 = (val.scale, val.bias, None) if val.pending \
            else (None, None, None)
        val2 = ("f32", None, None)
    else:
        uinv = 1.0 / ust[0]
        uclip = ctx.clip(unit.name, unit.activation, uinv)
        if uclip is None:
            return None
        _, M1, C1 = ctx.affine(val, uinv)
        zp0, lo, hi, sub, kind = uclip
        m1, c1, q1 = M1, C1 + zp0, (lo, hi, sub)
        val2 = (kind, None, unit.name)
    _, M2, C2 = ctx.affine(val2, binv)
    r, Mr = None, None
    if res_v is not None:
        r, Mr, C2 = ctx.residual(res_v, binv, C2)
    zp0, lo, hi, sub, kind = bclip
    rq = Requant(m1=m1, c1=c1, q1=q1, m2=M2, c2=C2 + zp0, q2=(lo, hi, sub),
                 r=r, mr=Mr)
    return (kind, val.launch(rq), node.name)


def _traced_nodes(graph: Graph, trace: Optional[list], snap):
    """The graph's nodes; with a ``trace`` list, (node name, float value
    after the node) appended after each node has run."""
    if trace is None:
        yield from graph
        return
    for node in graph:
        yield node
        trace.append((node.name, snap()))


def deploy_forward(graph: Graph, dparams: dict, act_steps: dict, x,
                   plan: Optional[dict] = None, device="cuda",
                   trace: Optional[list] = None):
    """Integer inference on NHWC input; returns the network output.

    ``act_steps`` from act_steps_from_qstate; ``plan`` from make_deploy_plan
    (computed here if omitted). Values between nodes are ('codes', int8,
    site), ('biased', int8, site), ('pair', terms, None) or ('f32',
    tensor, None). With a ``trace`` list, (name, float value) is appended
    after each unit of a block and after each node, as the JAX package
    does: the first unit where two forwards part. The served route stays
    the same; where a block's last unit writes the block site's codes,
    the trace requantizes that unit once more for its own value, and that
    extra launch or requant shows in the counts."""
    pair_stats["formed"] = 0
    pair_stats["consumed_fast"] = 0
    pair_terms = int(os.environ.get("SSQ_PAIR_TERMS", "2"))
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    if plan is None:
        plan = make_deploy_plan(graph, dparams, act_steps)
    act_steps = {**act_steps, **plan.get("__sum_steps__", {})}
    ctx = _Ctx(act_steps, plan["__int8_sites__"],
               plan.get("__biased_sites__", frozenset()))
    biased_sites = ctx.biased_sites
    to_float, materialize = ctx.to_float, ctx.materialize
    stem_name = plan.get("__fused_stem__")
    stem_ok = (stem_name is not None and x.ndim == 4
               and x.shape[1] == x.shape[2] and x.shape[1] % 8 == 0)
    consts = plan.get("__kernel_consts__", {})

    def unit_consts(spec: UnitSpec, device):
        """The unit's prepared launch constants, on ``device``."""
        k = consts.get(spec.name)
        if k is None or k.device != device:
            k = _kernel_consts(plan[spec.name][0], spec, dparams[spec.name],
                               act_steps, plan[spec.name][1], biased_sites)
            if k.device != device:
                raise ValueError(f"{spec.name}: deploy params on "
                                 f"{k.device}, input on {device}")
        return k

    def int_feed(v, delta, zp, n_bits):
        """Feed value -> (int8 codes, offset), centered = codes + offset."""
        vkind, t, _ = v
        if vkind == "codes":
            return t, 0
        if vkind == "biased":
            return t, 128           # biased sites have zp == 0
        zpv = int(_first(zp))
        if -zpv >= -128 and (2 ** n_bits - 1) - zpv <= 127:
            return _quant_centered(t, delta, zp, n_bits), 0
        q = torch.clamp(_round_act(t / delta) + zp, 0, 2 ** n_bits - 1)
        return (q - 128).to(torch.int8), 128 - zpv

    def run_unit(spec: UnitSpec, v):
        d = dparams[spec.name]
        kind_plan, feed_site = plan[spec.name]
        if v[0] == "pair" and kind_plan == "float" and d.w_int is not None \
                and d.w_groups is None:
            # a pair-fed consumer: the conv is linear, so conv(sum_i q_i *
            # d_i) is sum_i float(conv_int(q_i)) * d_i, one exact int8_conv
            # per term (a baked unit takes the f32 route below)
            pair_stats["consumed_fast"] += 1
            acc = None
            for _, tc, site in v[1]:
                term = _int_launch(spec, d, tc.contiguous(), 0, None)(None) \
                    * act_steps[site][0]
                acc = term if acc is None else acc + term
            return _Pending(acc, d.scale, d.bias)
        if kind_plan == "stem_fused" and not stem_ok:
            kind_plan = "float"       # kernel needs square, 8-aligned input
        if kind_plan in UNPORTED_KINDS:
            raise NotImplementedError(
                f"deploy plan kind {kind_plan!r} ({spec.name}) is not ported")
        if kind_plan == "stem_fused":
            # conv + relu + quant + maxpool in one kernel; the following
            # maxpool OpSpec is skipped by the walk below
            xf = to_float(v).contiguous()
            codes = stem_fused_prepared(xf, unit_consts(spec, xf.device))
            biased = spec.name in biased_sites
            return ("biased" if biased else "codes", codes, spec.name)
        if kind_plan == "dw_int8":
            # depthwise conv + epilogue + requant onto the unit's own grid
            # in one kernel; quantize_out passes its codes through
            delta, zp, n_bits = _scalar_feed(act_steps[feed_site], spec.name)
            vkind, t, _ = v
            xi = t if vkind == "codes" \
                else _quant_centered(to_float(v), delta, zp, n_bits)
            xi = xi.contiguous()
            out = dw_conv3x3_int8_prepared(
                xi, unit_consts(spec, xi.device), stride=spec.stride[0],
                act=spec.activation or "none")
            return ("codes", out, spec.name)
        if kind_plan == "packed":
            # 1x1 convs read their (strided) NHWC rows in the kernel; codes
            # go in as int8 (their step scales the epilogue), f32 feeds are
            # quantized on the way in
            delta, zp, n_bits = _scalar_feed(act_steps[feed_site], spec.name)
            zpv = zp.reshape(-1)[0].to(torch.float32)
            dv = delta.reshape(-1)[0].to(torch.float32)
            vkind, t, _ = v
            xin = t if vkind == "codes" else to_float(v)
            stride = 1
            if spec.kind == "conv" and spec.stride != (1, 1):
                if spec.stride[0] == spec.stride[1]:
                    stride = spec.stride[0]
                else:
                    xin = xin[:, ::spec.stride[0], ::spec.stride[1], :]
            xin = xin.contiguous()
            return _Deferred(lambda rq: packed_quant_matmul(
                xin, d.w_packed, d.w_pack_zp, d.scale.contiguous(),
                d.bias.contiguous(), dv, zpv, d.w_pack_bits, n_bits,
                stride=stride, requant=rq), pending=False)
        if kind_plan in ("int8", "bf16_codes", "int8_bd", "int8_pair"):
            # int8_pair's 8-bit unsigned feed arrives as biased codes with
            # offset 128: one launch computes its 16*hi + lo sum
            delta, zp, n_bits = _scalar_feed(act_steps[feed_site], spec.name)
            xi, offset = int_feed(v, delta, zp, n_bits)
            return _int_unit(spec, d, xi, offset, delta,
                             block_diagonal=kind_plan == "int8_bd")
        # float / float_1p: conv with integer-code weights, TF32 off;
        # float_1p rounds the activation to bf16 first, as the JAX single
        # bf16 pass does (the weight codes are bf16-exact). A float unit
        # sums in float64, rounded once to f32: on an f32 edge of a
        # per-channel site (codes times a step and its halves) the
        # products and sums of integer-code weights are exact in float64,
        # so the card and the CPU agree bit for bit in any summation
        # order, where f32 sums (or cuDNN's Winograd) round per device
        # and flip the next site's codes
        xf = materialize(v)
        if kind_plan == "float_1p":
            xf = xf.to(torch.bfloat16).to(torch.float32)
        w_eff = (d.w_int if d.w_int is not None else d.w_fp) \
            .to(torch.float32)
        if d.w_groups is not None:
            # baked unit on a float edge: fold the scale table back into
            # the weight (group_scales / scale is each candidate's shift)
            ratio = (d.group_scales / d.scale[None, :]).reshape(
                (d.w_groups.shape[0], -1) + (1,) * (w_eff.ndim - 1))
            w_eff = (d.w_groups.to(torch.float32) * ratio).sum(dim=0)
        if kind_plan == "float":
            xf, w_eff = xf.double(), w_eff.double()
        if spec.kind == "conv":
            out = conv2d(xf, w_eff, None, spec.stride, spec.padding,
                         spec.groups)
        else:
            out = xf @ w_eff.T
        return _Pending(out.float(), d.scale, d.bias)

    def run_block(node: BlockSpec, v):
        res_v = None
        if node.residual:
            # identity residuals stay codes and fuse into the block-site
            # requant; downsample residuals materialize their epilogue
            res_v = ("f32", materialize(run_unit(node.downsample, v),
                                        node.downsample.activation), None) \
                if node.downsample is not None else v
        t = v
        for u in node.units[:-1]:
            t = quantize_out(ctx, run_unit(u, t), u.name, u.activation)
            if trace is not None:
                trace.append((u.name, to_float(t)))
        last = node.units[-1]
        val = run_unit(last, t)
        if isinstance(val, _Deferred):
            # the last unit's kernel writes the block site's codes
            fused = _block_requant(ctx, val, last, node, res_v)
            if fused is not None:
                if trace is not None:
                    trace.append((last.name, to_float(quantize_out(
                        ctx, val, last.name, last.activation))))
                return fused
        t = quantize_out(ctx, val, last.name, last.activation)
        if trace is not None:
            trace.append((last.name, to_float(t)))
        no_site = act_steps.get(node.name) is None
        sum_site = f"{node.name}__sum__"
        if (node.post_activation is None and no_site
                and sum_site in act_steps and t[0] == "codes"
                and res_v is not None and res_v[0] == "codes"):
            # harmonized chain (equal-delta grids): an exact int8 code add
            return ("codes", t[1] + res_v[1], sum_site)
        if res_v is None and node.post_activation is None and no_site:
            return t            # siteless pass-through keeps its codes
        if (pair_terms >= 2 and node.post_activation is None and no_site
                and t[0] == "codes" and res_v[0] in ("codes", "pair")
                and (res_v[0] == "codes" or len(res_v[1]) < pair_terms)):
            # siteless residual of code grids: the sum is deferred to the
            # consumer; deeper chains than the cap take the exact f32 sum
            # below
            terms = (res_v,) if res_v[0] == "codes" else res_v[1]
            pair_stats["formed"] += 1
            return ("pair", (t,) + tuple(terms), None)
        return quantize_out(ctx, t, node.name, node.post_activation,
                            residual=res_v)

    v = ("f32", x, None)
    pooled_by_stem = False
    with torch.no_grad(), _fp32():
        for node in _traced_nodes(graph, trace, lambda: to_float(v)):
            if isinstance(node, OpSpec):
                if v[0] == "pair":          # ops take a plain tensor
                    v = ("f32", to_float(v), None)
                kind, t, site = v
                if node.op == "maxpool" and pooled_by_stem:
                    pooled_by_stem = False   # the stem kernel pooled
                elif node.op == "maxpool":
                    # monotonic: pool codes directly, or floats
                    if kind in ("codes", "biased"):
                        v = (kind, _max_pool_codes(t, node.window,
                                                   node.stride,
                                                   node.padding), site)
                    else:
                        v = (kind, max_pool(t, node.window, node.stride,
                                            node.padding), site)
                elif node.op == "gap":
                    v = ("f32", global_avg_pool(to_float(v)), None)
                elif node.op == "flatten":
                    v = ("f32", to_float(v).reshape(t.shape[0], -1), None)
            elif isinstance(node, UnitSpec):
                v = quantize_out(ctx, run_unit(node, v), node.name,
                                 node.activation)
                if node.name == stem_name and stem_ok:
                    pooled_by_stem = True
            else:
                v = run_block(node, v)
        return to_float(v)
