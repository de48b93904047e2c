"""Quantized-model construction and state (PyTorch port of
``shiftedscalequantization_tpu/quantize.py``).

BN-fold once, derive an explicit qstate dict, and express "quant on/off" as
Flags values. Head and stem stay 8-bit (``use_8bit_head_stem``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import fold_bn as fb
from ._device import resolve_device
from .graph import BlockSpec, Flags, Graph, OpSpec, UnitQuant, UnitSpec, \
    init_act_quant, iter_units
from .ops import quant as Q
from .ops import wquant as W


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantization hyperparameters."""
    n_bits_w: int = 2
    n_bits_a: int = 4
    channel_wise: bool = True
    sym: bool = False
    w_scale_method: str = "mse"      # 'mse' | 'max'
    a_scale_method: str = "mse"
    use_8bit_head_stem: bool = True


def build_qstate(graph: Graph, folded_params: dict, cfg: QuantConfig) -> dict:
    """Per-unit weight quantizers from the folded weights, with the 8-bit
    head/stem rule when cfg.use_8bit_head_stem."""
    wbit_override, _ = _head_stem_overrides(unit_order(graph), cfg)
    qstate = {}
    for u in iter_units(graph):
        w = folded_params[u.name]["w"]
        qp, raw_zp = W_init(w, wbit_override.get(u.name, cfg.n_bits_w), cfg)
        qstate[u.name] = UnitQuant(
            wq=W.UniformWQ(qp=qp), aq=None,
            alpha_out=torch.ones((u.out_ch,), dtype=w.dtype, device=w.device),
            beta_out=torch.zeros((u.out_ch,), dtype=w.dtype,
                                 device=w.device),
            raw_zp=raw_zp)
    return qstate


def W_init(w, n_bits, cfg: QuantConfig):
    return Q.init_weight_qparams(
        w.reshape(w.shape[0], -1), n_bits=n_bits, sym=cfg.sym,
        channel_wise=cfg.channel_wise, scale_method=cfg.w_scale_method)


def unit_order(graph: Graph):
    """Units in module-registration order."""
    return [u.name for u in iter_units(graph)]


def _head_stem_overrides(order, cfg: QuantConfig):
    """(weight-bit overrides, act-bit overrides) for 8-bit head/stem."""
    if not cfg.use_8bit_head_stem or len(order) < 2:
        return {}, {}
    return {order[0]: 8, order[-1]: 8}, {order[0]: 8, order[-2]: 8}


def reconstruction_targets(graph: Graph, block_level: bool = True):
    """Nodes to reconstruct, in order; the first unit is skipped (the
    8-bit stem is not reconstructed). Blocks without a block act site, and
    every block when ``block_level`` is False, are reconstructed unit by
    unit."""
    first = unit_order(graph)[0]
    targets = []
    for node in graph:
        if isinstance(node, UnitSpec):
            if node.name != first:
                targets.append(node.name)
        elif isinstance(node, BlockSpec):
            if block_level and node.block_act_quant:
                targets.append(node.name)
            else:
                targets.extend(u.name for u in node.units)
                if node.downsample is not None:
                    targets.append(node.downsample.name)
    return targets


def act_quant_sites(graph: Graph, cfg: QuantConfig,
                    disable_output_quant: bool = True):
    """name -> n_bits for every act-quant site (units with act quant
    enabled, and block outputs), honoring 8-bit head/stem and the disabled
    network-output quantizer."""
    order = unit_order(graph)
    _, abit_override = _head_stem_overrides(order, cfg)
    sites = {}
    for node in graph:
        if isinstance(node, UnitSpec):
            if not node.disable_act_quant:
                sites[node.name] = abit_override.get(node.name, cfg.n_bits_a)
        elif isinstance(node, BlockSpec):
            for u in node.units:
                if not u.disable_act_quant:
                    sites[u.name] = abit_override.get(u.name, cfg.n_bits_a)
            if node.block_act_quant:
                sites[node.name] = cfg.n_bits_a
    if disable_output_quant and order[-1] in sites:
        del sites[order[-1]]
    return sites


def act_flags(graph: Graph, cfg: QuantConfig, base: Optional[Flags] = None,
              disable_output_quant: bool = True) -> Flags:
    """Flags with act quant on exactly at the calibrated sites."""
    sites = act_quant_sites(graph, cfg, disable_output_quant)
    return dataclasses.replace(base or Flags(), act_on=frozenset(sites))


def calibrate_acts(graph: Graph, params, qstate, cali_batch,
                   cfg: QuantConfig, flags: Optional[Flags] = None,
                   disable_output_quant: bool = True,
                   bit_overrides: Optional[dict] = None, device="cuda"):
    """Initialize every activation quantizer in one pass over
    ``cali_batch`` (NHWC) and return a new qstate with aq set. ``flags``
    says which weight quantizers are live (default: all)."""
    if flags is None:
        flags = Flags().all_weights(graph)
    sites = act_quant_sites(graph, cfg, disable_output_quant)
    for name, bits in (bit_overrides or {}).items():
        if name not in sites:
            raise KeyError(
                f"act bit override for unknown/siteless act site {name!r}; "
                f"known sites: {sorted(sites)}")
        sites[name] = int(bits)
    new_aq = init_act_quant(graph, params, qstate, cali_batch, flags, sites,
                            act_sym=False, scale_method=cfg.a_scale_method,
                            device=device)
    qstate = dict(qstate)
    for name, qp in new_aq.items():
        if name in qstate and isinstance(qstate[name], UnitQuant):
            qstate[name] = dataclasses.replace(qstate[name], aq=qp)
        else:
            qstate[name] = qp
    return qstate


def prepare_model(graph: Graph, raw_params: dict, cfg: QuantConfig,
                  device="cuda"):
    """BN-fold + weight quantizer init. ``raw_params`` may hold tensors
    on any device or numpy arrays; they are moved to ``device``. Returns
    (folded_params, qstate)."""
    raw = to_device(raw_params, resolve_device(device))
    with torch.no_grad():
        folded = fb.fold_bn(raw)
        qstate = build_qstate(graph, folded, cfg)
    return folded, qstate


def _map_arrays(tree, fn):
    """``tree`` (dicts, UnitQuant and quantizer dataclasses) with ``fn``
    applied to every tensor or numpy array; other leaves are kept."""
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_arrays(v, fn) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_arrays(getattr(tree, f.name), fn)
            for f in dataclasses.fields(tree)})
    return tree


def to_device(tree, device):
    """A copy of params or qstate with every array a tensor on
    ``device``."""
    return _map_arrays(tree, lambda a: torch.as_tensor(a, device=device))


def to_numpy(tree):
    """A copy of params or qstate with every array a CPU numpy array (the
    checkpoint form; ``to_device`` inverts it)."""
    return _map_arrays(tree, lambda a: a.detach().cpu().numpy()
                       if torch.is_tensor(a) else a)


def harmonize_residual_chains(graph: Graph, qstate):
    """Share one act step across every siteless residual chain.

    Blocks without a block act site (MobileNetV2's and MNASNet's residual
    adds) leave the add unquantized, each operand on its own unit grid.
    This rewrites each chain's member act quantizers to the chain's largest
    delta, rescaling zero_point to keep the covered range anchored, so the
    add is exact in code space. Returns (new_qstate, {site: d_max /
    d_site}); a ratio of 1.0 means the site already had the chain's step.
    """
    def scalar_aq(name):
        uq = qstate.get(name)
        if not isinstance(uq, UnitQuant) or not isinstance(uq.aq,
                                                           Q.QParams):
            return None     # uncalibrated, or per-channel (ActShiftQuant)
        return uq.aq if uq.aq.delta.numel() == 1 else None

    parent = {}

    def find(a):
        parent.setdefault(a, a)
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    current = None          # site name of the tensor flowing forward
    for node in graph:
        if isinstance(node, OpSpec):
            if node.op in ("gap", "avgpool", "flatten"):
                current = None
            continue
        if isinstance(node, UnitSpec):
            current = node.name if scalar_aq(node.name) else None
            continue
        last = node.units[-1].name
        block_site = qstate.get(node.name) is not None
        if (node.residual and node.downsample is None
                and node.post_activation is None and not block_site
                and current is not None and scalar_aq(last) is not None):
            parent[find(current)] = find(last)
            current = last
        elif not node.residual and node.post_activation is None \
                and not block_site:
            current = last if scalar_aq(last) is not None else None
        else:
            current = node.name if block_site else None

    groups = {}
    for name in parent:
        groups.setdefault(find(name), []).append(name)
    qstate = dict(qstate)
    ratios = {}
    for members in groups.values():
        if len(members) < 2:
            continue
        d_max = max(float(qstate[m].aq.delta) for m in members)
        for m in members:
            aq = qstate[m].aq
            d_old = float(aq.delta)
            ratios[m] = d_max / d_old
            qstate[m] = dataclasses.replace(qstate[m], aq=dataclasses.replace(
                aq, delta=torch.full_like(aq.delta, d_max),
                zero_point=torch.round(aq.zero_point * (d_old / d_max))))
    return qstate, ratios
