"""Quantized-model construction and state (PyTorch port of
``shiftedscalequantization_tpu/quantize.py:25-192``).

BN-fold once, derive an explicit qstate dict, and express "quant on/off" as
Flags values. Head and stem stay 8-bit (``use_8bit_head_stem``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import fold_bn as fb
from ._device import resolve_device
from .graph import BlockSpec, Flags, Graph, UnitQuant, UnitSpec, \
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
    dev = resolve_device(device)
    raw = {name: _to_device(p, dev) for name, p in raw_params.items()}
    with torch.no_grad():
        folded = fb.fold_bn(raw)
        qstate = build_qstate(graph, folded, cfg)
    return folded, qstate


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return torch.as_tensor(tree, device=dev)
