"""Offline analysis / visualization tools (PyTorch port of
``shiftedscalequantization_tpu/utils/analysis.py``).

Weight distribution plots (the reference's myVisualize.py), the
independent numpy re-implementation of the MSE scale init used as a
cross-check oracle (myQuant.py:6-44), per-channel scale-candidate
statistics, and selection-ratio summaries after reconstruction. The numpy
code is the port's own copy; the functions take the port's tensors
(on any device) where the JAX package's took arrays.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def numpy_mse_scale_init(x: np.ndarray, n_bits: int, n_grid: int = 80,
                         p: float = 2.4):
    """Pure-numpy oracle of the LAPQ MSE grid init (the myQuant.py:6-44
    role): independent of the port's implementation, for cross-checking."""
    n_levels = 2 ** n_bits
    x_max, x_min = x.max(), x.min()
    best, bd, bzp = np.inf, None, None
    for i in range(n_grid):
        nm, nn = x_max * (1 - i * 0.01), x_min * (1 - i * 0.01)
        d = (nm - nn) / (n_levels - 1)
        if abs(d) < 1e-12:
            continue
        z = np.round(-nn / d)
        xq = np.clip(np.round(x / d) + z, 0, n_levels - 1)
        xdq = (xq - z) * d
        score = (np.abs(xdq - x) ** p).mean()
        if score < best:
            best, bd, bzp = score, d, z
    return bd, bzp, best


def weight_channel_stats(w) -> dict:
    """Per-out-channel spread statistics (the channel-spread hypothesis the
    reference explores in analysis/weight_plot.ipynb)."""
    w = _host(w)
    flat = w.reshape(w.shape[0], -1)
    absmax = np.abs(flat).max(axis=1)
    return {
        "oc": w.shape[0],
        "absmax_per_channel": absmax,
        "absmax_ratio": float(absmax.max() / max(absmax.min(), 1e-12)),
        "std_per_channel": flat.std(axis=1),
        "kurtosis_proxy": float(((flat - flat.mean()) ** 4).mean()
                                / (flat.var() ** 2 + 1e-12)),
    }


def selection_summary(selection_ratios: dict) -> str:
    """Printable summary of shift-selection ratios (the reference's
    print_ratio output format, layer_recon_fused_shiftedScale.py:13-21),
    e.g. of ``recon.engine.selection_ratios``."""
    lines = []
    for name, ratios in selection_ratios.items():
        if isinstance(ratios, str):   # e.g. 'skipped:high-bit' marker
            lines.append(f"{name} : {ratios}")
            continue
        r = _host(ratios)
        parts = " ".join(f"{i}:{v:.3f}" for i, v in enumerate(r))
        lines.append(f"{name} : {parts}")
    return "\n".join(lines)


def plot_weight_distributions(params: dict, unit_names, path: str,
                              qstate: Optional[dict] = None):
    """Violin-style per-channel weight distribution plot
    (myVisualize.py role), with each channel's quantizer range from
    ``qstate[name].wq.qp`` when given. Writes a PNG; needs matplotlib
    (ImportError without it)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(unit_names)
    fig, axes = plt.subplots(n, 1, figsize=(10, 2.2 * n), squeeze=False)
    for ax, name in zip(axes[:, 0], unit_names):
        w = _host(params[name]["w"])
        flat = w.reshape(w.shape[0], -1)
        show = flat[: min(32, flat.shape[0])]
        ax.violinplot([c for c in show], showextrema=False, widths=0.9)
        if qstate is not None and name in qstate:
            qp = qstate[name].wq.qp
            delta = _host(qp.delta).reshape(-1)
            zp = _host(qp.zero_point).reshape(-1)
            hi = delta * (2 ** qp.n_bits - 1 - zp)
            lo = -delta * zp
            xs = np.arange(1, show.shape[0] + 1)
            ax.plot(xs, hi[: len(xs)], "r.", ms=3, label="quant max")
            ax.plot(xs, lo[: len(xs)], "b.", ms=3, label="quant min")
        ax.set_title(name, fontsize=8)
        ax.tick_params(labelsize=6)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
