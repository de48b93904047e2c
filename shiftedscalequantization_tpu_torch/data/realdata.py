"""Real and procedural datasets for accuracy experiments (PyTorch port of
``shiftedscalequantization_tpu/data/realdata.py``).

  * ``digits``: sklearn's bundled real handwritten-digit images (1797
    samples, 8x8 grayscale, 10 classes) upsampled to 32x32 RGB, with the
    JAX package's deterministic train/test split. The bilinear resize is
    ``F.interpolate(..., align_corners=False)``, which computes what
    ``jax.image.resize(..., "bilinear")`` does when upsampling.
  * ``synth10``: a seeded procedural 10-class 32x32x3 shape/texture
    dataset (circle / square / triangle / ring / cross / diamond /
    two-dots x solid / striped). Drawing and rendering are split:
    ``synth10_draws`` takes every random number from one
    ``torch.Generator`` seeded with ``seed``, in the JAX package's order,
    and
    ``synth10_render`` is pure geometry on those draws. The port cannot
    reproduce ``jax.random`` bit for bit, so its synth10 images are a
    different sample of the same distribution; rendering the JAX
    package's own draws gives its images.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# digits (real data)
# ---------------------------------------------------------------------------

DIGITS_MEAN = 0.30
DIGITS_STD = 0.33


def digits_arrays(size: int = 32):
    """(x_train, y_train, x_test, y_test) NHWC float32 numpy, normalized.

    Every 5th sample is test (deterministic, class-balanced in
    expectation): 1438 train / 359 test. Needs scikit-learn (ImportError
    without it; nothing else stands in for the data).
    """
    from sklearn.datasets import load_digits

    d = load_digits()
    x = (d.images / 16.0).astype(np.float32)          # (1797, 8, 8) in [0,1]
    y = d.target.astype(np.int32)
    x = F.interpolate(torch.from_numpy(x)[:, None], size=(size, size),
                      mode="bilinear", align_corners=False)[:, 0].numpy()
    x = np.repeat(x[..., None], 3, axis=-1)           # grayscale -> RGB
    x = (x - DIGITS_MEAN) / DIGITS_STD
    test_mask = (np.arange(x.shape[0]) % 5) == 4
    return (x[~test_mask], y[~test_mask], x[test_mask], y[test_mask])


# ---------------------------------------------------------------------------
# synth10 (procedural)
# ---------------------------------------------------------------------------

# class -> shape primitive: 0 circle, 1 square, 2 triangle, 3 ring,
# 4 cross, 5 diamond, 6 two-dots
_SHAPE_OF_CLASS = (0, 1, 2, 3, 4, 0, 1, 5, 6, 4)
_STRIPED_CLASS = (0., 0., 0., 0., 0., 1., 1., 0., 0., 1.)


def synth10_draws(n: int, size: int = 32, seed: int = 0,
                  generator: torch.Generator | None = None):
    """Every random number of a batch of ``n`` samples, in the JAX
    package's order (its keys ks[0]..ks[12]): labels, centre, scale, the
    two rotations, stripe phase, foreground colour, background frequencies
    and phases, pixel noise. Drawn from ``generator``, on its device (a
    training step draws on the card), else from a CPU generator seeded
    with ``seed``."""
    g = generator if generator is not None \
        else torch.Generator().manual_seed(seed)
    dev = g.device

    def u(lo, hi, shape=(n, 1, 1)):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    y = torch.randint(0, 10, (n,), generator=g, device=dev)
    cx, cy = u(-5, 5), u(-5, 5)
    scale = u(0.75, 1.25)
    rot_full = u(0.0, 2 * math.pi)
    rot_lim = u(-0.35, 0.35)
    phase = u(0.0, 2 * math.pi)
    fg = u(0.45, 1.0, (n, 1, 1, 3))
    f1, f2 = u(0.1, 0.5), u(0.1, 0.5)
    p1, p2 = u(0, 2 * math.pi), u(0, 2 * math.pi)
    noise = torch.randn((n, size, size, 3), generator=g, device=dev)
    return dict(y=y, cx=cx, cy=cy, scale=scale, rot_full=rot_full,
                rot_lim=rot_lim, phase=phase, fg=fg, f1=f1, f2=f2, p1=p1,
                p2=p2, noise=noise)


def synth10_render(draws: dict, size: int = 32):
    """Render the samples of ``draws`` (``synth10_draws``' keys, tensors on
    one device). Returns (x NHWC f32 normalized, y int32)."""
    dr = {k: torch.as_tensor(v) for k, v in draws.items()}
    y = dr["y"].long()
    dev = y.device
    sig = torch.sigmoid
    shape_id = torch.tensor(_SHAPE_OF_CLASS, device=dev)[y]       # (n,)
    striped = torch.tensor(_STRIPED_CLASS, device=dev)[y][:, None, None]
    cx, cy, scale = dr["cx"], dr["cy"], dr["scale"]
    # square (1) vs diamond (5) differ only by 45 degrees: those two
    # classes get bounded rotation so they stay distinguishable
    sq_fam = ((shape_id == 1) | (shape_id == 5))[:, None, None]
    rot = torch.where(sq_fam, dr["rot_lim"], dr["rot_full"])

    c = (size - 1) / 2.0
    grid = torch.arange(size, dtype=torch.float32, device=dev) - c
    xx = grid[None, None, :]                           # (1,1,S)
    yy = grid[None, :, None]                           # (1,S,1)
    dx, dy = xx - cx, yy - cy
    cr, sr = torch.cos(rot), torch.sin(rot)
    xr = cr * dx + sr * dy                             # (n,S,S)
    yr = -sr * dx + cr * dy

    r0 = 9.0 * scale
    e = 0.9                                            # soft (antialiased) edge
    d = torch.sqrt(xr ** 2 + yr ** 2 + 1e-6)
    circle = sig((0.85 * r0 - d) / e)
    square = sig((0.72 * r0 - torch.maximum(xr.abs(), yr.abs())) / e)
    tri = sig((0.55 * r0
               - torch.maximum(0.866 * xr.abs() + 0.5 * yr, -yr)) / e)
    ring = sig((0.95 * r0 - d) / e) * sig((d - 0.5 * r0) / e)
    bar_h = sig((r0 - xr.abs()) / e) * sig((0.28 * r0 - yr.abs()) / e)
    bar_v = sig((0.28 * r0 - xr.abs()) / e) * sig((r0 - yr.abs()) / e)
    cross = torch.maximum(bar_h, bar_v)
    diamond = sig((0.9 * r0 - (xr.abs() + yr.abs())) / e)
    d1 = torch.sqrt((xr - 0.55 * r0) ** 2 + yr ** 2 + 1e-6)
    d2 = torch.sqrt((xr + 0.55 * r0) ** 2 + yr ** 2 + 1e-6)
    dots = torch.maximum(sig((0.42 * r0 - d1) / e), sig((0.42 * r0 - d2) / e))

    prims = torch.stack([circle, square, tri, ring, cross, diamond, dots])
    mask = prims[shape_id, torch.arange(y.shape[0], device=dev)]  # (n,S,S)

    stripe = 0.3 + 0.7 * sig(4.0 * torch.sin(1.6 * xr + dr["phase"]))
    mask = mask * torch.where(striped > 0, stripe, 1.0)

    f1, f2, p1, p2 = dr["f1"], dr["f2"], dr["p1"], dr["p2"]
    bg = (0.25 + 0.10 * torch.sin(f1 * dx + 0.7 * f1 * dy + p1)
          + 0.10 * torch.sin(0.6 * f2 * dx - f2 * dy + p2))  # (n,S,S)
    img = bg[..., None] + (dr["fg"] - bg[..., None]) * mask[..., None]
    img = img + 0.06 * dr["noise"]
    img = (img - 0.5) / 0.25
    return img.to(torch.float32), y.to(torch.int32)


def synth10_test_arrays(n: int = 2048, seed: int = 7, size: int = 32):
    """A fixed held-out set as numpy arrays, drawn and rendered on the
    CPU."""
    x, y = synth10_render(synth10_draws(n, size, seed), size)
    return x.numpy(), y.numpy()
