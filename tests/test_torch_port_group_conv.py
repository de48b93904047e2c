"""The grouped int8 implicit-GEMM convolution of the PyTorch port
(``ops/cuda/group_conv.py``), run on the CPU through its plain version.

- ``int8_group_conv`` (plain) against XLA's grouped integer convolution
  (``feature_group_count``, the JAX deploy path's ``_int_conv``) with
  int32 operands, so biased feeds fit: int32 sums bit for bit
  (``torch.equal``), and the scale-table sum bit for bit against the JAX
  deploy expression ``0 + sum_s f32(acc_s) * (table[s] * delta)``, op by
  op;
- against ``int8_conv`` (plain) on the dense block-diagonal operand
  deploy builds for ``int8_bd``: the same integers, so every mode equal;
- its requant modes against its sums mode followed by deploy's
  ``quantize_out``, bit for bit, in every requant epilogue.

Shapes cover what the kernel finds hardest: group widths Cg of 24
(RegNetX-600M), 8 (regnetx_200m) and odd; output groups OC/G not a
multiple of 8; stride 2 with padding 1; a 1x1 grouped conv; S = 1, 2, 3
weight groups; pad values of a biased (offset) feed. The card-only tests
(``tests/test_torch_port_cuda.py``) hold the kernel to the plain version
at these shapes.
"""
from types import SimpleNamespace as NS

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from shiftedscalequantization_tpu_torch import deploy as TD
from shiftedscalequantization_tpu_torch.ops.cuda import group_conv as TG
from shiftedscalequantization_tpu_torch.ops.cuda import int_matmul as TI
from shiftedscalequantization_tpu_torch.ops.cuda import requant as TR

# (b, h, w, c, n, conv groups, kernel, stride, padding, S, offset)
SHAPES = [
    (2, 8, 8, 48, 48, 2, 3, 2, 1, 1, 0),       # Cg = 24, stride 2
    (2, 7, 7, 24, 24, 3, 3, 1, 1, 2, 128),     # Cg = 8, biased feed
    (1, 9, 7, 15, 15, 3, 3, 2, 1, 3, 0),       # odd Cg = OC/G = 5
    (2, 6, 6, 16, 24, 2, 3, 1, 1, 1, 9),       # OC/G = 12, offset 9
    (2, 5, 5, 12, 8, 4, 1, 1, 0, 2, 0),        # 1x1 grouped, OC/G = 2
    (1, 6, 6, 96, 96, 4, 3, 2, 1, 3, 128),     # Cg = 24, S = 3, biased
]
SHAPE_IDS = ["cg24-s2", "cg8-biased", "cg5-odd", "ocg12", "1x1",
             "cg24-S3-biased"]
SITES = {"u4": (0.37, 0.0, 4), "a4": (0.29, 7.0, 4), "b8": (0.021, 0.0, 8),
         "blk": (0.41, 0.0, 4), "blka": (0.33, 8.0, 4)}
# (id, unit site, unit act, block site, block act, residual kind)
VARIANTS = [
    ("site-relu", "u4", "relu", None, None, None),
    ("site-relu6", "u4", "relu6", None, None, None),
    ("site-none", "a4", None, None, None, None),
    ("biased-relu", "b8", "relu", None, None, None),
    ("block-codes-res", None, None, "blk", "relu", "codes"),
    ("block-f32-res", None, None, "blk", "relu", "f32"),
    ("block-biased-res", None, None, "blka", None, "biased"),
    ("block-no-res", None, None, "blka", None, None),
    ("unit-site-then-block", "a4", None, "blk", "relu6", "codes"),
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _case(shape, seed=0):
    """Codes, grouped OIHW weights per weight group, the port's operand,
    and the offset's acc_offset, for one SHAPES entry."""
    b, h, w, c, n, g, k, st, p, s_n, offset = shape
    rng = np.random.default_rng(seed + c * 7 + n)
    span = 128 if offset else 8
    xi = rng.integers(-span, span, size=(b, h, w, c)).astype(np.int8)
    # symmetric weights: a biased feed's centered codes stay >= 0
    ws = rng.integers(-2, 3, size=(s_n, n, c // g, k, k)).astype(np.int8)
    wm = torch.as_tensor(np.ascontiguousarray(
        np.transpose(ws, (0, 1, 3, 4, 2)).reshape(s_n, n, -1)))
    acc_off = offset * wm.sum(dim=2, dtype=torch.int32) if offset else None
    geom = ((k, k), (st, st), (p, p))
    return rng, xi, ws, wm, acc_off, geom


def _jax_group_conv(xc, w_oihw, stride, padding, groups):
    """XLA's grouped integer conv of centered codes, zero padding (JAX
    deploy._int_conv with int32 operands)."""
    pad = ((padding[0], padding[0]), (padding[1], padding[1]))
    return jax.lax.conv_general_dilated(
        jnp.asarray(xc, jnp.int32),
        jnp.transpose(jnp.asarray(w_oihw, jnp.int32), (2, 3, 1, 0)),
        window_strides=stride, padding=pad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_group_conv_matches_jax_grouped_conv(shape):
    """int32 sums of each weight group bit for bit against XLA's grouped
    conv of the centered codes ``xi + offset`` (padding -offset, offset *
    sum(w) added back); the scale-table sum bit for bit against the JAX
    deploy expression."""
    _, _, _, _, n, g, _, _, _, s_n, offset = shape
    rng, xi, ws, wm, acc_off, geom = _case(shape)
    xc = xi.astype(np.int32) + offset
    accs = [np.array(_jax_group_conv(xc, ws[s], geom[1], geom[2], g))
            for s in range(s_n)]
    before = TG.int8_group_conv.launches
    for s in range(s_n):
        got = TG.int8_group_conv(
            torch.as_tensor(xi), wm[s:s + 1].contiguous(), *geom, g,
            pad_value=-offset,
            acc_offset=None if acc_off is None else acc_off[s:s + 1])
        assert got.dtype == torch.int32
        assert torch.equal(got, torch.as_tensor(accs[s]))
    table = (rng.random((s_n, n)) * 0.02 + 1e-3).astype(np.float32)
    delta = np.float32(0.37)
    want = jnp.float32(0.0)
    for s in range(s_n):
        want = want + jnp.asarray(accs[s]).astype(jnp.float32) \
            * (jnp.asarray(table[s]) * delta)
    got = TG.int8_group_conv(torch.as_tensor(xi), wm, *geom, g,
                             pad_value=-offset,
                             group_scales=torch.as_tensor(table),
                             act_delta=torch.tensor(delta),
                             acc_offset=acc_off)
    assert TG.int8_group_conv.launches == before     # the CPU runs plain
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.as_tensor(np.array(want)))


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_group_conv_equals_dense_block_diagonal(shape):
    """The grouped conv equals int8_conv on the dense block-diagonal
    operand deploy builds for int8_bd (zeros add nothing): sums, the
    scale-table sum and a requant, all torch.equal."""
    _, _, _, _, n, g, _, _, _, s_n, offset = shape
    rng, xi, ws, wm, acc_off, geom = _case(shape, seed=1)
    dense = TD._gemm_operand(torch.stack([
        TD._block_diagonal(torch.as_tensor(ws[s]), g) for s in range(s_n)]))
    assert torch.equal(dense.sum(dim=2, dtype=torch.int32),
                       wm.sum(dim=2, dtype=torch.int32))
    x = torch.as_tensor(xi)
    table = torch.as_tensor(rng.random((s_n, n)) * 0.02 + 1e-3,
                            dtype=torch.float32)
    rq = TR.Requant(m1=torch.full((n,), 0.37), c1=torch.tensor(0.5),
                    q1=(0.0, 15.0, 0.0))
    for kw in (dict(group_scales=table, act_delta=torch.tensor(0.37)),
               dict(group_scales=table, act_delta=torch.tensor(0.37),
                    requant=rq)):
        kw.update(pad_value=-offset, acc_offset=acc_off)
        assert torch.equal(TG.int8_group_conv(x, wm, *geom, g, **kw),
                           TI.int8_conv(x, dense, *geom, **kw))
    if s_n == 1:
        assert torch.equal(
            TG.int8_group_conv(x, wm, *geom, g, pad_value=-offset,
                               acc_offset=acc_off),
            TI.int8_conv(x, dense, *geom, pad_value=-offset,
                         acc_offset=acc_off))


def _ctx():
    steps = {k: (torch.tensor(d), torch.tensor(z), b)
             for k, (d, z, b) in SITES.items()}
    return TD._Ctx(steps, frozenset({"u4", "a4", "blk", "blka"}),
                   frozenset({"b8"}))


def _residuals(rng, shape):
    return {"codes": ("codes", torch.as_tensor(
                rng.integers(-7, 9, shape), dtype=torch.int8), "a4"),
            "biased": ("biased", torch.as_tensor(
                rng.integers(-128, 128, shape), dtype=torch.int8), "b8"),
            "f32": ("f32", torch.as_tensor(
                rng.normal(size=shape) * 1.5, dtype=torch.float32), None)}


@pytest.mark.parametrize("variant", VARIANTS, ids=[v[0] for v in VARIANTS])
@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[1], SHAPES[5]],
                         ids=["S1", "S2-biased", "S3-biased"])
def test_group_conv_requant_equals_sums_then_quantize_out(shape, variant):
    """The requant mode equals the sums mode followed by deploy's
    quantize_out elementwise route, and requant_plain on the sums, bit
    for bit, in every requant epilogue deploy builds."""
    _, _, _, c, n, g, k, _, _, s_n, offset = shape
    rng, xi, _, wm, acc_off, geom = _case(shape, seed=2)
    x = torch.as_tensor(xi)
    kk = k * k * c // g
    spread = (209.0 if offset else 6.6) * np.sqrt(kk)
    scale = torch.as_tensor(rng.uniform(0.75, 1.25, n) * 3 * 0.37 / spread,
                            dtype=torch.float32)
    bias = torch.as_tensor(rng.normal(size=n) * 0.6, dtype=torch.float32)
    delta = torch.tensor(0.37)
    table = None if s_n == 1 else torch.stack(
        [scale * (0.5 + 0.25 * s) for s in range(s_n)]) / delta
    kw = dict(pad_value=-offset, group_scales=table, act_delta=delta,
              acc_offset=acc_off)
    sums = TG.int8_group_conv(x, wm, *geom, g, **kw)
    pending = TD._Pending(sums.float(), scale, bias) if s_n == 1 \
        else TD._Pending(sums, None, bias)
    res = _residuals(rng, tuple(sums.shape))
    _, usite, uact, bsite, bact, rkind = variant
    ctx, seen = _ctx(), []

    def run(rq):
        seen.append(rq)
        return TG.int8_group_conv(x, wm, *geom, g, requant=rq, **kw)

    deferred = TD._Deferred(run, pending.scale, pending.bias)
    if bsite is None:
        fused = TD.quantize_out(ctx, deferred, usite, uact)
        unfused = TD.quantize_out(ctx, pending, usite, uact)
    else:
        unit = NS(name=usite or "no site", activation=uact)
        node = NS(name=bsite, post_activation=bact)
        r = res[rkind] if rkind else None
        fused = TD._block_requant(ctx, deferred, unit, node, r)
        t = TD.quantize_out(ctx, pending, unit.name, uact)
        unfused = TD.quantize_out(ctx, t, bsite, bact, residual=r)
    assert len(seen) == 1
    assert fused[0] == unfused[0] and fused[2] == unfused[2]
    assert fused[1].dtype == torch.int8
    assert torch.equal(fused[1], unfused[1])
    assert torch.equal(fused[1], TR.requant_plain(sums.float(), seen[0]))
    # a check that cannot fail would pass on saturated codes alone
    assert torch.unique(fused[1]).numel() >= 3


def test_block_diagonal_layout():
    """Each conv group's weights land on its diagonal block, zeros off
    it."""
    w = torch.arange(1, 6 * 2 * 1 * 1 + 1, dtype=torch.int8) \
        .reshape(6, 2, 1, 1)
    dense = TD._block_diagonal(w, 3)
    assert tuple(dense.shape) == (6, 6, 1, 1)
    for oc in range(6):
        g = oc // 2
        row = dense[oc, :, 0, 0]
        assert torch.equal(row[2 * g:2 * g + 2], w[oc, :, 0, 0])
        assert int(row.abs().sum()) == int(w[oc].abs().sum())

