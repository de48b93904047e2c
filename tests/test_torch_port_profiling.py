"""PyTorch port vs the JAX package: ``utils/profiling`` on the CPU.

The flop counters are pure Python over the graph specs: equal to the JAX
package's, node by node, on ResNet-18 and ResNet-50 (ImageNet),
MobileNetV2, RegNetX-600M and MNASNet. ``layer_timing`` runs on
tests/test_torch_port_recon.py's tiny model (8x8, width 8): the same rows
and flop counts as JAX's (the times are each framework's own host
clock); ``format_timing`` gives the same string on the same rows;
``trace`` writes a Chrome trace.
"""
import glob
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import shiftedscalequantization_tpu as ssq
from shiftedscalequantization_tpu.models import resnet as JR
from shiftedscalequantization_tpu.models import zoo as JZ
from shiftedscalequantization_tpu.utils import profiling as JPR
from shiftedscalequantization_tpu_torch import graph as TG
from shiftedscalequantization_tpu_torch.models import zoo as TZ
from shiftedscalequantization_tpu_torch.utils import jax_import as JI
from shiftedscalequantization_tpu_torch.utils import profiling as TPR
from test_torch_port_recon import _jax_tiny_graph, _port_graph

ARCHS = ["resnet18", "resnet50", "mobilenetv2", "regnetx_600m", "mnasnet"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_equal_jax(arch):
    jg, _ = JZ.build(arch, dataset="imagenet")
    tg, _ = TZ.build(arch, dataset="imagenet")
    for hw, batch in (((224, 224), 256), ((193, 160), 3)):
        jt, jper = JPR.graph_flops(jg, hw, batch)
        tt, tper = TPR.graph_flops(tg, hw, batch)
        assert tt == jt and tper == jper
        assert list(tper) == list(jper) and tt == sum(tper.values())
    for ju, tu in zip(TG.iter_units(jg), TG.iter_units(tg)):
        assert TPR.unit_flops(tu, (17, 9), 2) \
            == JPR.unit_flops(ju, (17, 9), 2)
    for jn, tn in zip(jg, tg):
        assert TPR.node_flops(tn, (56, 56), 4) \
            == JPR.node_flops(jn, (56, 56), 4)
    if arch == "resnet18":
        # ImageNet ResNet-18: 1.82 GMAC an image
        total, _ = TPR.graph_flops(tg, (224, 224), 1)
        assert 3.5e9 < total < 3.7e9, total


def test_grouped_conv_flops_count_in_ch_over_groups():
    u = TG.UnitSpec("u", "conv", 64, 128, kernel=(3, 3), stride=(2, 2),
                    padding=(1, 1), groups=4)
    assert TPR.unit_flops(u, (32, 32), 4) == 2 * 4 * 16 * 16 * 128 * 16 * 9


@pytest.fixture(scope="module")
def tiny():
    g = _jax_tiny_graph()
    raw = JR.init_params(jax.random.PRNGKey(0), g)
    cfg = ssq.QuantConfig(n_bits_w=2, n_bits_a=4, w_scale_method="max",
                          use_8bit_head_stem=False)
    params, qs = ssq.prepare_model(g, raw, cfg)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(g=g, gt=_port_graph(g), params=params, qs=qs,
                tparams=JI.params_from_numpy(np_tree(params), "cpu"),
                tqs=JI.qstate_from_numpy(np_tree(qs), "cpu"),
                x=np.random.default_rng(1).normal(size=(4, 8, 8, 3))
                .astype(np.float32))


def test_layer_timing_rows_equal_jax(tiny):
    jflags = ssq.Flags().all_weights(tiny["g"])
    tflags = TG.Flags().all_weights(tiny["gt"])
    jrows = JPR.layer_timing(tiny["g"], tiny["params"], tiny["qs"],
                             jnp.asarray(tiny["x"]), jflags, inner=2,
                             peak_flops=1e12)
    trows = TPR.layer_timing(tiny["gt"], tiny["tparams"], tiny["tqs"],
                             tiny["x"], tflags, inner=2, peak_flops=1e12,
                             device="cpu")
    assert [r["name"] for r in trows] == [r["name"] for r in jrows] \
        == ["model.conv1", "model.layer1.0", "model.fc"]
    assert [r["gflop"] for r in trows] == [r["gflop"] for r in jrows]
    for r in trows:
        assert set(r) == {"name", "ms", "gflop", "tflops", "roofline_frac"}
        assert r["ms"] > 0 and np.isfinite(r["ms"])
        assert r["roofline_frac"] == pytest.approx(r["tflops"])  # 1 TFLOP/s
    # without a peak, no roofline column
    rows = TPR.layer_timing(tiny["gt"], tiny["tparams"], tiny["tqs"],
                            tiny["x"], tflags, inner=1, device="cpu")
    assert all("roofline_frac" not in r for r in rows)


def test_format_timing_equal_strings():
    rows = [{"name": "model.conv1", "ms": 0.51234, "gflop": 1.2345,
             "tflops": 2.41, "roofline_frac": 0.0361},
            {"name": "model.layer1.0", "ms": 3.0, "gflop": 14.8,
             "tflops": 4.93},
            {"name": "model.fc", "ms": 0.0101, "gflop": 0.001,
             "tflops": 0.099}]
    assert TPR.format_timing(rows) == JPR.format_timing(rows)
    assert TPR.format_timing([]) == JPR.format_timing([])
    assert TPR.format_timing(rows).splitlines()[-1].startswith("TOTAL")


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    with TPR.trace(logdir) as prof:
        (a @ a).relu_().sum()
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names and "aten::relu_" in names
    assert "aten::mm" in {e.key for e in prof.key_averages()}

