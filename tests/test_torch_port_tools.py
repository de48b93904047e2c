"""PyTorch port vs the JAX package: ``utils/analysis`` and ``utils/sweep``
on the CPU.

The analysis functions are the same numpy arithmetic in both packages:
held equal exactly, on numpy inputs and on the port's tensors;
``selection_summary`` on the port engine's ``selection_ratios`` of a
shifted-scale state carried over from the JAX package gives the JAX
package's string. The sweep's two cases of tests/test_sweep.py run
against the port's CLI, and a log written by the JAX sweep resumes in the
port's (the combo ids and records are shared).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import shiftedscalequantization_tpu as ssq
from shiftedscalequantization_tpu.models import resnet as JR
from shiftedscalequantization_tpu.ops import quant as JQ
from shiftedscalequantization_tpu.recon import engine as JE
from shiftedscalequantization_tpu.utils import analysis as JA
from shiftedscalequantization_tpu.utils import sweep as JS
from shiftedscalequantization_tpu_torch.recon import engine as TE
from shiftedscalequantization_tpu_torch.utils import analysis as TA
from shiftedscalequantization_tpu_torch.utils import jax_import as JI
from shiftedscalequantization_tpu_torch.utils import sweep as TS
from test_torch_port_recon import _jax_tiny_graph

UNITS = ("model.layer1.0.conv1", "model.layer1.0.conv2")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("n_bits", [2, 4, 8])
def test_numpy_mse_scale_init_equal(n_bits):
    rng = np.random.default_rng(n_bits)
    x = rng.normal(size=400).astype(np.float32)
    assert TA.numpy_mse_scale_init(x, n_bits) \
        == JA.numpy_mse_scale_init(x, n_bits)
    # and the oracle still agrees with the JAX package's MSE init
    d_np, z_np, _ = TA.numpy_mse_scale_init(x, 4)
    d_j, z_j, _ = JQ.init_scale_mse(jnp.asarray(x), 4, False)
    np.testing.assert_allclose(float(d_j), d_np, rtol=1e-4)


def test_weight_channel_stats_equal():
    w = np.random.default_rng(1).normal(size=(16, 8, 3, 3)) \
        .astype(np.float32)
    want = JA.weight_channel_stats(w)
    for arg in (w, torch.as_tensor(w)):
        got = TA.weight_channel_stats(arg)
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v)


@pytest.fixture(scope="module")
def shifted_state():
    """The tiny model's fused shifted-scale quantizers on both block
    units, selection logits drawn with numpy so both candidates own
    channels; the JAX state and the port's copy."""
    g = _jax_tiny_graph()
    cfg = ssq.QuantConfig(n_bits_w=2, n_bits_a=4, w_scale_method="max",
                          use_8bit_head_stem=False)
    params, qs = ssq.prepare_model(
        g, JR.init_params(jax.random.PRNGKey(0), g), cfg)
    qs, _ = JE._init_quantizers(params, qs, UNITS, JE.ReconSettings(
        mode="fused", shift_targets=(0.5, 1.0)))
    rng = np.random.default_rng(7)
    for name in UNITS:
        wq = qs[name].wq
        alpha = jnp.asarray(rng.normal(size=wq.alpha.shape), jnp.float32)
        qs[name] = dataclasses.replace(
            qs[name], wq=dataclasses.replace(wq, alpha=alpha))
    return dict(params=params, qs=qs,
                tparams=JI.params_from_numpy(_np(params), "cpu"),
                tqs=JI.qstate_from_numpy(_np(qs), "cpu"))


def test_selection_summary_on_the_engines_ratios(shifted_state):
    jr = JE.selection_ratios(shifted_state["qs"], UNITS)
    tr = TE.selection_ratios(shifted_state["tqs"], UNITS)
    want = JA.selection_summary(jr)
    got = TA.selection_summary(tr)
    assert got == want
    assert len(got.splitlines()) == 2 and "0:" in got and "1:" in got
    # both candidates own groups
    assert all(0 < float(r[0]) < 1 for r in tr.values())
    marks = {"model.conv1": "skipped:high-bit", "layer1": [0.2, 0.3, 0.5]}
    assert TA.selection_summary(marks) == JA.selection_summary(marks)


def test_plot_weight_distributions_reads_the_ports_state(shifted_state,
                                                          tmp_path):
    out = TA.plot_weight_distributions(
        shifted_state["tparams"], ["model.conv1", *UNITS],
        str(tmp_path / "w.png"), shifted_state["tqs"])
    assert out == str(tmp_path / "w.png") and os.path.getsize(out) > 1000


def test_grid_parse_comma_and_semicolon_values():
    for mod in (TS, JS):
        assert mod.parse_grid("lmda=0.01,0.1") == ("lmda", ["0.01", "0.1"])
        k, vs = mod.parse_grid("shift_targets=0.5,1.0;0.25,1.0")
        assert k == "shift_targets" and vs == ["0.5,1.0", "0.25,1.0"]


def _fake_cli(calls):
    def cli(argv):
        calls.append(list(argv))
        if "--lmda" in argv and argv[argv.index("--lmda") + 1] == "9":
            raise RuntimeError("boom")
        return {"top1": 42.0}
    return cli


def test_sweep_skips_completed_combos_and_logs_jsonl(tmp_path, monkeypatch):
    """tests/test_sweep.py's resume case against the port's CLI."""
    calls = []
    monkeypatch.setattr("shiftedscalequantization_tpu_torch.cli.main",
                        _fake_cli(calls))
    out = tmp_path / "sweep.jsonl"
    res = TS.main(["--base", "--dataset cifar10",
                   "--grid", "lmda=1,2,9", "--out", str(out)])
    assert len(res) == 3 and len(calls) == 3
    assert calls[0] == ["--dataset", "cifar10", "--lmda", "1"]
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["combo"] for r in recs] == ["lmda=1", "lmda=2", "lmda=9"]
    assert recs[0]["result"]["top1"] == 42.0
    assert "error" in recs[2] and recs[2]["error"] == "boom"

    calls.clear()
    res2 = TS.main(["--base", "--dataset cifar10",
                    "--grid", "lmda=1,2,9,4", "--out", str(out)])
    assert [r["combo"] for r in res2] == ["lmda=4"]
    assert len(calls) == 1 and calls[0][-1] == "4"


def test_sweep_resumes_a_log_the_jax_sweep_wrote(tmp_path, monkeypatch):
    """Two grid keys: the JAX sweep runs and logs the first two combos,
    the port's sweep takes the log over and runs only the rest, and the
    JAX sweep then finds everything done; the records have one layout."""
    jcalls, tcalls = [], []
    monkeypatch.setattr("shiftedscalequantization_tpu.cli.main",
                        _fake_cli(jcalls))
    monkeypatch.setattr("shiftedscalequantization_tpu_torch.cli.main",
                        _fake_cli(tcalls))
    out = str(tmp_path / "sweep.jsonl")
    base = ["--base", "--arch resnet18", "--out", out]
    JS.main(base + ["--grid", "lmda=1,9", "--grid",
                    "shift_targets=0.5,1.0;1.0"])
    assert len(jcalls) == 4
    with open(out, "a") as f:
        f.write("not json\n")                    # a torn line is skipped
    res = TS.main(base + ["--grid", "lmda=1,9,3", "--grid",
                          "shift_targets=0.5,1.0;1.0"])
    assert [r["combo"] for r in res] == [
        "lmda=3,shift_targets=0.5,1.0", "lmda=3,shift_targets=1.0"]
    assert tcalls == [["--arch", "resnet18", "--lmda", "3",
                       "--shift_targets", "0.5,1.0"],
                      ["--arch", "resnet18", "--lmda", "3",
                       "--shift_targets", "1.0"]]
    jcalls.clear()
    assert JS.main(base + ["--grid", "lmda=1,9,3", "--grid",
                           "shift_targets=0.5,1.0;1.0"]) == []
    assert jcalls == []
    recs = [json.loads(line) for line in open(out) if line[0] == "{"]
    assert len(recs) == 6
    assert all(set(r) in ({"combo", "result", "wall_s"},
                          {"combo", "error", "wall_s"}) for r in recs)
