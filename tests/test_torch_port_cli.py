"""PyTorch port vs the JAX package: the CLI (``cli.py``) and its
flag set (``utils/config.py``), on the CPU.

The parity run drives both CLIs on the real digits data from the tracked
trained ResNet-18 weights, with the same flags. Both packages draw
minibatch rows from different generators, so the run uses
``--num_samples 32``: the reconstruction batch is fixed at 32, so every
step sees the whole cache and only summation orders differ. The JAX
package's and the port's native loaders (each takes it wherever it
builds) shuffle with their own generator, so both sides are pinned to
numpy's ``ArrayLoader``: the calibration rows these tolerances were
measured on.

Tolerances, for the eight blocks: each hard loss within rtol 1e-3 (the
JAX package sums the loss of a jitted step in f32 with an error of up to
7e-4 of it against float64; the port's sums are within 1e-6), the
hardened weight codes within a flip rate of 0.5% (the default three
candidates start with two tied selection logits, and the packages'
gradients differ by about 1e-5 of their size, which breaks a few ties
the other way from layer3.1 on: at most 3e-4 of the codes). For the fc,
whose input passes through all those blocks: hard loss within rtol 3e-2
and codes within 1.5%. Its L1 loss (p = 1) takes the sign of each
logit's error, so the few differing codes upstream move its trajectory
(measured: 1.4% and 0.68%). From the same caches the fc is held to the
blocks' limits: the JAX run records the qstate, caches and settings its
pipeline hands the fc, and the port's engine reconstructs the fc from
those, its hard loss within rtol 1e-3 and its codes within 0.5%. The
final top-1 and top-5 agree within one image of the 359 test images.
"""
import contextlib
import dataclasses
import io
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from shiftedscalequantization_tpu import cli as JCLI
from shiftedscalequantization_tpu.data import native_loader as JNL
from shiftedscalequantization_tpu.recon import pipeline as JP
from shiftedscalequantization_tpu.utils import checkpoint as JCK
from shiftedscalequantization_tpu.utils import config as JCFG
import shiftedscalequantization_tpu_torch as tp
from shiftedscalequantization_tpu_torch import cli as TCLI
from shiftedscalequantization_tpu_torch.data import native_loader as TNL
from shiftedscalequantization_tpu_torch.models import zoo as TZ
from shiftedscalequantization_tpu_torch.ops import wquant as TW
from shiftedscalequantization_tpu_torch.recon import engine as TE
from shiftedscalequantization_tpu_torch.train import load_raw_params
from shiftedscalequantization_tpu_torch.utils import checkpoint as TCK
from shiftedscalequantization_tpu_torch.utils import config as TCFG
from shiftedscalequantization_tpu_torch.utils import jax_import as JI

ROOT = Path(__file__).resolve().parents[1]
WEIGHTS = ROOT / "trained_resnet18_digits.npz"
TINY = ["--dataset", "digits", "--arch", "resnet18",
        "--pretrained", str(WEIGHTS), "--num_samples", "32",
        "--batch_size", "32", "--iters_w", "8", "--skip_test", "true",
        "--test_before_calibration", "false", "--platform", "cpu"]
LOSS_RTOL = 1e-3
FLIP_RATE = 0.005
FC_LOSS_RTOL = 3e-2
FC_FLIP_RATE = 0.015
TEST_IMAGES = 359
RECON_LINE = re.compile(r"^Reconstructed (\S+): soft (\S+) -> hard (\S+) ")


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parsers_match_flag_by_flag():
    """Every flag of the JAX parser exists in the port's with the same
    dest, option strings, default, choices and type, apart from the
    default of --run_device, which names the card."""
    jax_acts, port_acts = (_actions(JCFG.build_parser()),
                           _actions(TCFG.build_parser()))
    assert set(jax_acts) == set(port_acts)
    assert len(jax_acts) >= 50
    for dest, ja in jax_acts.items():
        ta = port_acts[dest]
        assert ta.option_strings == ja.option_strings, dest
        assert ta.choices == ja.choices, dest
        assert getattr(ta.type, "__name__", ta.type) \
            == getattr(ja.type, "__name__", ja.type), dest
        if dest == "run_device":
            assert (ja.default, ta.default) == ("tpu:0", "cuda:0")
        else:
            assert ta.default == ja.default, dest
    for v in ("1", "true", "Yes", "y", True, "0", "false", "no", False):
        assert TCFG._boolish(v) == JCFG._boolish(v)
    for s in ("0.96875,1.03125,1.0", "0.5,1.0", "1.0"):
        assert TCFG.parse_shift_targets(s) == JCFG.parse_shift_targets(s)
    argv = ["--mode", "brecq", "--iters_w", "7", "--bias_cal", "true",
            "--cache_dtype", "bfloat16", "--act_mode", "delta"]
    assert vars(TCFG.load_args(argv)) == {
        **vars(JCFG.load_args(argv)), "run_device": "cuda:0"}


def _run(main, tmp, tag):
    ck = tmp / tag
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        final = main(TINY + ["--mode", "fused", "--checkpoint_dir", str(ck),
                             "--log_path", str(tmp / f"{tag}.log")])
    hard = {m.group(1): float(m.group(3)) for m in
            map(RECON_LINE.match, out.getvalue().splitlines()) if m}
    return final, hard, str(ck / "QNN_W2_A4")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs' fused runs, once per module (two torch threads: beside
    the other test workers one thread per core oversubscribes the
    machine), and what the JAX pipeline hands the fc's reconstruction
    with what that returns."""
    tmp = tmp_path_factory.mktemp("cli")
    fc = {}
    real = JP.reconstruct_node

    def record(graph, params, qstate, name, ci, co, s, key, **kw):
        out = real(graph, params, qstate, name, ci, co, s, key, **kw)
        if name == "model.fc":
            fc.update(params=params, qstate=qstate, ci=np.asarray(ci),
                      co=np.asarray(co), settings=s, result=out)
        return out

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JNL, "native_available", lambda: False)
            mp.setattr(TNL, "native_available", lambda: False)
            mp.setattr(JP, "reconstruct_node", record)
            jax_run = _run(JCLI.main, tmp, "jax")
            port_run = _run(TCLI.main, tmp, "port")
    finally:
        torch.set_num_threads(n)
    return dict(jax=jax_run, port=port_run, fc=fc)


def _codes(wq, w):
    """The integer weight codes of a hardened quantizer."""
    d = wq.qp.delta.reshape((-1,) + (1,) * (w.ndim - 1))
    return torch.round(TW.apply_weight_quant(wq, w) / d)


def test_cli_fused_matches_jax(runs):
    jfinal, jhard, jck = runs["jax"]
    tfinal, thard, tck = runs["port"]
    jqs, jdone = JCK.load_qstate(jck)
    tqs, tdone = TCK.load_qstate(tck, device="cpu")
    assert tdone == jdone and len(tdone) == 9
    assert list(thard) == list(jhard) == tdone
    for t in tdone:
        assert np.isfinite(thard[t])
        rtol = FC_LOSS_RTOL if t == "model.fc" else LOSS_RTOL
        np.testing.assert_allclose(thard[t], jhard[t], rtol=rtol, err_msg=t)
    params, _ = tp.prepare_model(
        TZ.build("resnet18", dataset="digits")[0],
        load_raw_params(str(WEIGHTS), device="cpu"), tp.QuantConfig(),
        device="cpu")
    units = [u for u in jqs if hasattr(jqs[u], "wq")
             and type(jqs[u].wq).__name__ == "ShiftedScaleWQ"]
    assert len(units) == 20
    for u in units:
        assert type(tqs[u].wq).__name__ == "ShiftedScaleWQ"
        assert tqs[u].wq.hard_targets and tqs[u].wq.hard_round
        w = params[u]["w"]
        codes = [_codes(wq, w) for wq in
                 (tqs[u].wq, JI.weight_quantizer_from_numpy(jqs[u].wq, "cpu"))]
        rate = FC_FLIP_RATE if u == "model.fc" else FLIP_RATE
        assert float((codes[0] != codes[1]).double().mean()) <= rate, u
    for k in ("top1", "top5"):
        assert abs(tfinal[k] - jfinal[k]) <= 100.0 / TEST_IMAGES + 1e-9, k


def test_cli_fc_from_the_same_caches_matches_jax(runs):
    """The port's engine, given the qstate, caches and settings the JAX
    CLI's pipeline gave its fc (all eight blocks hardened before it),
    matches the JAX fc at the blocks' limits: trace, soft and hard loss
    within rtol 1e-3 and codes within 0.5%."""
    fc = runs["fc"]
    jq, jm = fc["result"]
    assert fc["ci"].shape[0] == fc["settings"].batch_size == 32
    params = JI.params_from_numpy(jax.tree.map(np.asarray, fc["params"]),
                                  "cpu")
    fields = {f.name for f in dataclasses.fields(TE.ReconSettings)}
    settings = TE.ReconSettings(**{
        k: v for k, v in dataclasses.asdict(fc["settings"]).items()
        if k in fields})
    tq, tm = TE.reconstruct_node(
        TZ.build("resnet18", dataset="digits")[0], params,
        JI.qstate_from_numpy(jax.tree.map(np.asarray, fc["qstate"]), "cpu"),
        "model.fc", torch.tensor(fc["ci"]), torch.tensor(fc["co"]),
        settings, seed=0)
    np.testing.assert_allclose(tm["rec_trace"].numpy(),
                               np.asarray(jm["rec_trace"]), rtol=LOSS_RTOL)
    for k in ("soft_loss", "hard_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    w = params["model.fc"]["w"]
    codes = [_codes(wq, w) for wq in
             (tq["model.fc"].wq,
              JI.weight_quantizer_from_numpy(jq["model.fc"].wq, "cpu"))]
    assert type(tq["model.fc"].wq).__name__ == "ShiftedScaleWQ"
    assert float((codes[0] != codes[1]).double().mean()) <= FLIP_RATE
