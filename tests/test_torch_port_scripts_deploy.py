"""PyTorch port vs the JAX package: the scripts' deploy evaluations,
``run_accuracy.deploy_eval`` and ``harm_accuracy.deploy_check``, against
the root scripts' own functions, on the CPU.

The state is calibrated with no reconstruction: made by the JAX package
from the tracked trained weights (max scales), saved in its checkpoint
format for the root script and carried into the port's
(``utils/jax_import``) for the port's script, each in a working
directory of its own. Both packages' ``synth10_test_arrays`` are patched
to the same 256 images, snapped to a 1/8 grid, and every step of the state to a power of
two: the JAX package's bf16 stem and the port's f32 stem give the same
codes, both deploys are integer arithmetic from there, and both sim
forwards compute the same values (unsnapped, one stem code flip moved one
MNASNet deploy prediction and the two sims parted by two images of 256).
W4A4 (MNASNet harmonized: its chains sum on int8 sites) keeps the top-1
well off chance. Tolerance: each top-1 within 0.1 point of the JAX
package's, the sum sites equal. The JAX package's MNASNet conversion and
jit take minutes on the CPU, so that comparison is marked slow; the
port's deploy_check on the same recipe runs in the tier-1 set, held to
the JAX package's sum-site count (10, as in its record
round4_logs/harm_accuracy.json).
"""
import ast
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import shiftedscalequantization_tpu as ssq
from shiftedscalequantization_tpu.data import realdata as JRD
from shiftedscalequantization_tpu.models import zoo as JZ
from shiftedscalequantization_tpu.train import load_raw_params as j_load
from shiftedscalequantization_tpu.utils import checkpoint as JCK
import shiftedscalequantization_tpu_torch as tp
from shiftedscalequantization_tpu_torch import quantize as TQZ
from shiftedscalequantization_tpu_torch.data import realdata as TRD
from shiftedscalequantization_tpu_torch.models import zoo as TZ
from shiftedscalequantization_tpu_torch.scripts import harm_accuracy as HA
from shiftedscalequantization_tpu_torch.scripts import run_accuracy as RA
from shiftedscalequantization_tpu_torch.train import load_raw_params as t_load
from shiftedscalequantization_tpu_torch.utils import checkpoint as TCK
from shiftedscalequantization_tpu_torch.utils import jax_import as JI

ROOT = Path(__file__).resolve().parents[1]
N_TEST = 256
MNASNET_SUM_SITES = 10


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_test_set(monkeypatch):
    """Both packages' synth10 test arrays: the port's first N_TEST,
    snapped to a 1/8 grid."""
    x, y = TRD.synth10_test_arrays()
    x, y = np.round(x[:N_TEST] * 8).astype(np.float32) / 8, y[:N_TEST]
    for mod in (JRD, TRD):
        monkeypatch.setattr(mod, "synth10_test_arrays",
                            lambda n=2048, seed=7, size=32: (x, y))
    return x, y


def jax_script(name, **names):
    """The root script's imports and functions in a namespace that also
    holds ``names``; nothing else of it runs."""
    path = ROOT / name
    body = [n for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.Import, ast.ImportFrom, ast.FunctionDef))]
    ns = {"__name__": f"jax_script_{path.stem}", **names}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"),
         ns)
    return ns


def _dirs(tmp_path, npz):
    """A working directory per package, each with the weights linked in."""
    out = []
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        os.symlink(ROOT / npz, d / npz)
        out.append(d)
    return out


def _save_both(qs, jdir, tdir, rel):
    JCK.save_qstate(str(jdir / rel), qs)
    TCK.save_qstate(str(tdir / rel), JI.qstate_from_numpy(
        jax.tree.map(np.asarray, qs), "cpu"))


def _pow2(a):
    return jnp.asarray(2.0 ** np.round(np.log2(np.asarray(a))), jnp.float32)


def _dyadic(qs):
    """Every weight and act step snapped to the nearest power of two."""
    out = {}
    for name, v in qs.items():
        if v is None or not hasattr(v, "wq"):
            out[name] = v if v is None else dataclasses.replace(
                v, delta=_pow2(v.delta))
            continue
        qp = dataclasses.replace(v.wq.qp, delta=_pow2(v.wq.qp.delta))
        aq = None if v.aq is None else \
            dataclasses.replace(v.aq, delta=_pow2(v.aq.delta))
        out[name] = dataclasses.replace(
            v, wq=dataclasses.replace(v.wq, qp=qp), aq=aq)
    return out


def _jax_state(arch, npz, nbw, nba, x, harmonize=False):
    graph, _ = JZ.build(arch, dataset="synth10")
    cfg = ssq.QuantConfig(n_bits_w=nbw, n_bits_a=nba, w_scale_method="max",
                          a_scale_method="max")
    params, qs = ssq.prepare_model(graph, j_load(str(ROOT / npz)), cfg)
    qs = _dyadic(ssq.calibrate_acts(graph, params, qs, jnp.asarray(x[:32]),
                                    cfg))
    if harmonize:
        from shiftedscalequantization_tpu.quantize import \
            harmonize_residual_chains
        qs, _ = harmonize_residual_chains(graph, qs)
    return qs


def test_deploy_eval_matches_jax(tmp_path, monkeypatch, small_test_set):
    """run_accuracy.deploy_eval: sim, the 2-pass and the 1-pass stem
    deploy, each within 0.1 top-1 point of the root script's, and the
    environment left as it was."""
    npz = "trained_resnet18_synth10.npz"
    jdir, tdir = _dirs(tmp_path, npz)
    qs = _jax_state("resnet18", npz, 4, 4, small_test_set[0])
    _save_both(qs, jdir, tdir, "checkPoint/acc_synth10_brecq/QNN_W4_A4")
    monkeypatch.setenv("SSQ_STEM_1PASS", "0")
    monkeypatch.chdir(jdir)
    jargs = RA.parse_args(["--platform", "cpu"])
    ns = jax_script("run_accuracy.py", A=jargs,
                    CKPTS={"synth10": npz, "digits": None})
    want = ns["deploy_eval"]("synth10", 4, 4, "brecq")
    monkeypatch.chdir(tdir)
    monkeypatch.setenv("SSQ_STEM_1PASS", "0")
    got = RA.deploy_eval(jargs, "synth10", 4, 4, "brecq")
    assert os.environ["SSQ_STEM_1PASS"] == "0"
    assert set(got) == set(want) == {"sim", "deploy_2pass", "deploy_1pass"}
    for k, v in want.items():
        assert abs(got[k] - v) <= 0.1, (k, got, want)
    assert got["sim"] >= 50.0, got


@pytest.fixture(scope="module")
def mnasnet_port_state(tmp_path_factory):
    """W4A4 MNASNet from the tracked trained weights, calibrated and
    harmonized by the port on 32 synth10 test images, saved as the
    harmonized CLI run would leave it (the plain state beside)."""
    tmp = tmp_path_factory.mktemp("harm")
    os.symlink(ROOT / HA.CKPT, tmp / HA.CKPT)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    graph, _ = TZ.build("mnasnet", dataset="synth10")
    cfg = tp.QuantConfig(n_bits_w=4, n_bits_a=4, w_scale_method="max",
                         a_scale_method="max")
    params, qs = tp.prepare_model(graph, t_load(str(ROOT / HA.CKPT), "cpu"),
                                  cfg, device="cpu")
    x, _ = TRD.synth10_test_arrays(64)
    qs = tp.calibrate_acts(graph, params, qs, torch.as_tensor(x[:32]), cfg,
                           device="cpu")
    TCK.save_qstate(str(tmp / "checkPoint/harm_plain/QNN_W2_A4"), qs)
    qs, _ = TQZ.harmonize_residual_chains(graph, qs)
    TCK.save_qstate(str(tmp / "checkPoint/harm_harmonized/QNN_W2_A4"), qs)
    torch.set_num_threads(n)
    return tmp, x


@pytest.mark.parametrize("tag,sum_sites", [("plain", 0),
                                           ("harmonized", MNASNET_SUM_SITES)])
def test_deploy_check_on_the_port(tag, sum_sites, mnasnet_port_state,
                                  monkeypatch):
    """harm_accuracy.deploy_check on 64 images: the sum sites the JAX
    package forms on this recipe (none without harmonization), and sim and
    deploy top-1 of one state within a point of each other."""
    tmp, x = mnasnet_port_state
    _, y = TRD.synth10_test_arrays(64)
    monkeypatch.setattr(TRD, "synth10_test_arrays",
                        lambda n=2048, seed=7, size=32: (x, y))
    monkeypatch.chdir(tmp)
    got = HA.deploy_check(HA.parse_args(["--platform", "cpu"]), tag,
                          tag == "harmonized")
    assert got["sum_sites"] == sum_sites, got
    assert abs(got["sim"] - got["deploy"]) <= 100.0 / 64 + 1e-9, got


@pytest.mark.slow
def test_deploy_check_matches_jax(tmp_path, monkeypatch, small_test_set):
    """harm_accuracy.deploy_check on a harmonized W4A4 state: sim and
    deploy within 0.1 top-1 point of the root script's, the same sum
    sites."""
    jdir, tdir = _dirs(tmp_path, HA.CKPT)
    qs = _jax_state("mnasnet", HA.CKPT, 4, 4, small_test_set[0],
                    harmonize=True)
    _save_both(qs, jdir, tdir, "checkPoint/harm_harmonized/QNN_W2_A4")
    monkeypatch.chdir(jdir)
    ns = jax_script("harm_accuracy.py", CKPT=HA.CKPT)
    want = ns["deploy_check"]("harmonized", True)
    monkeypatch.chdir(tdir)
    got = HA.deploy_check(HA.parse_args(["--platform", "cpu"]),
                          "harmonized", True)
    assert got["sum_sites"] == want["sum_sites"] == MNASNET_SUM_SITES
    for k in ("sim", "deploy"):
        assert abs(got[k] - want[k]) <= 0.1, (k, got, want)
