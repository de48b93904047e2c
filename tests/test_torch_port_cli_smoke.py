"""The PyTorch port's CLI (``cli.py``) on its own, on the CPU: the brecq
(with the act-delta phase), two-phase and mse modes at a tiny budget (digits, the tracked trained ResNet-18 weights, 32
calibration rows, 8 steps a target, max scales), as ``tests/test_cli.py``
drives the JAX package's CLI. The checkpoint flow is in
``test_torch_port_cli_resume.py``, the parity run against the JAX CLI in
``test_torch_port_cli.py``.
"""
from pathlib import Path

import pytest
import torch

from shiftedscalequantization_tpu_torch import cli
from shiftedscalequantization_tpu_torch.ops import wquant as TW
from shiftedscalequantization_tpu_torch.utils import checkpoint as ck

ROOT = Path(__file__).resolve().parents[1]
COMMON = ["--dataset", "digits", "--arch", "resnet18",
          "--pretrained", str(ROOT / "trained_resnet18_digits.npz"),
          "--num_samples", "32", "--batch_size", "32", "--iters_w", "8",
          "--w_scale_method", "max", "--a_scale_method", "max",
          "--skip_test", "true", "--test_before_calibration", "false",
          "--platform", "cpu"]


@pytest.fixture(autouse=True)
def few_threads():
    """Two torch threads: the CLI runs are the suite's heaviest CPU work,
    and beside the other test workers one thread per core oversubscribes
    the machine (measured: a run ten times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def run(tmp_path, extra, tag="ck"):
    return cli.main(COMMON + ["--checkpoint_dir", str(tmp_path / tag),
                              "--log_path", str(tmp_path / "run.log")]
                    + extra)


def _load(tmp_path, tag="ck"):
    return ck.load_qstate(str(tmp_path / tag / "QNN_W2_A4"), device="cpu")


def _acc_ok(acc):
    assert set(acc) == {"top1", "top5"}
    assert all(0 <= v <= 100 for v in acc.values())


def test_brecq_with_act_delta_phase(tmp_path, capsys):
    acc = run(tmp_path, ["--mode", "brecq", "--iters_a", "4"])
    _acc_ok(acc)
    out = capsys.readouterr().out
    assert out.count("Reconstructed ") == 9
    assert "act-phase delta drift: worst " in out
    assert "NON-POSITIVE" not in out
    qs, done = _load(tmp_path)
    assert len(done) == 9
    assert all(type(qs[u].wq) is TW.AdaRoundWQ and not qs[u].wq.soft
               for u in ("model.layer1.0.conv1", "model.fc"))
    deltas = cli._act_deltas(qs)
    assert len(deltas) == 17 and min(deltas.values()) > 0
    assert "brecq,resnet18,W2A4" in open(tmp_path / "run.log").read()


def test_two_phase(tmp_path, capsys):
    acc = run(tmp_path, ["--mode", "two_phase", "--shift_targets",
                         "0.5,1.0"])
    _acc_ok(acc)
    # 16 convs and 3 downsamples keep a selection; the 8-bit fc takes
    # plain AdaRound under a coarse candidate set
    assert capsys.readouterr().out.count("selection ratio ") == 19
    qs, done = _load(tmp_path)
    wq = qs["model.layer2.0.conv1"].wq
    assert type(wq) is TW.AdaRoundWQ and wq.st_index is not None


def test_mse_mode(tmp_path):
    _acc_ok(run(tmp_path, ["--mode", "mse", "--mse_level", "2"]))
