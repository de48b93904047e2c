"""The PyTorch port's CLI (``cli.py``) on MNASNet, on the CPU, with and
without ``--harmonize_residual``: digits (the CIFAR variant), random
init, 8 calibration rows, 2 brecq steps a target (the act-delta phase
off), max scales. Every per-unit target is reconstructed and the final
checkpoint serves through the integer deploy path: pair transport across
the siteless residual chains, or the harmonized chains' int8 __sum__
sites.
"""
import pytest
import torch

from shiftedscalequantization_tpu_torch import cli
from shiftedscalequantization_tpu_torch import deploy as TD
from shiftedscalequantization_tpu_torch import quantize as TQ
from shiftedscalequantization_tpu_torch.utils import checkpoint as ck
from shiftedscalequantization_tpu_torch.utils.config import load_args


@pytest.fixture(autouse=True)
def few_threads():
    """Two torch threads, as the other CLI test modules run."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("harmonize", ["false", "true"])
def test_cli_smoke_serves(harmonize, tmp_path, capsys, monkeypatch):
    for k in ("SSQ_PACKED", "SSQ_DW_KERNEL", "SSQ_PAIR_TERMS"):
        monkeypatch.delenv(k, raising=False)
    argv = ["--arch", "mnasnet", "--dataset", "digits", "--num_samples",
            "8", "--batch_size", "8", "--iters_w", "2", "--iters_a", "0",
            "--mode", "brecq", "--w_scale_method", "max",
            "--a_scale_method", "max", "--skip_test", "true",
            "--test_before_calibration", "false", "--platform", "cpu",
            "--harmonize_residual", harmonize,
            "--checkpoint_dir", str(tmp_path / "ck"),
            "--log_path", str(tmp_path / "run.log")]
    acc = cli.main(argv)
    assert set(acc) == {"top1", "top5"}
    out = capsys.readouterr().out
    args = load_args(argv)
    graph, raw, cfg = cli.build_everything(args, device="cpu")
    targets = TQ.reconstruction_targets(graph)
    # every unit but the stem
    assert len(targets) == 52 and out.count("Reconstructed ") == 52
    assert ("harmonized 15 chain act sites" in out) == (harmonize == "true")
    qs, done = ck.load_qstate(str(tmp_path / "ck" / "QNN_W2_A4"),
                              device="cpu")
    assert done == targets
    params, _ = TQ.prepare_model(graph, raw, cfg, device="cpu")
    dp = TD.build_deploy_params(graph, params, qs, device="cpu")
    steps = TD.act_steps_from_qstate(graph, qs)
    plan = TD.make_deploy_plan(graph, dp, steps, input_hw=(32, 32))
    x = torch.randn((4, 32, 32, 3), generator=torch.Generator()
                    .manual_seed(0))
    y = TD.deploy_forward(graph, dp, steps, x, plan=plan, device="cpu")
    assert tuple(y.shape) == (4, 10) and bool(torch.isfinite(y).all())
    if harmonize == "true":
        assert len(plan["__sum_steps__"]) == 10
        assert TD.pair_stats["formed"] == 0
    else:
        assert TD.pair_stats["formed"] > 0
        assert TD.pair_stats["consumed_fast"] == TD.pair_stats["formed"]
