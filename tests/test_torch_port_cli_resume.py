"""The PyTorch port's CLI (``cli.py``) on its own, on the CPU: the
checkpoint flow of ``tests/test_cli.py`` and a seeded rerun, at the
tiny budget of ``test_torch_port_cli_smoke.py``.
"""
import os

import numpy as np
import torch

from test_torch_port_cli_smoke import _load, few_threads, run  # noqa: F401


def test_checkpoint_resume_eval_and_determinism(tmp_path, capsys):
    """tests/test_cli.py's flow: --make_checkpoint exits after the act
    calibration; a fused run; a --resume run with every target done; an
    --eval_only replay through the golden-logit regression. All three
    accuracies equal; a second fused run in another directory, same
    seed, gives the same accuracy and checkpoint."""
    assert run(tmp_path, ["--make_checkpoint", "true"]) is None
    assert (tmp_path / "ck" / "digits_QNN_CW_W2_A4.pkl").exists()
    golden = str(tmp_path / "golden")
    a1 = run(tmp_path, ["--mode", "fused", "--golden_dir", golden])
    assert os.path.exists(f"{golden}/result_2bit.npz")
    capsys.readouterr()
    a2 = run(tmp_path, ["--mode", "fused", "--resume", "true"])
    out = capsys.readouterr().out
    assert "Resumed from" in out and "(9 layers done)" in out
    assert "Reconstructed " not in out
    a3 = run(tmp_path, ["--eval_only", "true", "--golden_dir", golden])
    out = capsys.readouterr().out
    assert "eval-only W2A4 (done=9 layers)" in out
    mse = float(out.split("golden-logit MSE: ")[1].split()[0])
    assert mse <= 1e-12
    assert a1 == a2 == a3
    a4 = run(tmp_path, ["--mode", "fused"], tag="again")
    assert a4 == a1
    q1, _ = _load(tmp_path)
    q2, _ = _load(tmp_path, "again")
    for u in ("model.layer2.0.conv1", "model.fc"):
        torch.testing.assert_close(q1[u].wq.alpha, q2[u].wq.alpha, rtol=0,
                                   atol=0)
        np.testing.assert_array_equal(q1[u].aq.delta.numpy() if q1[u].aq
                                      is not None else 0,
                                      q2[u].aq.delta.numpy() if q2[u].aq
                                      is not None else 0)
