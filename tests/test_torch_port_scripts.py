"""PyTorch port vs the JAX package: the accuracy scripts
(``shiftedscalequantization_tpu_torch/scripts``) against the repository's
root scripts ``advantage_demo.py``, ``imagenet_drill.py`` and
``run_accuracy.py``, on the CPU.

The root scripts parse their arguments and run at import, so only their
imports, functions and classes are loaded (``jax_script``), into a
namespace that holds the globals those functions read. Tolerances: the
planted npz and its report, the JPEG pixels, the imported checkpoint
params, the selection match fractions and the markdown table are equal
(bit for bit); the FP parity of the planted weights below the scripts' own
1e-4. The scripts' deploy evaluations are held to the JAX package's in
``test_torch_port_scripts_deploy.py``.
"""
import ast
import glob
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from shiftedscalequantization_tpu.utils import checkpoint as JCK
from shiftedscalequantization_tpu.utils import torch_import as JTI
from shiftedscalequantization_tpu.models import zoo as JZ
from shiftedscalequantization_tpu_torch.data import realdata as TRD
from shiftedscalequantization_tpu_torch.models import zoo as TZ
from shiftedscalequantization_tpu_torch.scripts import _common as C
from shiftedscalequantization_tpu_torch.scripts import advantage_demo as AD
from shiftedscalequantization_tpu_torch.scripts import harm_accuracy as HA
from shiftedscalequantization_tpu_torch.scripts import imagenet_drill as ID
from shiftedscalequantization_tpu_torch.scripts import run_accuracy as RA
from shiftedscalequantization_tpu_torch.utils import checkpoint as TCK
from shiftedscalequantization_tpu_torch.utils import jax_import as JI
from shiftedscalequantization_tpu_torch.utils import torch_import as TTI

ROOT = Path(__file__).resolve().parents[1]
DIGITS = str(ROOT / "trained_resnet18_digits.npz")
PAIRS = {"run_accuracy.py": RA, "advantage_demo.py": AD,
         "imagenet_drill.py": ID, "harm_accuracy.py": HA}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tree(name):
    path = ROOT / name
    return ast.parse(path.read_text(), filename=str(path))


def jax_script(name, **names):
    """The root script ``name``'s imports, functions and classes, run in a
    namespace that also holds ``names`` (what its functions read of the
    globals the script sets when it runs). Nothing else of it runs."""
    keep = [n for n in _tree(name).body
            if isinstance(n, (ast.Import, ast.ImportFrom, ast.FunctionDef,
                              ast.ClassDef))]
    ns = {"__name__": f"jax_script_{Path(name).stem}", **names}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(ROOT / name),
                 "exec"), ns)
    return ns


def _statement(name, target):
    """The value expression of the root script's top-level ``target =``."""
    for n in _tree(name).body:
        if isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == target
                for t in n.targets):
            return n.value
    raise KeyError(target)


def _regexes(tree):
    """The pattern of every re.findall / re.search call (and of the root
    run_accuracy.py's ``grab``, which wraps re.findall)."""
    def parses(f):
        return (isinstance(f, ast.Attribute) and f.attr in ("findall",
                                                            "search")
                and isinstance(f.value, ast.Name) and f.value.id == "re") \
            or (isinstance(f, ast.Name) and f.id == "grab")
    return sorted({n.args[0].value for n in ast.walk(tree)
                   if isinstance(n, ast.Call) and parses(n.func)
                   and isinstance(n.args[0], ast.Constant)})


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


# ---------------------------------------------------------------------------
# advantage_demo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,scales", [(7, "1,2,4"), (11, "1,1,16")])
def test_make_imbalanced_matches_jax(seed, scales, tmp_path):
    """The planted npz equals the root script's bit for bit (every array,
    dtype and shape), and so does the report."""
    s = [float(v) for v in scales.split(",")]
    jax_fn = jax_script("advantage_demo.py", SCALES=s)["make_imbalanced"]
    want_rep = jax_fn(DIGITS, str(tmp_path / "jax.npz"), seed)
    got_rep = AD.make_imbalanced(DIGITS, str(tmp_path / "port" / "t.npz"),
                                 seed, s)
    assert got_rep == want_rep and len(got_rep) == 8
    want, got = _npz(tmp_path / "jax.npz"), _npz(tmp_path / "port" / "t.npz")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert got[k].tobytes() == v.tobytes(), k
    src = _npz(DIGITS)
    changed = [k for k in want if not np.array_equal(want[k], src[k])]
    assert len(changed) == 8 * 3                 # conv2/w, gamma, beta


def test_fp_check_keeps_the_function(tmp_path):
    """The port's fp_check (W8A8 prepare, every flag off) on the planted
    npz is below the root script's bound (1e-4): the scales are powers of
    two, so the FP logits are equal; a wrong compensation shows."""
    dst = str(tmp_path / "planted.npz")
    AD.make_imbalanced(DIGITS, dst, 7, [1.0, 2.0, 4.0])
    assert AD.fp_check(DIGITS, dst, "digits", "cpu") < 1e-4
    d = _npz(dst)
    d["model.layer1.0.conv1/bn/beta"] = d["model.layer1.0.conv1/bn/beta"] * 2
    np.savez(tmp_path / "bad.npz", **d)
    assert AD.fp_check(DIGITS, str(tmp_path / "bad.npz"), "digits",
                       "cpu") > 1e-3


def test_arms_and_names_match_jax():
    """The four arms with their flags, and the seed/suffix naming."""
    args = AD.parse_args(["--act_mode_fused", "shift", "--shift_targets",
                          "0.5,1.0", "--arms", "brecq,two_phase,fused+beta",
                          "--extra", "--act_quant false"])
    want = eval(compile(ast.Expression(_statement("advantage_demo.py",
                                                  "runs")),
                        "advantage_demo.py", "eval"), {"A": args})
    want = [(t, m, ex + ["--act_quant", "false"]) for t, m, ex in want
            if t in ("brecq", "two_phase", "fused+beta")]
    assert AD.arms(args) == want
    nm = AD.names(AD.parse_args(["--seed", "11", "--suffix", "_b",
                                 "--scales", "1,1,16"]))
    assert nm["tag"] == "1x1x16" and nm["sfx"] == "_s11_b"
    assert nm["dst"] == os.path.join(
        "torch_logs", "trained_resnet18_digits_imbalanced_1x1x16_s11_b.npz")


def test_selection_vs_planted_matches_jax(tmp_path):
    """One hardened selection state, saved by each package in its own
    format: the same match fraction per block, and the ones planted."""
    import jax.numpy as jnp
    import jax
    from shiftedscalequantization_tpu.graph import UnitQuant
    from shiftedscalequantization_tpu.ops.quant import QParams
    from shiftedscalequantization_tpu.ops.wquant import AdaRoundWQ
    report = AD.make_imbalanced(DIGITS, str(tmp_path / "p.npz"), 7,
                                [1.0, 2.0, 4.0])
    sts = (0.25, 0.5, 1.0)
    qs, planted = {}, {}
    for i, (blk, info) in enumerate(sorted(report.items())):
        s = np.asarray(info["scales"])
        ic = info["ic"]
        expect = np.argmin(np.abs(np.asarray(sts)[None, :]
                                  - (s / s.max())[:, None]), 1)
        idx = expect.copy()
        wrong = (i * ic) // 8                    # 0, 1/8, ... 7/8 wrong
        idx[:wrong] = (idx[:wrong] + 1) % 3
        planted[blk] = float((idx == expect).mean())
        qp = QParams(delta=jnp.full((ic * 2, 1, 1, 1), 0.1),
                     zero_point=jnp.full((ic * 2, 1, 1, 1), 2.0), n_bits=2,
                     sym=False)
        qs[f"{blk}.conv2"] = UnitQuant(
            wq=AdaRoundWQ(qp=qp, alpha=jnp.zeros((ic * 2, ic, 3, 3)),
                          soft=False, st_index=jnp.asarray(idx),
                          shift_targets=sts),
            aq=None, alpha_out=None, beta_out=None)
    JCK.save_qstate(str(tmp_path / "jax" / "QNN_W2_A4"), qs)
    TCK.save_qstate(str(tmp_path / "port" / "QNN_W2_A4"),
                    JI.qstate_from_numpy(jax.tree.map(np.asarray, qs),
                                         "cpu"))
    want = jax_script("advantage_demo.py")["selection_vs_planted"](
        str(tmp_path / "jax"), report, "0.25,0.5,1.0")
    got = AD.selection_vs_planted(str(tmp_path / "port"), report,
                                  "0.25,0.5,1.0")
    assert got == want == planted
    assert len(set(got.values())) == 8


def test_aggregate_advantage_reads_port_records(tmp_path, monkeypatch):
    """Two seeds of the port's main (its CLI runs stubbed: one line of
    selection ratios and a final top-1 each) write records that the root
    aggregate_advantage.py reads into its table and margins."""
    os.symlink(DIGITS, tmp_path / "trained_resnet18_digits.npz")
    monkeypatch.chdir(tmp_path)

    def fake_cli(argv):
        seed = int(argv[argv.index("--seed") + 1])
        mode = argv[argv.index("--mode") + 1]
        top1 = {"brecq": 50.0, "two_phase": 60.0}[mode] + seed / 10
        out = ("accuracy of FP model: {'top1': 99.0, 'top5': 100.0}\n"
               "selection ratio model.layer1.0.conv2: [0.25, 0.75]\n")
        return {"top1": top1, "top5": 100.0}, out, 1.0

    monkeypatch.setattr(C, "run_cli", fake_cli)
    for seed in (7, 11):
        rec = AD.main(["--platform", "cpu", "--seed", str(seed), "--arms",
                       "brecq,two_phase", "--out",
                       f"torch_logs/adv_s{seed}.json"])
        assert [r["tag"] for r in rec["runs"]] == ["brecq", "two_phase"]
        assert rec["runs"][0]["selection_ratios"] == {
            "model.layer1.0.conv2": [0.25, 0.75]}
        # no checkpoint was written: the error is recorded, not raised
        assert rec["runs"][1]["selection_vs_planted"].startswith("error: ")
    files = sorted(glob.glob("torch_logs/adv_s*.json"))
    assert len(files) == 2 and json.load(open(files[0]))["fp_rel"] < 1e-4
    res = subprocess.run([sys.executable, str(ROOT / "aggregate_advantage.py"),
                          "torch_logs/adv_s*.json"], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    stats = json.loads(res.stdout.strip().splitlines()[-1])["stats"]
    assert sorted(stats["brecq"]["vals"]) == [50.7, 51.1]
    assert stats["two_phase"]["n"] == 2
    assert "- two_phase vs brecq: +10.00" in res.stdout


# ---------------------------------------------------------------------------
# imagenet_drill
# ---------------------------------------------------------------------------

def test_make_image_folder_matches_jax(tmp_path, monkeypatch):
    """With two train and one val image a class: the same files and the
    same decoded pixels."""
    from PIL import Image
    small = dict(N_CLASSES=10, N_TRAIN_PER=2, N_VAL_PER=1)
    for k, v in small.items():
        monkeypatch.setattr(ID, k, v)
    want = jax_script("imagenet_drill.py", np=np, **small)[
        "make_image_folder"](str(tmp_path / "jax"))
    got = ID.make_image_folder(str(tmp_path / "port"))
    assert got == want
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*.JPEG"))
    assert len(files) == 30 and files == sorted(
        p.relative_to(tmp_path / "port")
        for p in (tmp_path / "port").rglob("*.JPEG"))
    for f in files:
        a = np.asarray(Image.open(tmp_path / "jax" / f))
        b = np.asarray(Image.open(tmp_path / "port" / f))
        assert a.shape == b.shape and a.shape[0] >= 256
        np.testing.assert_array_equal(a, b)


def test_pth_tar_imports_equal_in_both_packages(tmp_path):
    """The drill's checkpoint is a flat state dict of ImageNet ResNet-18
    (1000 classes; torch's BN affine init, running mean N(0, 0.2), var
    U(0.5, 1.5)); both packages' torch_import give equal raw params."""
    path = ID.make_pth_tar(str(tmp_path / "r18.pth.tar"))
    sd = torch.load(path, weights_only=True)
    assert sd["fc.weight"].shape == (1000, 512) and "conv1.weight" in sd
    assert not any(k.startswith(("module.", "state_dict")) for k in sd)
    assert torch.equal(sd["bn1.weight"], torch.ones(64))
    assert torch.equal(sd["layer1.0.bn1.bias"], torch.zeros(64))
    var = torch.cat([v for k, v in sd.items() if k.endswith("running_var")])
    assert 0.5 <= float(var.min()) and float(var.max()) <= 1.5
    tg, km = TZ.build("resnet18", dataset="imagenet")
    jg, jkm = JZ.build("resnet18", dataset="imagenet")
    tp = TTI.params_from_state_dict(tg, km(tg), TTI.load_state_dict(path),
                                    device="cpu")
    jp = JTI.params_from_state_dict(jg, jkm(jg), JTI.load_state_dict(path))
    assert set(tp) == set(jp) and len(tp) == 21
    for name, p in jp.items():
        assert set(tp[name]) == set(p), name
        for k, v in p.items():
            for bk, arr in (v.items() if k == "bn" else [(None, v)]):
                got = tp[name][k][bk] if bk else tp[name][k]
                np.testing.assert_array_equal(got.numpy(), np.asarray(arr))


def test_drill_defaults_name_only_port_paths():
    args = ID.parse_args([])
    assert args.platform == "cuda" and args.out.startswith("torch_logs/")
    assert os.path.basename(args.root) == "ssq_imagenet_drill_torch"
    quick = ID.parse_args(["--quick"])
    assert (quick.iters, quick.iters_a, quick.num_samples) == (4, 4, 64)


# ---------------------------------------------------------------------------
# run_accuracy
# ---------------------------------------------------------------------------

def test_runs_and_filters_match_jax():
    want = ast.literal_eval(_statement("run_accuracy.py", "RUNS"))
    assert [tuple(r) for r in RA.RUNS] == [tuple(r) for r in want]
    args = RA.parse_args(["--only", "synth10:brecq:W2A4,digits:brecq:W3A4"])
    assert [r[:5] for r in RA.select_runs(args)] == [
        ("brecq", "synth10", "brecq", 2, 4), ("brecq", "digits", "brecq", 3,
                                              4)]
    quick = RA.parse_args(["--quick"])
    assert RA.select_runs(quick) == RA.RUNS[:1]
    assert (quick.iters, quick.iters_a) == (4, 4)
    assert RA.checkpoint_dir(args, "synth10", "brecq") == \
        "./checkPoint/acc_synth10_brecq"
    r50 = RA.parse_args(["--arch", "resnet50"])
    assert RA.checkpoint_dir(r50, "digits", "fused") == \
        "./checkPoint/acc_digits_resnet50_fused"


def test_markdown_table_is_the_root_scripts(tmp_path):
    """The table of the same records, byte for byte: the root script's
    writer (its top-level statements from ``lines = [`` on) against
    write_table."""
    results = [
        {"dataset": "synth10", "mode": "brecq", "bits": "W2A4",
         "fp_top1": 100.0, "init_top1": 11.328,
         "trajectory": [("model.layer1.0", 50.25), ("model.fc", 95.5)],
         "final": {"top1": 96.0, "top5": 100.0}, "wall_s": 3.5},
        {"dataset": "digits", "mode": "fused+beta", "bits": "W2A4",
         "fp_top1": 98.1, "init_top1": None, "trajectory": [],
         "final": {"top1": 90.5, "top5": 99.0}, "wall_s": 2.0}]
    dep = {"sim": 96.0, "deploy_2pass": 95.9, "deploy_1pass": 96.1}
    tree = _tree("run_accuracy.py")
    start = next(i for i, n in enumerate(tree.body)
                 if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", "") == "lines")
    args = RA.parse_args(["--platform", "cpu", "--iters", "100", "--iters_a",
                          "50", "--out", str(tmp_path / "port" / "A.md")])
    jargs = types.SimpleNamespace(**{**vars(args),
                                     "out": str(tmp_path / "jax.md")})
    exec(compile(ast.Module(body=tree.body[start:], type_ignores=[]),
                 "run_accuracy.py", "exec"),
         {"A": jargs, "results": results, "dep": dep, "print": lambda *a: 0})
    RA.write_table(args, results, dep)
    want = (tmp_path / "jax.md").read_text()
    assert (tmp_path / "port" / "A.md").read_text() == want
    assert "| synth10 | brecq | W2A4 | 100.0 | 11.328 | 96.0 | +84.67 |" \
        in want


# ---------------------------------------------------------------------------
# all four: the CLI-line regexes, and the defaults
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_lines(tmp_path_factory):
    """The lines of three cheap port CLI runs: ResNet-18 on digits,
    --mode fused with the per-target validation and a golden-logit
    directory; its --eval_only replay; MNASNet --harmonize_residual up to
    its initialized checkpoint."""
    tmp = tmp_path_factory.mktemp("cli")
    x_tr, y_tr, x_te, y_te = TRD.digits_arrays()
    saved = TRD.digits_arrays, torch.get_num_threads()
    TRD.digits_arrays = lambda size=32: (x_tr[:64], y_tr[:64], x_te[:32],
                                         y_te[:32])
    torch.set_num_threads(2)
    common = ["--dataset", "digits", "--num_samples", "16", "--batch_size",
              "16", "--w_scale_method", "max", "--a_scale_method", "max",
              "--platform", "cpu", "--log_path", str(tmp / "run.log")]
    r18 = ["--arch", "resnet18", "--pretrained", DIGITS, "--mode", "fused",
           "--iters_w", "1", "--iters_a", "0", "--golden_dir",
           str(tmp / "golden"), "--checkpoint_dir", str(tmp / "r18")]
    try:
        outs = [C.run_cli(common + r18)[1],
                C.run_cli(common + r18 + ["--eval_only", "true"])[1],
                C.run_cli(common + ["--arch", "mnasnet",
                                    "--harmonize_residual", "true",
                                    "--make_checkpoint", "true",
                                    "--checkpoint_dir", str(tmp / "mn")])[1]]
    finally:
        TRD.digits_arrays = saved[0]
        torch.set_num_threads(saved[1])
    return "".join(outs)


@pytest.mark.parametrize("script", sorted(PAIRS))
def test_cli_regexes_match_jax_and_find_port_lines(script, cli_lines):
    """Each script parses the CLI's lines with the root script's regexes,
    and each regex finds its line in the port's CLI output."""
    want = _regexes(_tree(script))
    got = _regexes(ast.parse(Path(PAIRS[script].__file__).read_text()))
    # the drill also reads the loaders line the port's CLI prints
    extra = {r"data loaders: (.*)"} if script == "imagenet_drill.py" \
        else set()
    assert set(got) == set(want) | extra and want
    for pat in got:
        assert re.findall(pat, cli_lines), pat


def test_defaults_write_only_port_paths():
    """No default output names a file or folder of the JAX scripts."""
    assert RA.parse_args([]).out == "torch_logs/ACCURACY.md"
    assert AD.parse_args([]).out == "torch_logs/advantage_demo.json"
    assert HA.parse_args([]).out == "torch_logs/harm_accuracy.json"
    for mod in PAIRS.values():
        assert mod.parse_args([]).platform == "cuda"
        src = Path(mod.__file__).read_text()
        assert "round3_logs" not in src and "round5_logs" not in src
        assert '"ACCURACY.md"' not in src
