"""Guards of the PyTorch port: what it imports, and that it never runs on
the CPU unless asked to."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import shiftedscalequantization_tpu_torch as tp
from shiftedscalequantization_tpu_torch import cli, deploy as TD
from shiftedscalequantization_tpu_torch.models import zoo as TZ
from shiftedscalequantization_tpu_torch.ops.cuda import _build
from shiftedscalequantization_tpu_torch.utils import jax_import as JI

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "shiftedscalequantization_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "shiftedscalequantization_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_and_smoke_script_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 18
    for new in ("ops/cuda/fake_quant.py", "recon/capture.py",
                "recon/engine.py", "recon/pipeline.py", "cli.py", "train.py",
                "data/datasets.py", "data/realdata.py", "utils/config.py",
                "utils/logging.py", "utils/eval.py", "utils/checkpoint.py",
                "models/regnet.py", "ops/cuda/group_conv.py",
                "ops/act_quant.py", "recon/search.py", "models/mnasnet.py",
                "ops/cuda/dw_conv.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/collectives.py",
                "parallel/dist.py", "utils/profiling.py",
                "utils/analysis.py", "utils/sweep.py"):
        assert PORT / new in files, new
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path.relative_to(ROOT)}: {name}"


def test_kernel_sources_and_build_command():
    """Every csrc/*.cu is compiled for sm_90a by its own nvcc process and
    linked into one library loaded with ctypes; the package carries no
    torch extension build."""
    srcs = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert srcs == ["dw_conv3x3.cu", "dw_conv_int8.cu", "fake_quant.cu",
                    "int8_group_conv.cu", "int_matmul.cu", "mbconv_fused.cu",
                    "packed_qmm.cu", "stem_fused.cu"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    # the fake-quant kernel divides and rounds half to even as the plain
    # version does; fast math would turn the division into a reciprocal
    assert not any("fast_math" in f or "ftz" in f or "prec-div" in f
                   for f in _build.NVCC_FLAGS)
    assert _build.BUILD_DIR == ROOT / "build" / "torch_kernels"
    for path in PORT.rglob("*.py"):
        text = path.read_text()
        assert "cpp_extension" not in text and "torch.compile" not in text
    # each C entry point the wrappers call is defined in the sources
    code = "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    for name in list(_build.SIGNATURES) + ["ssq_error_string"]:
        assert f'extern "C"' in code and f" {name}(" in code, name


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_a_card_raise(no_card):
    graph, _ = TZ.build("resnet18", num_classes=10, dataset="cifar10")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TZ.init_params(graph)
    raw = TZ.init_params(graph, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.prepare_model(graph, raw, tp.QuantConfig())
    cfg = tp.QuantConfig(w_scale_method="max", a_scale_method="max")
    params, qs = tp.prepare_model(graph, raw, cfg, device="cpu")
    x = torch.zeros((2, 32, 32, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.calibrate_acts(graph, params, qs, x, cfg)
    qs = tp.calibrate_acts(graph, params, qs, x, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.forward(graph, params, qs, x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.build_deploy_params(graph, params, qs)
    dp = TD.build_deploy_params(graph, params, qs, device="cpu")
    steps = TD.act_steps_from_qstate(graph, qs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.deploy_forward(graph, dp, steps, x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        JI.params_from_numpy({"w": np.zeros(3, np.float32)})
    # the CLI without --platform cpu (default auto: the card)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--dataset", "cifar10", "--synthetic_data", "true"])


def test_trainer_and_profiler_without_a_card_raise(no_card, tmp_path):
    """``train.main`` (default --platform auto: cuda:0), ``train_model``,
    ``eval_accuracy`` and ``profiling.layer_timing`` run on the card
    unless asked for the CPU."""
    from shiftedscalequantization_tpu_torch import train
    from shiftedscalequantization_tpu_torch.utils import profiling
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1", "--out", str(tmp_path / "t.npz")])
    assert not (tmp_path / "t.npz").exists()
    graph, _ = TZ.build("resnet18", num_classes=10, dataset="cifar10")
    raw = TZ.init_params(graph, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train_model(graph, raw, None, 1, 0.1, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.eval_accuracy(graph, *train.split_params(raw),
                            np.zeros((1, 32, 32, 3), np.float32),
                            np.zeros(1, np.int32))
    cfg = tp.QuantConfig(w_scale_method="max", a_scale_method="max")
    params, qs = tp.prepare_model(graph, raw, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.layer_timing(graph, params, qs,
                               np.zeros((1, 32, 32, 3), np.float32))


PARALLEL_ENTRIES = ("init_multihost", "sharded_validate", "sharded_capture",
                    "synced_calibrate_acts", "ddp_reconstruct",
                    "sharded_reconstruct")


@pytest.mark.parametrize("name", PARALLEL_ENTRIES)
def test_parallel_entry_points_without_a_card_raise(no_card, name):
    """``parallel/dist``'s entry points run each rank on its card unless
    asked for the CPU, and raise without one before any collective."""
    from shiftedscalequantization_tpu_torch.parallel import dist as PD
    from shiftedscalequantization_tpu_torch.parallel import make_mesh
    from shiftedscalequantization_tpu_torch.recon import ReconSettings
    graph, _ = TZ.build("resnet18", num_classes=10, dataset="cifar10")
    cfg = tp.QuantConfig(w_scale_method="max", a_scale_method="max")
    params, qs = tp.prepare_model(graph, TZ.init_params(graph, device="cpu"),
                                  cfg, device="cpu")
    mesh = make_mesh()
    x = torch.zeros((2, 32, 32, 3))
    cache = torch.zeros((2, 8, 8, 64))
    calls = {
        "init_multihost": lambda: PD.init_multihost(
            "localhost:1", num_processes=2, process_id=0),
        "sharded_validate": lambda: PD.sharded_validate(
            graph, params, qs, [(x, np.zeros(2, np.int64))], mesh),
        "sharded_capture": lambda: PD.sharded_capture(
            graph, params, qs, "model.layer1.0", x, mesh, tp.Flags(),
            tp.Flags()),
        "synced_calibrate_acts": lambda: PD.synced_calibrate_acts(
            graph, params, qs, x, cfg, mesh),
        "ddp_reconstruct": lambda: PD.ddp_reconstruct(
            graph, params, qs, "model.layer1.0", cache, cache,
            ReconSettings(iters=1, batch_size=2), 0, mesh),
        "sharded_reconstruct": lambda: PD.sharded_reconstruct(
            graph, params, qs, "model.layer1.0", cache, cache,
            ReconSettings(iters=1, batch_size=2), 0, mesh)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[name]()
    assert not torch.distributed.is_initialized()


def test_unported_weight_quantizer_is_refused():
    """Forms the JAX package also refuses to deploy (two-phase
    ShiftedScaleWQ with codes=False, InpScaleWQ) raise with its message;
    a quantizer type the port does not know is refused when carried."""
    from shiftedscalequantization_tpu_torch.ops import wquant as W
    from shiftedscalequantization_tpu_torch.ops.quant import QParams
    w = torch.randn(4, 3, 3, 3, generator=torch.Generator().manual_seed(0))
    qp = QParams(delta=torch.full((4, 1), 0.5), zero_point=torch.ones(4, 1),
                 n_bits=2, sym=False)
    for wq in (W.init_shifted_scale_twophase(qp, w, (0.5, 1.0)),
               W.init_inp_scale(qp, torch.zeros(4, 1), w)):
        with pytest.raises(NotImplementedError,
                           match=f"{type(wq).__name__} .*scale-table"):
            TD._hard_weight_codes(wq, w)

    class LogScaleWQ:       # a weight quantizer type the port lacks
        qp = None

    class Unit:
        wq = LogScaleWQ()
        aq = None
        alpha_out = beta_out = raw_zp = None

    with pytest.raises(NotImplementedError, match="LogScaleWQ"):
        JI.qstate_from_numpy({"u": Unit()}, device="cpu")


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_c_entry_argtypes_match_the_sources(name):
    """Each C entry's ctypes argtypes follow its definition in the
    sources, parameter by parameter: a pointer (or the stream) as
    c_void_p, an int as c_int; a wrong list would hand a pointer over as a
    32-bit int."""
    import ctypes
    import re
    code = "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    params = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{",
                       code, re.S).group(1)
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
             for p in params.split(",")]
    assert kinds == _build.SIGNATURES[name]
