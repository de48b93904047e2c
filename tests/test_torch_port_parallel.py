"""PyTorch port vs the JAX package: ``parallel/mesh`` and ``parallel/dist``
(sharded eval and capture, synced act calibration, data-parallel and
sharded reconstruction) and the reconstruction engine's gradient
averaging over a mesh axis, on the CPU.

The port runs in gloo rank processes (``torch_port_ranks``): one group of
two ranks and one of four for the whole module, each running every case
of its suite. The JAX package runs here on as many of the faked CPU
devices. State is made by the JAX package and carried across
(``utils/jax_import``); the tiny model and its caches are
``test_torch_port_recon.py``'s. Caches hold N = global batch rows, so a
data-parallel step sees every row and only summation orders differ.
Tolerances: eval hit counts equal; captures atol 1e-6; synced deltas rtol
1e-6 and zero points equal; reconstruction traces and losses rtol 1e-4
(the port's trajectory tolerance against the JAX package); the ranks of
one run bit for bit. The sharded run is held to the single process on
tests/test_parallel.py's own problem and tolerances (CIFAR ResNet-18
layer1.0, alpha rtol 1e-4 / atol 5e-5, hard loss rtol 1e-4): on the tiny
block some selection logits have gradients at the level of float noise,
which Adam turns into whole steps whatever the sharding (one rank with 4
threads against one with 1 already parts them by 3e-3).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import shiftedscalequantization_tpu as ssq
from shiftedscalequantization_tpu import graph as JG
from shiftedscalequantization_tpu.models import resnet as JR
from shiftedscalequantization_tpu.parallel import dist as JD
from shiftedscalequantization_tpu.parallel import mesh as JM
from shiftedscalequantization_tpu.recon import engine as JE
from shiftedscalequantization_tpu.utils.eval import validate_model as \
    jvalidate
from shiftedscalequantization_tpu_torch import graph as TG
from shiftedscalequantization_tpu_torch import quantize as TQZ
from shiftedscalequantization_tpu_torch.parallel import dist as TDI
from shiftedscalequantization_tpu_torch.parallel import mesh as TM
from shiftedscalequantization_tpu_torch.recon import engine as TE
from shiftedscalequantization_tpu_torch.utils import jax_import as JI
from shiftedscalequantization_tpu_torch.utils.eval import validate_model
from test_multiprocess import tiny_problem
from test_torch_port_recon import BLOCK, CASES, RTOL, UNITS, _a, _caches, \
    _np, _port_graph, _state
from torch_port_ranks import R18_BLOCK, R18_UNITS, r18_block, run_ranks

N = 16                       # cache rows = the global batch
DDP = {"f32": ("f32", "unit"), "int8": ("int8", "unit"),
       "f32_effective": ("f32", "effective")}
SHARDED = ("unit", "effective")
CFG = dict(n_bits_w=2, n_bits_a=4, w_scale_method="max",
           a_scale_method="max", use_8bit_head_stem=False)


def _mesh(n_data, n_model=1):
    return JM.make_mesh(n_data=n_data, n_model=n_model,
                        devices=jax.devices()[:n_data * n_model])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as each rank process has: the single-process
    references then sum in the ranks' order."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def tiny():
    return _state()


@pytest.fixture(scope="module")
def problem():
    """tests/test_multiprocess.py's tiny eval problem in both packages."""
    g, params, qs, data = tiny_problem()
    return dict(g=g, params=params, qs=qs, data=data,
                port=dict(g=_port_graph(g),
                          params=JI.params_from_numpy(_np(params), "cpu"),
                          qs=JI.qstate_from_numpy(_np(qs), "cpu"),
                          data=data))


def _calib_x():
    """test_parallel.py's rank-scaled shards: shard i is one base batch
    scaled by 1 + i/4."""
    base = np.random.default_rng(3).normal(size=(2, 8, 8, 3)) \
        .astype(np.float32)
    return np.concatenate([base * (1.0 + i / 4.0) for i in range(2)])


def _sharded_settings(case):
    """tests/test_parallel.py's sharded reconstruction (30 steps, batch
    16), with the near-1 or the coarse candidate set."""
    return dict(mode="fused", iters=30, batch_size=N, **CASES[case])


def _ddp_settings(case):
    wire, kind = DDP[case]
    return wire, dict(mode="fused", iters=40, batch_size=N, **CASES[kind])


@pytest.fixture(scope="module")
def act_state(tiny):
    """The tiny model with its act sites calibrated (the port's own
    calibration) and the block's caches, for the act phases."""
    qs = TQZ.calibrate_acts(tiny["gt"], tiny["tparams"], tiny["tqs"],
                            tiny["tcali"][:32], TQZ.QuantConfig(**CFG),
                            device="cpu")
    ci, co = _caches(tiny, BLOCK, N)
    return dict(qs=qs, ci=ci, co=co, settings=dict(iters=20, batch_size=N))


@pytest.fixture(scope="module")
def ranks2(tiny, problem, act_state, tmp_path_factory):
    ci, co = _caches(tiny, BLOCK, N)
    spec = dict(
        validate=problem["port"], block=BLOCK, units=UNITS,
        tiny=dict(g=tiny["gt"], params=tiny["tparams"], qs=tiny["tqs"]),
        capture_x=tiny["cali"][:31], calib_x=_calib_x(),
        calib_cfg=TQZ.QuantConfig(**CFG), ci=ci, co=co,
        ddp={c: dict(wire=_ddp_settings(c)[0], settings=_ddp_settings(c)[1])
             for c in DDP},
        act=act_state)
    return run_ranks("parallel2", 2, tmp_path_factory.mktemp("par2"), spec)


@pytest.fixture(scope="module")
def ranks4(problem, tmp_path_factory):
    x = np.concatenate([b[0] for b in problem["data"]])
    y = np.concatenate([b[1] for b in problem["data"]])
    spec = dict(validate={**problem["port"], "data": [(x, y)]},
                sharded={c: _sharded_settings(c) for c in SHARDED},
                r18_cfg=CFG)
    return run_ranks("parallel4", 4, tmp_path_factory.mktemp("par4"), spec)


def _same_on_every_rank(res, key):
    def eq(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                eq(a[k], b[k])
        elif isinstance(a, (tuple, list)):
            for u, v in zip(a, b):
                eq(u, v)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for r in res[1:]:
        eq(res[0][key], r[key])


# ---------------------------------------------------------------------------
# single process: start-up, mesh, the engine's checks
# ---------------------------------------------------------------------------

def test_init_multihost_is_a_noop_for_one_process(monkeypatch):
    monkeypatch.delenv("SSQ_NUM_PROCESSES", raising=False)
    assert TDI.init_multihost() is False
    assert TDI.init_multihost(num_processes=1) is False
    assert not torch.distributed.is_initialized()


def test_init_multihost_reads_the_ssq_variables(monkeypatch):
    seen = {}
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend,
                                                          **kw))
    monkeypatch.setenv("SSQ_NUM_PROCESSES", "2")
    monkeypatch.setenv("SSQ_COORDINATOR", "node0:1234")
    monkeypatch.setenv("SSQ_PROCESS_ID", "1")
    assert TDI.init_multihost(device="cpu") is True
    assert seen == dict(backend="gloo", init_method="tcp://node0:1234",
                        world_size=2, rank=1)


def test_backend_rule(monkeypatch):
    assert TDI.backend_for("cpu", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert TDI.backend_for("cuda", 2) == "gloo"     # two ranks, one card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert TDI.backend_for("cuda", 4) == "nccl"
    assert TDI.backend_for("cuda", 8) == "gloo"


def test_single_process_mesh_and_batch_shards():
    mesh = TM.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(TM.shard_batch(x, mesh), x)
    with pytest.raises(ValueError, match="does not cover"):
        TM.make_mesh(n_data=2)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.group("pipeline")
    pad, n = TDI.pad_to_multiple(x[:5], 4)
    assert n == 5 and pad.shape == (8, 2) and not pad[5:].any()


def test_engine_axis_without_mesh_raises(tiny, act_state):
    ci, co = (torch.tensor(a) for a in _caches(tiny, BLOCK, N))
    s = TE.ReconSettings(mode="fused", iters=2, batch_size=N,
                         grad_psum_axis="data")
    args = (tiny["gt"], tiny["tparams"], tiny["tqs"], BLOCK, ci, co, s)
    with pytest.raises(ValueError, match="no mesh binds it"):
        TE.reconstruct_node(*args)
    with pytest.raises(ValueError, match="no mesh binds it"):
        TE.reconstruct_act_delta(tiny["gt"], tiny["tparams"],
                                 act_state["qs"], BLOCK, ci, co, s)
    with pytest.raises(ValueError, match="no mesh binds it"):
        TE.reconstruct_act_shift(tiny["gt"], tiny["tparams"],
                                 act_state["qs"], BLOCK, ci, co, s)


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

def test_two_ranks_on_gloo(ranks2):
    assert [r["backend"] for r in ranks2] == ["gloo", "gloo"]
    assert [r["mesh"] for r in ranks2] == [
        ({"data": 2, "model": 1}, {"data": d, "model": 0}) for d in (0, 1)]


def test_sharded_validate_equals_jax_and_single_process(ranks2, problem):
    p = problem
    flags = JG.Flags().all_weights(p["g"])
    want = JD.sharded_validate(p["g"], p["params"], p["qs"], p["data"],
                               _mesh(2), flags)
    single = validate_model(p["port"]["g"], p["port"]["params"],
                            p["port"]["qs"], p["data"],
                            TG.Flags().all_weights(p["port"]["g"]))
    for r in ranks2:
        assert r["validate"] == pytest.approx(
            {k: float(v) for k, v in want.items()}, abs=1e-9)
        assert r["validate"] == single


def test_sharded_capture_equals_jax(ranks2, tiny):
    want = JD.sharded_capture(tiny["g"], tiny["params"], tiny["qs"], BLOCK,
                              jnp.asarray(tiny["cali"][:31]), _mesh(2),
                              JG.Flags().all_weights(tiny["g"]), JG.Flags(),
                              batch_size=8)
    for i, w in enumerate(want):
        got = np.concatenate([r["capture"][i] for r in ranks2])
        assert got.shape == (32,) + np.asarray(w).shape[1:]
        np.testing.assert_allclose(got, np.asarray(w), atol=1e-6)


def test_synced_calibration_equals_jax(ranks2, tiny):
    qs = JD.synced_calibrate_acts(tiny["g"], tiny["params"], tiny["qs"],
                                  jnp.asarray(_calib_x()),
                                  ssq.QuantConfig(**CFG), _mesh(2))
    _same_on_every_rank(ranks2, "calib")
    got = ranks2[0]["calib"]
    want = {k: getattr(v, "aq", v) for k, v in qs.items()}
    want = {k: a for k, a in want.items()
            if a is not None and hasattr(a, "delta")}
    assert got.keys() == want.keys() and len(got) == 3
    for k, (delta, zp) in got.items():
        np.testing.assert_allclose(delta, np.asarray(want[k].delta),
                                   rtol=1e-6, err_msg=k)
        np.testing.assert_array_equal(zp, np.asarray(want[k].zero_point))
        assert np.array_equal(zp, np.round(zp))


@pytest.mark.parametrize("case", list(DDP))
def test_ddp_reconstruct_equals_jax(ranks2, tiny, case):
    """f32 and int8 wire at N = global batch against the JAX package's
    ddp_reconstruct on a mesh of two devices; 'f32_effective' runs the
    warm start and the refine, each reduced the same way."""
    _same_on_every_rank(ranks2, f"ddp/{case}")
    got = ranks2[0][f"ddp/{case}"]
    wire, kw = _ddp_settings(case)
    ci, co = _caches(tiny, BLOCK, N)
    _, m = JD.ddp_reconstruct(tiny["g"], tiny["params"], tiny["qs"], BLOCK,
                              ci, co, JE.ReconSettings(**kw, chunk=8),
                              jax.random.PRNGKey(2), _mesh(2), wire=wire)
    traces = [("rec_trace", m["rec_trace"])]
    if "refine_trace" in m:
        traces.append(("refine_trace", m["refine_trace"]))
        np.testing.assert_allclose(
            got["presolve_hard_loss"],
            float(m["warmstart"]["presolve_hard_loss"]), rtol=RTOL)
    assert ("refine_trace" in got) == ("refine_trace" in m)
    for name, want in traces:
        assert got[name].shape == np.asarray(want).shape, name
        np.testing.assert_allclose(got[name], np.asarray(want), rtol=RTOL,
                                   err_msg=name)
    for k in ("soft_loss", "hard_loss"):
        np.testing.assert_allclose(got[k], float(m[k]), rtol=RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("phase", ["act_delta", "act_shift"])
def test_act_phases_average_over_data(ranks2, tiny, act_state, phase):
    """The act phases with grad_psum_axis set, each rank on its shard,
    against the single process on the whole set: the same steps, summed
    in another order."""
    _same_on_every_rank(ranks2, phase)
    trace, learned = ranks2[0][phase]
    fn = {"act_delta": TE.reconstruct_act_delta,
          "act_shift": TE.reconstruct_act_shift}[phase]
    qs, m = fn(tiny["gt"], tiny["tparams"], act_state["qs"], BLOCK,
               torch.tensor(act_state["ci"]), torch.tensor(act_state["co"]),
               TE.ReconSettings(**act_state["settings"]), seed=3)
    np.testing.assert_allclose(trace, _a(m["rec_trace"]), rtol=RTOL)
    assert learned.keys() == {u for u in UNITS if qs[u].aq is not None}
    for u, v in learned.items():
        want = qs[u].aq.delta if phase == "act_delta" else qs[u].aq.alpha
        np.testing.assert_allclose(v, _a(want), rtol=RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", SHARDED)
def test_sharded_reconstruct_equals_single_process(ranks4, case):
    """tests/test_parallel.py's sharded reconstruction (CIFAR ResNet-18
    layer1.0, 128 cached rows, batch 16, 30 steps) on a 2 x 2 grid: rows
    over 'data', theta's out-channels over 'model'; against the port's
    single-process reconstruct_node at that test's tolerances."""
    _same_on_every_rank(ranks4, f"sharded/{case}")
    got = ranks4[0][f"sharded/{case}"]
    g, params, qs, ci, co = r18_block(CFG)
    qs, m = TE.reconstruct_node(g, params, qs, R18_BLOCK, ci, co,
                                TE.ReconSettings(**_sharded_settings(case)),
                                seed=5)
    for u in R18_UNITS:
        np.testing.assert_allclose(got["theta"][u]["alpha"],
                                   _a(qs[u].wq.alpha), rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(got["hard_loss"], float(m["hard_loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(got["rec_trace"], _a(m["rec_trace"]),
                               rtol=RTOL)


def test_sharded_validate_uneven_batch(ranks4, problem):
    """30 rows over 4 ranks: two zero rows padded, masked."""
    p = problem
    x = np.concatenate([b[0] for b in p["data"]])
    y = np.concatenate([b[1] for b in p["data"]])
    flags = JG.Flags().all_weights(p["g"])
    want = JD.sharded_validate(p["g"], p["params"], p["qs"], [(x, y)],
                               _mesh(4), flags)
    single = jvalidate(p["g"], p["params"], p["qs"], [(x, y)], flags)
    assert want == single
    for r in ranks4:
        assert r["validate"] == pytest.approx(
            {k: float(v) for k, v in want.items()}, abs=1e-9)


def test_shard_shapes_equal_jax(ranks4):
    """shard_params / shard_qstate on the 2 x 2 grid: each rank's slice
    has the shape of the JAX package's shard on the device at the same
    grid place (OC 64 over 2: (32, 64, 3, 3))."""
    g = JR.build_resnet(18, num_classes=10, variant="cifar")
    params, qs = ssq.prepare_model(
        g, JR.init_params(jax.random.PRNGKey(0), g), ssq.QuantConfig(**CFG))
    mesh = _mesh(2, 2)
    sp, sq = JM.shard_params(params, mesh), JM.shard_qstate(qs, mesh)

    def shard_shape(a, rank):
        dev = mesh.devices.reshape(-1)[rank]
        return next(tuple(s.data.shape) for s in a.addressable_shards
                    if s.device == dev)

    for rank, r in enumerate(ranks4):
        shapes = r["shard_shapes"]
        assert shapes["params"]["model.layer1.0.conv1"]["w"] == \
            (32, 64, 3, 3)
        for unit, leaves in sp.items():
            for k, a in leaves.items():
                if k == "bn":
                    continue
                assert shapes["params"][unit][k] == shard_shape(a, rank), \
                    (unit, k)
            got = shapes["qstate"][unit].wq.qp
            want = sq[unit].wq.qp
            assert got.delta == shard_shape(want.delta, rank), unit
            assert got.zero_point == shard_shape(want.zero_point, rank), unit
