"""Rank processes for the port's ``parallel`` tests (no JAX here).

``run_ranks`` starts ``world`` processes, each ``python -c`` importing only
torch, numpy and the port, with ``SSQ_NUM_PROCESSES`` / ``SSQ_COORDINATOR``
/ ``SSQ_PROCESS_ID`` set and one torch thread. Each rank reads the spec the
test wrote (``spec.pt``: inputs made from numpy seeds and the port's state,
carried from the JAX package by the test), joins the gloo group through
``parallel.dist.init_multihost(device="cpu")``, runs every case of its
suite and writes ``rank{r}.pt``; the test process compares.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))

WORKER = r"""
import sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, {here!r})
import torch_port_ranks as R
R.rank_main({suite!r}, {tmp!r})
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(suite: str, world: int, tmp, spec: dict, timeout=240):
    """Write ``spec``, run ``world`` ranks of ``suite``; each rank's
    results, in rank order."""
    tmp = str(tmp)
    torch.save(spec, os.path.join(tmp, "spec.pt"))
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "SSQ_NUM_PROCESSES": str(world),
           "SSQ_COORDINATOR": f"localhost:{_free_port()}"}
    code = WORKER.format(here=HERE, suite=suite, tmp=tmp)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], env={**env, "SSQ_PROCESS_ID": str(r)},
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-6000:]}"
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def rank_main(suite: str, tmp: str):
    import torch.distributed as dist
    from shiftedscalequantization_tpu_torch.parallel import dist as D
    spec = torch.load(os.path.join(tmp, "spec.pt"), weights_only=False)
    assert D.init_multihost(device="cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"backend": dist.get_backend()}
    SUITES[suite](spec, rank, world, out)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# suites (rank side)
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy()


def collectives_suite(spec, rank, world, out):
    """quantized_pmean on each input's row ``rank``; the int8 wire's
    dtypes; pmean_tree f32 and int8 on a theta-like tree."""
    import torch.distributed as dist
    from shiftedscalequantization_tpu_torch.parallel import collectives as C
    for name, x in spec["xs"].items():
        out[f"qpm/{name}"] = _np(C.quantized_pmean(torch.as_tensor(x[rank])))

    seen = []
    names = ("all_reduce", "all_to_all_single", "all_gather_into_tensor")
    orig = {f: getattr(dist, f) for f in names}

    def spy(f):
        def call(*args, **kw):
            seen.append((f, str(args[0 if f == "all_reduce" else 1].dtype)))
            return orig[f](*args, **kw)
        return call

    for f in names:
        setattr(dist, f, spy(f))
    try:
        out["codes"] = _np(C.quantized_pmean(
            torch.as_tensor(spec["codes"][rank])))
    finally:
        for f in names:
            setattr(dist, f, orig[f])
    out["wire_dtypes"] = seen

    tree = {u: {k: torch.as_tensor(v[rank]) for k, v in t.items()}
            for u, t in spec["tree"].items()}
    for wire in ("f32", "int8"):
        red = C.pmean_tree(tree, None, wire)
        out[f"tree/{wire}"] = {u: {k: _np(v) for k, v in t.items()}
                               for u, t in red.items()}


def _recon_out(qs, m, units):
    """What a reconstruction returns, as numpy: the traces, the first-batch
    losses and every unit's learned logits."""
    out = {k: _np(m[k]) for k in ("rec_trace", "refine_trace", "init_loss",
                                  "soft_loss", "hard_loss") if k in m}
    if "warmstart" in m:
        out["presolve_hard_loss"] = _np(m["warmstart"]["presolve_hard_loss"])
    out["theta"] = {u: {f: _np(getattr(qs[u].wq, f))
                        for f in ("alpha", "beta")
                        if getattr(qs[u].wq, f, None) is not None}
                    for u in units}
    return out


def parallel2_suite(spec, rank, world, out):
    """Two ranks, one 'data' axis: sharded_validate, sharded_capture,
    synced_calibrate_acts, ddp_reconstruct (each wire and case) and the
    act phases with their gradients averaged over 'data'."""
    from shiftedscalequantization_tpu_torch.graph import Flags
    from shiftedscalequantization_tpu_torch.parallel import dist as D
    from shiftedscalequantization_tpu_torch.parallel.mesh import make_mesh, \
        shard_batch
    from shiftedscalequantization_tpu_torch.recon import engine as TE
    mesh = make_mesh(n_data=world)
    out["mesh"] = (mesh.shape, mesh.coords)
    v = spec["validate"]
    out["validate"] = D.sharded_validate(
        v["g"], v["params"], v["qs"], v["data"], mesh,
        Flags().all_weights(v["g"]), device="cpu")

    t = spec["tiny"]
    g, params, qs = t["g"], t["params"], t["qs"]
    ci, co = D.sharded_capture(g, params, qs, spec["block"],
                               torch.as_tensor(spec["capture_x"]), mesh,
                               Flags().all_weights(g), Flags(), batch_size=8,
                               device="cpu")
    out["capture"] = (_np(ci), _np(co))

    cqs = D.synced_calibrate_acts(g, params, qs,
                                  torch.as_tensor(spec["calib_x"]),
                                  spec["calib_cfg"], mesh, device="cpu")
    out["calib"] = {k: (_np(a.delta), _np(a.zero_point))
                    for k, a in ((k, getattr(v, "aq", v))
                                 for k, v in cqs.items())
                    if a is not None and hasattr(a, "delta")}

    for case, kw in spec["ddp"].items():
        rq, m = D.ddp_reconstruct(g, params, qs, spec["block"],
                                  torch.as_tensor(spec["ci"]),
                                  torch.as_tensor(spec["co"]),
                                  TE.ReconSettings(**kw["settings"]), 2,
                                  mesh, wire=kw["wire"], device="cpu")
        out[f"ddp/{case}"] = _recon_out(rq, m, spec["units"])

    a = spec["act"]
    ci, co = (shard_batch(torch.as_tensor(x), mesh) for x in (a["ci"],
                                                              a["co"]))
    s = TE.ReconSettings(**a["settings"], grad_psum_axis="data")
    aq, m = TE.reconstruct_act_delta(g, params, a["qs"], spec["block"], ci,
                                     co, s, seed=3, mesh=mesh)
    out["act_delta"] = (_np(m["rec_trace"]),
                        {u: _np(aq[u].aq.delta) for u in spec["units"]
                         if aq[u].aq is not None})
    aq, m = TE.reconstruct_act_shift(g, params, a["qs"], spec["block"], ci,
                                     co, s, seed=3, mesh=mesh)
    out["act_shift"] = (_np(m["rec_trace"]),
                        {u: _np(aq[u].aq.alpha) for u in spec["units"]
                         if aq[u].aq is not None})


R18_BLOCK = "model.layer1.0"
R18_UNITS = ("model.layer1.0.conv1", "model.layer1.0.conv2")


def r18_block(cfg: dict):
    """tests/test_parallel.py's sharded-reconstruction problem in the port:
    CIFAR ResNet-18 (the port's init, seed 0) prepared with ``cfg``, and
    the FP caches of model.layer1.0 over 128 numpy-drawn 16x16 images.
    Returns (graph, params, qstate, cached_inp, cached_out)."""
    from shiftedscalequantization_tpu_torch import quantize as TQ
    from shiftedscalequantization_tpu_torch.graph import Flags
    from shiftedscalequantization_tpu_torch.models import zoo
    from shiftedscalequantization_tpu_torch.recon.capture import capture_io
    g, _ = zoo.build("resnet18", num_classes=10, dataset="cifar10")
    params, qs = TQ.prepare_model(g, zoo.init_params(g, seed=0, device="cpu"),
                                  TQ.QuantConfig(**cfg), device="cpu")
    cali = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (128, 16, 16, 3), dtype=np.float32))
    ci, co = capture_io(g, params, qs, R18_BLOCK, cali, Flags(), Flags(),
                        batch_size=64, device="cpu")
    return g, params, qs, ci, co


def parallel4_suite(spec, rank, world, out):
    """Four ranks: sharded_reconstruct on a 2 x 2 grid, sharded_validate
    of an uneven batch over four 'data' ranks, and the out-channel shard
    shapes of params and qstate on the 2 x 2 grid."""
    from shiftedscalequantization_tpu_torch.graph import Flags
    from shiftedscalequantization_tpu_torch.parallel import dist as D
    from shiftedscalequantization_tpu_torch.parallel import mesh as M
    from shiftedscalequantization_tpu_torch.quantize import _map_arrays
    from shiftedscalequantization_tpu_torch.recon import engine as TE
    grid = M.make_mesh(n_data=2, n_model=2)
    row = M.make_mesh(n_data=4)
    out["mesh"] = (grid.shape, grid.coords)

    g, params, qs, ci, co = r18_block(spec["r18_cfg"])
    for case, kw in spec["sharded"].items():
        rq, m = D.sharded_reconstruct(g, params, qs, R18_BLOCK, ci, co,
                                      TE.ReconSettings(**kw), 5, grid,
                                      device="cpu")
        out[f"sharded/{case}"] = _recon_out(rq, m, R18_UNITS)
    out["shard_shapes"] = {
        name: _map_arrays(tree, lambda a: tuple(a.shape))
        for name, tree in (("params", M.shard_params(params, grid)),
                           ("qstate", M.shard_qstate(qs, grid)))}

    v = spec["validate"]
    out["validate"] = D.sharded_validate(
        v["g"], v["params"], v["qs"], v["data"], row,
        Flags().all_weights(v["g"]), device="cpu")


SUITES = {"collectives": collectives_suite, "parallel2": parallel2_suite,
          "parallel4": parallel4_suite}
