"""Distributed calibration, reconstruction and evaluation over a rank mesh
(PyTorch port of ``shiftedscalequantization_tpu/parallel/dist.py``), on
``torch.distributed``.

The reference's multi-GPU calibration script
(Brecq/main_imagenet_dist.py:141-271) spawns one process per GPU, splits
the calibration and eval sets over them, and all-reduces the gradients of
every reconstruction step (block_recon.py:100-102). The JAX package
writes that as SPMD programs over a device mesh; here it is one process
per rank again, each with this rank's rows, and explicit collectives
(``parallel/collectives``):

  * eval (``sharded_validate``): each rank runs its rows of every batch
    (zero-padded to a multiple of the data axis, the padding masked), and
    the top-k hit counts are all-reduced;
  * capture (``sharded_capture``): each rank captures its rows of the
    zero-padded calibration set;
  * act calibration (``synced_calibrate_acts``): each rank calibrates on
    its shard, then delta and zero_point are averaged over the axis;
  * reconstruction: ``ddp_reconstruct`` (each rank its shard of the caches
    and its own minibatches, the gradients averaged over 'data' with an
    f32 or int8 wire) and ``sharded_reconstruct`` (the single-process
    run's minibatches split over 'data', theta split over 'model').

Start: ``init_multihost()`` before building a mesh, in every process.
Devices: rank r runs on ``cuda:{r % torch.cuda.device_count()}`` unless
the caller passes ``device="cpu"``; a CUDA request without a card raises.
The backend rule (``backend_for``): NCCL when the ranks are on CUDA and
each has a card of its own, gloo otherwise (the CPU, or ranks sharing a
card: NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..graph import Flags, Graph, UnitQuant, forward, init_act_quant
from . import collectives as C
from .mesh import Mesh, Sharding, shard_batch


def backend_for(device, num_processes: int) -> str:
    """'nccl' when the ranks run on CUDA and each has a card of its own
    (no more processes than this host's cards), else 'gloo'."""
    if torch.device(device).type == "cuda" \
            and num_processes <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:{rank % device_count}`` for a CUDA
    request without an index (rank 0 when no group is initialized)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None, device="cuda") -> bool:
    """``init_process_group`` over TCP with the JAX package's environment
    fallbacks (SSQ_NUM_PROCESSES, SSQ_COORDINATOR host:port,
    SSQ_PROCESS_ID). A no-op returning False for one process. The backend
    is ``backend_for(device, num_processes)`` unless given; on CUDA the
    rank's card becomes the current device."""
    if num_processes is None:
        num_processes = int(os.environ.get("SSQ_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return False
    dev = resolve_device(device)
    rank = process_id if process_id is not None \
        else int(os.environ["SSQ_PROCESS_ID"])
    dist.init_process_group(
        backend or backend_for(dev, num_processes),
        init_method=f"tcp://{coordinator or os.environ['SSQ_COORDINATOR']}",
        world_size=num_processes, rank=rank)
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(dev))
    return True


def pad_to_multiple(x: torch.Tensor, m: int, axis: int = 0):
    """``x`` zero-padded along ``axis`` to a multiple of ``m``, and the
    length before."""
    n = x.shape[axis]
    rem = (-n) % m
    if rem == 0:
        return x, n
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, x.new_zeros(shape)], dim=axis), n


def sharded_validate(graph: Graph, params, qstate, data: Iterable,
                     mesh: Mesh, flags: Flags = Flags(), topk=(1, 5),
                     device="cuda"):
    """Top-k accuracy (%) of ``data`` ((images NHWC, labels) batches)
    with each batch's rows split over mesh['data']: every rank returns the
    same dict, equal to ``utils/eval.validate_model`` on the whole set.
    ``params`` and ``qstate`` lie on the rank's device."""
    dev = rank_device(device)
    n_data = mesh.shape["data"]
    maxk = max(topk)
    totals = torch.zeros(len(topk), dtype=torch.int64, device=dev)
    n = 0
    with torch.no_grad():
        for xb, yb in data:
            xb = torch.as_tensor(xb)
            yb = torch.as_tensor(yb).long()
            n += xb.shape[0]
            xb, real = pad_to_multiple(xb, n_data)
            yb, _ = pad_to_multiple(yb, n_data)
            valid = torch.arange(xb.shape[0]) < real
            xb, yb, valid = (shard_batch(t, mesh).to(dev)
                             for t in (xb, yb, valid))
            logits = forward(graph, params, qstate, xb, flags, device=dev)
            hit = (torch.topk(logits, maxk, dim=-1).indices
                   == yb[:, None]) & valid[:, None]
            totals += torch.stack([hit[:, :k].any(dim=1).sum()
                                   for k in topk])
    C.all_reduce(totals, dist.ReduceOp.SUM, mesh.group("data"))
    return {f"top{k}": 100.0 * c / max(n, 1)
            for k, c in zip(topk, totals.tolist())}


def sharded_capture(graph: Graph, params, qstate, target: str, cali_data,
                    mesh: Mesh, inp_flags: Flags, out_flags: Flags,
                    batch_size: int = 64, device="cuda"):
    """This rank's rows of ``capture_io`` over the calibration set
    zero-padded to a multiple of mesh['data'] and split over it: the
    ranks' results, concatenated in data order, are the whole capture."""
    from ..recon.capture import capture_io
    cali, _ = pad_to_multiple(torch.as_tensor(cali_data),
                              mesh.shape["data"])
    return capture_io(graph, params, qstate, target, shard_batch(cali, mesh),
                      inp_flags, out_flags, batch_size=batch_size,
                      device=rank_device(device))


def synced_calibrate_acts(graph: Graph, params, qstate, cali_data, cfg,
                          mesh: Mesh, axis: str = "data",
                          flags: Optional[Flags] = None, device="cuda"):
    """Activation-scale calibration with the statistics synced over
    ``axis`` (the reference's stubbed ``synchorize_activation_statistics``,
    quant/quant_model.py:78-83): each rank runs ``graph.init_act_quant``
    on its shard of the calibration set (zero-padded to a multiple of the
    axis, as the JAX package pads its last shard), then every site's
    delta and zero_point are averaged over the axis and the zero point
    re-rounded. Returns a qstate identical on every rank."""
    from ..quantize import act_quant_sites
    if flags is None:
        flags = Flags().all_weights(graph)
    dev = rank_device(device)
    sites = act_quant_sites(graph, cfg, disable_output_quant=True)
    cali, _ = pad_to_multiple(torch.as_tensor(cali_data), mesh.shape[axis])
    local = Sharding(mesh, axis).local(cali).to(dev)
    new_aq = init_act_quant(graph, params, qstate, local, flags, sites,
                            act_sym=False, scale_method=cfg.a_scale_method,
                            device=dev)
    means = C.pmean_tree({name: (qp.delta, qp.zero_point.float())
                          for name, qp in new_aq.items()}, mesh.group(axis))
    qstate = dict(qstate)
    for name, qp in new_aq.items():
        delta, zp = means[name]
        qp = dataclasses.replace(qp, delta=delta, zero_point=torch.round(zp))
        if name in qstate and isinstance(qstate[name], UnitQuant):
            qstate[name] = dataclasses.replace(qstate[name], aq=qp)
        else:
            qstate[name] = qp
    return qstate


def sharded_reconstruct(graph: Graph, params, qstate, node_name: str,
                        cached_inp, cached_out, settings, seed: int,
                        mesh: Mesh, device="cuda"):
    """The single-process ``reconstruct_node`` spread over the mesh, with
    its mathematics unchanged (the JAX package's GSPMD run "changes layout,
    not math"): every rank holds the whole caches and draws each step's
    rows as the single process does; data rank d takes its 1/n_data of
    them (the batch size must divide by n_data) and the gradients are
    averaged over 'data' (f32); over 'model', theta and its Adam moments
    are out-channel slices that each rank updates and all ranks gather
    before the next forward. ``params`` and ``qstate`` lie on the rank's
    device."""
    from ..recon.engine import reconstruct_node
    dev = rank_device(device)
    s = dataclasses.replace(settings, grad_psum_axis="data", grad_wire="f32")
    return reconstruct_node(graph, params, qstate, node_name,
                            torch.as_tensor(cached_inp).to(dev),
                            torch.as_tensor(cached_out).to(dev), s, seed,
                            mesh=mesh, split_rows=True)


def ddp_reconstruct(graph: Graph, params, qstate, node_name: str,
                    cached_inp, cached_out, settings, seed: int, mesh: Mesh,
                    wire: str = "f32", cached_grads=None, device="cuda"):
    """Data-parallel reconstruction with explicit collectives (the
    reference's multi-GPU reconstruction: per-rank minibatches and an
    all-reduce of the gradients, Brecq/block_recon.py link.allreduce).

    The caches are zero-padded to a multiple of mesh['data'] and split
    over it; each rank draws ``batch_size // n`` rows a step from its
    shard with the same seed (every JAX device uses the same key), and the
    gradients and the traced loss are averaged over 'data' with ``wire``:
    'f32' (the plain all-reduce) or 'int8' (``quantized_pmean``, about
    2.7x fewer bytes). The warm start and the refine run the same way. The
    first-batch losses are those of the set's first ``batch_size // n``
    rows, computed by data rank 0 and broadcast, so every rank returns
    the same state and metrics. ``params`` and ``qstate`` lie on the
    rank's device."""
    from ..recon.engine import reconstruct_node
    dev = rank_device(device)
    n = mesh.shape["data"]
    s = dataclasses.replace(settings, grad_psum_axis="data", grad_wire=wire,
                            batch_size=max(settings.batch_size // n, 1))

    def local(t):
        return None if t is None else shard_batch(
            pad_to_multiple(torch.as_tensor(t), n)[0], mesh).to(dev)

    ci, co, cg = local(cached_inp), local(cached_out), local(cached_grads)
    if ci.shape[0] < s.batch_size:
        raise ValueError(f"ddp_reconstruct: {ci.shape[0]} cached rows a "
                         f"rank, fewer than the local batch {s.batch_size}")
    return reconstruct_node(graph, params, qstate, node_name, ci, co, s,
                            seed, cached_grads=cg, mesh=mesh)


# ---------------------------------------------------------------------------
# what the reconstruction engine asks of the mesh
# ---------------------------------------------------------------------------

def from_data_rank0(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Data rank 0's ``t`` on every rank of this rank's data group."""
    src = mesh.rank_at(0, mesh.coords["model"])
    return C.broadcast(t.detach().clone().contiguous(), src,
                       mesh.group("data"))


def global_head(t: torch.Tensor, k: int, mesh: Mesh,
                axis: str = "data") -> torch.Tensor:
    """The first ``k`` rows of the set whose shards over ``axis`` are the
    ranks' ``t`` (``t`` holds at least this rank's first min(k, rows))."""
    return C.all_gather_rows(t[:k], mesh.group(axis))[:k]


def data_share(rows: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This data rank's columns of each step's drawn rows (steps, batch)."""
    n = mesh.shape["data"]
    if rows.shape[1] % n:
        raise ValueError(f"a batch of {rows.shape[1]} rows does not split "
                         f"over {n} data ranks")
    b = rows.shape[1] // n
    d = mesh.coords["data"]
    return rows[:, d * b:(d + 1) * b]


def model_slices(theta: dict, mesh: Mesh):
    """theta ({unit: {name: leaf}}) as this rank's out-channel slices
    over 'model' (leaves whose axis 0 does not split evenly stay whole),
    and ``gather``: slices -> the whole theta, this rank's slice the
    autograd leaf in its place, so the backward reaches only it."""
    group = mesh.group("model")
    n = mesh.shape["model"]
    m = mesh.coords["model"]
    cut = {(u, k) for u, t in theta.items() for k, v in t.items()
           if v.ndim >= 1 and v.shape[0] % n == 0 and v.shape[0] >= n}

    def own(u, k, v):
        if (u, k) not in cut:
            return v
        rows = v.shape[0] // n
        return v.detach()[m * rows:(m + 1) * rows].clone() \
            .requires_grad_(True)

    def gather(sliced):
        out = {}
        for u, t in sliced.items():
            out[u] = {}
            for k, v in t.items():
                if (u, k) not in cut:
                    out[u][k] = v
                    continue
                parts = list(C.all_gather_rows(v.detach(), group)
                             .split(v.shape[0]))
                parts[m] = v
                out[u][k] = torch.cat(parts)
        return out

    return ({u: {k: own(u, k, v) for k, v in t.items()}
             for u, t in theta.items()}, gather)
