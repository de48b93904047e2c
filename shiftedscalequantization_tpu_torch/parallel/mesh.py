"""Rank mesh and sharding helpers (PyTorch port of
``shiftedscalequantization_tpu/parallel/mesh.py``), on
``torch.distributed``.

The JAX package lays its devices out as one ``jax.sharding.Mesh`` with a
``data`` axis (calibration and eval batches split over it: the
DistributedSampler role of the reference's multi-GPU script,
Brecq/main_imagenet_dist.py:141-271) and a ``model`` axis (large conv
weights and their per-channel quantizer leaves split by out-channel). Here
the mesh is the grid of process ranks, rank = d * n_model + m for data
coordinate d and model coordinate m (the JAX device grid's row-major
order), with one process group per column (the ranks that share m: the
``data`` axis) and one per row (the ``model`` axis). ``shard_*`` return
this rank's piece of a tensor, where the JAX helpers return a global
array laid out over the devices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..quantize import _map_arrays

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An (n_data, n_model) grid of ranks and this rank's place in it.
    ``groups[axis]`` is this rank's process group along ``axis`` (None
    when the mesh is a single process)."""
    shape: dict
    coords: dict
    groups: dict

    def group(self, axis: str):
        """This rank's process group along ``axis`` ('data' or 'model')."""
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}; axes {AXES}")
        return self.groups[axis]

    def rank_at(self, data: int, model: int) -> int:
        """The global rank at grid coordinates (data, model)."""
        return data * self.shape["model"] + model


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The mesh over every rank of the default process group (one process
    when none is initialized). ``n_data`` defaults to world // n_model;
    n_data * n_model must equal the world size. Every rank must call it,
    and in the same order as its other ``new_group`` calls: each rank
    creates every row and column group."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"mesh {n_data} x {n_model} does not cover the "
                         f"{world} ranks")
    d, m = divmod(rank, n_model)
    groups = {"data": None, "model": None}
    if world > 1:
        for col in range(n_model):
            g = dist.new_group([r * n_model + col for r in range(n_data)])
            if col == m:
                groups["data"] = g
        for row in range(n_data):
            g = dist.new_group([row * n_model + c for c in range(n_model)])
            if row == d:
                groups["model"] = g
    return Mesh(shape={"data": n_data, "model": n_model},
                coords={"data": d, "model": m}, groups=groups)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Axis 0 split over ``axis`` of ``mesh`` (None: replicated)."""
    mesh: Mesh
    axis: Optional[str]

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``x`` (all of it when replicated); the
        split must be even, as a JAX sharding requires."""
        if self.axis is None:
            return x
        n = self.mesh.shape[self.axis]
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split evenly over "
                             f"{n} {self.axis!r} ranks")
        rows = x.shape[0] // n
        i = self.mesh.coords[self.axis]
        return x[i * rows:(i + 1) * rows]


def batch_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, "data")


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a batch split over ``data``."""
    return batch_sharding(mesh).local(x)


def _oc_sharding(a, mesh: Mesh) -> Sharding:
    """Out-channels (axis 0) over 'model' when they split evenly."""
    n_model = mesh.shape["model"]
    if a.ndim >= 1 and a.shape[0] % n_model == 0 and a.shape[0] >= n_model:
        return Sharding(mesh, "model")
    return replicated(mesh)


def _shard_oc(tree, mesh: Mesh):
    return _map_arrays(tree, lambda a: _oc_sharding(a, mesh).local(a))


def shard_params(params: dict, mesh: Mesh) -> dict:
    """This rank's out-channel slice of every conv/linear weight and bias
    that splits evenly over 'model'; other leaves whole."""
    return _shard_oc(params, mesh)


def shard_qstate(qstate: dict, mesh: Mesh) -> dict:
    """Per-out-channel quantizer leaves follow the weights' slices; small
    or irregular leaves stay whole."""
    return _shard_oc(qstate, mesh)
