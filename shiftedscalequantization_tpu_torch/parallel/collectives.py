"""Cross-rank collectives for gradient reduction (PyTorch port of
``shiftedscalequantization_tpu/parallel/collectives.py``), on
``torch.distributed``.

The reference's multi-GPU reconstruction all-reduces f32 gradients every
step (Brecq/block_recon.py: link.allreduce(p.grad) per parameter). For
links where those bytes cost, ``quantized_pmean`` decomposes the
all-reduce the EQuARX way, as the JAX package does, so that every hop
moves sub-f32 payloads:

  1. the global amax: one all_reduce(MAX) of a scalar per tensor;
  2. int8 codes clamp(round(x / delta), -127, 127), delta = max(amax,
     1e-30) / 127 in f32, rounding half to even (``jnp.round``'s rule);
  3. a reduce-scatter as int8: the codes zero-padded to a multiple of n
     rows, one ``all_to_all_single``, then a local int32 sum of the row
     this rank received from every peer;
  4. an all-gather of the chunk sums as int16 (|sum of n int8| <= 127n
     fits int16 for n <= 258);
  5. the mean: sums * (delta / n) in f32.

Wire: N int8 + N int16 = 3 bytes an element, against about 8 for a ring
all-reduce of f32. Every rank ends with the same bits (the exchange is
deterministic and integer), so replicated optimizer states stay
replicated; the error is one quantization, |err| <= delta/2 = amax/254.

int16 on the wire. Gloo refuses ``torch.int16`` in every collective
("Invalid scalar type": all_reduce, broadcast, all_gather,
all_gather_into_tensor, all_to_all_single, on CPU and CUDA tensors) and
NCCL has no int16 type, so step 4 sends the int16 sums as their bytes:
an int8 view, an int8 all-gather, and an int16 view of what arrives. That
keeps the 3 bytes an element and is exact.

Gloo and CUDA tensors. Gloo takes CUDA tensors in every collective used
here (all_reduce, broadcast, all_gather_into_tensor, all_to_all_single;
checked with two ranks on one H100 under PyTorch 2.11), copying them
through host memory itself. NCCL refuses two
ranks on one card ("invalid usage"), so ranks that share a card take gloo
(``dist.backend_for``).

Every function takes ``group`` (a ProcessGroup, None for the default
group); ``src`` ranks are global ranks. Without an initialized default
group, a ``None`` group is a world of one process.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

MAX_INT8_WIRE_RANKS = 258       # 127 * 258 = 32766 fits int16


def _size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None):
    """``t`` reduced over ``group`` with ``op``, in place; returns ``t``."""
    if dist.is_initialized():
        dist.all_reduce(t, op=op, group=group)
    return t


def broadcast(t: torch.Tensor, src: int, group=None):
    """``t`` from global rank ``src`` to every rank of ``group``, in place;
    returns ``t``."""
    if dist.is_initialized():
        dist.broadcast(t, src=src, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks), concatenated along
    axis 0 in group-rank order."""
    if not dist.is_initialized():
        return t
    src = t.contiguous()
    out = src.new_empty((dist.get_world_size(group) * src.shape[0],)
                        + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Row block r of ``t`` (n equal blocks along axis 0) goes to group rank
    r; block j of the result came from group rank j."""
    if not dist.is_initialized():
        return t
    src = t.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b as an IEEE quotient: PyTorch's CUDA division by a Python
    number (or a CPU scalar) multiplies by its reciprocal instead."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def _mean_f32(xs, group, n):
    """The plain mean of each tensor over the group: one all_reduce(SUM)
    of their concatenation, then / n (``lax.pmean``)."""
    if not xs:
        return []
    flat = torch.cat([x.reshape(-1) for x in xs])
    all_reduce(flat, dist.ReduceOp.SUM, group)
    flat = _div(flat, float(n))
    out, o = [], 0
    for x in xs:
        out.append(flat[o:o + x.numel()].reshape(x.shape).to(x.dtype))
        o += x.numel()
    return out


def _mean_int8(xs, group, n):
    """The quantized mean of each tensor (module doc), one collective per
    step for all of them: the amaxes in one all_reduce, every tensor's
    padded (n, chunk) code block side by side in one all_to_all, and the
    chunk sums in one all-gather. Each tensor keeps its own delta, so the
    result equals one ``quantized_pmean`` per tensor."""
    if not xs:
        return []
    if n > MAX_INT8_WIRE_RANKS:
        raise ValueError(f"int8 wire: {n} ranks overflow the int16 sums "
                         f"(at most {MAX_INT8_WIRE_RANKS})")
    flats = [x.reshape(-1).float() for x in xs]
    amax = torch.stack([f.abs().max() for f in flats])
    all_reduce(amax, dist.ReduceOp.MAX, group)
    delta = _div(torch.clamp(amax, min=1e-30), 127.0)
    blocks, chunks = [], []
    for i, f in enumerate(flats):
        q = torch.clamp(torch.round(f / delta[i]), -127, 127) \
            .to(torch.int8)
        pad = (-q.numel()) % n
        q = torch.cat([q, q.new_zeros(pad)]) if pad else q
        blocks.append(q.reshape(n, -1))
        chunks.append(blocks[-1].shape[1])
    # reduce-scatter: rank d receives every peer's columns of row d
    recv = _all_to_all(torch.cat(blocks, dim=1), group)
    part = recv.reshape(n, -1).to(torch.int32).sum(dim=0).to(torch.int16)
    # the chunk sums back to every rank, as int8 bytes (module doc)
    full = all_gather_rows(part.view(torch.int8), group) \
        .view(torch.int16).reshape(n, -1)
    out, o = [], 0
    for i, (x, c) in enumerate(zip(xs, chunks)):
        sums = full[:, o:o + c].reshape(-1)[:x.numel()]
        y = sums.float() * _div(delta[i], float(n))
        out.append(y.reshape(x.shape).to(x.dtype))
        o += c
    return out


def _mean(xs, group, wire):
    n = _size(group)
    if wire == "f32":
        return _mean_f32(xs, group, n)
    # tensors under 4n elements take the plain mean, as lax.pmean
    small = [x.numel() < 4 * n for x in xs]
    plain = iter(_mean_f32([x for x, t in zip(xs, small) if t], group, n))
    quant = iter(_mean_int8([x for x, t in zip(xs, small) if not t], group,
                            n))
    return [next(plain) if t else next(quant) for t in small]


def quantized_pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean of ``x`` over ``group`` with the int8 wire format (module
    doc); under 4n elements the plain f32 mean, where chunking cannot
    pay."""
    return _mean([x], group, "int8")[0]


WIRES = ("f32", "int8")


def _flatten(tree, leaves):
    if torch.is_tensor(tree):
        leaves.append(tree)
        return None
    if isinstance(tree, dict):
        return {k: _flatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, leaves) for v in tree)
    raise TypeError(f"pmean_tree: {type(tree).__name__} is not a tensor, "
                    f"dict, list or tuple")


def _unflatten(spec, it):
    if spec is None:
        return next(it)
    if isinstance(spec, dict):
        return {k: _unflatten(v, it) for k, v in spec.items()}
    return type(spec)(_unflatten(v, it) for v in spec)


def pmean_tree(grads, group=None, wire: str = "f32"):
    """The mean over ``group`` of every tensor in ``grads`` (nested dicts,
    lists and tuples of tensors), in the same structure. ``wire='f32'``
    is the plain all-reduce (NCCL's allreduce); ``'int8'`` the quantized
    one, per tensor (``quantized_pmean``)."""
    if wire not in WIRES:
        raise ValueError(f"unknown wire format {wire!r}")
    leaves = []
    spec = _flatten(grads, leaves)
    return _unflatten(spec, iter(_mean(leaves, group, wire)))
