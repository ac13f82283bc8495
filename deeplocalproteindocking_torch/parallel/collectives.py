"""The collectives of the multi-device layer.

The port's counterparts of ``jax.lax.all_gather``, its transpose and the
top-K merge that every sharded sweep of the JAX package ends with.  All
gathers use the list form ``dist.all_gather``, which NCCL and gloo both
take for CUDA and CPU tensors, so one code path serves a rank with a card
of its own (NCCL) and ranks that share one (gloo).

``AllGather`` is the differentiable gather of training.  Its backward is
the transpose of ``jax.lax.all_gather`` (a ``psum_scatter``): the gathered
gradient summed over the group, then this rank's slice.  It does not use
``torch.distributed.nn.functional.all_gather``, whose backward on a gloo
mesh subgroup raises ``ValueError: Global rank 0 is not part of group``
(it scatters from a global rank).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``[n, ...]`` on each of the group's R ranks -> ``[R * n, ...]`` in
    group-rank order, the same on every rank."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


class AllGather(torch.autograd.Function):
    """``all_gather_rows`` with a gradient: backward sums the gathered
    gradient over the group and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group, ctx.n = group, x.shape[0]
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        r = dist.get_rank(ctx.group)
        return grad[r * ctx.n:(r + 1) * ctx.n], None


def merge_topk(scores: torch.Tensor, rot_idx: torch.Tensor,
               shifts: torch.Tensor, group, top_k: int):
    """Every rank's candidates ``scores [..., K]``, ``rot_idx [..., K]``,
    ``shifts [..., K, 3]`` gathered over ``group``, then the same
    ``torch.topk`` on every rank: ``(scores, rot_idx, shifts)`` of the
    merged top-``top_k``, identical on every rank.  Leading dims (the
    complexes of a batched sweep) are kept."""
    lead = scores.shape[:-1]
    R = dist.get_world_size(group)

    def gathered(x, tail):
        g = all_gather_rows(x[None], group)           # [R, *lead, K, *tail]
        g = g.movedim(0, len(lead))                   # [*lead, R, K, *tail]
        return g.reshape(lead + (R * x.shape[len(lead)],) + tail)

    all_scores = gathered(scores, ())
    all_rot = gathered(rot_idx, ())
    all_shift = gathered(shifts, (3,))
    best, sel = torch.topk(all_scores, top_k, dim=-1)
    rot = torch.gather(all_rot, -1, sel)
    shift = torch.gather(all_shift, -2, sel[..., None].expand(
        sel.shape + (3,)))
    return best, rot, shift
