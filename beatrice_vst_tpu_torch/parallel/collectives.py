"""The collectives of tensor and data parallelism, each an autograd
function over one process group (JAX gets them from GSPMD).

Tensor parallelism over 'model' pairs the layers as Megatron does: a
column-parallel product (the weight's output columns split) takes a
replicated input through `copy_to_model` and yields a split output; a
row-parallel product (the weight's input rows split) takes the split input
and sums the ranks' partial products through `reduce_from_model`; a split
output that a replicated consumer reads is assembled by
`gather_from_model`.  Each collective's backward is the transpose of its
forward, so the gradients of replicated tensors stay the same on every
rank and those of split weights stay on their shards:

  copy_to_model      identity forward, all-reduce backward
  reduce_from_model  all-reduce forward, identity backward
  gather_from_model  all-gather along an axis forward, this rank's block
                     of the gradient backward

Data parallelism over 'streams' (the training steps): each rank computes
the loss of the whole batch from partial sums of its own rows
(`global_sum`, `global_mean`: the forward of `reduce_from_model`), so its
backward yields its rows' share of the whole batch's gradient, and
`all_reduce_grads_` sums the shares.  The loss's ratios (a masked sum over
a masked count, a norm over a norm) are thereby those of the whole batch,
as GSPMD computes them, not a mean of each rank's ratio.

Only `all_reduce`, `all_gather` and `broadcast` are used: `gloo` has no
reduce-scatter for CUDA tensors.

Each collective may run while a CUDA graph is captured (a compiled step on
NCCL ranks, `runtime/graphs.py`): it issues the same operations on the
capturing stream, in the same order, and its buffers (the clones, the
flat gradient, the zero gradients it makes) come from the graph's pool.
`mesh.check_capture` counts each one a capture takes in and raises for a
group whose backend cannot be captured.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from .mesh import all_gather_cat, axis_sizes, check_capture


@functools.cache
def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


def is_sharded(x) -> bool:
    """Whether x is a `DTensor` (a weight split over 'model')."""
    return isinstance(x, _dtensor())


def model_group(weight):
    """The 'model' group of a split weight (a `DTensor` on the mesh)."""
    return weight.device_mesh.get_group("model")


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        check_capture(ctx.group)
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        check_capture(group)
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.block = group, dim, x.shape[dim]
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        rank = dist.get_rank(ctx.group)
        return grad.narrow(ctx.dim, rank * ctx.block, ctx.block), None, None


def copy_to_model(x, group):
    """x unchanged; its gradient all-reduced over `group`."""
    return _CopyTo.apply(x, group)


def reduce_from_model(x, group):
    """The sum of x over the ranks of `group`; its gradient passed through."""
    return _ReduceFrom.apply(x, group)


def gather_from_model(x, group, dim: int = -1):
    """Every rank's block of x concatenated along `dim` in rank order; the
    gradient's block of this rank passed back."""
    return _GatherFrom.apply(x, group, dim % x.dim())


def local(weight):
    """A split weight's block on this rank (autograd reaches the `DTensor`);
    a replicated tensor as it is."""
    return weight.to_local() if is_sharded(weight) else weight


def gathered(weight):
    """A weight whole: a split `DTensor` all-gathered along its split axes
    (autograd gives each rank its block's gradient); a replicated tensor as
    it is."""
    from torch.distributed.tensor import Shard

    if not is_sharded(weight):
        return weight
    x = weight.to_local()
    mesh = weight.device_mesh
    for name, placement in zip(mesh.mesh_dim_names, weight.placements):
        if isinstance(placement, Shard):
            x = gather_from_model(x, mesh.get_group(name), placement.dim)
    return x


def global_sum(x, group=None):
    """The sum of x over its elements and, with a group, over its ranks
    (the forward of `reduce_from_model`: each rank's gradient is its own
    elements' share)."""
    s = x.sum()
    return s if group is None else reduce_from_model(s, group)


def global_mean(x, group=None):
    """The mean of x over its elements and, with a group, over the ranks'
    equal blocks; without a group, `torch.mean`."""
    if group is None:
        return torch.mean(x)
    return global_sum(x, group) / (x.numel() * dist.get_world_size(group))


def global_norm(x, group=None):
    """The L2 norm of x over its elements and, with a group, over its
    ranks; without a group, `torch.linalg.norm`."""
    if group is None:
        return torch.linalg.norm(x)
    return torch.sqrt(global_sum(x * x, group))


@torch.no_grad()
def reduce_sum(x, group):
    """x summed over the ranks of `group` (no gradient)."""
    check_capture(group)
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


@torch.no_grad()
def all_reduce_grads_(leaves, group) -> None:
    """Sum the leaves' gradients over `group`, in place (a split weight's
    gradient on its block): one all-reduce of the flattened gradients.  A
    leaf without a gradient gets a zero one first."""
    check_capture(group)
    grads = []
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad.to_local() if is_sharded(p.grad) else p.grad)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def dp_group(mesh):
    """The 'streams' group of a mesh where it has more than one rank, else
    None (the single-rank step is the plain one)."""
    if mesh is None or axis_sizes(mesh)["streams"] == 1:
        return None
    return mesh.get_group("streams")
