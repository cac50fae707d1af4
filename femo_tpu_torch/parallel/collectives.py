"""The two autograd Functions that stand for `jax.lax.psum` under
`shard_map` (femo_tpu/parallel/sharding.py).

In the JAX package a cells-sharded assembly takes its dof vectors
replicated (`in_specs=P()`), sums each device's partial result with a
psum and returns it replicated (`out_specs=P()`); JAX derives the
transpose of that pair itself.  In torch the pair is written out:

* `reduce_from_ranks(x)`: the partial result of each rank -> the sum,
  the same on every rank.  Forward all_reduce(SUM); backward identity
  (the cotangent of a replicated output is already whole on each rank);
  forward-mode derivative the all_reduce of the tangent.
* `copy_to_ranks(x)`: a replicated input, used by each rank's part of
  the work.  Forward identity; backward all_reduce(SUM) of the gradient
  (each rank holds the part of the gradient that its cells give);
  forward-mode derivative identity.

`torch.distributed.nn.functional.all_reduce` is not this pair: it
all-reduces the cotangent in its backward as well, which, with inputs
and outputs replicated, gives gradients scaled by the number of ranks or
left partial.

Both use the `setup_context` form, so `torch.func.jvp` (the Newton-Krylov
matvecs) and `torch.func.vjp` (the IFT adjoints) go through them.  Keep
them outside `torch.func.vmap`: the per-element kernels stay rank-local,
and the collective comes after the scatter, as the JAX code calls psum
after segment_sum.  Every rank must call them in the same order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(x, group):
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


class _ReduceFromRanks(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return _all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return grad, None

    @staticmethod
    def jvp(ctx, x_t, _):
        return _all_reduce(x_t, ctx.group)


class _CopyToRanks(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None

    @staticmethod
    def jvp(ctx, x_t, _):
        return x_t.clone()


def reduce_from_ranks(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the ranks of `group` of each rank's partial x."""
    return _ReduceFromRanks.apply(x, group)


def copy_to_ranks(x: torch.Tensor, group=None) -> torch.Tensor:
    """A replicated input x, whose gradient is summed over the ranks."""
    return _CopyToRanks.apply(x, group)
