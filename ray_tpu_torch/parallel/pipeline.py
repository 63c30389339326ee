"""Pipeline parallelism: GPipe-style microbatching over the ``pipe``
axis, the counterpart of `ray_tpu/parallel/pipeline.py`.

Schedule: M microbatches through S stages take M + S - 1 ticks; at tick
t stage s runs microbatch t - s when there is one (a bubble runs
nothing: the reference computes garbage there and masks it, which gives
the same values), and activations move to the next stage through the
differentiable `collectives.ppermute` without wrap. Only the last stage
holds outputs; a psum over the axis hands them to every stage.

Gradients. Every pipe rank computes what follows the pipeline (the loss)
whole, so the outputs' cotangent is the same on each, and the closing
psum passes it back unchanged (`collectives.reduce_from`); the input is
read by stage 0 only, so its cotangent is summed over the axis on the
way back (`collectives.copy_to`), which hands stage 0's to every rank.
A stage's sends whose results it never reads itself (stage 0's, and
each stage's last) are tied into the output with no gradient, and a
stage that receives while it has nothing to send passes zeros computed
from the input, so every rank runs its half of each backward transfer
(also under `torch.autograd.grad` with ``inputs``, which runs only the
backwards that lead to them).
"""

from __future__ import annotations

import torch
from torch.autograd import Function

from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import Mesh


def stack_stage_params(per_stage_params: list):
    """Stack a list of per-stage trees (nested dicts of tensors) into one
    tree with a leading stage axis."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage_params])
                for k in first}
    return torch.stack([torch.as_tensor(p) for p in per_stage_params])


class _Join(Function):
    """``out`` unchanged, with ``others`` as inputs that get no gradient:
    their producers' backwards run all the same."""

    @staticmethod
    def forward(ctx, out, *others):
        ctx.n = len(others)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g,) + (None,) * ctx.n


def _pipe_loop(params, x_micro, stage_fn, mesh: Mesh, axis_name: str):
    """This stage's part of the schedule. params: this stage's; x_micro:
    [M, mb, ...] microbatches (whole on every rank of the axis)."""
    s_count = mesh.shape[axis_name]
    s = mesh.axis_index(axis_name)
    m = x_micro.shape[0]
    grad = torch.is_grad_enabled()
    x_micro = collectives.copy_to(x_micro, axis_name, mesh)
    orphans = []
    # what a stage that sends nothing passes to a transfer it receives
    # from: zeros on the input's graph, so the backward that returns the
    # cotangent to the sender runs wherever the input's gradient is asked
    idle = (x_micro[0] * 0 if x_micro.requires_grad else
            torch.zeros_like(x_micro[0]).requires_grad_(grad))
    outs, act_in = [], None
    for t in range(m + s_count - 1):
        act_out = None
        if 0 <= t - s < m:
            act_out = stage_fn(params, x_micro[t - s] if s == 0 else act_in)
            if s == s_count - 1:
                outs.append(act_out)
        pairs = [(i, i + 1) for i in range(s_count - 1) if 0 <= t - i < m]
        if not pairs:
            continue
        got = collectives.ppermute(idle if act_out is None else act_out,
                                   axis_name, mesh, pairs)
        if any(dst == s for _, dst in pairs):
            act_in = got
        elif any(src == s for src, _ in pairs) and grad:
            orphans.append(got)
    if s == s_count - 1:
        out_buf = torch.stack(outs)
    else:
        out_buf = torch.zeros_like(x_micro)
    out = collectives.reduce_from(out_buf, axis_name, mesh)
    return _Join.apply(out, *orphans) if orphans else out


def pipeline_apply(stage_fn, per_stage_params: list, x, *,
                   mesh: Mesh, num_microbatches: int,
                   axis_name: str = "pipe"):
    """Run ``x`` through S pipeline stages of ``stage_fn``.

    ``stage_fn(params, microbatch)`` -> a microbatch-shaped output (every
    stage is shape-preserving, as transformer blocks are). Rank s of the
    axis runs stage s with ``per_stage_params[s]`` and reads no other
    entry (the others may be None). ``x`` is this rank's input, the same
    on every rank of the axis; with other mesh axes splitting the batch
    (the reference's ``batch_spec``) it is already the rank's block of
    rows. Returns the output on every rank of the axis.
    """
    s_count = mesh.shape.get(axis_name, 1)
    if len(per_stage_params) != max(s_count, 1):
        raise ValueError(
            f"{len(per_stage_params)} stages vs mesh {axis_name}="
            f"{s_count}")
    if x.shape[0] % num_microbatches:
        raise ValueError("batch not divisible by num_microbatches")
    if s_count == 1:
        out = x
        for p in per_stage_params:
            out = stage_fn(p, out)
        return out
    x_micro = x.reshape((num_microbatches, x.shape[0] // num_microbatches)
                        + tuple(x.shape[1:]))
    out = _pipe_loop(per_stage_params[mesh.axis_index(axis_name)], x_micro,
                     stage_fn, mesh, axis_name)
    return out.reshape(tuple(x.shape[:1]) + tuple(out.shape[2:]))
