"""Ulysses sequence parallelism: an all-to-all head/sequence reshard, the
counterpart of ``kubegpu_tpu/workload/ulysses.py``.

One ``all_to_all_single`` over the ``seq`` axis turns the
sequence-sharded ``[B, T/sp, H, D]`` into the head-sharded ``[B, T,
H/sp, D]``; attention then runs over the full sequence for the rank's
head group (the flash kernel unchanged, at global positions), and a
second all-to-all restores sequence sharding. Two all-to-alls of
activation size instead of ``sp`` rotations of K/V, and no merging.
The backward of each all-to-all is the inverse all-to-all.

The local head count must divide by the sequence-axis size.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from kubegpu_tpu_torch.workload.kernels.flash import flash_attention


def _all_to_all(x, group):
    """``x [n, ...]``: chunk ``j`` goes to group rank ``j``; returns the
    chunks received, in rank order."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _to_heads(x, group):
    """[B, T/n, H, D] -> [B, T, H/n, D]."""
    n = dist.get_world_size(group)
    b, t, h, d = x.shape
    parts = x.reshape(b, t, n, h // n, d).permute(2, 0, 1, 3, 4)
    got = _all_to_all(parts, group)                     # [n, B, t, H/n, D]
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * t, h // n, d)


def _to_seq(x, group):
    """[B, T, H/n, D] -> [B, T/n, H, D]."""
    n = dist.get_world_size(group)
    b, t, h, d = x.shape
    parts = x.reshape(b, n, t // n, h, d).permute(1, 0, 2, 3, 4)
    got = _all_to_all(parts, group)                     # [n, B, T/n, h, D]
    return got.permute(1, 2, 0, 3, 4).reshape(b, t // n, n * h, d)


class _ScatterHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _to_seq(g, ctx.group), None


class _GatherHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _to_heads(g, ctx.group), None


def _scatter_heads(x, group):
    """[B, T_local, H, D] -> [B, T_global, H/sp, D]: split the heads over
    the axis, gather the sequence (rank order is block order)."""
    return _ScatterHeads.apply(x, group)


def _gather_heads(x, group):
    """Inverse: [B, T_global, H/sp, D] -> [B, T_local, H, D]."""
    return _GatherHeads.apply(x, group)


def ulysses_attention(q, k, v, group, scale: float, use_flash: bool = False,
                      window: int = 0):
    """Exact causal attention over the ``group``-sharded sequence.

    q, k, v: this rank's blocks ``[B, T_local, H, D]`` (RoPE'd with global
    positions); returns ``[B, T_local, H, D]``. ``use_flash`` attends with
    the flash kernel (K1-K3), else with the plain `_causal_attention`."""
    sp = dist.get_world_size(group)
    h = q.shape[2]
    if h % sp != 0:
        raise ValueError(
            f"ulysses sequence parallelism needs heads%sp==0, got "
            f"{h} local heads over sp={sp}; use ring attention instead")
    qg, kg, vg = (_scatter_heads(x, group) for x in (q, k, v))
    if use_flash:
        out = flash_attention(qg, kg, vg, scale, window=window)
    else:
        # the single-device attention is the one both strategies match;
        # imported here, as model.py imports this module
        from kubegpu_tpu_torch.workload.model import _causal_attention

        out = _causal_attention(qg, kg, vg, scale, window=window)
    return _gather_heads(out, group)


def make_sharded_ulysses_attention(mesh, scale: float,
                                   use_flash: bool = False, window: int = 0):
    """``attend(q, k, v)`` over the mesh's ``seq`` axis, as
    `ring.make_sharded_ring_attention`, so the model swaps freely."""
    group = mesh.get_group("seq")

    def attend(q, k, v):
        return ulysses_attention(q, k, v, group, scale, use_flash=use_flash,
                                 window=window)

    return attend
