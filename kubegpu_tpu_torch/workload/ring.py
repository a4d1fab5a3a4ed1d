"""Ring attention: exact causal attention over a sequence-parallel axis,
the counterpart of ``kubegpu_tpu/workload/ring.py``.

Each rank of the ``seq`` axis holds one block of the sequence. K/V blocks
rotate around the ring (rank ``i`` sends to ``i+1`` and receives from
``i-1``) while every rank accumulates attention for its own Q block, so
the full causal attention is computed without any rank holding the whole
sequence. At ring step ``r`` rank ``i`` holds the block of rank ``(i - r)
mod sp``; blocks of later positions than the rank's own see no key at all
and contribute nothing.

The ring is written against a small seq-axis object (``rank``, ``size``,
``shift``): `GroupSeqAxis` rotates over a process group with one
``batch_isend_irecv`` per step, `InProcessSeqAxis` hands each virtual
rank the previous one's block from a list (one process runs every rank:
the tests and ``chip_smoke.py`` use it to hold the kernels' multi-block
calls on one card). Both go through the same attend-and-merge code.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from kubegpu_tpu_torch.workload.kernels.flash import (
    flash_attention_with_lse, merge_partials)

NEG_INF = -1e30


def _exchange(group, xs, dst, src) -> list:
    """Send each of ``xs`` to group rank ``dst`` and receive as many
    tensors like them from group rank ``src`` in one
    ``batch_isend_irecv``; None for either side skips it (the receive then
    gives zeros). Raises if the exchange fails."""
    outs = [torch.zeros(x.shape, dtype=x.dtype, device=x.device)
            for x in xs]
    ops = []
    if dst is not None:
        peer = dist.get_global_rank(group, dst)
        ops += [dist.P2POp(dist.isend, x.contiguous(), peer, group, j)
                for j, x in enumerate(xs)]
    if src is not None:
        peer = dist.get_global_rank(group, src)
        ops += [dist.P2POp(dist.irecv, o, peer, group, j)
                for j, o in enumerate(outs)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return outs


class Permute(torch.autograd.Function):
    """A differentiable point-to-point move over ``group``: the forward
    sends ``xs`` to ``dst`` and returns what ``src`` sent (zeros where
    ``src`` is None); the backward moves the cotangents the other way."""

    @staticmethod
    def forward(ctx, group, dst, src, *xs):
        ctx.group, ctx.dst, ctx.src = group, dst, src
        return tuple(_exchange(group, xs, dst, src))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None,
                *_exchange(ctx.group, gs, ctx.src, ctx.dst))


class GroupSeqAxis:
    """The ``seq`` axis over a process group: ``shift`` rotates K and V
    together one rank forward (one Function per step, so every rank's
    backward runs the reverse rotations in the same order)."""

    def __init__(self, group):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def shift(self, k, v):
        n = self.size
        return Permute.apply(self.group, (self.rank + 1) % n,
                             (self.rank - 1) % n, k, v)


class InProcessSeqAxis:
    """Virtual rank ``rank`` of a ring of ``len(ks)`` run in one process:
    its ``r``-th shift returns the block rank ``rank - r`` started with,
    which is what the previous virtual rank held before that shift.
    Gradients flow back to the listed blocks through autograd."""

    def __init__(self, rank: int, ks: list, vs: list):
        self.rank, self.size = rank, len(ks)
        self._ks, self._vs, self._step = ks, vs, 0

    def shift(self, k, v):
        self._step += 1
        j = (self.rank - self._step) % self.size
        return self._ks[j], self._vs[j]


def ring_attention(q, k, v, axis, scale: float, window: int = 0):
    """Causal attention with K/V rotating around ``axis``: the plain
    online softmax with a float32 carry (reference ``ring.py:24-80``).

    q, k, v: this rank's blocks ``[B, T_local, H, D]`` (RoPE'd with global
    positions). Returns ``[B, T_local, H, D]``. ``window`` > 0 keeps each
    row to the newest ``window`` keys at global positions."""
    i, n = axis.rank, axis.size
    b, t, h, d = q.shape
    q_pos = i * t + torch.arange(t, device=q.device)
    qf = q.float()
    o = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, t), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    for r in range(n):
        src = (i - r) % n
        kv_pos = src * t + torch.arange(t, device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float()) * scale
        mask = q_pos[:, None] >= kv_pos[None, :]
        if window:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                v.float())
        m = m_new
        if r < n - 1:
            k, v = axis.shift(k, v)
    out = o / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def ring_flash_attention(q, k, v, axis, scale: float, window: int = 0):
    """Ring attention whose per-step attend is the flash kernel: rank ``i``
    attends the block from ``src = (i - r) mod sp`` at global offsets
    (``q_offset = i·t``, ``kv_offset = src·t``) and folds the partial into
    a float32 carry, started at ``(0, -1e30)``, with `merge_partials`; the
    result is cast once at the end (reference ``ring.py:83-121``).
    Gradients come from the flash operator's backward (K2 then K3), which
    takes the lse cotangent the merge hands it."""
    i, n = axis.rank, axis.size
    b, t, h, d = q.shape
    o = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, t), NEG_INF, dtype=torch.float32,
                     device=q.device)
    for r in range(n):
        src = (i - r) % n
        o_r, lse_r = flash_attention_with_lse(
            q, k, v, scale, q_offset=i * t, kv_offset=src * t, causal=True,
            window=window)
        o, lse = merge_partials(o, lse, o_r, lse_r)
        if r < n - 1:
            k, v = axis.shift(k, v)
    return o.to(q.dtype)


def make_sharded_ring_attention(mesh, scale: float, use_flash: bool = False,
                                window: int = 0):
    """``attend(q, k, v)`` over the mesh's ``seq`` axis, on this rank's
    ``[B, T/sp, H_local, D]`` blocks; ``use_flash`` attends each step with
    the flash kernel."""
    axis = GroupSeqAxis(mesh.get_group("seq"))
    ring = ring_flash_attention if use_flash else ring_attention

    def attend(q, k, v):
        return ring(q, k, v, axis, scale, window=window)

    return attend
