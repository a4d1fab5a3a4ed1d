"""Counter-based random keys for sampling, computed in torch integer ops.

The reference draws with threefry keys (``jax.random.fold_in``); their bits
cannot be matched here, so the port has keys of its own with the same
lineage. A key is a 32-bit value held in an int64 tensor (any shape).
`fold` derives a child key from a key and a counter; `uniform` and
`gumbel` turn a key into one draw per vocab index (or per counter). Every
step is an integer hash of its inputs, so the bits are the same on the CPU
and on the card, and a draw depends on nothing but its lineage: the same
tokens whatever batch, slot, chunk or data plane produced them.

Lineage (as the reference's, ``serve.py``):
- a request's root is ``fold(seed, rid)``;
- the selection at absolute position ``p`` uses ``fold(root, p)``;
- a speculative round that starts at position ``p`` has the key
  ``fold(root, p)``; its draft step ``i`` samples with ``fold(round, i)``
  and its accept/resample draw uses ``fold(round, k)``.

The mix is Wellons' "lowbias32" permutation of 32-bit integers. torch has
no unsigned 64-bit arithmetic on CUDA and ``>>`` on int64 is arithmetic,
so every value stays in ``[0, 2^32)`` (where the shift is logical) and
each 32-bit product is taken in two 16-bit halves, none of which can
overflow int64.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x, c: int):
    """``x * c mod 2^32`` for ``x`` in [0, 2^32) without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def as_key(x, device=None):
    """``x`` (an int, a sequence or a tensor) as an int64 key tensor."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _M32


def fold(key, data):
    """The child key of ``key`` for counter ``data`` (tensors or ints,
    broadcast; both are taken mod 2^32)."""
    key = torch.as_tensor(key, dtype=torch.int64) & _M32
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    return _mix32((_mix32(key) + _mix32((data & _M32) ^ _GOLDEN)) & _M32)


def bits(key, n: int):
    """``[..., n]`` 32-bit values: counter ``0..n-1`` folded into each key."""
    key = torch.as_tensor(key, dtype=torch.int64)
    return fold(key[..., None], torch.arange(n, device=key.device))


def uniform(key, n: int):
    """``[..., n]`` float32 uniforms in (0, 1), 23 bits each: with 24, the
    half-step offset would round the largest to 1.0 in float32."""
    return ((bits(key, n) >> 9).float() + 0.5) * (1.0 / (1 << 23))


def gumbel(key, n: int):
    """``[..., n]`` float32 standard Gumbel draws: ``argmax(z + gumbel)``
    samples ``softmax(z)``."""
    return -torch.log(-torch.log(uniform(key, n)))
