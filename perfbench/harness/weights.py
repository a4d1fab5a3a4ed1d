"""Random weights from the seed, on the device, in the port's layout.

The tree is the one ``kubegpu_tpu_torch.workload.model`` takes (names and
``(in, out)`` shapes): ``embed [V, d]``, ``unembed [d, V]``,
``final_norm [d]`` and per layer ``ln1``, ``wq``, ``wk``, ``wv``, ``wo``,
``ln2`` with either ``w_up``, ``w_gate``, ``w_down`` or ``moe`` =
``{router [d, E], w_up [E, d, f], w_gate [E, d, f], w_down [E, f, d]}``.
A product's weight is normal with standard deviation ``in ** -0.5``, the
embedding's 0.02, the norms' gains ones, all float32.

One ``torch.randn`` a block (the embedding, head and final norm; then
each layer) draws every leaf of the block at once, and the leaves are
views of it, so the same seed gives the same numbers whatever reads them:
the program and the reference each call `make_params` and get equal
trees.
"""

from __future__ import annotations

import torch

from .spec import Model, derive_seed


def _layer_shapes(m: Model) -> list:
    """``[(path, shape, std)]`` of one layer; std None = ones."""
    d, f = m.d_model, m.d_ff
    h, kv = m.n_heads * m.head_dim, m.kv_heads * m.head_dim
    out = [(("ln1",), (d,), None), (("wq",), (d, h), d ** -0.5),
           (("wk",), (d, kv), d ** -0.5), (("wv",), (d, kv), d ** -0.5),
           (("wo",), (h, d), h ** -0.5), (("ln2",), (d,), None)]
    if m.moe:
        e = m.n_experts
        out += [(("moe", "router"), (d, e), d ** -0.5),
                (("moe", "w_up"), (e, d, f), d ** -0.5),
                (("moe", "w_gate"), (e, d, f), d ** -0.5),
                (("moe", "w_down"), (e, f, d), f ** -0.5)]
    else:
        out += [(("w_up",), (d, f), d ** -0.5),
                (("w_gate",), (d, f), d ** -0.5),
                (("w_down",), (f, d), f ** -0.5)]
    return out


def _top_shapes(m: Model) -> list:
    d, v = m.d_model, m.vocab
    return [(("embed",), (v, d), 0.02), (("unembed",), (d, v), d ** -0.5),
            (("final_norm",), (d,), None)]


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _block(gen: torch.Generator, shapes: list, device) -> dict:
    total = sum(_numel(s) for _, s, _ in shapes)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    tree: dict = {}
    off = 0
    for path, shape, std in shapes:
        n = _numel(shape)
        leaf = flat[off:off + n].view(shape)
        off += n
        if std is None:
            leaf.fill_(1.0)
        else:
            leaf.mul_(std)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def make_params(m: Model, seed: int, device) -> dict:
    """The float32 parameter tree of ``m`` drawn from ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, "weights"))
    params = _block(gen, _top_shapes(m), device)
    params["layers"] = [_block(gen, _layer_shapes(m), device)
                        for _ in range(m.n_layers)]
    return params


def leaves(params) -> list:
    """``[(name, tensor)]`` in a fixed order (dict keys sorted, layers in
    order), the order the program's optimizer also walks."""
    out = []

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}.{k}" if prefix else k, node[k])
        elif isinstance(node, (list, tuple)):
            for i, x in enumerate(node):
                walk(f"{prefix}.{i}", x)
        else:
            out.append((prefix, node))

    walk("", params)
    return out


def param_count(m: Model) -> int:
    return (sum(_numel(s) for _, s, _ in _top_shapes(m))
            + m.n_layers * sum(_numel(s) for _, s, _ in _layer_shapes(m)))
