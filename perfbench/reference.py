"""The plain reference of the benchmark's configurations, in float32.

A Mistral-style decoder (Mistral-7B, arXiv:2310.06825; Mixtral-8x7B,
arXiv:2401.04088) written from the published description in plain
PyTorch: RMSNorm (variance in float32, ``x / sqrt(var + eps) * g``), RoPE
on the two halves of each head (``rotate_half``, frequencies
``theta^(-2i/D)``), grouped-query attention with a causal mask and, where
the configuration has one, a sliding window of the newest ``window``
keys, a SwiGLU FFN ``(silu(x W_gate) * x W_up) W_down`` or Mixtral's
sparse experts (a softmax over the router's logits, the top ``k``
renormalised, only the chosen experts run), an untied head, and
next-token cross entropy. No kernel, cache or batching of the program:
every product is a float32 ``matmul`` with TF32 off, attention in blocks
of query rows so a long sequence fits.

One departure from the published config: the norm's epsilon is the
program's fixed 1e-6 (the configuration files list it under ``assumed``).

``quant="fp8"`` is the control: every product's operands pass through
float8 e4m3 (a scale a row of the activation and a column of the weight)
before the float32 product, the precision a step below the bf16 the
configurations state. It exists to show that the comparison fails a
lower precision; the benchmark's own runs never use it.

Imports neither ``jax``, the JAX package nor the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.harness.spec import Model

FP8_MAX = 448.0


def strict_float32() -> None:
    """Float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 with one scale per slice along
    ``dim`` (its amax maps to 448), back in float32."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    # the rounding passes no gradient of its own (straight through)
    return x + (q - x).detach()


class Ref:
    """The reference model for ``m`` in float32, or through fp8 with
    ``quant="fp8"``."""

    def __init__(self, m: Model, quant: str | None = None,
                 q_block: int = 1024):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.m = m
        self.quant = quant
        self.q_block = q_block

    # -- pieces --------------------------------------------------------------
    def mm(self, x, w):
        """``x [..., k] @ w [k, n]``."""
        if self.quant == "fp8":
            x, w = _fp8(x, -1), _fp8(w, 0)
        return x @ w

    def bmm(self, a, b):
        """A batched product inside attention, operands rounded alike."""
        if self.quant == "fp8":
            a, b = _fp8(a, -1), _fp8(b, -2)
        return a @ b

    def rmsnorm(self, x, g):
        var = x.square().mean(-1, keepdim=True)
        return x * torch.rsqrt(var + 1e-6) * g

    def rope(self, x, pos):
        """``x [B, T, H, D]`` at positions ``pos [T]``."""
        d = x.shape[-1]
        half = d // 2
        inv = self.m.rope_theta ** (-torch.arange(
            half, dtype=torch.float64, device=x.device) * 2 / d)
        ang = pos.double()[:, None] * inv[None, :]
        cos = torch.cos(ang).float()[None, :, None, :]
        sin = torch.sin(ang).float()[None, :, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def attention(self, q, k, v):
        """Causal (windowed) GQA over ``q [B, T, H, D]``, ``k, v [B, T,
        KV, D]``, in blocks of query rows."""
        m = self.m
        b, t, h, d = q.shape
        rep = h // k.shape[2]
        k = k.repeat_interleave(rep, dim=2).transpose(1, 2)   # [B,H,T,D]
        v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
        q = q.transpose(1, 2)
        kp = torch.arange(t, device=q.device)
        outs = []
        for s0 in range(0, t, self.q_block):
            qb = q[:, :, s0:s0 + self.q_block]
            qp = kp[s0:s0 + qb.shape[2]]
            s = self.bmm(qb, k.transpose(-1, -2)) / math.sqrt(d)
            vis = kp[None, :] <= qp[:, None]
            if m.window:
                vis &= kp[None, :] > qp[:, None] - m.window
            s = s.masked_fill(~vis, float("-inf"))
            outs.append(self.bmm(torch.softmax(s, -1), v))
        return torch.cat(outs, 2).transpose(1, 2).reshape(b, t, h * d)

    def ffn(self, layer, x):
        if "moe" not in layer:
            return self.mm(F.silu(self.mm(x, layer["w_gate"]))
                           * self.mm(x, layer["w_up"]), layer["w_down"])
        moe = layer["moe"]
        flat = x.reshape(-1, x.shape[-1])
        probs = torch.softmax(self.mm(flat, moe["router"]), -1)
        vals, idx = torch.topk(probs, self.m.top_k, -1)
        vals = vals / vals.sum(-1, keepdim=True)
        out = torch.zeros_like(flat)
        for e in range(moe["w_up"].shape[0]):
            rows, slot = torch.nonzero(idx == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = flat[rows]
            ye = self.mm(F.silu(self.mm(xe, moe["w_gate"][e]))
                         * self.mm(xe, moe["w_up"][e]), moe["w_down"][e])
            out = out.index_add(0, rows, ye * vals[rows, slot, None])
        return out.reshape(x.shape)

    def aux_loss(self, layer, x):
        """Mixtral's load-balancing term of one layer (the program adds
        ``moe_aux_weight`` times their sum to the training loss):
        ``E * sum(route_frac * gate_frac)``, ``route_frac`` the share of
        the ``top_k`` picks an expert gets."""
        moe = layer["moe"]
        flat = x.reshape(-1, x.shape[-1])
        probs = torch.softmax(self.mm(flat, moe["router"]), -1)
        e = probs.shape[-1]
        idx = torch.topk(probs, self.m.top_k, -1).indices
        picks = F.one_hot(idx, e).float().sum(1).mean(0) / self.m.top_k
        return e * (picks * probs.mean(0)).sum()

    def block(self, layer, x, pos):
        m = self.m
        b, t, _ = x.shape
        h = self.rmsnorm(x, layer["ln1"])
        q = self.mm(h, layer["wq"]).reshape(b, t, m.n_heads, m.head_dim)
        k = self.mm(h, layer["wk"]).reshape(b, t, m.kv_heads, m.head_dim)
        v = self.mm(h, layer["wv"]).reshape(b, t, m.kv_heads, m.head_dim)
        a = self.attention(self.rope(q, pos), self.rope(k, pos), v)
        x = x + self.mm(a, layer["wo"])
        h = self.rmsnorm(x, layer["ln2"])
        aux = self.aux_loss(layer, h) if "moe" in layer \
            else x.new_zeros(())
        return x + self.ffn(layer, h), aux

    # -- whole model ---------------------------------------------------------
    def hidden(self, params, tokens, remat: bool = False):
        """The final normed hidden states ``[B, T, d]`` and the summed aux
        term; ``remat`` recomputes each layer in the backward pass, so a
        training step fits."""
        tokens = torch.as_tensor(tokens, device=params["embed"].device)
        x = params["embed"][tokens.long()]
        pos = torch.arange(tokens.shape[1], device=x.device)
        aux = x.new_zeros(())
        for layer in params["layers"]:
            if remat and torch.is_grad_enabled():
                x, a = checkpoint(self.block, layer, x, pos,
                                  use_reentrant=False)
            else:
                x, a = self.block(layer, x, pos)
            aux = aux + a
        return self.rmsnorm(x, params["final_norm"]), aux

    def logits(self, params, tokens):
        h, _ = self.hidden(params, tokens)
        return self.mm(h, params["unembed"])

    def loss(self, params, tokens, aux_weight: float = 0.0):
        """Next-token cross entropy of ``tokens [B, T + 1]`` (token mean)
        plus ``aux_weight`` times the summed aux term."""
        tokens = torch.as_tensor(tokens, device=params["embed"].device)
        h, aux = self.hidden(params, tokens[:, :-1], remat=True)
        logits = self.mm(h, params["unembed"])
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              tokens[:, 1:].reshape(-1).long())
        return nll + aux_weight * aux


class AdamW:
    """Decoupled-weight-decay Adam (Loshchilov and Hutter), as PyTorch and
    optax define it: ``p -= lr·wd·p``, then the bias-corrected moment
    step ``p -= lr · m̂ / (sqrt(v̂) + eps)``."""

    def __init__(self, tensors, lr: float, betas=(0.9, 0.95),
                 eps: float = 1e-8, weight_decay: float = 0.01):
        self.tensors = list(tensors)
        self.lr, (self.b1, self.b2) = lr, betas
        self.eps, self.wd = eps, weight_decay
        self.m = [torch.zeros_like(p) for p in self.tensors]
        self.v = [torch.zeros_like(p) for p in self.tensors]
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, m, v in zip(self.tensors, self.m, self.v):
            g = p.grad
            p.mul_(1 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))
