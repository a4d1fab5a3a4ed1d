"""The plain reference agrees with the program at a tiny size on the CPU
(float32 on both sides), and its AdamW is PyTorch's."""

import dataclasses

import pytest
import torch

from perfbench.harness import spec, weights
from perfbench.harness.port import port_config
from perfbench.reference import AdamW, Ref, strict_float32
from perfbench.tests import tiny


def tiny_model(moe: bool):
    return spec.model_from_file("tiny", tiny.TINY_MOE if moe
                                else tiny.TINY_MODEL)


def port_cfg(m, seq):
    return dataclasses.replace(port_config(m, max_seq=seq), dtype="float32",
                               attn_impl="xla")


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_logits_agree(moe):
    from kubegpu_tpu_torch.workload.model import make_forward

    strict_float32()
    m = tiny_model(moe)
    params = weights.make_params(m, 11, "cpu")
    tokens = torch.randint(3, m.vocab, (2, 96), generator=torch.Generator()
                           .manual_seed(0))
    got = make_forward(port_cfg(m, 96))(params, tokens)
    want = Ref(m, q_block=32).logits(params, tokens)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_loss_and_gradients_agree(moe):
    from kubegpu_tpu_torch.workload.model import make_loss_fn

    strict_float32()
    m = tiny_model(moe)
    tokens = torch.randint(3, m.vocab, (2, 65), generator=torch.Generator()
                           .manual_seed(1))
    grads = []
    losses = []
    for side in ("port", "ref"):
        params = weights.make_params(m, 12, "cpu")
        named = weights.leaves(params)
        for _, p in named:
            p.requires_grad_(True)
        if side == "port":
            loss = make_loss_fn(port_cfg(m, 64))(params, tokens)
        else:
            loss = Ref(m).loss(params, tokens, 0.01 if moe else 0.0)
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({k: p.grad.clone() for k, p in named})
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    for k in grads[0]:
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=1e-3,
                                   atol=1e-6)


def test_adamw_is_torch_adamw():
    gen = torch.Generator().manual_seed(2)
    a = [torch.randn(7, 5, generator=gen) for _ in range(3)]
    b = [x.clone() for x in a]
    ours = AdamW(a, lr=3e-4)
    theirs = torch.optim.AdamW(b, lr=3e-4, betas=(0.9, 0.95), eps=1e-8,
                               weight_decay=0.01)
    for _ in range(3):
        g = [torch.randn(7, 5, generator=gen) for _ in range(3)]
        for x, y, gi in zip(a, b, g):
            x.grad, y.grad = gi.clone(), gi.clone()
        ours.step()
        theirs.step()
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)


def test_fp8_control_is_coarser():
    strict_float32()
    m = tiny_model(False)
    params = weights.make_params(m, 13, "cpu")
    tokens = torch.randint(3, m.vocab, (1, 64), generator=torch.Generator()
                           .manual_seed(3))
    exact = Ref(m).logits(params, tokens)
    coarse = Ref(m, quant="fp8").logits(params, tokens)
    err = (coarse - exact).abs().max()
    assert 1e-3 < err < 1.0


def test_weights_from_seed():
    m = tiny_model(True)
    a = weights.leaves(weights.make_params(m, 5, "cpu"))
    b = weights.leaves(weights.make_params(m, 5, "cpu"))
    c = weights.leaves(weights.make_params(m, 6, "cpu"))
    assert [k for k, _ in a] == [k for k, _ in b]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
    assert not torch.equal(dict(a)["layers.0.wq"], dict(c)["layers.0.wq"])
    assert sum(x.numel() for _, x in a) == weights.param_count(m)
    assert torch.equal(dict(a)["layers.1.ln2"], torch.ones(m.d_model))
    wq = dict(a)["layers.0.wq"]
    assert wq.std().item() == pytest.approx(m.d_model ** -0.5, rel=0.1)
