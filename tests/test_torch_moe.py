"""The port's single-device mixture-of-experts FFN
(kubegpu_tpu_torch.workload.moe, and its branches in the model, the train
step, decode and the server) held against the JAX package's
(kubegpu_tpu/workload/moe.py), mirroring tests/test_workload_parallel.py's
MoE tests on one device: routing (Switch top-1, Mixtral top-2), the aux
loss, a training model, validation.

Parameters come from JAX's ``init_params``/``init_moe_params``, carried
across with ``params_from_jax``; inputs from numpy with a seed; float32 on
the CPU. Tolerances, and why:
- ``moe_ffn`` out and aux 1e-5: the same float32 products summed in
  another order, at unit scale;
- logits 1e-4, loss 1e-5, parameters after AdamW steps atol 1e-5 / rtol
  1e-4: tests/test_torch_model.py's and tests/test_torch_train.py's;
- greedy streams token for token.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from kubegpu_tpu.workload import decode as jdecode  # noqa: E402
from kubegpu_tpu.workload import model as jmodel  # noqa: E402
from kubegpu_tpu.workload import moe as jmoe  # noqa: E402
from kubegpu_tpu.workload import presets as jpresets  # noqa: E402
from kubegpu_tpu.workload import train as jtrain  # noqa: E402
from kubegpu_tpu.workload.serve import DecodeServer as JaxServer  # noqa: E402
from kubegpu_tpu_torch.workload import decode as tdecode  # noqa: E402
from kubegpu_tpu_torch.workload import model as tmodel  # noqa: E402
from kubegpu_tpu_torch.workload import moe as tmoe  # noqa: E402
from kubegpu_tpu_torch.workload import presets as tpresets  # noqa: E402
from kubegpu_tpu_torch.workload import train as ttrain  # noqa: E402
from kubegpu_tpu_torch.workload.serve import DecodeServer  # noqa: E402

SMALL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=64, dtype="float32", attn_impl="xla")


def _to_port(tree):
    return tmodel.params_from_jax(jax.tree.map(np.asarray, tree),
                                  device="cpu")


def _configs(**kw):
    over = {**SMALL, **kw}
    return jpresets.make_config("moe", **over), \
        tpresets.make_config("moe", **over)


def _setup(seed=0, **kw):
    jcfg, tcfg = _configs(**kw)
    jp = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, _to_port(jp)


def _tokens(b=2, t=33, seed=1):
    return np.random.default_rng(seed).integers(0, 64, (b, t)) \
        .astype(np.int32)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_matches_jax(top_k):
    """Switch top-1 (raw gate) and Mixtral top-2 (renormalised): out and
    aux within 1e-5 of JAX's, aux in [1, E]."""
    jp = jmoe.init_moe_params(jax.random.PRNGKey(0), 16, 32, 4)
    x = np.random.default_rng(1).standard_normal((2, 8, 16)) \
        .astype(np.float32)
    want, want_aux = jmoe.moe_ffn(jp, jnp.asarray(x), jnp.float32,
                                  top_k=top_k)
    got, aux = tmoe.moe_ffn(_to_port(jp), torch.from_numpy(x),
                            torch.float32, top_k=top_k)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert abs(aux.item() - float(want_aux)) <= 1e-5
    assert 1.0 <= aux.item() <= 4.0


def test_moe_top1_keeps_switch_semantics():
    """top_k = 1 scales the winner's output by its raw gate probability."""
    p = tmoe.init_moe_params(torch.Generator().manual_seed(0), 16, 32, 4)
    x = torch.randn((2, 8, 16), generator=torch.Generator().manual_seed(1))
    out, _ = tmoe.moe_ffn(p, x, torch.float32, top_k=1)
    gates = torch.softmax(x @ p["router"], -1)
    top1 = gates.argmax(-1)
    up = torch.einsum("btd,edf->btef", x, p["w_up"])
    gate = torch.nn.functional.silu(
        torch.einsum("btd,edf->btef", x, p["w_gate"]))
    eo = torch.einsum("btef,efd->bted", up * gate, p["w_down"])
    want = eo.gather(2, top1[..., None, None].expand(-1, -1, 1, 16))[:, :, 0]
    want = want * gates.gather(-1, top1[..., None])
    torch.testing.assert_close(out, want, atol=1e-5, rtol=0)


def test_init_moe_params_layout_matches_reference():
    """The port's MoE parameters have the reference's tree and shapes, the
    dense FFN gives way to ``moe``, and the draws are reproducible."""
    jcfg, tcfg, jp, _ = _setup()
    tp = tmodel.init_params(torch.Generator().manual_seed(0), tcfg)

    def shapes(tree):
        return jax.tree.map(lambda x: tuple(x.shape), tree)

    assert shapes(tp) == shapes(jax.tree.map(np.asarray, jp))
    assert "w_up" not in tp["layers"][0]
    assert tuple(tp["layers"][0]["moe"]["w_up"].shape) == (4, 32, 64)
    again = tmodel.init_params(torch.Generator().manual_seed(0), tcfg)
    assert torch.equal(tp["layers"][1]["moe"]["router"],
                       again["layers"][1]["moe"]["router"])
    p = tmoe.init_moe_params(torch.Generator().manual_seed(0), 64, 256, 8)
    assert abs(p["w_up"].std().item() * 8 - 1) < 0.05
    assert abs(p["w_down"].std().item() * 16 - 1) < 0.05


def test_moe_logits_aux_and_loss_match_jax():
    """The ``moe`` preset's logits within 1e-4 of JAX's ``make_forward``;
    the aux term and the loss that includes it within 1e-5."""
    jcfg, tcfg, jp, tp = _setup()
    tok = _tokens()
    want, want_aux = jmodel.make_forward_with_aux(jcfg)(
        jp, jnp.asarray(tok[:, :-1]))
    got, aux = tmodel.make_forward_with_aux(tcfg)(
        tp, torch.from_numpy(tok[:, :-1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert abs(aux.item() - float(want_aux)) <= 1e-5
    assert 2.0 <= aux.item() <= 8.0              # [1, E] a layer
    np.testing.assert_allclose(
        tmodel.make_forward(tcfg)(tp, torch.from_numpy(tok)).numpy(),
        np.asarray(jmodel.make_forward(jcfg)(jp, jnp.asarray(tok))),
        atol=1e-4, rtol=1e-4)
    want_loss = float(jmodel.make_loss_fn(jcfg)(jp, jnp.asarray(tok)))
    loss = tmodel.make_loss_fn(tcfg)(tp, torch.from_numpy(tok)).item()
    assert abs(loss - want_loss) <= 1e-5
    no_aux = tmodel.make_loss_fn(dataclasses.replace(
        tcfg, moe_aux_weight=0.0))(tp, torch.from_numpy(tok)).item()
    assert abs(loss - no_aux - 0.01 * aux.item()) <= 1e-5


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_moe_train_steps_match_jax(remat):
    """Two AdamW steps of the MoE model against JAX's train step under the
    same remat mode: losses within 1e-5, parameters atol 1e-5 / rtol
    1e-4."""
    jcfg, tcfg, jp, tp = _setup(remat=remat)
    jopt = jtrain.default_optimizer()
    jstate = jopt.init(jp)
    jstep = jtrain.make_train_step(jcfg, None, jopt)
    tstep, tstate = ttrain.make_train_step(tcfg), None
    for i in range(2):
        tok = _tokens(seed=20 + i)
        jp, jstate, jloss = jstep(jp, jstate, jnp.asarray(tok))
        tp, tstate, tloss = tstep(tp, tstate, torch.from_numpy(tok))
        assert abs(tloss.item() - float(jloss)) <= 1e-5, i
    flat = jax.tree.leaves(jax.tree.map(np.asarray, jp))
    ours = jax.tree.leaves(jax.tree.map(lambda x: x.detach().numpy(), tp))
    assert len(ours) == len(flat)
    for x, w in zip(ours, flat):
        np.testing.assert_allclose(x, w, atol=1e-5, rtol=1e-4)


def test_moe_remat_dots_keeps_the_expert_up_and_gate_products():
    """Under remat "dots" the backward does not recompute the up and gate
    products (2-D products, kept as the reference's policy keeps
    ``btd,edf->btef``); "full" recomputes both in every layer. Counted as
    ``aten.mm`` calls of the forward product's shape ``[B·T, E·f]`` while
    the gradients are taken; the gradients equal "none"'s (1e-5)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    _, tcfg, _, tp = _setup()
    fwd_shape = (2 * 32, tcfg.n_experts * tcfg.d_ff)

    class CountForwardProducts(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is torch.ops.aten.mm.default and \
                    tuple(out.shape) == fwd_shape:
                self.n += 1
            return out

    leaves = ttrain.param_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    tok = torch.from_numpy(_tokens())
    grads, recomputed = {}, {}
    for remat in ("none", "dots", "full"):
        loss = tmodel.make_loss_fn(dataclasses.replace(tcfg, remat=remat))(
            tp, tok)
        with CountForwardProducts() as count:
            grads[remat] = torch.autograd.grad(loss, leaves)
        recomputed[remat] = count.n
    assert recomputed == {"none": 0, "dots": 0,
                          "full": 2 * SMALL["n_layers"]}
    for remat in ("dots", "full"):
        for g, w in zip(grads[remat], grads["none"]):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def test_moe_greedy_generate_equals_jax():
    jcfg, tcfg, jp, tp = _setup()
    prompt = np.random.default_rng(3).integers(1, 64, (2, 5)) \
        .astype(np.int32)
    want = np.asarray(jax.jit(jdecode.make_generate(jcfg),
                              static_argnums=(2,))(jp, jnp.asarray(prompt),
                                                   12))
    got = tdecode.make_generate(tcfg)(tp, torch.from_numpy(prompt), 12)
    assert got.numpy().tolist() == want.tolist()


def test_moe_decode_server_streams_equal_jax():
    """The continuous-batching server (fused chunk and per-token oracle,
    and the speculative server with the model as its own draft) emits
    JAX's server's greedy streams."""
    jcfg, tcfg, jp, tp = _setup()
    prompts = [[1, 2, 3], [7, 8, 9, 10, 11, 12, 13], [5] * 12, [2, 7]]
    srv = JaxServer(jcfg, jp, slots=2, prefill_buckets=(8, 16))
    rids = [srv.submit(p, max_new=8) for p in prompts]
    srv.run()
    want = [srv.result(r) for r in rids]
    for kw in (dict(), dict(chunk=1), dict(draft_params=tp, draft_cfg=tcfg)):
        ours = DecodeServer(tcfg, tp, slots=2, prefill_buckets=(8, 16), **kw)
        rids = [ours.submit(p, max_new=8) for p in prompts]
        ours.run()
        assert [ours.result(r) for r in rids] == want, kw


def test_moe_builds_and_the_mesh_is_still_refused():
    """``n_experts > 0`` builds, runs and trains on one device and over a
    mesh, and serves over a mesh; an object that is not a mesh raises
    TypeError, in serving too; top-k validation matches the reference."""
    _, tcfg, _, tp = _setup()
    tmodel.make_forward(tcfg)
    tmodel.init_params(torch.Generator(), tcfg)
    ttrain.make_train_step(tcfg)
    from tests.torch_worlds import single_rank_mesh

    with single_rank_mesh() as mesh:
        tmodel.make_forward(tcfg, mesh=mesh)
        DecodeServer(tcfg, tp, mesh=mesh)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmodel.make_forward(tcfg, mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        DecodeServer(tcfg, tp, mesh=object())
    x = torch.zeros((1, 2, 32))
    with pytest.raises(ValueError, match="top_k 5 must be in"):
        tmoe.moe_ffn(tp["layers"][0]["moe"], x, torch.float32, top_k=5)
    with pytest.raises(ValueError, match="moe_top_k"):
        tmodel.TransformerConfig(n_experts=4, moe_top_k=0)


def test_train_demo_moe_preset(capsys):
    """CLI: the ``moe`` preset trains and decodes on the CPU."""
    import json

    from kubegpu_tpu_torch.cmd import train_demo

    assert train_demo.main(["--device", "cpu", "--preset", "moe", "--steps",
                            "2", "--batch", "2", "--seq", "32", "--d-model",
                            "32", "--n-layers", "1", "--generate", "4"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["losses_full"]).all()
    assert len(out["generated"]) == 4
