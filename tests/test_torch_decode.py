"""The port's KV-cache decoding (kubegpu_tpu_torch.workload.decode) held
against the JAX package's: step logits equal the full forward, greedy
``make_generate`` tokens equal JAX's exactly, per-row ``start_pos`` works,
and the fused decode chunk freezes rows on the device without reading a
value back. float32, parameters carried across from JAX ``init_params``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from kubegpu_tpu.workload import decode as jdecode  # noqa: E402
from kubegpu_tpu.workload import model as jmodel  # noqa: E402
from kubegpu_tpu_torch.workload import decode as tdecode  # noqa: E402
from kubegpu_tpu_torch.workload import model as tmodel  # noqa: E402

SMALL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=64, dtype="float32", attn_impl="xla")
VARIANTS = {"dense": {}, "gqa": dict(n_kv_heads=2),
            "windowed": dict(attn_window=8)}


def _setup(variant="dense", seed=0):
    kw = {**SMALL, **VARIANTS[variant]}
    jcfg, tcfg = jmodel.TransformerConfig(**kw), tmodel.TransformerConfig(**kw)
    jp = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = tmodel.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def dense():
    return _setup("dense")


def _prompt(b, t, seed=3):
    return np.random.default_rng(seed).integers(1, 64, (b, t)) \
        .astype(np.int32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_step_logits_match_forward(variant):
    """Prefill then single-token steps reproduce the full forward's logits
    at every position (the port's and JAX's)."""
    jcfg, tcfg, jp, tp = _setup(variant)
    seq = _prompt(2, 20)
    full_j = np.asarray(jmodel.make_forward(jcfg)(jp, jnp.asarray(seq)))
    full_t = tmodel.make_forward(tcfg)(tp, torch.from_numpy(seq)).numpy()
    np.testing.assert_allclose(full_t, full_j, atol=1e-4, rtol=1e-4)
    step = tdecode.make_forward_step(tcfg)
    cache = tdecode.init_cache(tcfg, 2, 32, device="cpu")
    logits, cache = step(tp, cache, torch.from_numpy(seq[:, :12]), 0)
    np.testing.assert_allclose(logits.numpy(), full_j[:, :12], atol=1e-4,
                               rtol=1e-4)
    for i in range(12, 20):
        logits, cache = step(tp, cache, torch.from_numpy(seq[:, i:i + 1]), i)
        np.testing.assert_allclose(logits[:, 0].numpy(), full_j[:, i],
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_generate_tokens_equal_jax(variant):
    jcfg, tcfg, jp, tp = _setup(variant)
    prompt = _prompt(2, 5)
    want = np.asarray(jax.jit(jdecode.make_generate(jcfg),
                              static_argnums=(2,))(jp, jnp.asarray(prompt),
                                                   20))
    got = tdecode.make_generate(tcfg)(tp, torch.from_numpy(prompt), 20)
    assert got.shape == (2, 20)
    assert got.numpy().tolist() == want.tolist()


def test_per_row_start_pos_matches_scalar_steps(dense):
    """Rows at different depths step together: each row's logits and
    cache writes equal stepping it alone at its scalar position (and the
    JAX per-row step)."""
    jcfg, tcfg, jp, tp = dense
    step = tdecode.make_forward_step(tcfg)
    prompts = [_prompt(1, 5, seed=1), _prompt(1, 9, seed=2)]
    nxt = np.array([[7], [11]], np.int32)
    solo, rows = [], tdecode.init_cache(tcfg, 2, 32, device="cpu")
    for r, p in enumerate(prompts):
        c = tdecode.init_cache(tcfg, 1, 32, device="cpu")
        _, c = step(tp, c, torch.from_numpy(p), 0)
        for lr, lc in zip(rows, c):
            lr["k"][r], lr["v"][r] = lc["k"][0], lc["v"][0]
        logits, c = step(tp, c, torch.from_numpy(nxt[r:r + 1]), p.shape[1])
        solo.append((logits[0, 0], c))
    jrows = [{k: jnp.asarray(v.numpy()) for k, v in layer.items()}
             for layer in rows]
    pos = torch.tensor([5, 9])
    logits, rows = step(tp, rows, torch.from_numpy(nxt), pos)
    for r in range(2):
        torch.testing.assert_close(logits[r, 0], solo[r][0], atol=1e-5,
                                   rtol=1e-5)
        torch.testing.assert_close(rows[0]["k"][r], solo[r][1][0]["k"][0])
    jl, _ = jdecode.make_forward_step(jcfg)(jp, jrows, jnp.asarray(nxt),
                                            jnp.asarray([5, 9]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)


def test_generate_refuses_past_max_seq(dense):
    _, tcfg, _, tp = dense
    with pytest.raises(ValueError, match="exceeds max_seq"):
        tdecode.make_generate(tcfg)(tp, torch.ones((1, 60), dtype=torch.long),
                                    5)


def _chunk_inputs(tcfg, tp, prompts):
    """Prefill each prompt into its own row; return the chunk's carry."""
    step = tdecode.make_forward_step(tcfg)
    cache = tdecode.init_cache(tcfg, len(prompts), 64, device="cpu")
    tok, pos = [], []
    for r, p in enumerate(prompts):
        c = tdecode.init_cache(tcfg, 1, 64, device="cpu")
        logits, c = step(tp, c, torch.tensor([p]), 0)
        for lr, lc in zip(cache, c):
            lr["k"][r], lr["v"][r] = lc["k"][0], lc["v"][0]
        tok.append(int(logits[0, -1].argmax()))
        pos.append(len(p))
    return cache, torch.tensor(tok), torch.tensor(pos)


def test_decode_chunk_budget_and_eos_freeze_rows(dense):
    _, tcfg, _, tp = dense
    prompts = [[1, 2, 3], [9, 8, 7, 6]]
    ref = tdecode.make_generate(tcfg)(tp, torch.tensor([prompts[0]]), 10)[0]
    ref1 = tdecode.make_generate(tcfg)(tp, torch.tensor([prompts[1]]), 10)[0]
    cache, tok, pos = _chunk_inputs(tcfg, tp, prompts)
    chunk = tdecode.make_decode_chunk(tcfg, chunk=6)
    active = torch.tensor([True, True])
    budget = torch.tensor([3, 5])
    cache, toks, n_emit, tok_n, pos_n, act_n = chunk(tp, cache, tok, pos,
                                                     active, budget)
    assert n_emit.tolist() == [3, 5]
    assert toks[0, :3].tolist() == ref[1:4].tolist()
    assert toks[1, :5].tolist() == ref1[1:6].tolist()
    assert not toks[0, 3:].any() and not toks[1, 5:].any()
    assert pos_n.tolist() == [3 + 3, 4 + 5] and not act_n.any()
    assert tok_n.tolist() == [int(ref[3]), int(ref1[5])]

    # EOS: the row emits it, then freezes
    eos = int(ref[2])
    cache, tok, pos = _chunk_inputs(tcfg, tp, prompts[:1])
    chunk = tdecode.make_decode_chunk(tcfg, chunk=6, eos_id=eos)
    _, toks, n_emit, _, _, act_n = chunk(tp, cache, tok, pos,
                                         torch.tensor([True]),
                                         torch.tensor([9]))
    stop = ref[1:].tolist().index(eos) + 1
    assert n_emit.tolist() == [stop] and not act_n.any()
    assert toks[0, :stop].tolist() == ref[1:stop + 1].tolist()


def test_decode_chunk_reads_nothing_back(dense, monkeypatch):
    """No host synchronisation inside the chunk: no .item(), .tolist(),
    .cpu(), .numpy(), bool() or int() of a tensor."""
    _, tcfg, _, tp = dense
    cache, tok, pos = _chunk_inputs(tcfg, tp, [[1, 2, 3], [4, 5]])
    chunk = tdecode.make_decode_chunk(tcfg, chunk=4, eos_id=5)

    def refuse(*a, **k):
        raise AssertionError("host sync inside the decode chunk")

    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__index__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    out = chunk(tp, cache, tok, pos, torch.tensor([True, True]),
                torch.tensor([4, 4]))
    monkeypatch.undo()
    assert out[1].shape == (2, 4)


def test_sampling_is_out_of_slice_and_validation_matches(dense):
    jcfg, tcfg, _, _ = dense
    for args in ((-1.0, 0, 1.0), (0.0, 0, 0.0), (1.0, -1, 1.0),
                 (0.0, 3, 1.0)):
        with pytest.raises(ValueError):
            jdecode.validate_sampling(jcfg, *args)
        with pytest.raises(ValueError):
            tdecode.validate_sampling(tcfg, *args)
    assert tdecode.validate_sampling(tcfg, 1.0, 1000, 1.0) == 64
    with pytest.raises(NotImplementedError, match="slice 4"):
        tdecode.make_generate(tcfg, temperature=0.8)
    with pytest.raises(NotImplementedError, match="slice 4"):
        tdecode.make_decode_chunk(tcfg, temperature=0.8)
    with pytest.raises(ValueError, match="chunk"):
        tdecode.make_decode_chunk(tcfg, chunk=0)


def test_init_cache_is_narrow_under_gqa():
    _, tcfg, _, _ = _setup("gqa")
    cache = tdecode.init_cache(tcfg, 3, 16, device="cpu")
    assert len(cache) == 2
    assert cache[0]["k"].shape == (3, 16, 2, 8)
    assert cache[0]["v"].dtype == torch.float32 and not cache[1]["k"].any()
