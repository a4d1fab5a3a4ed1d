"""The port's speculative decoding (kubegpu_tpu_torch.workload.speculative)
held against the JAX package's, mirroring tests/test_speculative.py.

Greedy: the output equals the JAX target's greedy sequence and the JAX
speculative decoder's, token for token, with the same number of target
calls (float32, parameters carried across with ``params_from_jax``).
Sampled: the port's keys are not threefry's, so sampled paths are held
to the target's (truncated) distribution by a chi-square test at a fixed
seed (p > 1e-3 on the bins the distribution reaches, no draw outside
them) and by the reference's 4-sigma bound per bin (0.033 at 4000 draws).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
scipy_stats = pytest.importorskip("scipy.stats")

import jax.numpy as jnp  # noqa: E402

from kubegpu_tpu.workload import decode as jdecode  # noqa: E402
from kubegpu_tpu.workload import model as jmodel  # noqa: E402
from kubegpu_tpu.workload import speculative as jspec  # noqa: E402
from kubegpu_tpu_torch.workload import decode as tdecode  # noqa: E402
from kubegpu_tpu_torch.workload import keys  # noqa: E402
from kubegpu_tpu_torch.workload import model as tmodel  # noqa: E402
from kubegpu_tpu_torch.workload import speculative as tspec  # noqa: E402

CHI2_P = 1e-3


def _cfg(layers, **kw):
    base = dict(vocab=64, d_model=32, n_heads=4, n_layers=layers, d_ff=64,
                max_seq=128, attn_impl="xla", dtype="float32")
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def models():
    """(JAX and port configs and params of a 3-layer target and a 1-layer
    draft)."""
    out = {}
    for name, layers, seed in (("target", 3, 0), ("draft", 1, 7)):
        jcfg = jmodel.TransformerConfig(**_cfg(layers))
        jp = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
        out[name] = (jcfg, jp, tmodel.TransformerConfig(**_cfg(layers)),
                     tmodel.params_from_jax(jax.tree.map(np.asarray, jp),
                                            device="cpu"))
    return out


def _jax_greedy(jcfg, jp, prompt, n_new):
    gen = jax.jit(jdecode.make_generate(jcfg), static_argnums=(2,))
    return np.asarray(gen(jp, jnp.asarray([prompt], jnp.int32),
                          n_new))[0].tolist()


def _chi2(counts, probs):
    """p-value of ``counts`` against ``probs`` over the bins ``probs``
    reaches; asserts no count falls outside them."""
    counts, probs = np.asarray(counts, float), np.asarray(probs, float)
    support = probs > 0
    assert counts[~support].sum() == 0
    expected = probs[support] / probs[support].sum() * counts.sum()
    return scipy_stats.chisquare(counts[support], expected).pvalue


@pytest.mark.parametrize("k", [1, 3, 5])
def test_exactly_matches_target_greedy(models, k):
    jcfg, jp, tcfg, tp = models["target"]
    jdc, jdp, tdc, tdp = models["draft"]
    prompt = [3, 1, 4, 1, 5]
    got, calls = tspec.make_speculative_generate(tcfg, tdc, k=k)(
        tp, tdp, prompt, 12)
    assert got == _jax_greedy(jcfg, jp, prompt, 12)
    want, jcalls = jspec.make_speculative_generate(jcfg, jdc, k=k)(
        jp, jdp, prompt, 12)
    assert (got, calls) == (want, jcalls)


def test_perfect_draft_needs_few_target_calls(models):
    jcfg, jp, tcfg, tp = models["target"]
    gen = tspec.make_speculative_generate(tcfg, tcfg, k=4)
    got, calls = gen(tp, tp, [9, 8, 7], 15)
    assert got == _jax_greedy(jcfg, jp, [9, 8, 7], 15)
    assert calls <= 1 + -(-(15 - 1) // 5), calls


def test_weak_draft_still_exact_and_bounded(models):
    jcfg, jp, tcfg, tp = models["target"]
    _, _, tdc, tdp = models["draft"]
    got, calls = tspec.make_speculative_generate(tcfg, tdc, k=2)(
        tp, tdp, [1, 2], 10)
    assert got == _jax_greedy(jcfg, jp, [1, 2], 10)
    assert calls <= 10


def test_validation(models):
    _, _, tcfg, tp = models["target"]
    _, _, tdc, tdp = models["draft"]
    with pytest.raises(ValueError, match="k must"):
        tspec.make_speculative_generate(tcfg, tdc, k=0)
    with pytest.raises(ValueError, match="vocab"):
        tspec.make_speculative_generate(
            tcfg, tmodel.TransformerConfig(**_cfg(1, vocab=32)))
    gen = tspec.make_speculative_generate(tcfg, tdc, k=2)
    with pytest.raises(ValueError, match="n_new"):
        gen(tp, tdp, [1, 2], 0)
    with pytest.raises(ValueError, match="max_seq"):
        gen(tp, tdp, [1] * 120, 10)
    with pytest.raises(ValueError, match="temperature"):
        tspec.make_speculative_generate(tcfg, tdc, temperature=-1.0)
    with pytest.raises(ValueError, match="top_k/top_p"):
        tspec.make_speculative_generate(tcfg, tdc, top_k=5)
    with pytest.raises(ValueError, match="top_p"):
        tspec.make_speculative_generate(tcfg, tdc, temperature=1.0,
                                        top_p=0.0)


def test_sampled_self_draft_accepts_everything(models):
    """Draft == target gives p == q, so ``u * q < p`` always accepts."""
    _, _, tcfg, tp = models["target"]
    gen = tspec.make_speculative_generate(tcfg, tcfg, k=4, temperature=1.0)
    got, calls = gen(tp, tp, [9, 8, 7], 15, rng=0)
    assert len(got) == 15
    assert calls <= 1 + -(-(15 - 1) // 5), calls


def test_sampled_deterministic_per_key_and_needs_rng(models):
    _, _, tcfg, tp = models["target"]
    _, _, tdc, tdp = models["draft"]
    gen = tspec.make_speculative_generate(tcfg, tdc, k=2, temperature=0.9,
                                          top_k=8, top_p=0.9)
    a = gen(tp, tdp, [1, 2, 3], 8, rng=5)[0]
    assert a == gen(tp, tdp, [1, 2, 3], 8, rng=5)[0] and len(a) == 8
    assert any(gen(tp, tdp, [1, 2, 3], 8, rng=s)[0] != a for s in (6, 7))
    with pytest.raises(ValueError, match="rng"):
        gen(tp, tdp, [1, 2, 3], 8)


@pytest.mark.parametrize("trunc", [{"top_k": 1}, {"top_p": 1e-6}])
def test_truncation_to_argmax_reproduces_greedy(models, trunc):
    """top_k=1, or a nucleus that only the argmax survives, makes the
    truncated target a point mass: sampled speculation must emit the
    target's greedy sequence for every seed."""
    jcfg, jp, tcfg, tp = models["target"]
    _, _, tdc, tdp = models["draft"]
    gen = tspec.make_speculative_generate(tcfg, tdc, k=3, temperature=1.0,
                                          **trunc)
    want = _jax_greedy(jcfg, jp, [3, 1, 4], 10)
    for seed in (0, 1, 2):
        assert gen(tp, tdp, [3, 1, 4], 10, rng=seed)[0] == want


def _first_emitted(p_rows, q_rows, n):
    """The first token that a round emits, for ``n`` keyed rounds over
    fixed ``p_rows [k+1, V]`` and ``q_rows [k, V]``: each round samples
    its ``k`` drafts from ``q_rows`` with ``fold(round, 0)`` and accepts
    with ``fold(round, 1)``."""
    k, v = q_rows.shape
    rounds = torch.arange(n)
    kd = keys.fold(keys.fold(rounds, 0)[:, None], torch.arange(k))
    drafts = (torch.log(q_rows.clamp_min(1e-30))
              + keys.gumbel(kd, v)).argmax(-1)               # [n, k]
    n_acc, extra = tspec.accept_resample(
        p_rows.expand(n, -1, -1), q_rows.expand(n, -1, -1), drafts,
        keys.fold(rounds, 1))
    first = torch.where(n_acc >= 1, drafts[:, 0], extra)
    return np.bincount(first.numpy(), minlength=v)


def test_accept_resample_emits_target_distribution():
    """Whatever q proposes, the first emitted token of a round follows
    p[0] (the reference's test at :180, a deliberately skewed draft)."""
    rng = np.random.default_rng(0)
    v, k, n = 5, 3, 4000
    p = rng.dirichlet(np.ones(v), size=k + 1).astype(np.float32)
    q = rng.dirichlet(np.ones(v) * 0.3, size=k).astype(np.float32)
    counts = _first_emitted(torch.from_numpy(p), torch.from_numpy(q), n)
    np.testing.assert_allclose(counts / n, p[0], atol=0.033)
    assert _chi2(counts, p[0]) > CHI2_P


def test_truncated_accept_resample_emits_truncated_target():
    """Both p and q truncated (top_p 0.9) and renormalised, as the
    decoder feeds them: the first emitted token follows the truncated
    target (the reference's test at :131), never outside its support."""
    rng = np.random.default_rng(1)
    v, k, n = 6, 3, 4000
    zp = torch.from_numpy(rng.normal(size=(k + 1, v)).astype(np.float32)) * 2
    zq = torch.from_numpy(rng.normal(size=(k, v)).astype(np.float32)) * 2
    p_rows = tdecode.truncated_probs(zp, 1.0, 0, 0.9)
    q_rows = tdecode.truncated_probs(zq, 1.0, 0, 0.9)
    np.testing.assert_allclose(
        p_rows.numpy(),
        np.asarray(jdecode.truncated_probs(jnp.asarray(zp.numpy()), 1.0, 0,
                                           0.9)), atol=1e-6)
    assert (p_rows[0] == 0).any()                    # truncation bit
    counts = _first_emitted(p_rows, q_rows, n)
    np.testing.assert_allclose(counts / n, p_rows[0].numpy(), atol=0.033)
    assert _chi2(counts, p_rows[0].numpy()) > CHI2_P


def test_accept_resample_float_guards():
    """p == q never rejects; a residual with no mass falls back to p; a
    batch of rounds equals the rounds one at a time."""
    p = torch.softmax(torch.randn(4, 7, generator=torch.Generator()
                                  .manual_seed(0)), -1)
    drafts = torch.tensor([1, 5, 2])
    for key in range(20):
        n_acc, extra = tspec.accept_resample(p, p[:3], drafts, key)
        assert int(n_acc) == 3 and 0 <= int(extra) < 7
    # q puts all its mass on the draft, p none: the residual is p itself
    q = torch.zeros(1, 7)
    q[0, 3] = 1.0
    p1 = torch.zeros(2, 7)
    p1[0, 6] = 1.0
    p1[1, 0] = 1.0
    n_acc, extra = tspec.accept_resample(p1, q, torch.tensor([3]), 9)
    assert (int(n_acc), int(extra)) == (0, 6)
    q2 = torch.softmax(torch.randn(5, 3, 7), -1)
    p2 = torch.softmax(torch.randn(5, 4, 7), -1)
    d2 = torch.randint(0, 7, (5, 3))
    ks = keys.fold(torch.arange(5), 3)
    n_b, e_b = tspec.accept_resample(p2, q2, d2, ks)
    for i in range(5):
        n_i, e_i = tspec.accept_resample(p2[i], q2[i], d2[i], ks[i])
        assert (int(n_b[i]), int(e_b[i])) == (int(n_i), int(e_i))


def test_sampled_generate_holds_truncated_target(models):
    """Sampled speculative decoding end to end: the second emitted token
    (the first a round emits) follows the truncated target marginal
    ``sum_t0 p(t0) p(. | prompt + t0)`` over 400 seeds."""
    _, _, tcfg, tp = models["target"]
    _, _, tdc, tdp = models["draft"]
    prompt, kw = [3, 1, 4], dict(temperature=1.0, top_k=3)
    gen = tspec.make_speculative_generate(tcfg, tdc, k=2, **kw)
    fwd = tmodel.make_forward(tcfg)

    def probs(seq):
        with torch.no_grad():
            logits = fwd(tp, torch.tensor([seq]))[0, -1]
        return tdecode.truncated_probs(logits[None], kw["temperature"],
                                       kw["top_k"], 1.0)[0].numpy()

    p0 = probs(prompt)
    marginal = sum(p0[t] * probs(prompt + [t]) for t in np.flatnonzero(p0))
    counts = np.zeros(tcfg.vocab)
    # 400 decodes of tiny tensors: one thread, so that parallel test
    # workers do not oversubscribe the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for seed in range(400):
            out, _ = gen(tp, tdp, prompt, 2, rng=seed)
            counts[out[1]] += 1
    finally:
        torch.set_num_threads(threads)
    assert _chi2(counts, marginal) > CHI2_P
