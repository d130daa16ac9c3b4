"""The torch port's counter PRNG, sampler and speculative accept rule on
the CPU, held against the JAX package on identical inputs.

* Keys and bits: ``sample_key_ref`` (JAX's ``PRNGKey(0)`` + ``fold_in``
  chain), ``random_bits`` and ``uniform`` are held BIT-EQUAL to
  ``jax.random`` over a grid of seed x position x stream.  Integer steps
  are exact in both frameworks, so any difference is a fault.
* ``gumbel`` is -log(-log(u)): the two ``log`` implementations (XLA's on
  the CPU, PyTorch's) may differ in the last bit, so a gumbel draw is held
  within ``GUMBEL_ULPS`` ulp of max(|g|, 1) (an ulp of the inner log
  moves a draw near 0 by that much in absolute terms).
* ``filtered_dist_ref`` within ``DIST_TOL`` over temperature / top-k /
  top-p, with tied logits and a top-p boundary the two frameworks compute
  exactly; ``sample_tokens`` tokens equal and logprobs within ``LP_TOL``.
* ``spec_verify_rows`` tokens and ``n_emit`` equal, logprobs within
  ``LP_TOL``, plus the four algebraic cases of the JAX package's own
  tests (``tests/test_sampling.py``: identical dists accept all, disjoint
  dists reject at 0, zero drafts are a plain sample, a greedy chain).
* ``derive_draft`` shares the target's tensors and raises the reference's
  errors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.registry import derive_draft

SEEDS = (0, 1, 2**31 - 1, 2**32 - 1)
POSITIONS = (0, 1, 7, 1023, 2**20)
STREAMS = (0, 1, 2, 3)
GUMBEL_ULPS = 4
DIST_TOL = 1e-6
LP_TOL = 1e-5
V = 512


def _jkey(seed, pos, stream):
    return np.asarray(jref.sample_key_ref(seed, pos, stream)).astype(
        np.int64)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pos", POSITIONS)
def test_sample_keys_bit_equal_to_jax(seed, pos):
    k1, k2 = tref.sample_key_ref(torch.tensor([seed] * 4),
                                 torch.tensor([pos] * 4),
                                 torch.tensor(STREAMS))
    for i, stream in enumerate(STREAMS):
        assert [int(k1[i]), int(k2[i])] == _jkey(seed, pos, stream).tolist()


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_and_uniform_bit_equal_to_jax(seed):
    for pos in POSITIONS:
        for stream in STREAMS:
            jk = jref.sample_key_ref(seed, pos, stream)
            tk = tref.sample_key_ref(seed, pos, stream)
            want = np.asarray(jax.random.bits(jk, (V,))).astype(np.int64)
            assert np.array_equal(tref.random_bits(tk, V).numpy(), want)
            np.testing.assert_array_equal(
                tref.uniform(tk, V).numpy(),
                np.asarray(jax.random.uniform(jk, (V,))))
            assert float(tref.uniform(tk)) == float(jax.random.uniform(jk))


def test_prng_key_and_fold_in_match_jax():
    assert [int(w) for w in tref.prng_key(0)] == \
        np.asarray(jax.random.PRNGKey(0)).tolist()
    key = tref.prng_key(0)
    jkey = jax.random.PRNGKey(0)
    for data in (0, 5, 2**32 - 1):
        key = tref.fold_in(key, tref._u32(data))
        jkey = jax.random.fold_in(jkey, jnp.asarray(data, jnp.uint32))
        assert [int(w) for w in key] == np.asarray(jkey).tolist()


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_ulps_of_jax(seed):
    for pos in (0, 1023):
        for stream in (0, 3):
            want = np.asarray(jax.random.gumbel(
                jref.sample_key_ref(seed, pos, stream), (4096,)))
            got = tref.gumbel(tref.sample_key_ref(seed, pos, stream),
                              4096).numpy()
            ulp = np.spacing(np.maximum(np.abs(want), 1.0)
                             .astype(np.float32))
            assert np.all(np.abs(got - want) <= GUMBEL_ULPS * ulp)


def _logits(rows, seed=0, v=V):
    rng = np.random.RandomState(seed)
    lg = (rng.standard_normal((rows, v)) * 3).astype(np.float32)
    lg[0, [5, 9, 11]] = lg[0].max() + 1.0       # a three-way tie at the top
    lg[1, :40] = 2.5                            # a long tie across top-k
    return lg


OPERANDS = [
    # (temperature, top_k, top_p) per row of a batch of 4
    ((0.0, 0.8, 1.5, 0.3), (0, 0, 0, 0), (1.0, 1.0, 1.0, 1.0)),
    ((0.8, 0.8, 0.9, 1.0), (1, 20, 40, 512), (1.0, 1.0, 1.0, 1.0)),
    ((0.8, 0.8, 0.9, 1.0), (0, 0, 0, 0), (0.9, 0.5, 0.01, 0.99)),
    ((0.7, 1.3, 0.0, 0.9), (50, 3, 50, 0), (0.9, 0.6, 0.9, 0.75)),
]


@pytest.mark.parametrize("temps,top_k,top_p", OPERANDS)
def test_filtered_dist_matches_jax(temps, top_k, top_p):
    lg = _logits(4)
    want = jax.vmap(jref.filtered_dist_ref)(
        jnp.asarray(lg), jnp.asarray(temps, jnp.float32),
        jnp.asarray(top_k, jnp.int32), jnp.asarray(top_p, jnp.float32))
    got = tref.filtered_dist_ref(torch.from_numpy(lg), temps, top_k, top_p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=DIST_TOL)
    # the supports agree, except for tokens whose preceding mass lies
    # within rounding of top_p (the cumulative sums round differently)
    for r, c in np.argwhere((got.numpy() > 0) != (np.asarray(want) > 0)):
        t = temps[r] if temps[r] > 0 else 1.0
        probs = np.asarray(jax.nn.softmax(jnp.asarray(lg[r] / t)),
                           np.float64)
        order = np.argsort(-probs, kind="stable")
        before = np.cumsum(probs[order]) - probs[order]
        assert abs(before[np.flatnonzero(order == c)[0]] - top_p[r]) < 1e-5


def test_top_p_boundary_is_exact():
    """probs (1/2, 1/4, 1/8, 1/8) are exact in fp32, so the mass before
    each token is exact in both frameworks: top_p = 0.75 keeps the first
    two (mass before the third is exactly 0.75, not < 0.75)."""
    lg = np.log(np.asarray([[0.5, 0.25, 0.125, 0.125]], np.float32))
    for p, n_kept in ((0.75, 2), (0.7500001, 3), (0.5, 1), (0.5000001, 2)):
        got = tref.filtered_dist_ref(torch.from_numpy(lg), [1.0], [0], [p])
        want = jref.filtered_dist_ref(jnp.asarray(lg[0]), 1.0, 0, p)
        assert int((got.numpy() > 0).sum()) == n_kept
        assert np.array_equal(got.numpy()[0] > 0, np.asarray(want) > 0)


@pytest.mark.parametrize("temps,top_k,top_p", OPERANDS)
def test_sample_tokens_match_jax(temps, top_k, top_p):
    lg = _logits(4, seed=1, v=32000)
    seeds, pos = [0, 7, 2**31 - 1, 123], [3, 1023, 17, 2**20]
    jt, jl = jref.sample_tokens_ref(
        jnp.asarray(lg), jnp.asarray(temps, jnp.float32),
        jnp.asarray(top_k, jnp.int32), jnp.asarray(top_p, jnp.float32),
        jnp.asarray(seeds, jnp.int32), jnp.asarray(pos, jnp.int32))
    tt, tl = ops.sample_tokens(torch.from_numpy(lg), temps, top_k, top_p,
                               seeds, pos)
    assert tt.tolist() == np.asarray(jt).tolist()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LP_TOL)
    greedy = np.asarray(temps) <= 0
    assert np.all(tl.numpy()[greedy] == 0.0)


def test_all_greedy_shortcut_equals_full_formula():
    lg = torch.from_numpy(_logits(3, seed=2))
    ops_args = ([0.0, -1.0, 0.0], [5, 0, 0], [0.5, 1.0, 1.0], [1, 2, 3],
                [4, 5, 6])
    short = ops.sample_tokens(lg, *ops_args)
    full = tref.sample_tokens_ref(lg, *ops_args)
    assert short[0].tolist() == full[0].tolist() == \
        torch.argmax(lg, dim=-1).tolist()
    assert short[1].tolist() == full[1].tolist() == [0.0] * 3


def _softmax_rows(rng, *shape):
    return np.array(jax.nn.softmax(jnp.asarray(
        rng.standard_normal(shape) * 2, jnp.float32)))


@pytest.mark.parametrize("n_draft", [(0, 1, 2, 3), (3, 3, 3, 3),
                                     (2, 0, 3, 1)])
def test_spec_verify_rows_match_jax(n_draft):
    rng = np.random.RandomState(sum(n_draft))
    b, k, v = 4, 3, 64
    p = _softmax_rows(rng, b, k + 1, v)
    q = _softmax_rows(rng, b, k, v)
    # half the drafts are q's own argmax (likely accepted), half random
    draft = np.where(rng.rand(b, k) < 0.5, q.argmax(-1),
                     rng.randint(0, v, (b, k))).astype(np.int32)
    seed = np.asarray([0, 9, 2**31 - 1, 77], np.int32)
    base = np.asarray([5, 1023, 40, 2**20], np.int32)
    jt, jn, jl = jref.spec_verify_rows_ref(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(draft),
        jnp.asarray(n_draft, jnp.int32), jnp.asarray(seed),
        jnp.asarray(base))
    tt, tn, tl = ops.spec_verify_rows(
        torch.from_numpy(p), torch.from_numpy(q), torch.from_numpy(draft),
        n_draft, seed, base)
    assert tn.tolist() == np.asarray(jn).tolist()
    assert tt.tolist() == np.asarray(jt).tolist()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LP_TOL)


def _verify_one(p, q, draft, n_draft, seed, base):
    """One row through the batched port (the JAX unit tests' single-row
    ``spec_verify_ref``)."""
    t, n, lp = tref.spec_verify_rows_ref(
        torch.as_tensor(p)[None], torch.as_tensor(q)[None],
        torch.as_tensor(draft)[None], [n_draft], [seed], [base])
    return t[0], int(n[0]), lp[0]


def test_spec_verify_identical_dists_accept_all():
    """q == p accepts every live proposal (u * p < p for u in [0,1))
    and the bonus token comes from p[n_draft] via the RESIDUAL stream."""
    rng = np.random.RandomState(2)
    k = 3
    p = torch.softmax(torch.from_numpy(rng.randn(k + 1, 16)
                                       .astype(np.float32)), dim=-1)
    draft = torch.tensor([1, 5, 9])
    toks, n_emit, lps = _verify_one(p, p[:k], draft, 3, 11, 100)
    assert n_emit == k + 1
    assert toks[:k].tolist() == [1, 5, 9]
    bonus, _ = tref.gumbel_pick_ref(p[k][None], tref.sample_key_ref(
        torch.tensor([11]), torch.tensor([100 + k]), tref.STREAM_RESIDUAL))
    assert int(toks[k]) == int(bonus[0])
    np.testing.assert_allclose(lps[:k].numpy(),
                               np.log(p[torch.arange(k), draft].numpy()),
                               rtol=1e-5)


def test_spec_verify_disjoint_dists_reject_first():
    """p puts zero mass on the draft's token: rejected at j=0 and the
    correction comes from the residual max(p - q, 0) ∝ p."""
    p = torch.zeros((3, 8))
    p[:, 2] = 1.0
    q = torch.zeros((2, 8))
    q[:, 5] = 1.0
    toks, n_emit, _ = _verify_one(p, q, torch.tensor([5, 5]), 2, 0, 0)
    assert n_emit == 1
    assert int(toks[0]) == 2          # residual is one-hot at 2


def test_spec_verify_zero_draft_is_plain_sample():
    """n_draft == 0 degenerates to one sampled token from p[0] — keyed
    on the RESIDUAL stream at base_pos."""
    rng = np.random.RandomState(3)
    p = torch.softmax(torch.from_numpy(rng.randn(3, 16).astype(np.float32)),
                      dim=-1)
    toks, n_emit, _ = _verify_one(p, torch.zeros((2, 16)),
                                  torch.zeros(2, dtype=torch.int64), 0, 21,
                                  55)
    assert n_emit == 1
    want, _ = tref.gumbel_pick_ref(p[0][None], tref.sample_key_ref(
        torch.tensor([21]), torch.tensor([55]), tref.STREAM_RESIDUAL))
    assert int(toks[0]) == int(want[0])


def test_spec_verify_greedy_chain_matches_argmax():
    """One-hot p and q (the greedy sentinel dists): a draft that matches
    p's argmax chain is fully accepted; a mismatch at j corrects to p's
    argmax — SPEC GREEDY is exact, never approximate."""
    argmaxes = [3, 6, 1]
    p = torch.zeros((3, 8))
    for j, a in enumerate(argmaxes):
        p[j, a] = 1.0
    toks, n_emit, _ = _verify_one(p, p[:2], torch.tensor([3, 6]), 2, 0, 0)
    assert n_emit == 3 and toks.tolist() == argmaxes
    q_miss = torch.zeros((2, 8))
    q_miss[0, 4] = 1.0
    q_miss[1, 6] = 1.0
    toks, n_emit, _ = _verify_one(p, q_miss, torch.tensor([4, 6]), 2, 0, 0)
    assert n_emit == 1 and int(toks[0]) == 3


# ------------------------------------------------------------ the draft


@pytest.fixture(scope="module")
def target():
    jcfg = jget_config("tinyllama-1.1b").reduced().replace(dtype="float32")
    jp, _ = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config("tinyllama-1.1b").reduced().replace(dtype="float32")
    return build_model(cfg), from_jax_params(
        jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")


def test_derive_draft_shares_the_targets_tensors(target):
    model, params = target
    cfg = model.cfg
    draft, dp = derive_draft(model, params)
    assert draft.cfg.n_layers == max(1, cfg.n_layers // 2)
    assert len(dp.blocks) == draft.cfg.n_layers
    for name in ("embed", "final_norm", "lm_head"):
        assert getattr(dp, name).data_ptr() == \
            getattr(params, name).data_ptr()
    for db, tb in zip(dp.blocks, params.blocks):
        assert db is tb
    draft1, dp1 = derive_draft(model, params, n_layers=1)
    assert draft1.cfg.n_layers == 1 and len(dp1.blocks) == 1


def test_derive_draft_raises_the_reference_errors(target):
    model, params = target
    with pytest.raises(ValueError, match="spec_draft"):
        derive_draft(model, params, spec_draft="trained")
    with pytest.raises(ValueError, match="exceeds"):
        derive_draft(model, params, n_layers=model.cfg.n_layers + 1)
