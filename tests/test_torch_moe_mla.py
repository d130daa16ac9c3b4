"""The torch port's MoE and MLA decoders held against the JAX models on the
same weights: the JAX init (``PRNGKey(7)``) of the reduced OLMoE-1B-7B
(8 experts top-2) and DeepSeek-V2 (MLA, a dense first layer, 8 experts
top-2 + 1 shared) configs in fp32, bridged with ``from_jax_params``.

Logits, decode steps and every decode cache tensor agree at rtol = atol =
1e-4 (fp32; the two frameworks sum in different orders).  The MoE FFN
alone drops the same tokens as the reference at a capacity that drops
some (its keep mask equal to the reference's) and agrees at 1e-5; the MLA
absorbed decode agrees in its output and both latent caches; the flash
kernel's plain version at D = 192 (DeepSeek-V2's nope 128 + rope 64, V
padded) agrees with the reference's ``blockwise_attention``."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import build_model, from_jax_params
from repro_torch.models import mla, moe

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["olmoe-1b-7b", "deepseek-v2-236b"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = jget_config(arch).reduced().replace(dtype="float32")
    jmodel = jbuild_model(jcfg)
    jp, _ = jmodel.init(jax.random.PRNGKey(7))
    cfg = get_config(arch).reduced().replace(dtype="float32")
    model = build_model(cfg)
    tp = from_jax_params(_np_tree(jp), cfg, "cpu")
    return jmodel, jp, model, tp


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _models(request.param)


def _ffn_tree(jp, cfg):
    """The first MoE block's FFN subtree of the JAX parameters."""
    return jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["ffn"])


def test_bridge_and_init_follow_the_reference(models):
    jmodel, jp, model, tp = models
    cfg = model.cfg
    assert len(tp.head_blocks) == cfg.first_dense_layers
    assert len(tp.blocks) == cfg.n_layers - cfg.first_dense_layers
    for i, blk in enumerate(tp.head_blocks):
        jb = jp[f"head_block_{i}"]
        for name, t in blk.attn.named_parameters():
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(jb["attn"][name]))
    for i, blk in enumerate(tp.blocks):
        for name, t in blk.ffn.named_parameters():
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(jp["blocks"]["ffn"][name][i]))
    n_jax = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(jp))
    assert sum(p.numel() for p in tp.parameters()) == n_jax
    seeded = model.init(seed=0, device="cpu")
    assert [tuple(p.shape) for p in seeded.parameters()] == \
        [tuple(p.shape) for p in tp.parameters()]
    # expert weights are fan-in scaled by their first (expert) dim, as the
    # reference scales every leaf
    wi = seeded.blocks[0].ffn.wi_gate
    assert wi.abs().max().item() <= 2.0 / math.sqrt(cfg.n_experts) * 1.01


def test_logits_fn_matches_jax(models):
    jmodel, jp, model, tp = models
    tokens = np.random.RandomState(1).randint(
        0, model.cfg.vocab_size, size=(2, 24)).astype(np.int32)
    want, _ = jmodel.logits_fn(jp, {"tokens": jnp.asarray(tokens)})
    got, labels = model.logits_fn(tp, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, 24, model.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert labels.tolist() == tokens.tolist()


def test_decode_step_and_caches_match_jax(models):
    """Token-by-token decode at B = 2 (capacity 1: the decode dispatch
    drops tokens in both) against the JAX decode step, every cache entry
    (head and tail, k/v or the MLA latents) compared at the end."""
    jmodel, jp, model, tp = models
    b, steps = 2, 6
    tokens = np.random.RandomState(2).randint(
        0, model.cfg.vocab_size, size=(b, steps)).astype(np.int32)
    shapes, _ = jmodel.init_cache(b, steps + 1)
    jcache = {k: jnp.zeros(s.shape, s.dtype) for k, s in shapes.items()}
    cache = model.init_cache(b, steps + 1, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(s.shape) for k, s in shapes.items()}
    jstep = jax.jit(jmodel.decode_step)
    for t in range(steps):
        batch = {"tokens": tokens[:, t:t + 1],
                 "cache_len": np.full((b,), t + 1, np.int32)}
        jl, jcache = jstep(
            jp, jcache, {k: jnp.asarray(v) for k, v in batch.items()})
        tl, cache = model.decode_step(
            tp, cache, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name, want in jcache.items():
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(want),
                                   **TOL, err_msg=name)


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_moe_ffn_drops_the_reference_tokens(models, capacity_factor):
    """``apply_moe_ffn`` alone at T = 48 tokens: at capacity factor 0.5
    (and 1.25 on these random weights) some (token, expert) choices
    overflow their expert; the keep mask equals the one the reference's
    dispatch computes, and the outputs agree at 1e-5."""
    jmodel, jp, model, tp = models
    cfg = model.cfg.replace(capacity_factor=capacity_factor)
    jcfg = jmodel.cfg.replace(capacity_factor=capacity_factor)
    x = np.random.RandomState(3).standard_normal(
        (3, 16, cfg.d_model)).astype(np.float32)
    jffn = _ffn_tree(jp, jcfg)
    want = jmoe.apply_moe_ffn(jffn, jcfg, jnp.asarray(x))
    got = moe.apply_moe_ffn(tp.blocks[0].ffn, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the reference's keep mask, by its own dispatch arithmetic
    t, e, k = 48, jcfg.n_experts, jcfg.top_k
    cap = max(int(t * k * jcfg.capacity_factor / e), 1)
    xf = jnp.asarray(x).reshape(t, -1)
    gates = jax.nn.softmax(xf @ jffn["router"], axis=-1)
    _, tope = jax.lax.top_k(gates, k)
    oh = jax.nn.one_hot(tope, e, dtype=jnp.int32).reshape(t * k, e)
    pos = ((jnp.cumsum(oh, axis=0) * oh).sum(-1) - 1).reshape(t, k)
    jkeep = np.asarray((pos < cap) & (pos >= 0))
    _, tope_t, _, keep = moe.route(tp.blocks[0].ffn, cfg,
                                   torch.from_numpy(x).reshape(t, -1))
    assert tope_t.tolist() == np.asarray(tope).tolist()
    assert keep.tolist() == jkeep.tolist()
    assert moe.capacity(cfg, t) == cap
    if capacity_factor < 1:
        assert not jkeep.all(), "no token was dropped"


def test_mla_decode_matches_jax():
    """The absorbed MLA decode of one token per row against the reference:
    the output and both latent caches, rows at different cache lengths."""
    jmodel, jp, model, tp = _models("deepseek-v2-236b")
    jcfg, cfg = jmodel.cfg, model.cfg
    p = tp.head_blocks[0].attn
    ja = jp["head_block_0"]["attn"]
    rng = np.random.RandomState(4)
    b, s = 3, 10
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((b, s, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((b, s, cfg.rope_head_dim)).astype(np.float32)
    cache_len = np.array([3, 10, 7], np.int32)
    positions = (cache_len - 1)[:, None]
    jout, jckv, jkr = jmla.mla_attention_decode(
        ja, jcfg, jnp.asarray(x), jnp.asarray(ckv), jnp.asarray(kr),
        jnp.asarray(cache_len), jnp.asarray(positions))
    out, tckv, tkr = mla.mla_attention_decode(
        p, cfg, torch.from_numpy(x), torch.from_numpy(ckv.copy()),
        torch.from_numpy(kr.copy()), torch.from_numpy(cache_len),
        torch.from_numpy(positions))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tckv.numpy(), np.asarray(jckv), **TOL)
    np.testing.assert_allclose(tkr.numpy(), np.asarray(jkr), **TOL)


@pytest.mark.parametrize("h,hkv,s", [(4, 4, 40), (2, 1, 70)])
def test_flash_plain_at_head_dim_192_matches_jax(h, hkv, s):
    """DeepSeek-V2's prefill attention shape (the reduced config reaches
    only D = 24): nope 128 + rope 64, V padded from 128 with zeros, scale
    1 / sqrt(192), against the reference's ``blockwise_attention``."""
    rng = np.random.RandomState(5)
    q = rng.standard_normal((2, s, h, 192)).astype(np.float32)
    k = rng.standard_normal((2, s, hkv, 192)).astype(np.float32)
    v = rng.standard_normal((2, s, hkv, 192)).astype(np.float32)
    v[..., 128:] = 0.0
    want = jlayers.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        chunk=32, softmax_scale=1.0 / math.sqrt(192))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)
    assert np.all(got.numpy()[..., 128:] == 0.0)
