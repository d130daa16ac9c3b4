"""The torch port's dense decoder held against the JAX model on the same
weights: the JAX init (``PRNGKey(7)``) of the reduced TinyLlama config in
fp32, bridged with ``from_jax_params``.  Logits agree at atol 1e-4 (fp32;
the two frameworks sum in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.models import build_model, from_jax_params
from repro_torch.models import layers

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("tinyllama-1.1b").reduced().replace(dtype="float32")
    jmodel = jbuild_model(jcfg)
    jp, _ = jmodel.init(jax.random.PRNGKey(7))
    cfg = get_config("tinyllama-1.1b").reduced().replace(dtype="float32")
    model = build_model(cfg)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return jmodel, jp, model, tp


def test_layers_match_jax():
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal((16,)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None] + 100
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-6, atol=1e-6)
    ang = layers.rope_angles(torch.from_numpy(pos), 16, 10000.0)
    jang = jlayers.rope_angles(jnp.asarray(pos), 16, 10000.0)
    np.testing.assert_allclose(ang.numpy(), np.asarray(jang), rtol=1e-6)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), ang).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jang)),
        rtol=1e-5, atol=1e-5)


def test_bridge_splits_stacked_blocks(models):
    _, jp, model, tp = models
    assert len(tp.blocks) == model.cfg.n_layers
    for i, blk in enumerate(tp.blocks):
        np.testing.assert_array_equal(
            blk.attn.wq.numpy(), np.asarray(jp["blocks"]["attn"]["wq"][i]))
        np.testing.assert_array_equal(
            blk.ffn.wo.numpy(), np.asarray(jp["blocks"]["ffn"]["wo"][i]))
    np.testing.assert_array_equal(tp.lm_head.numpy(),
                                  np.asarray(jp["lm_head"]))
    assert not any(p.requires_grad for p in tp.parameters())


def test_logits_fn_matches_jax(models):
    jmodel, jp, model, tp = models
    tokens = np.random.RandomState(1).randint(
        0, model.cfg.vocab_size, size=(2, 12)).astype(np.int32)
    want, _ = jmodel.logits_fn(jp, {"tokens": jnp.asarray(tokens)})
    got, labels = model.logits_fn(tp, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, 12, model.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert labels.tolist() == tokens.tolist()


def test_decode_step_matches_jax(models):
    """Token-by-token decode through the contiguous cache, two rows at
    different lengths, against the JAX decode step; the last step's logits
    also equal the full forward's."""
    jmodel, jp, model, tp = models
    b, steps = 2, 9
    tokens = np.random.RandomState(2).randint(
        0, model.cfg.vocab_size, size=(b, steps)).astype(np.int32)
    shapes, _ = jmodel.init_cache(b, steps + 1)
    jcache = {k: jnp.zeros(s.shape, s.dtype) for k, s in shapes.items()}
    cache = model.init_cache(b, steps + 1, device="cpu")
    for t in range(steps):
        batch = {"tokens": tokens[:, t:t + 1],
                 "cache_len": np.full((b,), t + 1, np.int32)}
        jl, jcache = jmodel.decode_step(
            jp, jcache, {k: jnp.asarray(v) for k, v in batch.items()})
        tl, cache = model.decode_step(
            tp, cache, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               **TOL)
    full, _ = model.logits_fn(tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tl.numpy(), full[:, -1].numpy(), **TOL)


def test_seeded_init_is_deterministic_and_truncated():
    cfg = get_config("tinyllama-1.1b").reduced()
    model = build_model(cfg)
    a = model.init(seed=3, device="cpu")
    b = model.init(seed=3, device="cpu")
    c = model.init(seed=4, device="cpu")
    assert a.embed.dtype == torch.bfloat16
    assert torch.equal(a.blocks[1].attn.wk, b.blocks[1].attn.wk)
    assert not torch.equal(a.blocks[1].attn.wk, c.blocks[1].attn.wk)
    # fan-in scaled truncated normal on [-2, 2]
    w = a.blocks[0].ffn.wo.float()
    assert w.abs().max().item() <= 2.0 / np.sqrt(cfg.d_ff) * 1.01
    assert torch.equal(a.blocks[0].ln1, torch.ones(cfg.d_model,
                                                   dtype=torch.bfloat16))
    assert sum(p.numel() for p in a.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
            jbuild_model(jget_config("tinyllama-1.1b").reduced())
            .abstract_params()[0]))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-1.3b",
                                  "deepseek-v2-236b"])
def test_other_families_not_ported(arch):
    with pytest.raises(NotImplementedError, match="A.10"):
        build_model(get_config(arch).reduced())


def test_entry_points_default_to_the_card(monkeypatch):
    """``device=None`` means CUDA: without a card it raises instead of
    quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_config("tinyllama-1.1b").reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 8)
