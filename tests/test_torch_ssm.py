"""The torch port's Mamba2 (``ssm``) and Zamba2 (``hybrid``) models held
against the JAX models on the same weights: the JAX init (``PRNGKey(7)``)
of each reduced config in fp32, bridged with ``from_jax_params``.

The JAX init leaves ``a_log``, ``dt_bias``, ``d_skip`` and ``conv_b`` at
zero, where every head decays alike and the skip term vanishes; both trees
get the same seeded random values there first.  Logits and caches agree
at rtol = atol = 1e-4 (fp32; the frameworks sum in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd_scan as tss
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.params import MambaBlockParams

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["mamba2-1.3b", "zamba2-1.2b"]
PERTURBED = ("a_log", "dt_bias", "d_skip", "conv_b")


def perturb(tree, seed=0):
    """Seeded random values in place of the zero-initialised decay, skip
    and conv-bias leaves of a numpy parameter tree (in place)."""
    rng = np.random.RandomState(seed)
    blk = tree["blocks"]
    for name in PERTURBED:
        blk[name] = (rng.standard_normal(blk[name].shape) * 0.5).astype(
            blk[name].dtype)
    return tree


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    jcfg = jget_config(arch).reduced().replace(dtype="float32")
    jmodel = jbuild_model(jcfg)
    jp, _ = jmodel.init(jax.random.PRNGKey(7))
    tree = perturb(jax.tree_util.tree_map(np.asarray, jp))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    cfg = get_config(arch).reduced().replace(dtype="float32")
    model = build_model(cfg)
    return jmodel, jp, model, from_jax_params(tree, cfg, "cpu")


def test_bridge_splits_stacked_blocks(models):
    jmodel, jp, model, tp = models
    assert len(tp.blocks) == model.cfg.n_layers
    for i, blk in enumerate(tp.blocks):
        for name in MambaBlockParams.NAMES:
            np.testing.assert_array_equal(
                getattr(blk, name).numpy(), np.asarray(jp["blocks"][name][i]))
    if model.cfg.family == "hybrid":
        np.testing.assert_array_equal(tp.shared.attn.wq.numpy(),
                                      np.asarray(jp["shared"]["attn"]["wq"]))
        np.testing.assert_array_equal(tp.shared.ffn.wo.numpy(),
                                      np.asarray(jp["shared"]["ffn"]["wo"]))
        assert model.groups == jmodel.groups
    np.testing.assert_array_equal(tp.lm_head.numpy(),
                                  np.asarray(jp["lm_head"]))
    assert not any(p.requires_grad for p in tp.parameters())
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jp))
    assert sum(p.numel() for p in tp.parameters()) == n_jax


def test_logits_fn_matches_jax(models):
    """S = 40 is ragged against the reduced configs' SSD chunk (16) and
    attention chunk (32).  On CPU tensors no kernel launches."""
    jmodel, jp, model, tp = models
    tokens = np.random.RandomState(1).randint(
        0, model.cfg.vocab_size, size=(2, 40)).astype(np.int32)
    want, _ = jmodel.logits_fn(jp, {"tokens": jnp.asarray(tokens)})
    before = (tss.launches.count, tfa.launches.count)
    got, labels = model.logits_fn(tp, {"tokens": torch.from_numpy(tokens)})
    assert (tss.launches.count, tfa.launches.count) == before
    assert got.shape == (2, 40, model.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert labels.tolist() == tokens.tolist()


def test_decode_step_matches_jax(models):
    """Nine decode steps against the JAX decode step: logits and every
    cache tensor after each step."""
    jmodel, jp, model, tp = models
    b, steps = 2, 9
    tokens = np.random.RandomState(2).randint(
        0, model.cfg.vocab_size, size=(b, steps)).astype(np.int32)
    shapes, _ = jmodel.init_cache(b, steps + 1)
    jcache = {k: jnp.zeros(s.shape, s.dtype) for k, s in shapes.items()}
    cache = model.init_cache(b, steps + 1, device="cpu")
    assert sorted(cache) == sorted(jcache)
    for k in cache:
        assert tuple(cache[k].shape) == jcache[k].shape
    for t in range(steps):
        batch = {"tokens": tokens[:, t:t + 1],
                 "cache_len": np.full((b,), t + 1, np.int32)}
        jl, jcache = jmodel.decode_step(
            jp, jcache, {k: jnp.asarray(v) for k, v in batch.items()})
        tl, cache = model.decode_step(
            tp, cache, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for k in cache:
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(jcache[k]), **TOL,
                                       err_msg=f"cache {k!r} at step {t}")


def test_incremental_decode_matches_own_forward(models):
    """Token-by-token decode through the cache reproduces the port's full
    forward at every position (``tests/test_models_smoke.py``'s check)."""
    _, _, model, tp = models
    b, s = 2, 8
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, model.cfg.vocab_size, size=(b, s)).astype(np.int64))
    full, _ = model.logits_fn(tp, {"tokens": tokens})
    cache = model.init_cache(b, s, device="cpu")
    for t in range(s):
        logits, cache = model.decode_step(tp, cache, {
            "tokens": tokens[:, t:t + 1],
            "cache_len": torch.full((b,), t + 1, dtype=torch.int32)})
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3,
                                   err_msg=f"diverges at t={t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_seeded_init_follows_the_reference_scheme(arch):
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    a = model.init(seed=3, device="cpu")
    b = model.init(seed=3, device="cpu")
    c = model.init(seed=4, device="cpu")
    assert a.embed.dtype == torch.bfloat16
    assert torch.equal(a.blocks[1].in_proj, b.blocks[1].in_proj)
    assert not torch.equal(a.blocks[1].in_proj, c.blocks[1].in_proj)
    blk = a.blocks[0]
    for name in PERTURBED:
        assert torch.count_nonzero(getattr(blk, name)) == 0, name
    assert torch.equal(blk.out_norm, torch.ones_like(blk.out_norm))
    # fan-in scaled truncated normal on [-2, 2]: conv_w's fan-in is W
    assert blk.conv_w.float().abs().max().item() <= \
        2.0 / np.sqrt(cfg.ssm_conv_width) * 1.01
    shapes, _ = jbuild_model(jget_config(arch).reduced()).abstract_params()
    assert sum(p.numel() for p in a.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_default_to_the_card(monkeypatch, arch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_config(arch).reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 8)
