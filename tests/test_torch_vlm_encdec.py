"""The torch port's Qwen2-VL (``vlm``) decoder and Whisper (``encdec``)
encoder-decoder held against the JAX models on the same weights: the JAX
init (``PRNGKey(7)``) of each reduced config in fp32, bridged with
``from_jax_params``.

The JAX init leaves every LayerNorm scale at one and every bias at zero,
where a bias or a scale bridged to the wrong leaf would not show; both
trees get the same seeded random values in every norm scale and bias
first.  Logits,
labels, decode steps and every decode cache tensor agree at rtol = atol =
1e-4 (fp32; the frameworks sum in different orders), as do the four new
primitives (``layer_norm``, ``mrope_angles``, ``sinusoidal_positions``,
``gelu_mlp``).  The inputs the JAX models take from stubs (Whisper's
frames, Qwen2-VL's patch embeddings and M-RoPE positions, the cross-
attention cache) are made with numpy and handed to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import build_model, from_jax_params, layers

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["qwen2-vl-72b", "whisper-base"]


SCALES = ("ln1", "ln2", "final_norm")     # and every "*_s" leaf
BIASES = ("bi", "bo")                      # and every "*_b" leaf


def perturb(tree, seed=0):
    """Seeded random values in place of every norm scale (near one) and
    bias (near zero) of a numpy parameter tree, in place."""
    rng = np.random.RandomState(seed)

    def walk(node):
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                walk(leaf)
            elif name in SCALES or name.endswith("_s"):
                node[name] = (1.0 + 0.3 * rng.standard_normal(leaf.shape)
                              ).astype(leaf.dtype)
            elif name in BIASES or name.endswith("_b"):
                node[name] = (0.3 * rng.standard_normal(leaf.shape)
                              ).astype(leaf.dtype)
    walk(tree)
    return tree


def _models(arch):
    jcfg = jget_config(arch).reduced().replace(dtype="float32")
    jmodel = jbuild_model(jcfg)
    jp, _ = jmodel.init(jax.random.PRNGKey(7))
    tree = perturb(jax.tree_util.tree_map(np.asarray, jp))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    cfg = get_config(arch).reduced().replace(dtype="float32")
    return jmodel, jp, build_model(cfg), from_jax_params(tree, cfg, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _models(request.param)


@pytest.fixture(scope="module")
def vlm():
    return _models("qwen2-vl-72b")


@pytest.fixture(scope="module")
def whisper():
    return _models("whisper-base")


STACKS = ("blocks", "enc_blocks", "dec_blocks")


def _jax_leaf(jp, name):
    """The JAX leaf behind the port's parameter ``name``: ``blocks.3.x.y``
    is layer 3 of the stacked ``blocks/x/y`` (likewise Whisper's two
    stacks), any other name the leaf at the same path."""
    parts = name.split(".")
    node = jp[parts[0]]
    rest = parts[2:] if parts[0] in STACKS else parts[1:]
    for part in rest:
        node = node[part]
    return np.asarray(node)[int(parts[1])] if parts[0] in STACKS \
        else np.asarray(node)


# ------------------------------------------------------------ primitives


def test_layer_norm_matches_jax_with_population_variance():
    rng = np.random.RandomState(0)
    x = (rng.standard_normal((3, 5, 64)) * 2 + 0.7).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jlayers.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                         jnp.asarray(bias)))
    got = layers.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                            torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the unbiased variance (torch's default) is another function here
    xt = torch.from_numpy(x)
    unbiased = (xt - xt.mean(-1, keepdim=True)) * torch.rsqrt(
        xt.var(-1, keepdim=True) + 1e-5) * torch.from_numpy(scale) + \
        torch.from_numpy(bias)
    assert not np.allclose(unbiased.numpy(), want, **TOL)
    # bf16 in, bf16 out, fp32 inside
    xb = torch.from_numpy(x).bfloat16()
    out = layers.layer_norm(xb, torch.from_numpy(scale).bfloat16(),
                            torch.from_numpy(bias).bfloat16())
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("sections,theta", [((2, 3, 3), 1e6),
                                            ((16, 24, 24), 1e6),
                                            ((4, 2, 2), 1e4)])
def test_mrope_angles_match_jax(sections, theta):
    head_dim = 2 * sum(sections)
    pos = np.random.RandomState(1).randint(0, 5000, size=(2, 7, 3)).astype(
        np.int32)
    want = np.asarray(jlayers.mrope_angles(jnp.asarray(pos), head_dim,
                                           sections, theta))
    got = layers.mrope_angles(torch.from_numpy(pos), head_dim, sections,
                              theta)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # t = h = w = i gives plain rope at the same theta
    same = np.repeat(np.arange(9, dtype=np.int32)[None, :, None], 3, -1)
    np.testing.assert_allclose(
        layers.mrope_angles(torch.from_numpy(same), head_dim, sections,
                            theta).numpy(),
        layers.rope_angles(torch.arange(9)[None], head_dim, theta).numpy(),
        rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="must sum"):
        layers.mrope_angles(torch.from_numpy(pos), head_dim + 2, sections)


@pytest.mark.parametrize("seq_len,dim", [(13, 64), (1500, 512)])
def test_sinusoidal_positions_match_jax(seq_len, dim):
    want = np.asarray(jlayers.sinusoidal_positions(seq_len, dim))
    got = layers.sinusoidal_positions(seq_len, dim)
    assert got.shape == (seq_len, dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    # [sin | cos] side by side: the first half at position 0 is all 0
    assert np.all(got.numpy()[0, :dim // 2] == 0.0)
    assert np.all(got.numpy()[0, dim // 2:] == 1.0)


def test_gelu_mlp_matches_jax_tanh_gelu_not_erf():
    rng = np.random.RandomState(2)
    x = (rng.standard_normal((2, 6, 32)) * 2).astype(np.float32)
    wi = rng.standard_normal((32, 48)).astype(np.float32)
    bi = rng.standard_normal(48).astype(np.float32)
    wo = rng.standard_normal((48, 32)).astype(np.float32)
    bo = rng.standard_normal(32).astype(np.float32)
    want = np.asarray(jlayers.gelu_mlp(*(jnp.asarray(a)
                                         for a in (x, wi, bi, wo, bo))))
    t = [torch.from_numpy(a) for a in (x, wi, bi, wo, bo)]
    np.testing.assert_allclose(layers.gelu_mlp(*t).numpy(), want, **TOL)
    erf = F.gelu(t[0] @ t[1] + t[2]) @ t[3] + t[4]
    assert not np.allclose(erf.numpy(), want, **TOL), \
        "erf-GELU should miss the reference's tanh GELU at 1e-4"


# ---------------------------------------------------------------- bridge


def test_bridge_copies_every_leaf(models):
    """Every parameter of the port is the JAX leaf at its path (stacked
    leaves split per layer), and nothing else is there; the seeded init
    has the same shapes."""
    jmodel, jp, model, tp = models
    for name, t in tp.named_parameters():
        np.testing.assert_array_equal(t.numpy(), _jax_leaf(jp, name),
                                      err_msg=name)
    assert sum(p.numel() for p in tp.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jp))
    assert not any(p.requires_grad for p in tp.parameters())
    seeded = model.init(seed=0, device="cpu")
    assert [(n, tuple(p.shape)) for n, p in seeded.named_parameters()] == \
        [(n, tuple(p.shape)) for n, p in tp.named_parameters()]
    cfg = model.cfg
    if cfg.family == "vlm":
        assert tp.vision_proj.shape == (cfg.vision_embed_dim, cfg.d_model)
    else:
        assert (len(tp.enc_blocks), len(tp.dec_blocks)) == \
            (cfg.enc_layers, cfg.dec_layers)


# ------------------------------------------------------------- Qwen2-VL


def _vlm_batch(cfg, b=2, s_vis=6, s_text=10, seed=3):
    rng = np.random.RandomState(seed)
    s = s_vis + s_text
    # a 2 x 3 patch grid at t = 0, then text at 3 + i on every axis
    grid = np.stack([np.zeros(s_vis), np.arange(s_vis) // 3,
                     np.arange(s_vis) % 3], -1)
    text = np.repeat((3 + np.arange(s_text))[:, None], 3, -1)
    pos = np.broadcast_to(np.concatenate([grid, text]), (b, s, 3))
    return {"tokens": rng.randint(0, cfg.vocab_size, (b, s_text))
            .astype(np.int32),
            "patch_embeds": rng.standard_normal(
                (b, s_vis, cfg.vision_embed_dim)).astype(np.float32),
            "positions_thw": np.ascontiguousarray(pos).astype(np.int32)}


def test_vlm_logits_fn_with_vision_rows_matches_jax(vlm):
    jmodel, jp, model, tp = vlm
    batch = _vlm_batch(model.cfg)
    want, wlabels = jmodel.logits_fn(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got, labels = model.logits_fn(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (2, 16, model.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert labels.tolist() == np.asarray(wlabels).tolist()
    assert labels[:, :6].eq(-1).all()
    assert labels[:, 6:].tolist() == batch["tokens"].tolist()


def test_vlm_decode_step_and_caches_match_jax(vlm):
    """Token-by-token decode at B = 2 with numpy-made M-RoPE positions
    that differ per axis, against the JAX decode step; every cache
    tensor compared at the end."""
    jmodel, jp, model, tp = vlm
    b, steps = 2, 6
    rng = np.random.RandomState(4)
    tokens = rng.randint(0, model.cfg.vocab_size, (b, steps)).astype(
        np.int32)
    thw = rng.randint(0, 40, (b, steps, 3)).astype(np.int32)
    shapes, _ = jmodel.init_cache(b, steps + 1)
    jcache = {k: jnp.zeros(s.shape, s.dtype) for k, s in shapes.items()}
    cache = model.init_cache(b, steps + 1, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(s.shape) for k, s in shapes.items()}
    jstep = jax.jit(jmodel.decode_step)
    for t in range(steps):
        batch = {"tokens": tokens[:, t:t + 1],
                 "cache_len": np.full((b,), t + 1, np.int32),
                 "positions_thw": thw[:, t:t + 1]}
        jl, jcache = jstep(
            jp, jcache, {k: jnp.asarray(v) for k, v in batch.items()})
        tl, cache = model.decode_step(
            tp, cache, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name, want in jcache.items():
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(want),
                                   **TOL, err_msg=name)


def test_vlm_text_decode_equals_forward(vlm):
    """No patches, text at t = h = w = i: the forward and token-by-token
    decode are one function (``chip_smoke.py`` phase 15a's hold)."""
    _, _, model, tp = vlm
    cfg = model.cfg
    b, s = 2, 9
    tokens = torch.from_numpy(np.random.RandomState(5).randint(
        0, cfg.vocab_size, (b, s)))
    thw = torch.arange(s)[None, :, None].expand(b, s, 3)
    full, _ = model.logits_fn(tp, {
        "tokens": tokens, "positions_thw": thw,
        "patch_embeds": torch.zeros(b, 0, cfg.vision_embed_dim)})
    cache = model.init_cache(b, s, device="cpu")
    for t in range(s):
        logits, cache = model.decode_step(tp, cache, {
            "tokens": tokens[:, t:t + 1],
            "cache_len": torch.full((b,), t + 1, dtype=torch.int32),
            "positions_thw": thw[:, t:t + 1]})
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   **TOL)


# -------------------------------------------------------------- Whisper


def _frames(cfg, b=2, seed=6):
    return np.random.RandomState(seed).standard_normal(
        (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def _cross_cache(model, params, frames, cache):
    """Each decoder layer's cross K/V of the encoder's memory, written
    into ``cache`` (the reference's callers fill these entries)."""
    cfg = model.cfg
    memory = model._encode(params, frames)
    b, s, _ = memory.shape
    for i, blk in enumerate(params.dec_blocks):
        cache["cross_k"][i] = (memory @ blk.cross.wk).reshape(
            b, s, cfg.n_heads, cfg.head_dim)
        cache["cross_v"][i] = (memory @ blk.cross.wv).reshape(
            b, s, cfg.n_heads, cfg.head_dim)
    return cache


def test_whisper_logits_fn_matches_jax(whisper):
    jmodel, jp, model, tp = whisper
    cfg = model.cfg
    frames = _frames(cfg)
    tokens = np.random.RandomState(7).randint(
        0, cfg.vocab_size, (2, 11)).astype(np.int32)
    want, wtok = jmodel.logits_fn(jp, {"frames": jnp.asarray(frames),
                                       "tokens": jnp.asarray(tokens)})
    got, labels = model.logits_fn(tp, {"frames": torch.from_numpy(frames),
                                       "tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, 11, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert labels.tolist() == tokens.tolist()
    np.testing.assert_allclose(
        model._encode(tp, torch.from_numpy(frames)).numpy(),
        np.asarray(jmodel._encode(jp, jnp.asarray(frames))), **TOL)


def test_whisper_attention_calls_go_through_flash(whisper, monkeypatch):
    """Every attention of the forward reaches ``ops.flash_attention``
    (on the card, the flash kernel): per layer the encoder's full
    self-attention (Sq = Sk = enc_seq), the decoder's causal
    self-attention, and the cross-attention from T queries to the
    enc_seq memory keys, not causal."""
    _, _, model, tp = whisper
    cfg = model.cfg
    calls, real = [], ops.flash_attention

    def spy(q, k, v, *, causal):
        calls.append((q.shape[1], k.shape[1], causal))
        return real(q, k, v, causal=causal)
    monkeypatch.setattr(ops, "flash_attention", spy)
    model.logits_fn(tp, {"frames": torch.from_numpy(_frames(cfg)),
                         "tokens": torch.zeros(2, 5, dtype=torch.long)})
    e = cfg.enc_seq
    assert calls == [(e, e, False)] * cfg.enc_layers + \
        [(5, 5, True), (5, e, False)] * cfg.dec_layers


def test_whisper_decode_step_and_caches_match_jax(whisper):
    """Decode at B = 2 with numpy-made cross K/V in both caches, against
    the JAX decode step; every cache tensor compared at the end."""
    jmodel, jp, model, tp = whisper
    cfg = model.cfg
    b, steps = 2, 6
    rng = np.random.RandomState(8)
    tokens = rng.randint(0, cfg.vocab_size, (b, steps)).astype(np.int32)
    shapes, _ = jmodel.init_cache(b, steps + 1)
    cross = {k: rng.standard_normal(shapes[k].shape).astype(np.float32)
             for k in ("cross_k", "cross_v")}
    jcache = {k: jnp.asarray(cross[k]) if k in cross
              else jnp.zeros(s.shape, s.dtype) for k, s in shapes.items()}
    cache = model.init_cache(b, steps + 1, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(s.shape) for k, s in shapes.items()}
    for k, v in cross.items():
        cache[k].copy_(torch.from_numpy(v))
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


def test_whisper_decode_equals_forward_with_the_encoders_cross_cache(
        whisper):
    """With the cross cache built from the port's own encoder, decoding
    token by token gives the forward's logits at every position
    (``chip_smoke.py`` phase 15a's hold)."""
    _, _, model, tp = whisper
    cfg = model.cfg
    b, s = 2, 9
    frames = torch.from_numpy(_frames(cfg, seed=9))
    tokens = torch.from_numpy(np.random.RandomState(10).randint(
        0, cfg.vocab_size, (b, s)))
    full, _ = model.logits_fn(tp, {"frames": frames, "tokens": tokens})
    cache = _cross_cache(model, tp, frames,
                         model.init_cache(b, s, device="cpu"))
    for t in range(s):
        logits, cache = model.decode_step(tp, cache, {
            "tokens": tokens[:, t:t + 1],
            "cache_len": torch.full((b,), t + 1, dtype=torch.int32)})
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   **TOL)
