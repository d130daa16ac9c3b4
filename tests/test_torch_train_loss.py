"""The torch port's training loss and its gradients held against the JAX
package on the same weights and inputs.

* ``cross_entropy_loss`` against the reference's, with ignored (-1)
  labels.
* ``loss_fn`` and EVERY gradient leaf against
  ``jax.value_and_grad(model.loss_fn)`` for each arch in ``ALL_ARCHS``,
  reduced, fp32, ``remat="none"``: the JAX init (``PRNGKey(7)``) bridged
  with ``from_jax_params``, which is a pure re-layout and so carries the
  JAX gradient tree onto the port's modules as it carries the weights.
  The batch is made with numpy (the Qwen2-VL patch embeddings and M-RoPE
  positions, Whisper's frames) and handed to both.  Mamba2 / Zamba2's
  zero-initialised decay, skip and conv-bias leaves are perturbed in both
  trees first.  Tolerance (fp32; the frameworks sum in different orders):
  the loss within rtol 1e-5, each gradient element within rtol 2e-4 and
  atol 2e-6.  The reference is evaluated op by op, as the port is: that
  limit lies at fp32's noise floor for Zamba2's ``embed`` gradient, where
  the JAX gradient under ``jax.jit`` and the same gradient op by op
  differ by 1.18 times it (relative L2 3.9e-6), and the port lies at 0.96
  of it from the op-by-op one.
* ``remat="full"`` gives the same loss and gradients as ``"none"``.
* The kernels' ``autograd.Function``s, driven with the plain forward on
  the CPU: outputs and gradients equal plain autograd's exactly (the
  backward is the plain version's vector-Jacobian product), for flash
  causal, full and Sq != Sk with GQA, and SSD with and without d_skip,
  with and without the final state's gradient; each gradient in its
  input's dtype."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeSpec
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import build_model, from_jax_params, layers
from repro_torch.models.params import flatten_params

LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=2e-4, atol=2e-6)
PERTURBED = ("a_log", "dt_bias", "d_skip", "conv_b")


def test_cross_entropy_loss_matches_jax():
    rng = np.random.RandomState(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 3
    labels = rng.randint(0, 50, (3, 7)).astype(np.int32)
    labels[0, 2] = labels[2, :] = -1
    want, want_n = jlayers.cross_entropy_loss(jnp.asarray(logits),
                                              jnp.asarray(labels))
    got, n = layers.cross_entropy_loss(torch.from_numpy(logits),
                                       torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    assert int(n) == int(want_n) == 13
    # every label ignored: the count clamps to 1 and the loss is 0
    _, n = layers.cross_entropy_loss(torch.from_numpy(logits),
                                     torch.full((3, 7), -1))
    assert int(n) == 1


def _batch(jmodel, cfg, seed=1):
    """numpy inputs of a (2, 32) train shape for both frameworks."""
    rng = np.random.RandomState(seed)
    batch = {}
    for name, spec in jmodel.input_specs(ShapeSpec("t", 32, 2,
                                                   "train")).items():
        if name == "tokens":
            batch[name] = rng.randint(0, cfg.vocab_size,
                                      spec.shape).astype(np.int32)
        elif name == "positions_thw":
            batch[name] = np.broadcast_to(
                np.arange(spec.shape[1])[None, :, None],
                spec.shape).astype(np.int32)
        else:
            batch[name] = (rng.standard_normal(spec.shape) * 0.1).astype(
                np.float32)
    return batch


def _models(arch, remat="none"):
    jcfg = jget_config(arch).reduced().replace(dtype="float32",
                                               remat="none")
    jmodel = jbuild_model(jcfg)
    jp, _ = jmodel.init(jax.random.PRNGKey(7))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    if jcfg.family in ("ssm", "hybrid"):
        rng = np.random.RandomState(0)
        for name in PERTURBED:
            leaf = tree["blocks"][name]
            tree["blocks"][name] = (rng.standard_normal(leaf.shape) *
                                    0.5).astype(leaf.dtype)
    cfg = get_config(arch).reduced().replace(dtype="float32", remat=remat)
    tp = from_jax_params(tree, cfg, "cpu").requires_grad_(True)
    return jmodel, jax.tree_util.tree_map(jnp.asarray, tree), \
        build_model(cfg), tp


def _port_grads(model, tp, batch):
    flat = flatten_params(tp)
    loss = model.loss_fn(tp, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.item(), dict(zip(flat, grads))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_fn_and_every_gradient_match_jax(arch):
    jmodel, jp, model, tp = _models(arch)
    batch = _batch(jmodel, model.cfg)
    want, jgrads = jax.value_and_grad(jmodel.loss_fn)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got, grads = _port_grads(model, tp, batch)
    np.testing.assert_allclose(got, float(want), rtol=LOSS_RTOL)
    want_grads = flatten_params(from_jax_params(
        jax.tree_util.tree_map(np.asarray, jgrads), model.cfg, "cpu"))
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(),
                                   err_msg=f"{arch} {name}", **GRAD_TOL)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-1.2b",
                                  "whisper-base"])
def test_remat_gives_the_same_loss_and_gradients(arch):
    jmodel, _, model, tp = _models(arch)
    batch = _batch(jmodel, model.cfg)
    want, want_grads = _port_grads(model, tp, batch)
    remat_model = build_model(model.cfg.replace(remat="full"))
    got, grads = _port_grads(remat_model, tp, batch)
    assert got == want
    for name, g in grads.items():
        assert torch.equal(g, want_grads[name]), name


def _tensors(rng, *shapes, dtype=torch.float32):
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        dtype).requires_grad_(True) for s in shapes]


def _grads(out, ins, dout):
    outs = [o for o, g in zip(out, dout) if g is not None]
    return torch.autograd.grad(outs, ins, [g for g in dout if g is not None],
                               allow_unused=True)


@pytest.mark.parametrize("sq,sk,causal", [(24, 24, True), (24, 24, False),
                                          (9, 40, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_backward_is_plain_autograd(sq, sk, causal, dtype):
    rng = np.random.RandomState(sq + sk)
    q, k, v = _tensors(rng, (2, sq, 4, 16), (2, sk, 2, 16), (2, sk, 2, 16),
                       dtype=dtype)
    dout = torch.from_numpy(rng.standard_normal(q.shape).astype(
        np.float32)).to(dtype)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    want_g = _grads([want], [q, k, v], [dout])
    before = fa.launches.count
    out = fa.FlashAttentionFn.apply(q, k, v, causal,
                                    fa.flash_attention_plain)
    got_g = _grads([out], [q, k, v], [dout])
    assert fa.launches.count == before
    assert torch.equal(out, want)
    for g, w, t in zip(got_g, want_g, (q, k, v)):
        assert g.dtype == t.dtype
        assert torch.equal(g, w)
    # only the inputs that need a gradient get one
    k2 = k.detach()
    out = fa.FlashAttentionFn.apply(q, k2, v, causal,
                                    fa.flash_attention_plain)
    got = torch.autograd.grad(out, [q, v], dout)
    want = torch.autograd.grad(fa.flash_attention_plain(
        q, k2, v, causal=causal), [q, v], dout)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("with_skip", [True, False])
@pytest.mark.parametrize("final_grad", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_function_backward_is_plain_autograd(with_skip, final_grad,
                                                 dtype):
    rng = np.random.RandomState(5)
    bsz, s, h, p, g, n, chunk = 2, 32, 4, 8, 2, 16, 16
    x, b, c = _tensors(rng, (bsz, s, h, p), (bsz, s, g, n), (bsz, s, g, n),
                       dtype=dtype)
    dt = torch.from_numpy(np.log1p(np.exp(
        rng.standard_normal((bsz, s, h)) - 1.0)).astype(
            np.float32)).requires_grad_(True)
    a = torch.from_numpy(-np.exp(rng.standard_normal(h) * 0.5).astype(
        np.float32)).requires_grad_(True)
    d_skip = _tensors(rng, (h,), dtype=dtype)[0] if with_skip else None
    ins = [t for t in (x, dt, a, b, c, d_skip) if t is not None]
    dy = torch.from_numpy(rng.standard_normal(x.shape).astype(
        np.float32)).to(dtype)
    dfinal = torch.from_numpy(rng.standard_normal((bsz, h, p, n)).astype(
        np.float32)) if final_grad else None
    want = ss.ssd_scan_plain(x, dt, a, b, c, chunk=chunk, d_skip=d_skip)
    want_g = _grads(want, ins, [dy, dfinal])
    before = ss.launches.count
    got = ss.SSDScanFn.apply(x, dt, a, b, c, d_skip, chunk,
                             ss.ssd_scan_plain)
    got_g = _grads(got, ins, [dy, dfinal])
    assert ss.launches.count == before
    assert all(torch.equal(o, w) for o, w in zip(got, want))
    for gr, w, t in zip(got_g, want_g, ins):
        assert gr.dtype == t.dtype
        assert torch.equal(gr, w)


def test_cpu_calls_run_the_plain_versions_under_grad():
    """On CPU tensors the wrappers run the plain versions directly (no
    Function, no launch), differentiable as before."""
    rng = np.random.RandomState(3)
    q, k, v = _tensors(rng, (1, 8, 2, 16), (1, 8, 2, 16), (1, 8, 2, 16))
    before = fa.launches.count
    out = fa.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    assert "FlashAttentionFn" not in type(out.grad_fn).__name__
    assert fa.launches.count == before


def test_ssd_plain_gradient_stays_finite_under_strong_decay():
    """Above the diagonal the chunk's log-decay difference is positive and
    at a strong decay exp() of it overflows; the plain version masks it
    before the exp, so its gradient stays finite (a where() after the exp
    would give 0 * inf = NaN)."""
    rng = np.random.RandomState(9)
    x, b, c = _tensors(rng, (1, 32, 2, 4), (1, 32, 1, 8), (1, 32, 1, 8))
    dt = torch.full((1, 32, 2), 2.0, requires_grad=True)
    a = torch.tensor([-8.0, -4.0], requires_grad=True)
    y, final = ss.ssd_scan_plain(x, dt, a, b, c, chunk=32)
    grads = torch.autograd.grad((y.sum(), final.sum()), (x, dt, a, b, c))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
