"""The torch port's optimizers held against the JAX package's: AdamW and
Adafactor (bf16 accumulators) take 3 updates on a random tree with a 1-D,
a 2-D and a stacked 3-D leaf under ``cosine_schedule``, from the same
numpy parameters and gradients (the port's as the flat ``/``-keyed dict
the trainer passes).  The parameters and AdamW's fp32 moments
agree within rtol 1e-5 (fp32; the frameworks may fuse the arithmetic
differently); Adafactor's bf16 accumulators within one bf16 ulp (a last-
bit difference in fp32 can round to either neighbour); ``count`` exactly.
The port updates the parameters and the moments in place."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch.train import optimizer as topt

SHAPES = {"norm": (6,), "w": (5, 7), "blocks": {"w": (3, 4, 5)}}
RTOL = 1e-5


def _tree(shapes, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in shapes.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _pair(name, **kw):
    sched = dict(warmup=2, total=10)
    return (jopt.make_optimizer(name, schedule=jopt.cosine_schedule(
                1e-2, **sched), **kw),
            topt.make_optimizer(name, schedule=topt.cosine_schedule(
                1e-2, **sched), **kw))


def _run(name, steps=3, seed=0, **kw):
    rng = np.random.RandomState(seed)
    params = _tree(SHAPES, lambda s: rng.standard_normal(s).astype(
        np.float32))
    grads = [_tree(SHAPES, lambda s: (rng.standard_normal(s) * 0.1).astype(
        np.float32)) for _ in range(steps)]
    jo, to = _pair(name, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = _torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        ts = to.update(_torch(g), ts, tp)
    return jp, js, tp, ts


def _torch(tree):
    """The tree as the port takes it: ``{"a/b": tensor}``."""
    return {k: torch.from_numpy(v.copy()) for k, v in _leaves(tree)}


def _pairs(jtree, ttree):
    """(name, numpy leaf of the JAX tree, port tensor) by ``/``-joined
    name (jax rebuilds dicts with sorted keys)."""
    want = dict(_leaves(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jtree)))
    got = ttree
    assert set(want) == set(got)
    return [(name, want[name], got[name]) for name in sorted(got)]


def _check_params(jp, tp):
    for name, want, got in _pairs(jp, tp):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   err_msg=name)


def test_adamw_matches_jax():
    jp, js, tp, ts = _run("adamw")
    _check_params(jp, tp)
    assert int(ts["count"]) == int(js["count"]) == 3
    assert ts["count"].dtype == torch.int32 and ts["count"].dim() == 0
    for moment in ("m", "v"):
        for name, want, got in _pairs(js[moment], ts[moment]):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                       err_msg=f"{moment} {name}")


def _bf16_ulps(got, want):
    """|got - want| in units of one bf16 ulp at |want| (numpy floats)."""
    exp = np.floor(np.log2(np.maximum(np.abs(want), 1e-38)))
    return np.abs(got - want) / np.exp2(exp - 7)


def test_adafactor_bf16_accumulators_match_jax():
    jp, js, tp, ts = _run("adafactor")
    _check_params(jp, tp)
    assert int(ts["count"]) == int(js["count"]) == 3
    for name, want, got in _pairs(js["f"], ts["f"]):
        assert got.dtype == torch.bfloat16, name
        assert _bf16_ulps(got.float().numpy(), want).max() <= 1.0, name
    # the factored leaves keep a row and a column accumulator
    assert set(ts["f"]) == {"norm/v", "w/vr", "w/vc", "blocks/w/vr",
                            "blocks/w/vc"}
    assert ts["f"]["blocks/w/vc"].shape == (3, 5)


@pytest.mark.parametrize("warmup,total", [(2, 10), (0, 5), (5, 5)])
def test_cosine_schedule_matches_jax(warmup, total):
    jfn = jopt.cosine_schedule(3e-4, warmup, total)
    tfn = topt.cosine_schedule(3e-4, warmup, total)
    for c in range(0, total + 3):
        want = float(jfn(jnp.asarray(c, jnp.int32)))
        got = tfn(torch.tensor(c, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), want, rtol=RTOL)


def test_update_is_in_place_and_make_optimizer_names():
    rng = np.random.RandomState(1)
    p = {"w": torch.from_numpy(rng.standard_normal((4, 3)).astype(
        np.float32))}
    before = p["w"].clone()
    opt = topt.make_optimizer("adamw")
    state = opt.init(p)
    m = state["m"]["w"]
    new = opt.update({"w": torch.ones(4, 3)}, state, p)
    assert not torch.equal(p["w"], before)
    assert new["m"]["w"] is m and bool((m != 0).all())
    assert isinstance(topt.make_optimizer("adafactor"), topt.Adafactor)
    with pytest.raises(ValueError):
        topt.make_optimizer("sgd")
