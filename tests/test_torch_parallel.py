"""The torch port's distribution layer against the JAX package's.

* ``resolve`` equals JAX's ``resolve`` (as a tuple) for every leaf spec of
  every arch's reduced config, on stand-in meshes (2,4), (16,16) and
  (2,16,16), under every preset; exact.
* ``param_specs`` and ``abstract_params`` equal the JAX specs tree and
  abstract shapes mapped to the port's names (``"layers"`` dropped);
  ``abstract_state`` (AdamW, Adafactor) equals ``init``'s shapes and
  dtypes and the reference's spec rule; exact.
* ``quantize_int8`` / ``dequantize_int8`` byte-equal to JAX's.
* On gloo (processes through a ``FileStore`` in ``tmp_path``, each group
  under its own timeout): the sharded train step on a 2x2 mesh against the
  JAX single-device step (loss rtol 2e-5, params rtol = atol 2e-4, the
  reference test's tolerances); every other family's sharded loss and
  gradients against JAX's single-device ``value_and_grad`` (loss rtol
  2e-5, each leaf relative L2 2e-4); ``compressed_psum`` / ``hierarchical_psum``
  against numpy sums of JAX's ``compress_decompress``; ``gpipe_forward``
  on 2 ranks against the sequential stack and JAX's ``gpipe_forward``
  (atol 2e-5); checkpoint restore onto 1x1 and 1x2 meshes byte-equal; the
  sharded Trainer's checkpoint published to both of 2 ranks.

JAX is imported inside the tests only, so the spawned ranks load torch
alone."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT = 240

MESHES = {"2x4": {"data": 2, "model": 4},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
PRESETS = ("baseline", "fsdp_pod", "tp_only", "kv_tp", "sp_act", "ep_wide",
           "serve_replicated")


class StandInMesh:
    """What ``resolve`` reads of a mesh: ``shape``, axis name → size."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _archs():
    from repro_torch.configs import ALL_ARCHS
    return ALL_ARCHS


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _to_port(tree, cfg):
    """A JAX parameter-shaped tree (stacked ``blocks`` / ``enc_blocks`` /
    ``dec_blocks`` with a leading layer axis, ``head_block_{i}``) → the
    port's flat names, each stacked leaf split by ``split(leaf, i)``."""
    out = {}
    n_stack = {"blocks": cfg.n_layers - cfg.first_dense_layers,
               "enc_blocks": cfg.enc_layers, "dec_blocks": cfg.dec_layers}
    for path, leaf in _leaves(tree):
        head = path[0]
        if head in n_stack:
            for i in range(n_stack[head]):
                out["/".join((head, str(i)) + path[1:])] = (leaf, i)
        elif head.startswith("head_block_"):
            out["/".join(("head_blocks", head[len("head_block_"):]) +
                         path[1:])] = (leaf, None)
        else:
            out["/".join(path)] = (leaf, None)
    return out


# ------------------------------------------------------------- resolve


def test_rule_tables_equal_the_reference():
    from repro.parallel import sharding as js
    from repro_torch.parallel import sharding as ts
    assert ts.DEFAULT_RULES == js.DEFAULT_RULES
    assert ts.PRESETS == js.PRESETS


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_resolve_matches_jax(mesh_name, preset):
    from repro.configs import get_config
    from repro.models import build_model
    from repro.parallel import sharding as js
    from repro_torch.parallel import sharding as ts
    mesh = StandInMesh(MESHES[mesh_name])
    rules = dict(js.DEFAULT_RULES, **js.PRESETS[preset])
    n = 0
    for arch in _archs():
        cfg = get_config(arch).reduced()
        shapes, specs = build_model(cfg).abstract_params()
        flat_shapes = dict(_leaves(shapes))
        for path, axes in _leaves(specs):
            shape = flat_shapes[path].shape
            for sh in (shape, None):
                want = tuple(js.resolve(axes, sh, mesh, rules))
                assert ts.resolve(axes, sh, mesh, rules) == want, \
                    (arch, path, sh)
                n += 1
    assert n > 300


def test_placements_follow_the_spec_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.parallel.sharding import placements

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
    assert placements((("pod", "data"), None, "model"), Mesh()) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements((None, None), Mesh()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        placements((("data", "pod"),), Mesh())


def test_param_sharding_places_every_leaf_by_its_axes():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.params import flatten_params
    from repro_torch.parallel.sharding import param_sharding

    class Mesh:
        mesh_dim_names = ("data", "model")
        shape = (2, 4)
    meta, specs = build_model(get_config("tinyllama-1.1b").reduced()) \
        .abstract_params()
    got = param_sharding(specs, Mesh(), flatten_params(meta))
    assert set(got) == set(specs)
    # wq (embed, heads): d over data, heads over model; ln1 replicated
    assert got["blocks/0/attn/wq"] == (Shard(0), Shard(1))
    assert got["blocks/0/ln1"] == (Replicate(), Replicate())
    assert got["embed"] == (Shard(1), Shard(0))      # (vocab, embed)


def test_constrain_without_a_mesh_is_the_identity():
    from repro_torch.parallel.sharding import constrain
    x = torch.randn(2, 3)
    assert constrain(x, "batch", "act_embed") is x


# --------------------------------------------------- specs and abstract


@pytest.mark.parametrize("arch", [
    "tinyllama-1.1b", "qwen3-8b", "qwen3-32b", "llama3-405b", "olmoe-1b-7b",
    "deepseek-v2-236b", "qwen2-vl-72b", "mamba2-1.3b", "zamba2-1.2b",
    "whisper-base"])
def test_param_specs_and_abstract_params_match_jax(arch):
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.params import flatten_params, param_specs
    jcfg = jget(arch).reduced()
    shapes, specs = jbuild(jcfg).abstract_params()
    want_specs = {}
    for name, (ax, i) in _to_port(specs, jcfg).items():
        want_specs[name] = tuple(ax[1:]) if i is not None else tuple(ax)
        if i is not None:
            assert ax[0] == "layers"
    cfg = get_config(arch).reduced()
    assert param_specs(cfg) == want_specs
    params, got_specs = build_model(cfg).abstract_params()
    assert got_specs == want_specs
    flat = flatten_params(params)
    for name, (leaf, i) in _to_port(shapes, jcfg).items():
        shape = leaf.shape[1:] if i is not None else leaf.shape
        p = flat[name]
        assert p.device.type == "meta"
        assert tuple(p.shape) == tuple(shape), name
        assert str(p.dtype).split(".")[-1] == str(leaf.dtype), name
    assert set(flat) == set(want_specs)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_abstract_state_matches_init_and_the_reference_rule(name):
    import jax
    import jax.numpy as jnp
    from repro.train.optimizer import make_optimizer as jopt
    from repro_torch.checkpoint.manager import flatten_tree
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.params import flatten_params
    from repro_torch.train.optimizer import make_optimizer
    cfg = get_config("olmoe-1b-7b").reduced()   # 3-d expert weights
    model = build_model(cfg)
    opt = make_optimizer(name)
    meta, specs = model.abstract_params()
    flat_meta = flatten_params(meta)
    shapes, ospecs = opt.abstract_state(flat_meta, specs)
    got = flatten_tree(shapes)
    built = flatten_tree(opt.init(flatten_params(model.init(0, "cpu"))))
    assert set(got) == set(built)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert (t.shape, t.dtype) == (built[k].shape, built[k].dtype), k
    # the reference's rule, applied to the port's leaves
    jshapes = {k: jax.ShapeDtypeStruct(tuple(p.shape), getattr(
        jnp, str(p.dtype).split(".")[-1])) for k, p in flat_meta.items()}
    js, jo = jopt(name).abstract_state(jshapes, specs)
    flat_js = {"/".join(k): v for k, v in _leaves(js)}
    flat_jo = {"/".join(k): v for k, v in _leaves(jo)}
    assert set(flat_js) == set(got)
    for k, t in got.items():
        assert tuple(t.shape) == tuple(flat_js[k].shape), k
        assert str(t.dtype).split(".")[-1] == str(flat_js[k].dtype), k
    assert flatten_tree(ospecs) == {k: tuple(v) for k, v in flat_jo.items()}


# ---------------------------------------------------------- collectives


@pytest.mark.parametrize("n,dtype", [(1000, "float32"), (256, "float32"),
                                     (4096 + 7, "float32"),
                                     (1000, "bfloat16")])
def test_int8_quantize_byte_equal_to_jax(n, dtype):
    import jax.numpy as jnp
    import ml_dtypes
    from repro.parallel import collectives as jc
    from repro_torch.parallel import collectives as tc
    x = (np.random.RandomState(n).randn(n) * 3).astype(np.float32)
    if dtype == "bfloat16":
        xj = jnp.asarray(x.astype(ml_dtypes.bfloat16))
        xt = torch.from_numpy(x).to(torch.bfloat16)
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    qj, sj = jc.quantize_int8(xj)
    qt, st = tc.quantize_int8(xt)
    assert np.array_equal(np.asarray(qj), qt.numpy())
    assert np.array_equal(np.asarray(sj), st.numpy())
    dj = np.asarray(jc.dequantize_int8(qj, sj, (n,)))
    assert np.array_equal(dj, tc.dequantize_int8(qt, st, (n,)).numpy())
    assert np.array_equal(np.asarray(jc.compress_decompress(xj)),
                          tc.compress_decompress(xt).numpy())


def test_int8_error_feedback_quantization():
    from repro_torch.parallel.collectives import compress_decompress
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1000).astype(np.float32) * 3)
    xq = compress_decompress(x)
    # per-block int8: relative error < 1%
    assert float((xq - x).abs().max()) <= float(x.abs().max()) / 127.0 + 1e-6
    # error feedback: accumulated residual keeps the running sum unbiased
    residual = torch.zeros_like(x)
    total_sent = torch.zeros_like(x)
    for _ in range(50):
        target = x + residual
        sent = compress_decompress(target)
        residual = target - sent
        total_sent += sent
    np.testing.assert_allclose((total_sent / 50).numpy(), x.numpy(),
                               atol=2e-2)


# ------------------------------------------------------ gloo processes


def _spawn(fn, world, tmp_path, *args):
    """Run ``fn(rank, world, store, *args)`` in ``world`` spawned
    processes on a gloo group through a FileStore; every rank must exit 0
    within GROUP_TIMEOUT seconds."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    store = str(tmp_path / f"store_{fn.__name__}_{world}")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, store) + args)
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(GROUP_TIMEOUT)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, f"{fn.__name__}: ranks timed out"
    assert [p.exitcode for p in procs] == [0] * world, \
        f"{fn.__name__}: exit codes {[p.exitcode for p in procs]}"


def _rank_main(fn, rank, world, store, *args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def _reduced_qwen(get_config):
    return get_config("qwen3-8b").reduced().replace(
        dtype="float32", remat="none", d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128)


def _sharded_step_rank(rank, world, out_dir):
    """Rank body: the port's sharded AdamW step on a 2x2 mesh from the
    JAX init, then compressed_psum / hierarchical_psum."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_cpu_mesh, make_mesh
    from repro_torch.models import build_model, from_jax_params
    from repro_torch.models.params import flatten_params, param_specs
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.sharding import (axis_rules, placements,
                                               resolve, shard_params)
    from repro_torch.train.optimizer import Adafactor, AdamW
    cfg = _reduced_qwen(get_config)
    with np.load(f"{out_dir}/init.npz") as f:
        tree = {}
        for key in f.files:
            node = tree
            *path, leaf = key.split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = f[key]
        tokens = torch.from_numpy(tree.pop("tokens"))
    model = build_model(cfg)
    params = from_jax_params(tree, cfg, "cpu")
    mesh = make_cpu_mesh(2, 2)
    opt = AdamW()
    with axis_rules(mesh):
        shard_params(params, param_specs(cfg), mesh)
        params.requires_grad_(True)
        flat = flatten_params(params)
        tok = distribute_tensor(tokens, mesh, placements(
            resolve(("batch", "seq"), tokens.shape, mesh), mesh))
        loss = model.loss_fn(params, {"tokens": tok})
        grads = torch.autograd.grad(loss, list(flat.values()))
        state = opt.init(flat)
        # the moments follow their parameters' placements (Adafactor's
        # factors keep the split of the dimensions they keep)
        placed = all(state["m"][k].placements == v.placements
                     for k, v in flat.items())
        fac = Adafactor().init(flat)["f"]
        placed &= all(fac[f"{k}/vr"].shape == v.shape[:-1] and
                      fac[f"{k}/vc"].shape == v.shape[:-2] + v.shape[-1:]
                      for k, v in flat.items() if v.dim() >= 2)
        opt.update(dict(zip(flat, grads)), state, flat)
        full = {k: v.full_tensor().detach().numpy() for k, v in flat.items()}
        sharded = sum(1 for v in flat.values()
                      if any(p.is_shard() for p in v.placements))
        loss = float(loss.full_tensor())
    # int8 error-feedback all-reduce and the two-level psum
    rng = np.random.RandomState(rank)
    x = torch.from_numpy(rng.randn(1000).astype(np.float32) * 3)
    res = torch.from_numpy(rng.randn(1000).astype(np.float32) * 0.01)
    reduced, new_res = col.compressed_psum(x, None, res)
    two_d = col.hierarchical_psum(x, mesh)
    pod = make_mesh((2, 2, 1), ("pod", "data", "model"), "cpu")
    three_d = col.hierarchical_psum(x, pod)
    out = dict(reduced=reduced.numpy(), new_res=new_res.numpy(),
               two_d=two_d.numpy(), three_d=three_d.numpy())
    if rank == 0:
        out.update({f"p/{k}": v for k, v in full.items()})
        out["loss"] = np.float64(loss)
        out["sharded_leaves"] = np.int64(sharded)
        out["state_placed"] = np.bool_(placed)
    np.savez(f"{out_dir}/rank{rank}.npz", **out)


def test_sharded_step_and_collectives_on_gloo(tmp_path):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import build_model
    from repro.parallel.collectives import compress_decompress
    from repro.train.optimizer import make_optimizer
    cfg = _reduced_qwen(get_config)
    model = build_model(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    opt = make_optimizer("adamw")
    tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 32), 0, 200)

    def step(p, o, t):
        loss, grads = jax.value_and_grad(model.loss_fn)(p, {"tokens": t})
        p2, _ = opt.update(grads, o, p)
        return loss, p2
    loss_ref, params_ref = jax.jit(step)(params, opt.init(params), tokens)
    flat = {"/".join(p): np.asarray(v) for p, v in _leaves(params)}
    np.savez(tmp_path / "init.npz", tokens=np.asarray(tokens), **flat)
    _spawn(_sharded_step_rank, 4, tmp_path, str(tmp_path))

    with np.load(tmp_path / "rank0.npz") as f:
        got = {k: f[k] for k in f.files}
    np.testing.assert_allclose(float(got["loss"]), float(loss_ref),
                               rtol=2e-5)
    assert int(got["sharded_leaves"]) > 10     # the 2x2 mesh did shard
    assert bool(got["state_placed"])
    want = _to_port(jax.tree_util.tree_map(np.asarray, params_ref), cfg)
    assert {k[2:] for k in got if k.startswith("p/")} == set(want)
    for name, (leaf, i) in want.items():
        np.testing.assert_allclose(got["p/" + name],
                                   leaf if i is None else leaf[i],
                                   rtol=2e-4, atol=2e-4, err_msg=name)
    ranks, xs, sent = [], [], []
    for r in range(4):
        with np.load(tmp_path / f"rank{r}.npz") as f:
            ranks.append({k: f[k] for k in ("reduced", "new_res", "two_d",
                                           "three_d")})
        rng = np.random.RandomState(r)
        x = rng.randn(1000).astype(np.float32) * 3
        res = rng.randn(1000).astype(np.float32) * 0.01
        target = x + res
        xs.append(x)
        sent.append(np.asarray(compress_decompress(jnp.asarray(target))))
        assert np.array_equal(ranks[r]["new_res"], target - sent[-1])
    total = np.sum(sent, axis=0)
    for r in range(4):
        np.testing.assert_allclose(ranks[r]["reduced"], total, rtol=1e-6,
                                   atol=1e-5)
        # 2x2 (data, model): rank = 2 d + m; the data group shares m
        np.testing.assert_allclose(ranks[r]["two_d"],
                                   xs[r % 2] + xs[2 + r % 2], rtol=1e-6)
        np.testing.assert_allclose(ranks[r]["three_d"],
                                   np.sum(xs, axis=0), rtol=1e-6, atol=1e-5)


FAMILY_ARCHS = ["mamba2-1.3b", "zamba2-1.2b", "olmoe-1b-7b",
                "deepseek-v2-236b", "qwen2-vl-72b", "whisper-base"]
PERTURBED = ("a_log", "dt_bias", "d_skip", "conv_b")
FAMILY_SHAPE = (4, 32)          # batch, seq: the batch splits over data


def _tree(flat):
    """``{"a/b": leaf}`` → nested dicts."""
    tree = {}
    for key, leaf in flat.items():
        node = tree
        *path, last = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def _family_reference(arch, out_dir, overrides=None):
    """JAX's single-device loss and gradients of the reduced fp32 model
    (init ``PRNGKey(7)``; Mamba2 / Zamba2's zero-initialised leaves
    perturbed; ``overrides`` replaced in the config) on a seeded numpy
    batch of every input it takes; the weights and the batch are written
    for the ranks."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.models import build_model
    cfg = get_config(arch).reduced().replace(dtype="float32", remat="none",
                                             **(overrides or {}))
    model = build_model(cfg)
    tree = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(7))[0])
    rng = np.random.RandomState(0)
    if cfg.family in ("ssm", "hybrid"):
        for name in PERTURBED:
            leaf = tree["blocks"][name]
            tree["blocks"][name] = (rng.standard_normal(leaf.shape) *
                                    0.5).astype(leaf.dtype)
    b, s = FAMILY_SHAPE
    batch = {}
    for name, spec in model.input_specs(ShapeSpec("t", s, b,
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
    loss, grads = jax.value_and_grad(model.loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    np.savez(f"{out_dir}/{arch}.npz",
             **{"p/" + "/".join(k): v for k, v in _leaves(tree)},
             **{"b/" + k: v for k, v in batch.items()})
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _families_rank(rank, world, out_dir):
    """Rank body: for each family, loss and gradients of the reduced fp32
    model from JAX's weights, with DTensor parameters on a 2x2 mesh (the
    SSD and the flash kernels through local_map on head and batch
    shards, the MoE FFN expert-parallel); rank 0 writes the full
    gradients."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_cpu_mesh
    from repro_torch.models import build_model, from_jax_params
    from repro_torch.models.params import flatten_params, param_specs
    from repro_torch.parallel.sharding import (axis_rules, placements,
                                               resolve, shard_params)
    mesh = make_cpu_mesh(2, 2)
    b, s = FAMILY_SHAPE
    out = {}
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch).reduced().replace(dtype="float32",
                                                 remat="none")
        model = build_model(cfg)
        with np.load(f"{out_dir}/{arch}.npz") as f:
            tree = _tree({k[2:]: f[k] for k in f.files if k[0] == "p"})
            batch = {k[2:]: torch.from_numpy(f[k]) for k in f.files
                     if k[0] == "b"}
        axes = model.input_axes(ShapeSpec("t", s, b, "train"))
        params = from_jax_params(tree, cfg, "cpu")
        with axis_rules(mesh):
            shard_params(params, param_specs(cfg), mesh)
            params.requires_grad_(True)
            flat = flatten_params(params)
            placed = {k: distribute_tensor(v, mesh, placements(
                resolve(axes[k], v.shape, mesh), mesh))
                for k, v in batch.items()}
            loss = model.loss_fn(params, placed)
            grads = torch.autograd.grad(loss, list(flat.values()))
            out[f"{arch}/loss"] = np.float64(float(loss.full_tensor()))
            for k, g in zip(flat, grads):
                out[f"{arch}/g/{k}"] = g.full_tensor().numpy()
        out[f"{arch}/split_leaves"] = np.int64(sum(
            v.to_local().shape != v.shape for v in flat.values()))
    if rank == 0:
        np.savez(f"{out_dir}/families.npz", **out)


@pytest.fixture(scope="module")
def family_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("families")
    want = {arch: _family_reference(arch, tmp) for arch in FAMILY_ARCHS}
    _spawn(_families_rank, 4, tmp, str(tmp))
    with np.load(tmp / "families.npz") as f:
        return {k: f[k] for k in f.files}, want


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_sharded_loss_and_grads_every_family(family_runs, arch):
    """The sharded port's loss within rtol 2e-5 of JAX's single-device
    ``value_and_grad`` on the same weights and batch, and every gradient
    leaf within relative L2 2e-4 of JAX's."""
    from repro_torch.configs import get_config
    from repro_torch.models import from_jax_params
    from repro_torch.models.params import flatten_params
    got, want = family_runs
    loss, jgrads = want[arch]
    cfg = get_config(arch).reduced().replace(dtype="float32", remat="none")
    np.testing.assert_allclose(got[f"{arch}/loss"], loss, rtol=2e-5)
    want_grads = {k: v.detach().numpy() for k, v in flatten_params(
        from_jax_params(jgrads, cfg, "cpu")).items()}
    prefix = f"{arch}/g/"
    assert {k[len(prefix):] for k in got if k.startswith(prefix)} == \
        set(want_grads)
    worst = (0.0, None)
    for name, w in want_grads.items():
        norm = float(np.linalg.norm(w.astype(np.float64)))
        if norm > 0:
            d = float(np.linalg.norm(got[prefix + name].astype(np.float64) -
                                     w) / norm)
            worst = max(worst, (d, name))
    print(f"{arch}: loss {got[f'{arch}/loss']:.8g} (JAX {loss:.8g}), "
          f"worst leaf {worst[1]} at relative L2 {worst[0]:.3g}")
    assert worst[0] <= 2e-4, worst
    assert got[f"{arch}/split_leaves"] > 0


def _gpipe_rank(rank, world, out_dir):
    from repro_torch.parallel.pipeline import gpipe_forward, split_stages
    with np.load(f"{out_dir}/gpipe_in.npz") as f:
        w, x = torch.from_numpy(f["w"]), torch.from_numpy(f["x"])
    staged = split_stages({"w": w}, world)
    fn = gpipe_forward(lambda lp, h: torch.tanh(h @ lp["w"]), None,
                       n_microbatches=x.shape[0])
    out = fn(staged, x)
    np.save(f"{out_dir}/gpipe_rank{rank}.npy", out.numpy())


def test_gpipe_matches_sequential_and_jax(tmp_path):
    L, D, M, MB = 4, 16, 4, 2   # layers, width, microbatches, mb size
    rng = np.random.RandomState(0)
    w = (rng.randn(L, D, D) * 0.3).astype(np.float32)
    x = rng.randn(M, MB, D).astype(np.float32)
    np.savez(tmp_path / "gpipe_in.npz", w=w, x=x)
    _spawn(_gpipe_rank, 2, tmp_path, str(tmp_path))
    ref = torch.from_numpy(x)
    for i in range(L):
        ref = torch.tanh(ref @ torch.from_numpy(w[i]))
    script = textwrap.dedent("""
        import sys, jax, jax.numpy as jnp, numpy as np
        from repro.parallel.pipeline import gpipe_forward, split_stages
        f = np.load(sys.argv[1] + "/gpipe_in.npz")
        mesh = jax.make_mesh((2,), ("pod",))
        staged = split_stages({"w": jnp.asarray(f["w"])}, 2)
        fn = gpipe_forward(lambda lp, h: jnp.tanh(h @ lp["w"]), mesh,
                           n_microbatches=f["x"].shape[0])
        np.save(sys.argv[1] + "/gpipe_jax.npy",
                np.asarray(jax.jit(fn)(staged, jnp.asarray(f["x"]))))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 " +
                        env.get("XLA_FLAGS", ""))
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                          capture_output=True, text=True, env=env,
                          timeout=GROUP_TIMEOUT, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want_jax = np.load(tmp_path / "gpipe_jax.npy")
    for r in range(2):
        got = np.load(tmp_path / f"gpipe_rank{r}.npy")
        np.testing.assert_allclose(got, ref.numpy(), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, want_jax, rtol=2e-5, atol=2e-5)


def _bits(t):
    """A tensor's bytes as numpy (bf16 as int16: numpy has no bfloat16)."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _restore_rank(rank, world, out_dir):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_cpu_mesh
    from repro_torch.models.params import param_specs
    from repro_torch.parallel.sharding import resolve
    cfg = get_config("tinyllama-1.1b").reduced()
    mesh = make_cpu_mesh(1, world)
    params, opt, manifest = CheckpointManager(f"{out_dir}/ckpt").restore(
        3, mesh=mesh, param_specs=param_specs(cfg),
        opt_specs={"m": param_specs(cfg)}, resolve_fn=resolve)
    sharded = sum(t.to_local().shape != t.shape for t in params.values())
    out = {f"p/{k}": _bits(t.full_tensor()) for k, t in params.items()}
    out.update({f"m/{k}": _bits(t.full_tensor())
                for k, t in opt["m"].items()})
    out["count"] = opt["count"].full_tensor().numpy()
    out["sharded"] = np.int64(sharded)
    out["manifest_specs"] = np.array(json.dumps(manifest["param_specs"]))
    np.savez(f"{out_dir}/restored_{world}_{rank}.npz", **out)


@pytest.mark.parametrize("world", [1, 2])
def test_checkpoint_restore_onto_a_mesh(tmp_path, world):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.params import flatten_params, param_specs
    cfg = get_config("tinyllama-1.1b").reduced()       # bf16 leaves
    flat = {k: v.detach() for k, v in
            flatten_params(build_model(cfg).init(3, device="cpu")).items()}
    m = {k: torch.randn(v.shape) for k, v in flat.items()}
    opt = {"m": m, "count": torch.tensor(3, dtype=torch.int32)}
    CheckpointManager(tmp_path / "ckpt").save(
        3, flat, opt, param_specs=param_specs(cfg), block=True)
    _spawn(_restore_rank, world, tmp_path, str(tmp_path))
    for r in range(world):
        with np.load(tmp_path / f"restored_{world}_{r}.npz") as f:
            for k, v in flat.items():
                assert np.array_equal(f[f"p/{k}"], _bits(v)), k
            for k, v in m.items():
                assert np.array_equal(f[f"m/{k}"], _bits(v)), k
            assert int(f["count"]) == 3
            assert (int(f["sharded"]) > 0) == (world > 1)
            specs = json.loads(str(f["manifest_specs"]))
            assert specs == {k: list(v) for k, v in param_specs(cfg).items()}


def _trainer_ckpt_rank(rank, world, out_dir):
    """Rank body: the Trainer on a 1x2 mesh saves as it trains, then a
    fresh Trainer's ``restore_or_init`` on every rank; then a save whose
    write is slow on rank 0 and one whose write fails there."""
    import time
    from repro_torch.checkpoint import manager
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_cpu_mesh
    from repro_torch.models.params import flatten_params
    from repro_torch.train.loop import Trainer
    cfg = get_config("tinyllama-1.1b").reduced().replace(dtype="float32",
                                                         remat="none")
    mesh = make_cpu_mesh(1, world)

    def trainer():
        return Trainer(cfg, global_batch=2, seq_len=16, device="cpu",
                       mesh=mesh, checkpoint_dir=f"{out_dir}/ckpt",
                       checkpoint_every=2)
    t = trainer()
    state = t.train(t.restore_or_init(), 3)       # saves steps 2 and 3
    saved = {k: v.full_tensor().detach().clone()
             for k, v in flatten_params(state.params).items()}
    again = trainer()
    back = again.restore_or_init()
    equal = all(torch.equal(v.full_tensor(), saved[k])
                for k, v in flatten_params(back.params).items())
    out = dict(restored_step=back.step, params_equal=equal,
               data_index=again.pipeline.index)
    savez = manager.np.savez

    def slow(*a, **k):
        time.sleep(1.0)
        return savez(*a, **k)
    if rank == 0:
        manager.np.savez = slow
    flat = flatten_params(back.params)
    again.ckpt.save(7, flat, back.opt_state)             # async
    out["latest_after_async"] = again.ckpt.latest_step()

    def broken(*a, **k):
        raise OSError("disk full")
    if rank == 0:
        manager.np.savez = broken
    try:
        again.ckpt.save(9, flat, back.opt_state, block=True)
        out["failed_save"] = None
    except Exception as e:          # noqa: BLE001 (recorded, held below)
        out["failed_save"] = f"{type(e).__name__}: {e}"
    manager.np.savez = savez
    out["latest_after_failure"] = again.ckpt.latest_step()
    t.close()
    again.close()
    with open(f"{out_dir}/trainer_ckpt_{rank}.json", "w") as f:
        json.dump(out, f)


def test_trainer_checkpoint_is_published_to_every_rank(tmp_path):
    """Two gloo ranks: a checkpoint the sharded Trainer saved is the one
    ``restore_or_init`` restores on both (step 3, parameters equal); a
    rank returns from an async save's ``latest_step`` only once rank 0
    has published it (rank 0's write slowed by 1 s); a failed write on
    rank 0 raises on both ranks."""
    _spawn(_trainer_ckpt_rank, 2, tmp_path, str(tmp_path))
    for r in range(2):
        got = json.loads((tmp_path / f"trainer_ckpt_{r}.json").read_text())
        assert got["restored_step"] == 3, (r, got)
        assert got["params_equal"], r
        assert got["data_index"] == 3, (r, got)
        assert got["latest_after_async"] == 7, (r, got)
        assert got["failed_save"] is not None, r
        assert "disk full" in got["failed_save"], (r, got)
        assert got["latest_after_failure"] == 7, (r, got)
