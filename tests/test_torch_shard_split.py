"""Under a mesh the port splits the three parts the reference's rule table
splits: the GQA head slice in front of the flash kernel, the head-split
SSD scan and the expert-parallel MoE FFN.

On gloo (four processes through a ``FileStore``, each group under
``GROUP_TIMEOUT``), reduced fp32 models from JAX's weights:

* TinyLlama (H 4, Hkv 2) on a 1 x 4 ``(data, model)`` mesh: every flash
  call on every rank receives 1 q head and 1 kv head;
* Mamba2 (16 SSD heads) on 1 x 4: every SSD call receives 4 heads; then
  two decode steps on the mesh keep the recurrent state split on its
  heads (``SSM_CACHE_SPECS``) and agree with the unsharded decode at
  rtol = atol 1e-5;
* OLMoE (8 experts top 2) with ``capacity_factor=0.5`` on both sides, so
  choices are dropped: on 1 x 4 (experts over ``model``, 2 a rank), on
  2 x 2 (token blocks over ``data``, whose offsets come from the
  all-gathered counts; 4 experts a rank) and on 2 x 2 under ``ep_wide``
  (experts over ``(data, model)``, 2 a rank, tokens gathered over data).
  Every expert product and every expert leaf on every rank holds E/ep
  experts, and the dropped (token, choice) count over the layers equals
  JAX's, which is above 0.  A 2 x 2 x 1 ``(pod, data, model)`` case
  splits the batch into four token blocks, pod-major, as DTensor orders
  them.

Each case's loss is held within rtol 2e-5, and every gradient leaf within
relative L2 2e-4, of JAX's single-device ``value_and_grad`` on the same
weights and batch (``test_torch_parallel._family_reference``).

In one process on the CPU, the per-rank bodies rank by rank:
``sharded.gqa_local`` over r = 0..n-1 concatenated equals the plain
attention on the whole heads, ``ssd_scan`` over head blocks the scan of
all heads, and ``moe.expert_partial`` summed over expert blocks, with
offsets from split token blocks, ``apply_moe_ffn``, with the same kept
choices."""

import numpy as np
import pytest
import torch

from test_torch_parallel import (FAMILY_SHAPE, _family_reference, _spawn,
                                 _tree)

DROP = {"capacity_factor": 0.5}
# case: (arch, mesh sizes (data, model) or (pod, data, model), preset,
# config overrides, the ranks whose token blocks make up the batch once)
CASES = {
    "tinyllama-1x4": ("tinyllama-1.1b", (1, 4), "baseline", {}, [0]),
    "mamba2-1x4": ("mamba2-1.3b", (1, 4), "baseline", {}, [0]),
    "olmoe-1x4": ("olmoe-1b-7b", (1, 4), "baseline", DROP, [0]),
    # rank = 2 d + m: data blocks 0 and 1 sit on ranks 0 and 2
    "olmoe-2x2": ("olmoe-1b-7b", (2, 2), "baseline", DROP, [0, 2]),
    "olmoe-ep_wide-2x2": ("olmoe-1b-7b", (2, 2), "ep_wide", DROP, [0]),
    # the batch over (pod, data), pod the outer split: four token blocks
    "olmoe-2x2x1": ("olmoe-1b-7b", (2, 2, 1), "baseline", DROP,
                    [0, 1, 2, 3]),
}
DECODE_STEPS = 2


def _ref_dir(name):
    """The directory of a case's JAX reference: cases with one arch and
    one config share it."""
    arch, _, _, over, _ = CASES[name]
    return "-".join([arch] + [f"{k}{v}" for k, v in sorted(over.items())])


def _spies(seen):
    """Record what each per-rank local call receives: heads at the plain
    flash and SSD calls, experts and dropped choices at
    ``expert_partial``.  Returns a function that restores the three."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import moe
    fa_plain, ss_plain, partial = (fa.flash_attention_plain,
                                   ss.ssd_scan_plain, moe.expert_partial)

    def flash(q, k, v, *, causal):
        seen["flash"].append((q.shape[2], k.shape[2]))
        return fa_plain(q, k, v, causal=causal)

    def ssd(x, *args, **kw):
        seen["ssd"].append(x.shape[2])
        return ss_plain(x, *args, **kw)

    def experts(p, cfg, xf, routing, **kw):
        y, keep = partial(p, cfg, xf, routing, **kw)
        seen["experts"].append((p.wi_gate.shape[0], int((~keep).sum())))
        return y, keep
    fa.flash_attention_plain, ss.ssd_scan_plain, moe.expert_partial = \
        flash, ssd, experts

    def restore():
        fa.flash_attention_plain, ss.ssd_scan_plain, moe.expert_partial = \
            fa_plain, ss_plain, partial
    return restore


def _decode(model, params, cfg, tokens, mesh=None):
    """DECODE_STEPS steps from a zero cache (placed by ``cache_specs`` on
    ``mesh``) → (logits of each step, the final cache, the dimension of
    the "ssm" state each mesh dimension splits (-1: none), or None)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.parallel.sharding import placements, resolve
    b = tokens.shape[0]
    cache = model.init_cache(b, DECODE_STEPS, device="cpu")
    if mesh is not None:
        specs = model.cache_specs()
        cache = {k: distribute_tensor(v, mesh, placements(
            resolve(specs[k], v.shape, mesh), mesh))
            for k, v in cache.items()}
    logits = []
    with torch.no_grad():
        for i in range(DECODE_STEPS):
            tok = tokens[:, i:i + 1]
            if mesh is not None:
                tok = distribute_tensor(tok, mesh, placements(
                    resolve(("batch", None), tok.shape, mesh), mesh))
            out, cache = model.decode_step(params, cache, {
                "tokens": tok, "cache_len": torch.full((b,), i + 1)})
            logits.append(out.full_tensor() if mesh is not None else out)
    place = None
    if mesh is not None:
        place = [p.dim if p.is_shard() else -1
                 for p in cache["ssm"].placements]
        cache = {k: v.full_tensor() for k, v in cache.items()}
    return torch.stack(logits), cache, place


def _split_rank(rank, world, out_dir):
    """Rank body: each case's sharded loss and gradients with the spies
    on; Mamba2's decode on the mesh; rank 0 writes the full gradients,
    every rank what its spies saw."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model, from_jax_params
    from repro_torch.models.params import flatten_params, param_specs
    from repro_torch.parallel.sharding import (axis_rules, placements,
                                               resolve, shard_params)
    b, s = FAMILY_SHAPE
    out = {}
    for name, (arch, dims, preset, over, _) in CASES.items():
        cfg = get_config(arch).reduced().replace(dtype="float32",
                                                 remat="none", **over)
        model = build_model(cfg)
        with np.load(f"{out_dir}/{_ref_dir(name)}/{arch}.npz") as f:
            tree = _tree({k[2:]: f[k] for k in f.files if k[0] == "p"})
            batch = {k[2:]: torch.from_numpy(f[k]) for k in f.files
                     if k[0] == "b"}
        axes = model.input_axes(ShapeSpec("t", s, b, "train"))
        params = from_jax_params(tree, cfg, "cpu")
        mesh = make_mesh(dims, ("pod", "data", "model")[-len(dims):],
                         "cpu")
        seen = {"flash": [], "ssd": [], "experts": []}
        with axis_rules(mesh, preset=preset):
            shard_params(params, param_specs(cfg), mesh)
            params.requires_grad_(True)
            flat = flatten_params(params)
            placed = {k: distribute_tensor(v, mesh, placements(
                resolve(axes[k], v.shape, mesh), mesh))
                for k, v in batch.items()}
            restore = _spies(seen)
            try:
                loss = model.loss_fn(params, placed)
            finally:
                restore()
            grads = torch.autograd.grad(loss, list(flat.values()))
            out[f"{name}/loss"] = np.float64(float(loss.detach()
                                                   .full_tensor()))
            for k, g in zip(flat, grads):
                out[f"{name}/g/{k}"] = g.full_tensor().numpy()
            out[f"{name}/expert_leaves"] = np.array(
                [v.to_local().shape[0] for k, v in flat.items()
                 if k.split("/")[-1] in ("wi_gate", "wi_up", "wo") and
                 v.dim() == 3], dtype=np.int64)
            if arch.startswith("mamba2"):
                params.requires_grad_(False)
                tokens = batch["tokens"][:, :DECODE_STEPS]
                got, cache, place = _decode(model, params, cfg, tokens, mesh)
                want, wcache, _ = _decode(
                    model, from_jax_params(tree, cfg, "cpu"), cfg, tokens)
                out[f"{name}/decode_placements"] = np.array(place)
                out[f"{name}/decode_err"] = np.float64(max(
                    float((got - want).abs().max()),
                    max(float((cache[k] - wcache[k]).abs().max())
                        for k in cache)))
        out[f"{name}/flash"] = np.array(seen["flash"] or [(0, 0)])
        out[f"{name}/ssd"] = np.array(seen["ssd"] or [0])
        out[f"{name}/experts"] = np.array(seen["experts"] or [(0, 0)])
    if rank != 0:
        out = {k: v for k, v in out.items()
               if k.split("/")[1] in ("flash", "ssd", "experts",
                                      "expert_leaves")}
    np.savez(f"{out_dir}/split_rank{rank}.npz", **out)


def _jax_dropped(arch, overrides, npz):
    """JAX's dropped (token, choice) count over the MoE layers of one
    forward on the weights and batch in ``npz``, by the reference's own
    dispatch arithmetic at each layer's input."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import build_model
    from repro.models import transformer as jt
    cfg = get_config(arch).reduced().replace(dtype="float32", remat="none",
                                             **overrides)
    with np.load(npz) as f:
        tree = _tree({k[2:]: jnp.asarray(f[k]) for k in f.files
                      if k[0] == "p"})
        batch = {k[2:]: jnp.asarray(f[k]) for k in f.files if k[0] == "b"}
    dropped = []
    apply = jt.apply_moe_ffn

    def counting(p, c, x):
        t = x.shape[0] * x.shape[1]
        xf = x.reshape(t, -1)
        gates = jax.nn.softmax(xf.astype(jnp.float32) @
                               p["router"].astype(jnp.float32), axis=-1)
        _, tope = jax.lax.top_k(gates, c.top_k)
        oh = jax.nn.one_hot(tope, c.n_experts, dtype=jnp.int32)
        oh = oh.reshape(t * c.top_k, c.n_experts)
        pos = ((jnp.cumsum(oh, axis=0) * oh).sum(-1) - 1)
        cap = max(int(t * c.top_k * c.capacity_factor / c.n_experts), 1)
        jax.debug.callback(lambda n: dropped.append(int(n)),
                           (~((pos < cap) & (pos >= 0))).sum())
        return apply(p, c, x)
    jt.apply_moe_ffn = counting
    try:
        jax.block_until_ready(build_model(cfg).loss_fn(tree, batch))
        jax.effects_barrier()
    finally:
        jt.apply_moe_ffn = apply
    return sum(dropped)


@pytest.fixture(scope="module")
def split_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("split")
    want = {}
    for name, (arch, _, _, over, _) in CASES.items():
        ref = tmp / _ref_dir(name)
        if ref.exists():
            want[name] = want[next(n for n in want
                                   if _ref_dir(n) == ref.name)]
            continue
        ref.mkdir()
        want[name] = _family_reference(arch, ref, over)
        if arch.startswith("olmoe"):
            want[name] += (_jax_dropped(arch, over, ref / f"{arch}.npz"),)
    _spawn(_split_rank, 4, tmp, str(tmp))
    ranks = []
    for r in range(4):
        with np.load(tmp / f"split_rank{r}.npz") as f:
            ranks.append({k: f[k] for k in f.files})
    return ranks, want


def _worst_leaf(got, name, jgrads, cfg):
    from repro_torch.models import from_jax_params
    from repro_torch.models.params import flatten_params
    want = {k: v.detach().numpy() for k, v in flatten_params(
        from_jax_params(jgrads, cfg, "cpu")).items()}
    prefix = f"{name}/g/"
    assert {k[len(prefix):] for k in got if k.startswith(prefix)} == \
        set(want)
    worst = (0.0, None)
    for leaf, w in want.items():
        norm = float(np.linalg.norm(w.astype(np.float64)))
        if norm > 0:
            d = float(np.linalg.norm(got[prefix + leaf].astype(np.float64) -
                                     w) / norm)
            worst = max(worst, (d, leaf))
    return worst


@pytest.mark.parametrize("name", list(CASES))
def test_split_loss_grads_and_local_shapes(split_runs, name):
    """The split port's loss within rtol 2e-5 and every gradient leaf
    within relative L2 2e-4 of JAX's single-device ``value_and_grad``;
    each rank's local calls see only its share."""
    from repro_torch.configs import get_config
    ranks, want = split_runs
    arch, dims, preset, over, blocks = CASES[name]
    n_model = dims[-1]
    cfg = get_config(arch).reduced().replace(dtype="float32", remat="none",
                                             **over)
    got = ranks[0]
    loss, jgrads = want[name][:2]
    worst = _worst_leaf(got, name, jgrads, cfg)
    print(f"{name}: loss {got[f'{name}/loss']:.8g} (JAX {loss:.8g}), worst "
          f"leaf {worst[1]} at relative L2 {worst[0]:.3g}")
    np.testing.assert_allclose(got[f"{name}/loss"], loss, rtol=2e-5)
    assert worst[0] <= 2e-4, worst
    for r, rk in enumerate(ranks):
        if arch.startswith("tinyllama"):
            # H 4, Hkv 2 over model 4: 1 q head and its 1 kv head a rank
            assert rk[f"{name}/flash"].tolist() == [[1, 1]] * cfg.n_layers
        if arch.startswith("mamba2"):
            assert rk[f"{name}/ssd"].tolist() == \
                [cfg.ssm_n_heads // n_model] * cfg.n_layers
        if arch.startswith("olmoe"):
            ep = n_model * (dims[-2] if preset == "ep_wide" else 1)
            e_l = cfg.n_experts // ep
            seen = rk[f"{name}/experts"]
            assert seen[:, 0].tolist() == [e_l] * cfg.n_layers, r
            assert rk[f"{name}/expert_leaves"].tolist() == \
                [e_l] * (3 * cfg.n_layers), r
    if arch.startswith("olmoe"):
        # a rank's count covers its token block
        dropped = sum(int(ranks[r][f"{name}/experts"][:, 1].sum())
                      for r in blocks)
        print(f"{name}: dropped choices {dropped} (JAX {want[name][2]})")
        assert dropped == want[name][2] > 0


def test_mamba2_decode_keeps_the_head_split_state(split_runs):
    """Two decode steps of reduced Mamba2 on the 1 x 4 mesh: the state
    stays split on its heads (``("layers", "batch", "act_heads", ...)``)
    and logits and cache agree with the unsharded decode."""
    got = split_runs[0][0]
    # (L, B, H, P, N): the batch over data, the heads over model
    assert got["mamba2-1x4/decode_placements"].tolist() == [1, 2]
    assert float(got["mamba2-1x4/decode_err"]) <= 1e-5


# ------------------------------------------------- per-rank bodies, CPU


@pytest.mark.parametrize("h,hkv,ways", [(4, 2, 4), (32, 4, 16), (8, 2, 8),
                                        (8, 1, 4), (16, 2, 16)])
def test_gqa_local_rank_by_rank_equals_the_whole_heads(h, hkv, ways):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sharded
    rng = np.random.RandomState(h * 100 + ways)
    b, s, d = 2, 24, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((b, s, h, d), (b, s, hkv, d),
                                   (b, s, hkv, d)))
    want = fa.flash_attention(q, k, v, causal=True)
    hl = h // ways
    got = torch.cat([sharded.gqa_local(q[:, :, r * hl:(r + 1) * hl], k, v,
                                       r, ways, True)
                     for r in range(ways)], dim=2)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ways", [2, 4, 16])
def test_ssd_local_over_head_blocks_equals_the_plain_scan(ways):
    from repro_torch.kernels.ssd_scan import ssd_scan
    rng = np.random.RandomState(ways)
    b, s, h, p, n = 2, 40, 16, 8, 16

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))
    x, bm, cm = arr(b, s, h, p), arr(b, s, 1, n), arr(b, s, 1, n)
    dt = torch.nn.functional.softplus(arr(b, s, h))
    a, skip = -torch.exp(arr(h, scale=0.5)), arr(h)
    want_y, want_state = ssd_scan(x, dt, a, bm, cm, chunk=16, d_skip=skip)
    hl = h // ways
    parts = [ssd_scan(x[:, :, r * hl:(r + 1) * hl].contiguous(),
                      dt[:, :, r * hl:(r + 1) * hl], a[r * hl:(r + 1) * hl],
                      bm, cm, chunk=16, d_skip=skip[r * hl:(r + 1) * hl])
             for r in range(ways)]
    torch.testing.assert_close(torch.cat([y for y, _ in parts], dim=2),
                               want_y, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(torch.cat([st for _, st in parts], dim=1),
                               want_state, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("token_blocks,expert_blocks,factor", [
    (1, 4, 0.5), (2, 2, 0.5), (2, 4, 1.25), (4, 8, 0.5), (4, 1, 0.25)])
def test_expert_partial_summed_over_blocks_equals_apply_moe_ffn(
        token_blocks, expert_blocks, factor):
    from types import SimpleNamespace
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, moe
    cfg = get_config("olmoe-1b-7b").reduced().replace(
        dtype="float32", capacity_factor=factor)
    p = build_model(cfg).init(3, device="cpu").blocks[0].ffn
    b, s, d = 4, 16, cfg.d_model
    x = torch.from_numpy(np.random.RandomState(token_blocks).standard_normal(
        (b, s, d)).astype(np.float32))
    with torch.no_grad():
        want = moe.apply_moe_ffn(p, cfg, x).reshape(b * s, d)
        _, _, _, want_keep = moe.route(p, cfg, x.reshape(b * s, d))
    cap = moe.capacity(cfg, b * s)
    e_l = cfg.n_experts // expert_blocks
    xs = x.reshape(b * s, d).chunk(token_blocks)
    with torch.no_grad():
        routes = [moe.route(p, cfg, xb)[:3] for xb in xs]
    counts = [moe.expert_counts(tope, cfg.n_experts) for _, tope, _ in routes]
    got, keeps = [], []
    for t, xb in enumerate(xs):
        topw, tope, pos = routes[t]
        offsets = sum(counts[:t], torch.zeros_like(counts[0]))
        routing = (topw, tope, pos + offsets[tope])
        y = torch.zeros_like(xb)
        for e in range(expert_blocks):
            w = SimpleNamespace(router=p.router, **{
                n: getattr(p, n)[e * e_l:(e + 1) * e_l]
                for n in ("wi_gate", "wi_up", "wo")})
            with torch.no_grad():
                part, keep = moe.expert_partial(w, cfg, xb, routing, cap=cap,
                                                first=e * e_l)
            y += part
        got.append(y)
        keeps.append(keep)
    assert torch.cat(keeps).tolist() == want_keep.tolist()
    if factor < 1:
        assert not want_keep.all(), "no choice was dropped"
    torch.testing.assert_close(torch.cat(got), want, rtol=1e-5, atol=1e-6)
