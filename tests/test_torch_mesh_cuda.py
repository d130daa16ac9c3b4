"""The sharded step on four cards: one process a card, NCCL, a 2 x 2
("data", "model") mesh, at published widths.

TinyLlama-1.1B (flash through ``local_map`` on local shards: 16 of its 32
heads and 2 of its 4 kv heads a card) and Mamba2-1.3B (the SSD scan on
local shards, the zero-initialised leaves perturbed) in fp32, B 4 x 512,
``remat="full"``: each card's sharded loss within rtol 2e-5 of the same
model unsharded on that card, and every kernel launch counted (22 x 2
flash, 48 x 2 SSD a card).  TinyLlama's every gradient leaf within
relative L2 2e-4 of the unsharded one's.  Mamba2's 48 fp32 layers sit at
that distance by fp32 noise alone, so its gradients are held as
``chip_smoke.py`` 16b-seeds holds them: each path's per-leaf relative L2
distance to an fp64 unsharded plain path (the SSD by
``kernels.ref.ssd_quadratic``), the sharded path's median and worst leaf
each at most ``FP64_RATIO`` (2) times the unsharded fp32 path's.
OLMoE-1B-7B at 4 of its 16 layers (the cut lets both steps fit one
card), published widths, fp32, B 4 x 512: the MoE FFN expert-parallel
(32 of the 64 experts a card, token blocks over data), held as
TinyLlama is, with 2 x 4 flash launches a card.
Then ``compressed_psum`` over the whole mesh and ``hierarchical_psum``
over its data groups against the CPU's sums of each rank's int8 round
trip.  ``tests/test_torch_parallel.py`` holds the same path on a 2 x 2
gloo mesh at reduced widths on the CPU.

Needs four CUDA devices and skips with fewer:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mesh_cuda.py
"""

import json
import traceback

import numpy as np
import pytest
import torch

WORLD = 4
TIMEOUT = 900
FP64_RATIO = 2.0     # 16b-seeds' multiple, set before the run
# arch: _step's overrides.  OLMoE at 4 of its 16 layers (published widths)
# so that both the sharded and the unsharded step fit one card.
ARCHS = {"tinyllama-1.1b": {}, "mamba2-1.3b": {"fp64": True},
         "olmoe-1b-7b": {"n_layers": 4}}


def _perturb(params, seed):
    """Mamba2's zero-initialised decay, skip and conv-bias leaves set to
    seeded normal values (scale 0.5), so every head differs."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for blk in getattr(params, "blocks", []):
            for name in ("a_log", "dt_bias", "d_skip", "conv_b"):
                t = getattr(blk, name, None)
                if t is not None:
                    t.copy_((torch.randn(t.shape, generator=gen) * 0.5)
                            .to(t.device, t.dtype))


def _rel(g, w):
    g, w = g.double(), w.double()
    return float((g - w).norm() / w.norm())


def _fp64_grads(model, params, tokens):
    """Every gradient of the fp64 copy of ``params``, the SSD by its fp64
    quadratic form in ``ops.ssd``'s place (the norms' and the loss's fp32
    islands stay)."""
    import copy
    from repro_torch.kernels import ops, ref
    from repro_torch.models.params import flatten_params
    p64 = copy.deepcopy(params).double().requires_grad_(True)
    flat = flatten_params(p64)
    kernel, ops.ssd = ops.ssd, ref.ssd_quadratic
    try:
        loss = model.loss_fn(p64, {"tokens": tokens})
        return dict(zip(flat, torch.autograd.grad(loss,
                                                  list(flat.values()))))
    finally:
        ops.ssd = kernel


def _step(arch, mesh, device, b, s, overrides):
    """(loss, sharded loss, gradient readings, launches of the sharded
    step, leaves split) of one fp32 loss + backward.  The readings are
    the worst leaf's relative L2 sharded to unsharded and, with
    ``fp64``, each path's median and worst leaf distance to the fp64
    path."""
    import copy
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, ssd_scan
    from repro_torch.models import build_model
    from repro_torch.models.params import flatten_params, param_specs
    from repro_torch.parallel.sharding import (axis_rules, placements,
                                               resolve, shard_params)
    fp64 = overrides.pop("fp64", False)
    cfg = get_config(arch).replace(dtype="float32", **overrides)
    model = build_model(cfg)
    params = model.init(0, device=device)
    _perturb(params, 1)
    params.requires_grad_(True)
    tokens = torch.from_numpy(np.random.RandomState(17).randint(
        0, cfg.vocab_size, (b, s))).to(device)
    flat = flatten_params(params)
    loss = model.loss_fn(params, {"tokens": tokens})
    grads = torch.autograd.grad(loss, list(flat.values()))
    sh = copy.deepcopy(params)
    for mod in (flash_attention, ssd_scan):
        mod.launches.reset()
    with axis_rules(mesh):
        shard_params(sh, param_specs(cfg), mesh)
        sflat = flatten_params(sh)
        tok = distribute_tensor(tokens, mesh, placements(
            resolve(("batch", "seq"), tokens.shape, mesh), mesh))
        sloss = model.loss_fn(sh, {"tokens": tok})
        sgrads = torch.autograd.grad(sloss, list(sflat.values()))
        launches = {"flash_attention": flash_attention.launches.count,
                    "ssd_scan": ssd_scan.launches.count}
        sgrads = [g.full_tensor() for g in sgrads]
        split = sum(v.to_local().shape != v.shape for v in sflat.values())
        experts = sorted({v.to_local().shape[0] for k, v in sflat.items()
                          if k.split("/")[-1] in ("wi_gate", "wi_up", "wo")
                          and v.dim() == 3})
        sloss = float(sloss.detach().full_tensor())
    del sh, sflat
    read = {"worst_grad": max(_rel(g, w) for g, w in zip(sgrads, grads)
                              if float(w.norm()) > 0),
            "experts_per_card": experts}
    if fp64:
        exact = _fp64_grads(model, params, tokens)
        for name, gs in (("sharded", sgrads), ("unsharded", grads)):
            d = [_rel(g, exact[k]) for g, k in zip(gs, flat)
                 if float(exact[k].norm()) > 0]
            read[f"{name}_median"] = float(np.median(d))
            read[f"{name}_worst"] = max(d)
    return float(loss.detach()), sloss, read, launches, split, cfg.n_layers


def _rank(rank, world, store, out):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import collectives as col
    torch.cuda.set_device(rank)
    device = torch.device("cuda", rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            device_id=device)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), "cuda")
        res = {}
        for arch, over in ARCHS.items():
            try:
                loss, sloss, read, launches, split, layers = _step(
                    arch, mesh, device, 4, 512, dict(over))
            except Exception:      # recorded; the next arch still runs
                res[arch] = {"error": traceback.format_exc()[-3000:]}
                continue
            res[arch] = dict(loss=loss, sharded_loss=sloss,
                             launches=launches, split_leaves=split,
                             layers=layers, **read)
            torch.cuda.empty_cache()
        xs = [torch.from_numpy(np.random.RandomState(r).randn(4096 + 7)
                               .astype(np.float32) * 3) for r in range(world)]
        reduced, resid = col.compressed_psum(
            xs[rank].to(device), None, torch.zeros(4096 + 7, device=device))
        sent = [col.compress_decompress(x) for x in xs]
        two_level = col.hierarchical_psum(xs[rank].to(device), mesh)
        # 2 x 2 (data, model): rank = 2 d + m; a data group shares m
        group = [r for r in range(world) if r % 2 == rank % 2]
        res["collectives"] = dict(
            compressed=float((reduced.cpu() - sum(sent)).abs().max()),
            residual_exact=bool(torch.equal(resid.cpu(),
                                            xs[rank] - sent[rank])),
            hierarchical=float((two_level.cpu() - sum(
                xs[r] for r in group)).abs().max()))
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA devices (one process a card)")


@pytest.mark.cuda
def test_sharded_steps_on_four_cards(four_cards, tmp_path):
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, WORLD, str(tmp_path / "st"),
                                             str(tmp_path)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "ranks timed out"
    assert [p.exitcode for p in procs] == [0] * WORLD
    for r in range(WORLD):
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        for arch in ARCHS:
            a = res[arch]
            print(f"rank {r} {arch}: {a}")
            assert "error" not in a, a.get("error")
            np.testing.assert_allclose(a["sharded_loss"], a["loss"],
                                       rtol=2e-5)
            if "sharded_median" in a:      # against fp64
                for what in ("median", "worst"):
                    assert a[f"sharded_{what}"] <= \
                        FP64_RATIO * a[f"unsharded_{what}"], (r, arch, what)
            else:
                assert a["worst_grad"] <= 2e-4, (r, arch)
            assert a["split_leaves"] > 0
            kernel = "ssd_scan" if arch.startswith("mamba") \
                else "flash_attention"
            assert a["launches"][kernel] == 2 * a["layers"], (r, arch)
            if arch.startswith("olmoe"):
                # 64 experts over model 2: 32 a card, never gathered
                assert a["experts_per_card"] == [32], (r, a)
        c = res["collectives"]
        print(f"rank {r} collectives: {c}")
        assert c["residual_exact"]
        assert c["compressed"] <= 1e-5 and c["hierarchical"] <= 1e-5
