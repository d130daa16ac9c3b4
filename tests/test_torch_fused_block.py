"""The decoder block's fused elementwise ops (``kernels/fused_block.py``)
on the CPU, where each runs its plain version.

* Each plain version equals the chain the serving engine ran before the
  fusion (``rms_norm``, ``apply_rope``, ``index_put_`` of the live lanes,
  ``F.silu`` and the product), byte for byte, in fp32 and bf16, at
  Qwen3-32B's widths (64 / 8 heads, D 128, q/k norm) and TinyLlama-1.1B's
  (32 / 4 heads, D 64, no q/k norm).
* A negative page writes nothing: padding rows and lanes leave every page
  byte as it was.
* Each of the engine's device calls (the decode step, a single-sequence
  and a packed prompt chunk through the one prefill device function, the
  speculative verify) writes exactly its live lanes' slots, in every
  layer, of a K/V pair and (but the verify) of a latent pool.
* ``stats()`` counts the decoder-block passes, all of them eager on the
  CPU, and the benchmark's reader of the two counters
  (``h100bench/metrics/engine.fused_block_share.py``) turns window totals
  into the fused share.

The CUDA kernels are held against these plain versions on the card in
``tests/test_torch_kernels_cuda.py``."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import serving
from repro_torch.configs import get_config
from repro_torch.kernels import fused_block, ops
from repro_torch.models import build_model
from repro_torch.models.layers import apply_rope, rms_norm, rope_angles
from repro_torch.serving.engine import Request, _Seq

# (d, H, Hkv, D, qk_norm, d_ff, rope_theta) of the published configs
SHAPES = {"qwen3-32b": (5120, 64, 8, 128, True, 25600, 1e6),
          "tinyllama-1.1b": (2048, 32, 4, 64, False, 5632, 1e4)}
PAGE = 8
N_PAGES = 16


def _randn(rng, shape, dtype):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _kv_case(shape, dtype, seed, b=2, s=3):
    """q, k, v of (b, s) lanes, the norms, the lanes' rope angles, a pool
    and targets with padding lanes (page -1) between live ones."""
    _, h, hkv, d, qk_norm, _, theta = SHAPES[shape]
    rng = np.random.RandomState(seed)
    n = b * s
    q = _randn(rng, (b, s, h, d), dtype)
    k = _randn(rng, (b, s, hkv, d), dtype)
    v = _randn(rng, (b, s, hkv, d), dtype)
    q_norm = _randn(rng, (d,), dtype) if qk_norm else None
    k_norm = _randn(rng, (d,), dtype) if qk_norm else None
    positions = torch.from_numpy(rng.randint(0, 4000, size=(b, s)))
    angles = rope_angles(positions, d, theta)
    k_pages = _randn(rng, (N_PAGES, PAGE, hkv, d), dtype)
    v_pages = _randn(rng, (N_PAGES, PAGE, hkv, d), dtype)
    slots = rng.permutation(N_PAGES * PAGE)[:n]
    wr_page = torch.from_numpy((slots // PAGE).astype(np.int64))
    wr_slot = torch.from_numpy((slots % PAGE).astype(np.int64))
    wr_page[1::2] = -1
    return q, k, v, q_norm, k_norm, angles, k_pages, v_pages, wr_page, \
        wr_slot


def _eager_qk(q, k, v, q_norm, k_norm, angles, k_pages, v_pages, wr_page,
              wr_slot):
    """The engine's chain before the fusion: ``_qkv``'s q/k norm, two
    ``apply_rope`` and the ``index_put_`` of the live lanes."""
    if q_norm is not None:
        q, k = rms_norm(q, q_norm), rms_norm(k, k_norm)
    q, k = apply_rope(q, angles), apply_rope(k, angles)
    live = torch.nonzero(wr_page >= 0)[:, 0]
    flat = (wr_page.shape[0],) + k_pages.shape[2:]
    k_pages[wr_page[live], wr_slot[live]] = k.reshape(flat)[live]
    v_pages[wr_page[live], wr_slot[live]] = v.reshape(flat)[live]
    return q


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["add_rms_norm", "qk_norm_rope_write",
                                "silu_mul"])
def test_plain_version_equals_the_eager_chain(op, dtype, shape):
    d, _, _, _, _, d_ff, _ = SHAPES[shape]
    rng = np.random.RandomState(3)
    if op == "add_rms_norm":
        x, r = _randn(rng, (2, 3, d), dtype), _randn(rng, (2, 3, d), dtype)
        scale = _randn(rng, (d,), dtype)
        s, h = ops.add_rms_norm(x, r, scale)
        assert torch.equal(s, x + r)
        assert torch.equal(h, rms_norm(x + r, scale))
        s, h = ops.add_rms_norm(x, None, scale)
        assert s is x and torch.equal(h, rms_norm(x, scale))
    elif op == "qk_norm_rope_write":
        case = _kv_case(shape, dtype, seed=5)
        q, k, v, q_norm, k_norm, angles, k_pages, v_pages, wr_page, \
            wr_slot = case
        kp, vp = k_pages.clone(), v_pages.clone()
        want = _eager_qk(q, k, v, q_norm, k_norm, angles, kp, vp, wr_page,
                         wr_slot)
        got = ops.qk_norm_rope_write(
            q, k, v, q_norm, k_norm, torch.cos(angles), torch.sin(angles),
            k_pages, v_pages, wr_page, wr_slot)
        assert torch.equal(got, want)
        assert torch.equal(k_pages, kp) and torch.equal(v_pages, vp)
    else:
        gate, up = _randn(rng, (4, d_ff), dtype), _randn(rng, (4, d_ff),
                                                         dtype)
        assert torch.equal(ops.silu_mul(gate, up), F.silu(gate) * up)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_negative_page_writes_nothing(dtype):
    q, k, v, q_norm, k_norm, angles, k_pages, v_pages, wr_page, wr_slot = \
        _kv_case("qwen3-32b", dtype, seed=9)
    cos, sin = torch.cos(angles), torch.sin(angles)
    kp, vp = k_pages.clone(), v_pages.clone()
    fused_block.qk_norm_rope_write_plain(
        q, k, v, q_norm, k_norm, cos, sin, k_pages, v_pages,
        torch.full_like(wr_page, -1), wr_slot)
    assert torch.equal(k_pages, kp) and torch.equal(v_pages, vp)
    fused_block.qk_norm_rope_write_plain(
        q, k, v, q_norm, k_norm, cos, sin, k_pages, v_pages, wr_page,
        wr_slot)
    changed = (k_pages != kp).any(-1).any(-1) | (v_pages != vp).any(-1) \
        .any(-1)
    live = wr_page >= 0
    want = {(int(p), int(s)) for p, s in zip(wr_page[live], wr_slot[live])}
    assert {tuple(i) for i in changed.nonzero().tolist()} == want


CONFIG = dict(num_pages=64, page_size=4, max_batch=2, max_seq_len=64,
              prefill_chunk_tokens=8)


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("tinyllama-1.1b").reduced().replace(dtype="float32")
    model = build_model(cfg)
    return model, model.init(seed=0, device="cpu")


@pytest.fixture(scope="module")
def tiny_latent():
    cfg = get_config("deepseek-v2-236b").reduced().replace(dtype="float32")
    model = build_model(cfg)
    return model, model.init(seed=0, device="cpu")


def _pools(shard):
    """The shard's pool tensors: its K/V pair, or its latent pool."""
    if shard.k_pages is None:
        return (shard.stack.latent_pages,)
    return shard.k_pages, shard.v_pages


def _changed(before, after):
    """(layer, page, slot) triples whose K or V (or latent) changed."""
    diff = torch.stack([(a != b).flatten(3).any(dim=-1)
                        for a, b in zip(before, after)]).any(dim=0)
    return {tuple(i) for i in diff.nonzero().tolist()}


@pytest.mark.parametrize("path", ["decode", "chunk", "packed", "verify",
                                  "latent-decode", "latent-chunk",
                                  "latent-packed"])
def test_device_functions_write_only_their_live_lanes(tiny, request, path):
    """Each device function called with padding: a batch row that is not
    occupied (its block table aliasing a live row's pages), padding lanes
    of a prompt chunk, verify lanes past a row's draft depth or of an
    unoccupied row.  Exactly the live lanes' (page, slot) change, in every
    layer; every other page byte is as it was.  ``latent-`` runs the path
    on an MLA model's latent pool."""
    conf = dict(CONFIG, spec_k=2) if path == "verify" else dict(CONFIG)
    if path.startswith("latent-"):
        # a latent pool takes no live migration, the default watchdog's
        model, params = request.getfixturevalue("tiny_latent")
        path = path[len("latent-"):]
        conf["watchdog"] = "off"
    else:
        model, params = tiny
    if path == "packed":
        conf["scheduler"] = "packed"
    session = serving.serve(model, params, serving.ServingConfig(**conf),
                            device="cpu", start=False)
    shard = session.engine.shards[0]
    n_layers, pgsz = model.cfg.n_layers, shard.page_size
    row = np.arange(3, 3 + shard.max_pages, dtype=np.int32)  # a page run
    dev = shard._to_dev
    rng = np.random.RandomState(1)
    for seed, pool in enumerate(_pools(shard), start=2):
        pool.normal_(generator=torch.Generator().manual_seed(seed))
    before = tuple(pool.clone() for pool in _pools(shard))
    with torch.inference_mode():
        if path == "decode":
            # row 0 live at position 9, row 1 padding aliasing row 0
            bt = np.stack([row, row])
            ctx = np.asarray([10, 10], np.int32)
            occ = np.asarray([True, False])
            wr_page = np.asarray([row[9 // pgsz], -1], np.int64)
            pos = (ctx - 1).astype(np.int64)
            shard._paged_decode_step(
                dev(bt), dev(ctx), dev(np.asarray([5, 6], np.int64)),
                dev(occ), dev(pos), dev(wr_page), dev(pos % pgsz))
            live = [9]
        elif path == "chunk":
            # 5 valid lanes of an 8-lane chunk from position 4, as one
            # segment of the prefill device function; the prompt goes on
            req = Request(prompt=rng.randint(1, 100, size=20).tolist())
            req._hit_tokens = 4
            shard._advance_prefill(_Seq(req, [], 0, row), 5)
            live = list(range(4, 9))
        elif path == "packed":
            # two segments of 3 and 2 lanes, then padding
            seg = np.asarray([0, 0, 0, 1, 1, -1, -1, -1], np.int32)
            pos = np.asarray([0, 1, 2, 8, 9, 0, 0, 0], np.int32)
            rows = np.stack([row, row + 20]).astype(np.int32)
            upd = np.full((8,), -1, np.int64)
            upd[:5] = rows[seg[:5], pos[:5] // pgsz]
            shard._paged_prefill_packed(
                dev(rng.randint(1, 100, size=8).astype(np.int64)), dev(seg),
                dev(pos), dev(rows), dev(np.asarray([3, 10], np.int32)),
                dev(np.asarray([2, 4], np.int64)), dev(upd),
                dev((pos % pgsz).astype(np.int64)))
            live = None
            want = {(i, int(upd[j]), int(pos[j] % pgsz))
                    for i in range(n_layers) for j in range(5)}
        else:
            # row 0 live at ctx 6 with one draft token (lanes at 5, 6);
            # its third lane and row 1 (unoccupied) are dead
            b = shard.max_batch
            ctx = np.asarray([6, 1], np.int64)
            sampf = np.zeros((b, 2), np.float32)
            sampi = np.zeros((b, 2), np.int64)
            d_toks, q_dists = shard._draft_propose(
                dev(np.zeros((b, pgsz * 2), np.int64)), dev(ctx), sampf,
                sampi)
            shard._spec_verify(np.asarray([7, 0], np.int64), d_toks, ctx,
                               np.asarray([1, 0], np.int64),
                               np.asarray([True, False]),
                               np.stack([row, row]), sampf, sampi, q_dists)
            live = [5, 6]
    session.close()
    if live is not None:
        want = {(i, int(row[p // pgsz]), p % pgsz)
                for i in range(n_layers) for p in live}
    assert _changed(before, _pools(shard)) == want


def test_stats_count_block_passes_all_eager_on_the_cpu(tiny):
    model, params = tiny
    session = serving.serve(model, params, serving.ServingConfig(**CONFIG),
                            device="cpu")
    handles = session.submit_many([[1, 2, 3, 4, 5], list(range(9, 30))],
                                  max_new_tokens=4)
    for h in handles:
        h.result(timeout=120)
    stats = session.stats()
    session.close()
    totals = stats["totals"]
    n_layers = model.cfg.n_layers
    assert totals["fused_blocks"] == 0
    assert totals["eager_blocks"] > 0
    assert totals["eager_blocks"] % n_layers == 0
    for shard in stats["shards"]:
        assert shard["fused_blocks"] == 0
        assert shard["eager_blocks"] % n_layers == 0


def _share_reader():
    path = (Path(__file__).resolve().parents[1] / "h100bench" / "metrics"
            / "engine.fused_block_share.py")
    spec = importlib.util.spec_from_file_location(
        "fused_block_share_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fused_block_share_reader():
    """Fused block passes over all block passes in the window; nothing
    where no block ran or the program has no such counters."""
    reader = _share_reader()

    def run(a, b):
        return SimpleNamespace(stats_a=a, stats_b=b, seconds=50.0)

    assert reader.TRACED and reader.UNIT == "%"
    a = {"fused_blocks": 640, "eager_blocks": 0}
    assert reader.read(run(a, {"fused_blocks": 6400,
                               "eager_blocks": 0})) == 100.0
    assert reader.read(run({}, {"fused_blocks": 30,
                                "eager_blocks": 10})) == 75.0
    assert reader.read(run(a, a)) is None
    assert reader.read(run({}, {"steps": 5})) is None
