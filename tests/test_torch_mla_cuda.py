"""The MLA kernels and the dropless expert layer held against their plain
PyTorch versions on the card: the absorbed-form attention over a paged
latent pool (decode and prefill entry names, 64 and 128 heads, contexts 0
to 2,600, pages of 8 and 16, one split and several, unoccupied rows
aliasing live rows' pages), the latent store (a page of -1 writes nothing,
interleaved and plain rope), and the grouped-product expert layer against
the plain loop over experts.

Every test needs a CUDA device and skips without one; this module imports
neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mla_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import mla_attention as tmla
from repro_torch.models.config import options
from repro_torch.models import moe as tmoe
from repro_torch.models.mla import rope_table
from repro_torch.models.params import MoEFFNParams

pytestmark = pytest.mark.cuda

SCALE = 0.1147   # about DeepSeek-V2's YaRN score scale


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _attention_inputs(b, h, page, n_pages, n_phys, ctx, seed, alias=False):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.standard_normal((b, h, 576)).astype(np.float32))
    pool = torch.from_numpy(
        rng.standard_normal((n_phys, page, 576)).astype(np.float32))
    tables = torch.from_numpy(
        rng.randint(0, n_phys, size=(b, n_pages)).astype(np.int32))
    occ = torch.ones(b, dtype=torch.bool)
    if alias:
        for i in range(1, b, 2):
            tables[i] = tables[i - 1]
            occ[i] = False
    return (q.bfloat16(), pool.bfloat16(), tables,
            torch.tensor(ctx, dtype=torch.int32), occ)


CASES = [
    # (B, H, page, n_pages, n_phys, contexts, splits)
    (3, 128, 8, 40, 64, [1, 77, 320], None),
    (2, 64, 16, 20, 32, [0, 319], 1),
    (4, 128, 8, 330, 400, [2600, 1150, 33, 2048], 1),
    (4, 128, 8, 330, 400, [2600, 1150, 33, 2048], 5),
    (1, 128, 8, 330, 400, [1999], None),
]


@pytest.mark.parametrize("prefill", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_mla_attention_matches_plain(dev, case, prefill):
    b, h, page, n_pages, n_phys, ctx, splits = case
    q, pool, tables, lens, occ = _attention_inputs(b, h, page, n_pages,
                                                   n_phys, ctx, seed=b + h)
    want = tmla.mla_attention_plain(q.float(), pool.float(), tables, lens,
                                    occ, SCALE, 512)
    tmla.launches.reset()
    got = tmla.mla_attention(q.to(dev), pool.to(dev), tables.to(dev),
                             lens.to(dev), scale=SCALE, occupancy=occ.to(dev),
                             num_splits=splits, prefill=prefill)
    torch.cuda.synchronize()
    assert tmla.launches.of("prefill" if prefill else "decode") == 1
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float().cpu(), want, rtol=2e-2,
                               atol=2e-2)
    for i, n in enumerate(ctx):
        if n == 0:
            assert (got[i] == 0).all()


def test_mla_unoccupied_rows_are_zero(dev):
    q, pool, tables, _, occ = _attention_inputs(4, 128, 8, 16, 32, [0] * 4,
                                                seed=3, alias=True)
    lens = torch.tensor([100, 100, 50, 50], dtype=torch.int32)
    got = tmla.mla_attention(q.to(dev), pool.to(dev), tables.to(dev),
                             lens.to(dev), scale=SCALE,
                             occupancy=occ.to(dev)).cpu()
    want = tmla.mla_attention_plain(q.float(), pool.float(), tables, lens,
                                    occ, SCALE, 512)
    assert (got[1] == 0).all() and (got[3] == 0).all()
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)


def test_mla_splits_refused_above_the_cap(dev):
    q, pool, tables, lens, occ = _attention_inputs(1, 64, 8, 8, 8, [10], 1)
    with pytest.raises(ValueError):
        tmla.mla_attention(q.to(dev), pool.to(dev), tables.to(dev),
                           lens.to(dev), scale=SCALE, occupancy=occ.to(dev),
                           num_splits=tmla.MAX_SPLITS + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("interleaved", [False, True])
def test_latent_store_matches_plain(dev, dtype, interleaved):
    cfg = options(get_config("deepseek-v2-236b")).replace(
        yarn_factor=40.0, yarn_mscale=0.707, yarn_mscale_all_dim=0.707)
    rng = np.random.RandomState(5)
    n, page, n_phys = 37, 8, 12
    kv = torch.from_numpy(rng.standard_normal((n, 576)).astype(np.float32))
    gain = torch.from_numpy(1 + 0.1 * rng.standard_normal(512)
                            .astype(np.float32))
    pos = torch.from_numpy(rng.randint(0, 4000, size=n))
    cos, sin = rope_table(cfg, pos)
    # distinct (page, slot) targets, about one lane in n_phys writing none
    flat = torch.from_numpy(rng.permutation(n_phys * page)[:n])
    wr_page = torch.where(torch.from_numpy(rng.randint(0, n_phys, size=n))
                          == 0, -1, flat // page)
    wr_slot = flat % page
    pool = torch.from_numpy(rng.standard_normal((n_phys, page, 576))
                            .astype(np.float32)).to(dtype)
    want = pool.clone()
    tmla.mla_latent_store_plain(kv.to(dtype), gain.to(dtype), cos, sin, want,
                                wr_page, wr_slot, interleaved, 1e-6)
    got = pool.to(dev)
    tmla.mla_latent_store(kv.to(dtype).to(dev), gain.to(dtype).to(dev),
                          cos.to(dev), sin.to(dev), got, wr_page.to(dev),
                          wr_slot.to(dev), interleaved=interleaved)
    got = got.cpu()
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    untouched = torch.ones((n_phys, page), dtype=torch.bool)
    live = wr_page >= 0
    untouched[wr_page[live], wr_slot[live]] = False
    assert torch.equal(got[untouched], pool[untouched])


@pytest.mark.parametrize("tokens", [1, 9, 256, 2048])
def test_dropless_grouped_matches_the_loop(dev, tokens):
    """bf16 grouped products against the plain loop over the held experts,
    on the same bf16 inputs and weights, at DeepSeek-V2's widths with 20
    of 160 experts held (group 3) and a padding row."""
    cfg = options(get_config("deepseek-v2-236b")).replace(
        topk_method="group_limited_greedy", n_group=8, topk_group=3,
        norm_topk_prob=False, routed_scaling_factor=16.0, experts_held=20,
        first_expert=60)
    g = torch.Generator().manual_seed(tokens)
    d, f, e = cfg.d_model, cfg.expert_d_ff, 20

    def w(*shape):
        return (torch.randn(shape, generator=g) /
                math.sqrt(shape[-2])).bfloat16()
    p = MoEFFNParams(router=w(d, 160), wi_gate=w(e, d, f), wi_up=w(e, d, f),
                     wo=w(e, f, d), shared_wi_gate=w(d, 2 * f),
                     shared_wi_up=w(d, 2 * f), shared_wo=w(2 * f, d))
    x = torch.randn((tokens, d), generator=g).bfloat16()
    live = torch.ones(tokens, dtype=torch.bool)
    live[-1] = tokens == 1
    pairs_cpu = torch.zeros((), dtype=torch.int64)
    want = tmoe.dropless_moe(p, cfg, x, live, pairs_cpu)
    p_dev = p.to(dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    got = tmoe.dropless_moe(p_dev, cfg, x.to(dev), live.to(dev), pairs)
    torch.cuda.synchronize()
    assert int(pairs) == int(pairs_cpu)
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("d", [512, 1536])
def test_add_rms_norm_at_the_latent_widths(dev, d):
    """The fused norm at MLA's q (1536) and kv (512) latent widths."""
    from repro_torch.kernels import fused_block as tfb
    g = torch.Generator().manual_seed(d)
    x = torch.randn((300, d), generator=g).bfloat16()
    scale = (1 + 0.1 * torch.randn(d, generator=g)).bfloat16()
    _, want = tfb.add_rms_norm_plain(x, None, scale)
    _, got = tfb.add_rms_norm(x.to(dev), None, scale.to(dev))
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=1e-2,
                               atol=1e-2)
