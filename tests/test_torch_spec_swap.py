"""The torch port's sampled, speculative and swap-tier serving on the CPU,
held against the JAX engine on the same weights and seeds.

Both engines serve the JAX init of the reduced TinyLlama config at
``PRNGKey(7)`` (bridged with ``from_jax_params``).  The JAX engine's
streams are made once per module (``jax_streams``: one uninterrupted JAX
session per ``spec_k``, every job submitted at once); the JAX package's own
tests (``tests/test_sampling.py``, ``tests/test_swap.py``) hold those
uninterrupted streams equal to its preempted, migrated, packed and
speculative runs, so one reference serves every scenario here.  The port
must give, under ``chunked`` and ``packed``:

* seeded ``temperature`` / ``top_k`` / ``top_p`` tokens equal to the JAX
  engine's and to the port's own contiguous-cache oracle keyed by absolute
  position; logprobs within ``LP_TOL``; stop sequences halting as there;
* ``spec_k`` 2 and 4 greedy tokens equal to plain greedy, and spec-sampled
  tokens equal to the JAX engine's and deterministic across sessions;
* swap preemption and live migration token-exact against the
  uninterrupted run, with zero arena slots and zero pool pages leaked.

The one divergence a test accepts is a near-tie: at the first differing
token the port's oracle finds the top two gumbel-perturbed scores (the
top two logits for greedy) less than ``TIE_MARGIN`` apart, so the two
frameworks' last-bit rounding may pick either.  Spec-sampled streams are
held exactly.  On the CPU every stream has matched exactly."""

import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.models import build_model as jbuild_model
from repro_torch import serving
from repro_torch.configs import get_config
from repro_torch.kernels import packed_prefill as tpp
from repro_torch.kernels import ref as tref
from repro_torch.models import build_model, from_jax_params
from repro_torch.runtime.swap import SwapArena, page_nbytes
from repro_torch.serving import FaultSpec
from repro_torch.serving.engine import _ShardEngine
from repro_torch.serving.session import PrefixRouter
from test_serving import _prompt_for_shard
from test_torch_kernels_cuda import VERIFY_CTX, VERIFY_ND, _verify_chunk

CONF = dict(smr="IBR", num_pages=64, page_size=8, max_batch=4,
            max_seq_len=128)
CLASSES = ("hi:priority=10", "lo:priority=0")
LP_TOL = 1e-5
TIE_MARGIN = 1e-3

# named sampling policies: (class name, kwargs); built in either package
POLICIES = {
    "greedy": None,
    "t08": ("TemperatureSampling", dict(temperature=0.8, seed=123)),
    "t08b": ("TemperatureSampling", dict(temperature=0.8, seed=124)),
    "topk": ("TopKSampling", dict(k=20, temperature=0.9, seed=7)),
    "topp": ("TopPSampling", dict(p=0.8, temperature=0.9, seed=7)),
    "lp": ("TemperatureSampling", dict(temperature=0.8, seed=5,
                                       logprobs=True)),
    "swap": ("TemperatureSampling", dict(temperature=0.8, seed=1234)),
    "spec": ("TemperatureSampling", dict(temperature=0.8, seed=321)),
    "mig": ("TemperatureSampling", dict(temperature=0.8, seed=777)),
    "specswap": ("TemperatureSampling", dict(temperature=0.8, seed=555)),
}


def _policy(mod, name):
    if POLICIES[name] is None:
        return None
    cls, kw = POLICIES[name]
    return getattr(mod, cls)(**kw)


def _prompts(seed, n, length):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, 200, size=length)) for _ in range(n)]


def _migration_prompts(n=2):
    """``n`` prompts the two-shard router places on shard 0."""
    router = PrefixRouter(2, CONF["page_size"])
    rng = np.random.RandomState(11)
    return [_prompt_for_shard(router, rng, 0, 10) for _ in range(n)]


def _jobs():
    """(key, prompt, max_new_tokens, policy, spec_k) of every stream the
    tests compare."""
    rng = np.random.RandomState(5)
    jobs = [(("t08", i), p, 6, "t08", 0) for i, p in enumerate(
        [list(rng.randint(1, 200, size=n)) for n in (9, 13)])]
    p11 = _prompts(6, 1, 11)[0]
    jobs += [(("topk", 0), p11, 6, "topk", 0), (("topp", 0), p11, 6, "topp",
                                                 0),
             (("lp", 0), p11, 5, "lp", 0)]
    rng = np.random.RandomState(9)
    jobs += [(("greedy", i), list(rng.randint(1, 200, size=n)), 8,
              "greedy", 0) for i, n in enumerate((9, 17, 12))]
    for pol, spec_k, seed in (("swap", 0, 42), ("greedy", 0, 43),
                              ("specswap", 2, 47)):
        lows, highs = _prompts(seed, 6, 16), _prompts(seed + 100, 2, 16)
        jobs += [((pol + "_lo", i), p, 48, pol, spec_k)
                 for i, p in enumerate(lows)]
        jobs += [((pol + "_hi", i), p, 32, pol, spec_k)
                 for i, p in enumerate(highs)]
    jobs += [(("mig", i), p, 20, "mig", 0)
             for i, p in enumerate(_migration_prompts())]
    jobs += [(("miggreedy", 0), _migration_prompts(3)[2], 20, "greedy", 0)]
    jobs += [(("spec", i), p, 8, "spec", 2)
             for i, p in enumerate(_prompts(10, 2, 11))]
    low, hi = _prompts(44, 2, 16)
    jobs += [(("exhaust", 0), low, 48, "greedy", 0),
             (("exhaust", 1), hi, 40, "greedy", 0)]
    return jobs


JOBS = {key: (p, n, pol, k) for key, p, n, pol, k in _jobs()}


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("tinyllama-1.1b").reduced().replace(dtype="float32")
    jmodel = jbuild_model(jcfg)
    jp, _ = jmodel.init(jax.random.PRNGKey(7))
    cfg = get_config("tinyllama-1.1b").reduced().replace(dtype="float32")
    model = build_model(cfg)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return jmodel, jp, model, tp


@pytest.fixture(scope="module")
def jax_streams(models):
    """key → (tokens, logprobs) of every job, from the JAX engine: one
    uninterrupted session per spec_k."""
    jmodel, jp, _, _ = models
    out = {}
    for spec_k in (0, 2):
        keys = [k for k, job in JOBS.items() if job[3] == spec_k]
        session = jserving.serve(jmodel, jp, jserving.ServingConfig(
            backend="xla", spec_k=spec_k, **CONF))
        handles = [session.submit(JOBS[k][0], max_new_tokens=JOBS[k][1],
                                  sampling=_policy(jserving, JOBS[k][2]))
                   for k in keys]
        for k, h in zip(keys, handles):
            out[k] = (h.result(timeout=300), h.logprobs())
        session.close()
    return out


def _oracle(model, params, prompt, n_new, policy):
    """The port's contiguous-cache decode + its sampler keyed by ABSOLUTE
    position → (tokens, margins): margins[j] is the gap between the top
    two scores the j-th pick compared (gumbel-perturbed log-probs under
    the filtered distribution; plain logits for greedy)."""
    t_f, k_i, p_f, seed = policy.operands() if policy else (0.0, 0, 1.0, 0)
    cache = model.init_cache(1, len(prompt) + n_new + 1, device="cpu")
    toks, out, margins = list(prompt), [], []
    for t in range(len(prompt) + n_new):
        logits, cache = model.decode_step(params, cache, {
            "tokens": torch.tensor([[toks[t]]]),
            "cache_len": torch.tensor([t + 1], dtype=torch.int32)})
        if t < len(prompt) - 1:
            continue
        if t_f <= 0:
            score = logits[0]
        else:
            dist = tref.filtered_dist_ref(logits, [t_f], [k_i], [p_f])
            key = tref.sample_key_ref(torch.tensor([seed]),
                                      torch.tensor([t + 1]), 0)
            score = torch.log(torch.clamp(dist, min=1e-30))[0] + \
                tref.gumbel(key, dist.shape[-1])[0]
        top = torch.topk(score, 2).values
        out.append(int(torch.argmax(score)))
        margins.append(float(top[0] - top[1]))
        if len(out) == n_new:
            return out, margins
        toks.append(out[-1])


def _assert_stream(out, want, margins=None):
    """Equal, or the first differing token is a near-tie by ``margins``
    (taken along the reference stream, so valid up to that token)."""
    if out == want:
        return
    assert margins is not None, (out, want)
    j = next(i for i, (a, b) in enumerate(zip(out, want)) if a != b)
    assert margins[j] < TIE_MARGIN, \
        f"token {j}: {out[j]} != {want[j]} at margin {margins[j]:.3g}"


def _serve(model, tp, **over):
    kw = dict(CONF)
    kw.update(over)
    return serving.serve(model, tp, serving.ServingConfig(**kw),
                         device="cpu")


def _run(model, tp, keys, **over):
    session = _serve(model, tp, **over)
    handles = [session.submit(JOBS[k][0], max_new_tokens=JOBS[k][1],
                              sampling=_policy(serving, JOBS[k][2]))
               for k in keys]
    outs = [h.result(timeout=300) for h in handles]
    totals = session.stats()["totals"]
    shard = session.engine.shards[0]
    session.close()
    assert shard.pool.free_count() == shard.config.num_pages
    return outs, totals, handles


# ============================================== sampling through the engine
@pytest.mark.parametrize("scheduler", ["chunked", "packed"])
def test_seeded_sampling_matches_jax_and_oracle(models, jax_streams,
                                                scheduler):
    _, _, model, tp = models
    keys = [("t08", 0), ("t08", 1)]
    outs, _, _ = _run(model, tp, keys, scheduler=scheduler)
    again, _, _ = _run(model, tp, keys, scheduler=scheduler)
    assert outs == again, "same seed, different stream"
    pol = _policy(serving, "t08")
    for k, out in zip(keys, outs):
        want, margins = _oracle(model, tp, JOBS[k][0], JOBS[k][1], pol)
        _assert_stream(out, want, margins)
        _assert_stream(out, jax_streams[k][0], margins)
    # a different seed decodes a different stream (overwhelmingly)
    session = _serve(model, tp, scheduler=scheduler)
    other = [session.submit(JOBS[k][0], max_new_tokens=6, sampling=_policy(
        serving, "t08b")).result(timeout=300) for k in keys]
    session.close()
    assert other != outs


@pytest.mark.parametrize("scheduler", ["chunked", "packed"])
@pytest.mark.parametrize("name", ["topk", "topp"])
def test_topk_topp_match_jax_and_oracle(models, jax_streams, name,
                                        scheduler):
    _, _, model, tp = models
    key = (name, 0)
    (out,), _, _ = _run(model, tp, [key], scheduler=scheduler)
    want, margins = _oracle(model, tp, JOBS[key][0], 6,
                            _policy(serving, name))
    _assert_stream(out, want, margins)
    _assert_stream(out, jax_streams[key][0], margins)


def test_logprobs_recorded(models, jax_streams):
    _, _, model, tp = models
    prompt = JOBS[("lp", 0)][0]
    session = _serve(model, tp)
    g = session.submit(prompt, max_new_tokens=5,
                       sampling=serving.GreedySampling(logprobs=True))
    s = session.submit(prompt, max_new_tokens=5,
                       sampling=_policy(serving, "lp"))
    n = session.submit(prompt, max_new_tokens=5)
    for h in (g, s, n):
        assert h.wait(timeout=300)
    session.close()
    assert g.logprobs() == [0.0] * 5        # greedy sentinel: lp 0
    want_toks, want_lps = jax_streams[("lp", 0)]
    assert s.result() == want_toks
    np.testing.assert_allclose(s.logprobs(), want_lps, rtol=0, atol=LP_TOL)
    assert all(lp <= 0.0 for lp in s.logprobs())
    assert n.logprobs() == []               # not requested, not recorded


def test_stop_sequence_halts_generation(models, jax_streams):
    _, _, model, tp = models
    prompt = JOBS[("greedy", 0)][0]
    full = jax_streams[("greedy", 0)][0]
    stop = tuple(full[2:4])                 # matches after the 4th token
    session = _serve(model, tp)
    out = session.submit(prompt, max_new_tokens=8, sampling=serving
                         .GreedySampling(stop=(stop,))).result(timeout=300)
    unused = next(t for t in range(1, 300) if t not in full)
    inert = session.submit(prompt, max_new_tokens=8, sampling=serving
                           .GreedySampling(stop=((unused,),))).result(
        timeout=300)
    session.close()
    assert out == full[:4], "stop sequence did not halt at the match"
    assert inert == full


# ================================================== speculative decoding
@pytest.mark.parametrize("scheduler", ["chunked", "packed"])
@pytest.mark.parametrize("spec_k", [2, 4])
def test_spec_greedy_equals_plain_greedy(models, jax_streams, spec_k,
                                         scheduler):
    """Under one-hot dists the rejection sampler accepts exactly the
    argmax-matching prefix, so spec-greedy reproduces plain greedy (the
    JAX engine's) token for token while counting proposals."""
    _, _, model, tp = models
    keys = [("greedy", i) for i in range(3)]
    outs, totals, _ = _run(model, tp, keys, spec_k=spec_k,
                           scheduler=scheduler)
    for k, out in zip(keys, outs):
        _, margins = _oracle(model, tp, JOBS[k][0], JOBS[k][1], None)
        _assert_stream(out, jax_streams[k][0], margins)
    assert totals["draft_proposed"] > 0
    assert 0.0 <= totals["accept_rate"] <= 1.0


@pytest.mark.parametrize("scheduler", ["chunked", "packed"])
def test_spec_greedy_row_emits_its_first_token_at_prefill(models, scheduler):
    """In speculative mode a greedy row emits its first token from the
    final prefill chunk, as plain greedy does (so no verify lane
    recomputes the last prompt position, which the prefill chunk wrote);
    a sampled row emits nothing there and draws its first token in a spec
    round, as the reference does.  Both then finish their streams."""
    _, _, model, tp = models
    session = serving.serve(model, tp, serving.ServingConfig(
        spec_k=2, scheduler=scheduler, **CONF), device="cpu", start=False)
    shard = session.engine.shards[0]
    keys = [("greedy", 0), ("spec", 0)]
    handles = [session.submit(JOBS[k][0], max_new_tokens=JOBS[k][1],
                              sampling=_policy(serving, JOBS[k][2]))
               for k in keys]
    before = []                 # each stream as the first round finds it
    spec_round = shard._spec_round

    def recording():
        if not before:
            before.extend(list(h.req.out_tokens) for h in handles)
        spec_round()
    shard._spec_round = recording
    try:
        with torch.inference_mode():
            while shard.step():
                pass
    finally:
        session.close()
    want, _ = _oracle(model, tp, JOBS[keys[0]][0], 1, None)
    assert before == [want, []]
    assert [len(h.req.out_tokens) for h in handles] == \
        [JOBS[k][1] for k in keys]


@pytest.mark.parametrize("scheduler", ["chunked", "packed"])
def test_spec_sampled_matches_jax_and_is_deterministic(models, jax_streams,
                                                       scheduler):
    _, _, model, tp = models
    keys = [("spec", 0), ("spec", 1)]
    one, st1, _ = _run(model, tp, keys, spec_k=2, scheduler=scheduler)
    two, st2, _ = _run(model, tp, keys, spec_k=2, scheduler=scheduler)
    assert one == two, "seeded spec decode not deterministic"
    assert st1["draft_accepted"] == st2["draft_accepted"]
    assert st1["draft_proposed"] > 0
    assert one == [jax_streams[k][0] for k in keys]
    assert all(len(o) == 8 for o in one)


# ========================= interrupted ≡ uninterrupted (swap, migration)
def _arena_bytes(model, slots=64):
    cfg = model.cfg
    return slots * page_nbytes(cfg.n_layers, 8, cfg.n_kv_heads,
                               cfg.head_dim, "float32")


def _swap_over(model, **over):
    kw = dict(num_pages=32, admission="priority", eviction="swap",
              swap_bytes=_arena_bytes(model), priority_classes=CLASSES)
    kw.update(over)
    return kw


def _wait_decoding(handles, n, timeout=60.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if sum(1 for h in handles if h.out_tokens) >= n:
            return True
        time.sleep(0.002)
    return False


def _preempt_scenario(model, tp, pol, spec_k=0, watch=False):
    """Six lows fill the 32-page pool and the 4-row batch; two highs
    arrive and preempt.  Returns (handles lows + highs, totals, shard,
    whether a low was seen parked as ``swapped``)."""
    session = _serve(model, tp, spec_k=spec_k, **_swap_over(model))
    session.warm()
    lows = [session.submit(JOBS[(pol + "_lo", i)][0], max_new_tokens=48,
                           priority_class="lo",
                           sampling=_policy(serving, pol))
            for i in range(6)]
    assert _wait_decoding(lows, 4), "lows never saturated the batch"
    highs = [session.submit(JOBS[(pol + "_hi", i)][0], max_new_tokens=32,
                            priority_class="hi",
                            sampling=_policy(serving, pol))
             for i in range(2)]
    saw_swapped = False
    deadline = time.perf_counter() + (30.0 if watch else 0.0)
    while time.perf_counter() < deadline and not saw_swapped:
        saw_swapped = any(h.status == "swapped" for h in lows)
        time.sleep(0.0005)
    for h in lows + highs:
        assert h.wait(timeout=300), "request hung under preemption"
    totals = session.stats()["totals"]
    shard = session.engine.shards[0]
    session.close()
    # nothing leaks: every device page home, every arena slot free
    assert shard.pool.free_count() == shard.config.num_pages
    assert shard.swap_arena.slots_used() == 0
    assert shard.swap_arena.stats()["sequences"] == 0
    return lows + highs, totals, shard, saw_swapped


def _want(jax_streams, pol):
    return [jax_streams[(pol + "_lo", i)][0] for i in range(6)] + \
        [jax_streams[(pol + "_hi", i)][0] for i in range(2)]


def test_preempt_resume_token_exact(models, jax_streams):
    """Greedy: a high-priority arrival preempts low-priority decoders into
    the host arena, the victims park as ``swapped``, resume, and every
    stream equals the JAX engine's uncontended one; zero leaks."""
    _, _, model, tp = models
    handles, totals, _, saw = _preempt_scenario(model, tp, "greedy",
                                                watch=True)
    assert saw, "no low was ever observed in 'swapped' status"
    assert totals["preemptions"] >= 1 and totals["resumed"] >= 1
    assert totals["swapped_out"] >= 1
    assert sum(h.preemptions for h in handles[:6]) >= 1
    assert all(h.preemptions == 0 for h in handles[6:])
    # a resumed sequence gets every written position back from the arena
    # and goes straight to decode: the only prefill chunks are the eight
    # 16-token prompts' own
    assert totals["prefill_chunks"] == len(handles)
    for h, want in zip(handles, _want(jax_streams, "greedy")):
        assert h.status == "done", (h.status, h.req.error)
        assert h.result() == want, \
            f"preempted decode diverged (preemptions={h.preemptions})"


def test_sampled_preempt_resume_token_exact(models, jax_streams):
    """Seeded temperature=0.8 requests that are swap-preempted and resumed
    emit exactly the uninterrupted JAX streams; the park interval is
    excluded from itl() and visible in gaps()."""
    _, _, model, tp = models
    handles, totals, _, _ = _preempt_scenario(model, tp, "swap")
    assert totals["preemptions"] >= 1 and totals["resumed"] >= 1
    for h, want in zip(handles, _want(jax_streams, "swap")):
        assert h.status == "done", (h.status, h.req.error)
        assert h.result() == want, \
            f"sampled preempted decode diverged (preempt={h.preemptions})"
    preempted = [h for h in handles[:6] if h.preemptions > 0]
    assert preempted
    for h in preempted:
        assert len(h.gaps()) >= 1 and all(g > 0 for g in h.gaps())
        assert len(h.itl()) + len(h.gaps()) == len(h.out_tokens) - 1
    assert totals["gap_intervals"] >= len(preempted)
    for h in handles[6:]:
        if h.preemptions == 0:
            assert h.gaps() == []


def test_spec_preempt_resume_token_exact(models, jax_streams):
    """Speculative mode composes with preemption: nd/accept/residual
    schedules are pure position functions, so a preempted+resumed spec
    request replays the uninterrupted JAX spec stream exactly."""
    _, _, model, tp = models
    handles, totals, _, _ = _preempt_scenario(model, tp, "specswap",
                                              spec_k=2)
    assert totals["preemptions"] >= 1
    assert totals["draft_proposed"] > 0
    for h, want in zip(handles, _want(jax_streams, "specswap")):
        assert h.status == "done", (h.status, h.req.error)
        assert h.result() == want, \
            f"spec preempted decode diverged (preempt={h.preemptions})"


def test_sampled_migration_token_exact(models, jax_streams):
    """A stalled shard's seeded-sampled sequences live-migrate and still
    emit the uninterrupted JAX streams: teacher-forced replay + counter
    PRNG.  The migration stall is a gap, not an ITL."""
    _, _, model, tp = models
    session = _serve(model, tp, num_shards=2, num_pages=128,
                     heartbeat_timeout_s=0.25, watchdog_interval_s=0.02,
                     faults=(FaultSpec(kind="stall", shard=0, after_done=1,
                                       duration_s=2.0),))
    rng = np.random.RandomState(12)
    router = session.engine.router
    short = session.submit(_prompt_for_shard(router, rng, 0, 10),
                           max_new_tokens=2)
    keys = [("mig", 0), ("mig", 1)]
    handles = [session.submit(JOBS[k][0], max_new_tokens=20,
                              sampling=_policy(serving, "mig"))
               for k in keys]
    assert short.result(timeout=300) is not None
    outs = [h.result(timeout=300) for h in handles]
    totals = session.stats()["totals"]
    shards = session.engine.shards
    session.close()
    assert totals["migrations"] >= 1, "stall never forced a migration"
    assert totals["failed_requests"] == 0
    assert outs == [jax_streams[k][0] for k in keys]
    migrated = [h for h in handles if h.gaps()]
    assert migrated, "no migrated request recorded its adoption gap"
    for h in migrated:
        assert len(h.itl()) + len(h.gaps()) == len(h.out_tokens) - 1
    for shard in shards:
        assert shard.pool.free_count() == shard.config.num_pages


def test_migration_carries_pages_and_replays_exactly(models, jax_streams,
                                                     monkeypatch):
    """Live migration carries a decoding sequence's pages to the target
    shard (no re-prefill of the emitted tokens) and resumes it straight
    into decode: a greedy and a seeded-sampled request, both mid-decode
    when shard 0 stalls, still emit the uninterrupted JAX streams in fp32,
    and both pools are whole after close."""
    _, _, model, tp = models
    restored = []
    carried = _ShardEngine._restore_carried

    def counting(self, req, seq):
        restored.append((req.req_id, req._carried[2]))
        carried(self, req, seq)
    monkeypatch.setattr(_ShardEngine, "_restore_carried", counting)
    session = _serve(model, tp, num_shards=2, num_pages=128,
                     heartbeat_timeout_s=0.25, watchdog_interval_s=0.02,
                     faults=(FaultSpec(kind="stall", shard=0, after_done=1,
                                       duration_s=2.0),))
    rng = np.random.RandomState(13)
    router = session.engine.router
    short = session.submit(_prompt_for_shard(router, rng, 0, 10),
                           max_new_tokens=4)
    keys = [("mig", 0), ("miggreedy", 0)]
    handles = [session.submit(JOBS[k][0], max_new_tokens=20,
                              sampling=_policy(serving, JOBS[k][2]))
               for k in keys]
    assert short.result(timeout=300) is not None
    outs = [h.result(timeout=300) for h in handles]
    totals = session.stats()["totals"]
    shards = session.engine.shards
    session.close()
    assert totals["migrations"] >= 1 and totals["failed_requests"] == 0
    assert restored, "no migrated sequence carried its pages"
    assert all(n > 10 for _, n in restored), restored   # mid-decode
    assert outs == [jax_streams[k][0] for k in keys]
    for shard in shards:
        assert shard.pool.free_count() == shard.config.num_pages


def test_ttft_slo_cancels_unrescuable_waiting(models):
    """Without the swap tier there is no rescue: a high-priority request
    behind a full pool of long decoders blows its TTFT SLO and is
    cancelled through the normal cancel path."""
    _, _, model, tp = models
    session = _serve(model, tp, num_pages=54, max_batch=2, max_seq_len=256,
                     admission="priority", eviction="pressure",
                     priority_classes=("hi:priority=10,ttft_slo_s=0.025",
                                       "lo:priority=0"))
    session.warm()
    lows = [session.submit(p, max_new_tokens=200, priority_class="lo")
            for p in _prompts(43, 2, 16)]
    assert _wait_decoding(lows, 2)
    hi = session.submit(_prompts(143, 1, 16)[0], max_new_tokens=8,
                        priority_class="hi")
    assert hi.wait(timeout=60), "SLO expiry never fired"
    assert hi.status == "cancelled", hi.status
    assert "TTFT SLO exceeded" in (hi.req.error or "")
    totals = session.stats()["totals"]
    assert totals["slo_cancelled"] >= 1
    assert totals["preemptions"] == 0          # no arena, no rescue
    for h in lows:                             # don't wait out 200 steps
        h.cancel()
        h.wait(timeout=60)
    shard = session.engine.shards[0]
    session.close()
    assert shard.pool.free_count() == shard.config.num_pages


def test_pool_exhaust_chaos_composes_with_swap(models, jax_streams):
    """The ``pool_exhaust`` fault grabs every free page for 3 s.  Without
    swap a high-priority request with a TTFT SLO has no rescue and is
    cancelled; with swap it preempts the active low, completes, and the
    victim still finishes token-exact (both streams the JAX engine's)."""
    _, _, model, tp = models
    (low_p, _, _, _), (hi_p, _, _, _) = JOBS[("exhaust", 0)], \
        JOBS[("exhaust", 1)]
    ctl_p = _prompts(244, 1, 16)[0]
    fault = FaultSpec(kind="pool_exhaust", shard=0, after_done=1,
                      duration_s=3.0)

    def _go(eviction, swap_bytes, with_low):
        session = _serve(model, tp, num_pages=32, admission="priority",
                         eviction=eviction, swap_bytes=swap_bytes,
                         priority_classes=("hi:priority=10,ttft_slo_s=0.75",
                                           "lo:priority=0"),
                         faults=(fault,))
        session.warm()
        low = None
        if with_low:
            low = session.submit(low_p, max_new_tokens=48,
                                 priority_class="lo")
            assert _wait_decoding([low], 1)
        session.submit(ctl_p, max_new_tokens=2,
                       priority_class="lo").result(timeout=300)
        shard = session.engine.shards[0]
        t0 = time.perf_counter()
        while not all(inj.fired for inj in shard.fault_line.injectors):
            assert time.perf_counter() - t0 < 30, "fault never fired"
            time.sleep(0.002)
        hi = session.submit(hi_p, max_new_tokens=40, priority_class="hi")
        assert hi.wait(timeout=60)
        if low is not None:
            low.wait(timeout=300)
        totals = session.stats()["totals"]
        session.close()
        return hi, low, totals

    hi, _, totals = _go("pressure", 0, with_low=False)
    assert hi.status == "cancelled", (hi.status, hi.req.error)
    assert "TTFT SLO exceeded" in (hi.req.error or "")
    assert totals["preemptions"] == 0

    hi, low, totals = _go("swap", _arena_bytes(model), with_low=True)
    assert hi.status == "done", (hi.status, hi.req.error)
    assert hi.result() == jax_streams[("exhaust", 1)][0]
    assert totals["preemptions"] >= 1
    assert totals["failed_requests"] == 0
    assert low.status == "done", (low.status, low.req.error)
    assert low.result() == jax_streams[("exhaust", 0)][0]


def test_verify_layout_plain_matches_jax_oracle():
    """The verify chunk's layout (``verify_lanes``: 8 rows x 5 lanes, dead
    lanes interleaved, a row's dead lanes past its page run) through the
    port's plain packed attention equals the JAX oracle; dead lanes are
    exactly 0.  The card test holds the kernels against this plain
    version at the same layout."""
    arrays = _verify_chunk(8, 2, 16, seed=41, npg=128)
    tx = [torch.from_numpy(a) for a in arrays]
    out = tpp.packed_prefill_plain(*tx).numpy()
    want = np.asarray(jref.packed_prefill_attention_ref(
        *[jnp.asarray(a) for a in arrays]))
    np.testing.assert_allclose(out, want, rtol=3e-5, atol=3e-5)
    assert np.all(out[arrays[4] < 0] == 0.0)
    # the layout is the JAX engine's: positions ctx-1+j, live j <= nd on
    # occupied rows, seg_ctx = ctx + nd
    assert (arrays[4] >= 0).sum() == sum(
        n + 1 for i, n in enumerate(VERIFY_ND) if i != 6)
    assert arrays[6].tolist() == [c + n if i != 6 else 0 for i, (c, n) in
                                  enumerate(zip(VERIFY_CTX, VERIFY_ND))]


# ================================================= movers, warm-up, shim
def test_swap_arena_bf16_round_trip_bit_exact():
    """bf16 pages travel as 16-bit patterns: the arena is built ``uint16``
    (numpy has no bfloat16; same item size, so the byte budget is
    unchanged) and a page gathered, stored, loaded and scattered back is
    bit-identical — NaN and inf patterns included."""
    cfg = get_config("tinyllama-1.1b").reduced()          # bf16
    model = build_model(cfg)
    shard = _ShardEngine(model, model.init(0, device="cpu"),
                         serving.ServingConfig(
                             num_pages=8, page_size=4, max_seq_len=16,
                             swap_bytes=4 * page_nbytes(
                                 cfg.n_layers, 4, cfg.n_kv_heads,
                                 cfg.head_dim, "uint16")), device="cpu")
    arena = shard.swap_arena
    assert isinstance(arena, SwapArena) and arena.num_slots == 4
    assert arena._k.dtype == np.uint16
    g = torch.Generator().manual_seed(0)
    for pool in (shard.k_pages, shard.v_pages):
        bits = torch.randint(-2**15, 2**15, pool.shape, generator=g,
                             dtype=torch.int32).to(torch.int16)
        pool.copy_(bits.view(torch.bfloat16))
    src, dst = np.asarray([5, 2]), np.asarray([0, 7])
    k_np, v_np = shard.stack.pages_to_host(src)
    assert k_np.dtype == np.uint16
    arena.store(1, k_np, v_np, 8)
    k_back, v_back = arena.load(1)
    shard.stack.pages_from_host(dst, k_back, v_back)
    arena.release(1)
    for pool in (shard.k_pages, shard.v_pages):
        assert torch.equal(pool[:, dst].view(torch.int16),
                           pool[:, src].view(torch.int16))
    assert arena.slots_used() == 0


def test_session_warm_on_cpu_then_serves(models, jax_streams):
    """``warm()`` with every warm path on (packed buckets, a spec round,
    a page gather/scatter) writes no page, and the session then serves the
    JAX engine's tokens."""
    _, _, model, tp = models
    session = _serve(model, tp, scheduler="packed", spec_k=2,
                     **_swap_over(model))
    shard = session.engine.shards[0]
    before = shard.k_pages.clone(), shard.v_pages.clone()
    session.warm()
    session.warm()                          # idempotent
    assert torch.equal(before[0], shard.k_pages)
    assert torch.equal(before[1], shard.v_pages)
    keys = [("spec", 0), ("spec", 1)]
    outs = [session.submit(JOBS[k][0], max_new_tokens=8,
                           sampling=_policy(serving, "spec"))
            .result(timeout=300) for k in keys]
    session.close()
    assert outs == [jax_streams[k][0] for k in keys]


def test_paged_serving_engine_warns_and_serves(models, jax_streams):
    """The one-release shim: old kwargs → ``ServingConfig`` with a
    ``DeprecationWarning``; it serves the JAX engine's tokens."""
    _, _, model, tp = models
    with pytest.warns(DeprecationWarning, match="ServingConfig"):
        eng = serving.PagedServingEngine(model, tp, smr="EBR", num_pages=64,
                                         page_size=8, max_batch=4,
                                         max_seq_len=128, device="cpu")
    assert eng.config.smr == "EBR"
    prompt, n_new, _, _ = JOBS[("greedy", 1)]
    req = eng.submit(serving.Request(prompt=prompt, max_new_tokens=n_new))
    t = threading.Thread(target=eng.run, daemon=True)
    t.start()
    assert req.done.wait(timeout=120), "legacy engine stalled"
    eng.stop()
    t.join(timeout=10)
    assert req.out_tokens == jax_streams[("greedy", 1)][0]
    stats = eng.pool.stats()
    assert stats["free"] == 64 and stats["awaiting_reclaim"] == 0, stats
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng2 = serving.PagedServingEngine(
            model, tp, config=serving.ServingConfig(**CONF), device="cpu")
    eng2.stop()
