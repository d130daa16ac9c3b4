"""The torch port's serving engine on the CPU, held against the JAX engine.

Both serve the same weights (the JAX init of the reduced TinyLlama config
at ``PRNGKey(7)``, bridged with ``from_jax_params``).  Under greedy
decoding the port's ``serve(..., device="cpu")`` must give tokens identical
to the JAX engine (``backend="xla"``) and to the contiguous-cache
reference decode, under the ``chunked`` and ``packed`` schedulers, with a
shared-prefix pair so that the prefix cache hits.  The engine's masked
writes are checked directly: a padding row or lane never writes a page."""

import jax
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro_torch import serving
from repro_torch.configs import get_config
from repro_torch.models import build_model, from_jax_params
from repro_torch.serving import FaultSpec
from test_serving import _prompt_for_shard, _reference_greedy

CONFIG = dict(num_pages=64, page_size=4, max_batch=2, max_seq_len=64,
              prefill_chunk_tokens=8)
N_NEW = 6


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("tinyllama-1.1b").reduced().replace(dtype="float32")
    jmodel = jbuild_model(jcfg)
    jp, _ = jmodel.init(jax.random.PRNGKey(7))
    cfg = get_config("tinyllama-1.1b").reduced().replace(dtype="float32")
    model = build_model(cfg)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return jmodel, jp, model, tp


def _prompts():
    rng = np.random.RandomState(0)
    shared = rng.randint(1, 200, size=16).tolist()
    # the first prompt completes alone, so the second finds their 16-token
    # (four-page) prefix in the cache; the tail exercises multi-chunk
    # prefill (21 > 8) and batching
    return [shared + [5, 6, 7], shared + [9],
            rng.randint(1, 200, size=21).tolist(),
            rng.randint(1, 200, size=9).tolist()]


def _run(session, prompts):
    outs = [session.submit(prompts[0], max_new_tokens=N_NEW)
            .result(timeout=120)]
    handles = [session.submit(p, max_new_tokens=N_NEW) for p in prompts[1:]]
    outs += [h.result(timeout=120) for h in handles]
    stats = session.stats()
    session.close()
    return outs, stats, session


@pytest.mark.parametrize("scheduler", ["chunked", "packed"])
def test_greedy_tokens_match_jax_engine_and_reference(models, scheduler):
    jmodel, jp, model, tp = models
    prompts = _prompts()
    cfg = serving.ServingConfig(scheduler=scheduler, **CONFIG)
    outs, stats, session = _run(serving.serve(model, tp, cfg, device="cpu"),
                                prompts)
    jouts, _, _ = _run(jserving.serve(jmodel, jp, jserving.ServingConfig(
        scheduler=scheduler, backend="xla", **CONFIG)), prompts)
    assert outs == jouts
    for p, out in zip(prompts, outs):
        assert out == _reference_greedy(jmodel, jp, p, N_NEW)
    totals = stats["totals"]
    assert totals["prefix_hits"] >= 1, "no prefix-cache hit"
    assert totals["completed"] == len(prompts) and totals["failed"] == 0
    if scheduler == "packed":
        assert totals["packed_chunks"] >= 1
    # drained clean: every page back on the free list
    assert all(s.pool.free_count() == cfg.num_pages
               for s in session.engine.shards)


def _contiguous_greedy(model, params, prompt, n_new):
    """The port's own contiguous-cache reference decode."""
    cache = model.init_cache(1, len(prompt) + n_new + 1, device="cpu")
    toks, out = list(prompt), []
    for t in range(len(prompt) + n_new):
        logits, cache = model.decode_step(params, cache, {
            "tokens": torch.tensor([[toks[t]]]),
            "cache_len": torch.tensor([t + 1], dtype=torch.int32)})
        if t >= len(prompt) - 1:
            out.append(int(torch.argmax(logits[0])))
            if len(out) == n_new:
                return out
            toks.append(out[-1])


def test_multi_shard_session_matches_port_reference(models):
    _, _, model, tp = models
    prompts = _prompts()
    session = serving.serve(model, tp, serving.ServingConfig(
        num_shards=2, **CONFIG), device="cpu")
    handles = session.submit_many(prompts, max_new_tokens=N_NEW)
    outs = [h.result(timeout=120) for h in handles]
    session.close()
    for shard in session.engine.shards:
        assert shard.pool.free_count() == CONFIG["num_pages"]
    for p, out in zip(prompts, outs):
        assert out == _contiguous_greedy(model, tp, p, N_NEW)


def test_crash_guard_fails_requests_and_pool_is_clean(models):
    """The copied crash guard around the port's engine loop: an injected
    crash fails every in-flight request with the traceback and returns
    every page."""
    _, _, model, tp = models
    session = serving.serve(model, tp, serving.ServingConfig(
        watchdog="off", faults=(FaultSpec(kind="crash", after_done=1),),
        **CONFIG), device="cpu")
    probe = session.submit([3, 1, 4, 1, 5], max_new_tokens=2)
    victims = [session.submit([9, 2, 6, i], max_new_tokens=30)
               for i in range(2)]
    assert probe.result(timeout=60) is not None
    shard = session.engine.shards[0]
    for h in victims:
        assert h.wait(timeout=60), "crash guard left a client hanging"
        with pytest.raises(RuntimeError, match="InjectedFault"):
            h.result()
    assert shard.crashed
    assert shard.pool.free_count() == CONFIG["num_pages"]
    session.close()


def test_stall_migrates_live_sequences_token_exact(models):
    """A stalled shard is degraded by heartbeat; its decoding sequences
    move to the healthy shard through the copied SMR-safe handoff (replay
    through the port's prefill) and finish token-exact."""
    _, _, model, tp = models
    session = serving.serve(model, tp, serving.ServingConfig(
        num_shards=2, heartbeat_timeout_s=0.25, watchdog_interval_s=0.02,
        faults=(FaultSpec(kind="stall", shard=0, after_done=1,
                          duration_s=2.0),), **CONFIG), device="cpu")
    rng = np.random.RandomState(11)
    router = session.engine.router
    short = session.submit(_prompt_for_shard(router, rng, 0, 10),
                           max_new_tokens=2)
    longs = [_prompt_for_shard(router, rng, 0, 10) for _ in range(2)]
    handles = [session.submit(p, max_new_tokens=20) for p in longs]
    assert short.result(timeout=60) is not None
    outs = [h.result(timeout=60) for h in handles]
    totals = session.stats()["totals"]
    session.close()
    for p, out in zip(longs, outs):
        assert out == _contiguous_greedy(model, tp, p, 20)
    assert totals["migrations"] >= 1, "stall never forced a migration"
    assert totals["failed_requests"] == 0


def _changed_slots(before, after):
    """(layer, page, slot) triples whose K changed."""
    diff = (before != after).any(dim=-1).any(dim=-1)
    return {tuple(i) for i in diff.nonzero().tolist()}


def test_padding_rows_and_lanes_never_write_a_page(models):
    """Masked writes: a decode step with one live row in a batch of two,
    and a packed chunk with padding lanes, change exactly the slots of
    their live positions, in every layer, and nothing else — not the
    page 0 slot 0 that padding rows alias."""
    _, _, model, tp = models
    n_layers = model.cfg.n_layers
    for scheduler in ("chunked", "packed"):
        session = serving.serve(model, tp, serving.ServingConfig(
            scheduler=scheduler, **CONFIG), device="cpu", start=False)
        shard = session.engine.shards[0]
        prompt = list(range(1, 11))                # 10 tokens, 2 chunks
        handle = session.submit(prompt, max_new_tokens=4)
        writes = []
        while not handle.done.is_set():
            k0 = shard.k_pages.clone()
            shard.step()
            writes.append(_changed_slots(k0, shard.k_pages))
        session.close()
        # every write landed on the request's own positions, once each
        seen = set()
        for slots in writes:
            layers = {s[0] for s in slots}
            assert layers <= set(range(n_layers))
            per_layer = {s[1:] for s in slots}
            assert len(slots) == len(per_layer) * n_layers
            assert not (per_layer & seen), "a position was written twice"
            seen |= per_layer
        # prompt (10) + the first 3 generated tokens' K/V (the 4th is
        # never fed back); exactly those positions, nothing else
        assert len(seen) == len(prompt) + 3, (scheduler, len(seen))


def test_config_refuses_unported_paths():
    with pytest.raises(NotImplementedError, match="A.7"):
        serving.ServingConfig(spec_k=2)
    with pytest.raises(NotImplementedError, match="A.6"):
        serving.ServingConfig(eviction="swap", swap_bytes=1 << 20)
    with pytest.raises(NotImplementedError, match="A.6"):
        serving.ServingConfig(swap_bytes=1 << 20)
    with pytest.raises(TypeError):
        serving.ServingConfig(backend="xla")     # dispatch is by device
    assert "backend" not in serving.ServingConfig().summary()


def test_sampling_with_temperature_is_refused(models):
    _, _, model, tp = models
    session = serving.serve(model, tp, serving.ServingConfig(**CONFIG),
                            device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="A.5"):
            session.submit([1, 2, 3], sampling=serving.TemperatureSampling(
                temperature=0.8))
        # greedy policies by name still serve
        out = session.submit([1, 2, 3], max_new_tokens=2,
                             sampling="greedy").result(timeout=60)
        assert len(out) == 2
    finally:
        session.close()


def test_serve_defaults_to_the_card(models, monkeypatch):
    _, _, model, tp = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.serve(model, tp, serving.ServingConfig(**CONFIG))


def test_params_on_another_device_or_dtype_are_refused(models):
    _, _, model, tp = models
    bf16 = build_model(model.cfg.replace(dtype="bfloat16"))
    with pytest.raises(ValueError, match="params live on"):
        serving.serve(bf16, tp, serving.ServingConfig(**CONFIG),
                      device="cpu")
