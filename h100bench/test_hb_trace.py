"""The trace reduction's pure parts: kernel names, the class of the paged
kernels, idle gaps named by the host sampler, the slice's decode work
from the engine's counters, and its bytes and operations."""

import threading
import time

import hb_cell
import hb_trace

ARCH = hb_cell.plugin("archs", "qwen3")


def test_short_kernel_names_and_classes():
    cases = {
        "void paged_mma::paged_mma_kernel<128>(__nv_bfloat16 const*, int)":
            ("paged_mma::paged_mma_kernel<128>", True),
        "void (anonymous namespace)::tcp::partial_kernel<128>(float*)":
            ("(anonymous namespace)::tcp::partial_kernel<128>", False),
        "void paged_combine_kernel(float const*)":
            ("paged_combine_kernel", True),
        "void plan_kernel(int const*)": ("plan_kernel", False),
        "nvjet_tst_192x128_64x5_1x2_h_bz_coopB_NNT":
            ("nvjet_tst_192x128_64x5_1x2_h_bz_coopB_NNT", False),
    }
    for raw, (name, paged) in cases.items():
        got = hb_trace.short(raw)
        assert got == name
        assert bool(ARCH.DECODE_KERNELS.search(got)) == paged


def test_idle_gaps_named_by_samples():
    gaps = [(0.0, 1000.0), (2000.0, 2100.0), (5000.0, 9000.0)]
    samples = [(500.0, "engine.py:_emit"), (6000.0, "ref.py:threefry"),
               (7000.0, "ref.py:threefry"), (8000.0, "engine.py:_emit")]
    got = dict(hb_trace._name_gaps(gaps, samples, reach=1000.0))
    assert got["host: not sampled"] == 100.0 / 1e6
    assert got["ref.py:threefry"] == 4000.0 / 1e6
    assert got["engine.py:_emit"] == 1000.0 / 1e6
    # a gap of a few microseconds takes the nearest sample's name
    got = dict(hb_trace._name_gaps([(6400.0, 6410.0)], samples, 1000.0))
    assert list(got) == ["ref.py:threefry"]


def test_host_sampler_reads_the_engine_thread():
    stop = threading.Event()

    def busy():
        while not stop.is_set():
            sum(range(1000))

    t = threading.Thread(target=busy, name="shard-0-engine", daemon=True)
    t.start()
    s = hb_trace.HostSampler(every_s=0.001)
    s.start()
    time.sleep(0.05)
    s.stop()
    stop.set()
    t.join()
    assert s.samples
    assert all(k == "engine thread gone" or ":" in k for _, k in s.samples)


def test_paged_bytes_and_operations():
    cfg = {"num_attention_heads": 32, "num_key_value_heads": 8,
           "head_dim": 128, "num_hidden_layers": 2, "hidden_size": 4096,
           "intermediate_size": 12288, "vocab_size": 1000}
    # one decode call of two rows at contexts 10 and 20, in both layers
    sl = hb_trace.Slice(stats_a={"decode_rows": 5, "decode_kv_tokens": 70},
                        stats_b={"decode_rows": 7, "decode_kv_tokens": 100})
    assert hb_trace.slice_decode_work(sl) == (2, 30)
    nb, fl = ARCH.decode_attention_work(cfg, 2, 30, 2)
    assert nb == 2 * (30 * 2 * 8 * 128 * 2 + 2 * 2 * 32 * 128 * 2)
    assert fl == 2 * 4 * 32 * 128 * 30
