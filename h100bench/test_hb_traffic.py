"""The traffic generator repeats for a seed, and stratification gives
every seed the same sizes in another order."""

import hb_cell
import pytest

MIXES = [p.stem for p in sorted((hb_cell.HERE / "mixes").glob("*.json"))]


def make(name, seed, end=30.0):
    mix = hb_cell.load_json(hb_cell.HERE / "mixes" / f"{name}.json")
    mod = hb_cell.plugin("traffic", mix["kind"])
    return mod.make(mix["params"], seed, 151936, -mix["lead_s"], end, 8)


def first_wave(t):
    return [(due, s.prompt, s.max_new) for due, s in t.initial()]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a, b = make(name, 2**31 + 5), make(name, 2**31 + 5)
    assert first_wave(a) == first_wave(b)
    assert first_wave(a) != first_wave(make(name, 6))


@pytest.mark.parametrize("name", MIXES)
def test_follow_ups_repeat(name):
    a, b = make(name, 9), make(name, 9)
    for (_, sa), (_, sb) in zip(a.initial()[:4], b.initial()[:4]):
        out = list(range(sa.max_new))
        assert [(d, s.prompt, s.max_new) for d, s in a.after(sa, out, 1.0)] \
            == [(d, s.prompt, s.max_new) for d, s in b.after(sb, out, 1.0)]


def test_seeds_share_sizes():
    """Every block of 64 requests holds the same prompt and output lengths
    whatever the seed."""
    sizes = []
    for seed in (3, 4):
        t = make("batch-decode", seed)
        specs = [s for _, s in t.initial()]
        while len(specs) < 128:
            specs += [s for _, s in t.after(specs[-1], [], 1.0)]
        sizes.append([(sorted(len(s.prompt) for s in specs[i:i + 64]),
                       sorted(s.max_new for s in specs[i:i + 64]))
                      for i in (0, 64)])
    assert sizes[0] == sizes[1]
    lens = sizes[0][0][0]
    assert 256 <= lens[0] and lens[-1] <= 1024


def test_closed_loop_refills():
    t = make("batch-decode", 13)
    assert len(t.initial()) == 32
    _, s = t.initial()[0]
    assert len(t.after(s, [1, 2], 5.0)) == 1
    assert t.after(s, [1, 2], 31.0) == []
