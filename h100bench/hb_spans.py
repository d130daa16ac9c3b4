"""Reading the serving loop's span totals and counters over the window:
``run.stats_b`` less ``run.stats_a`` (``session.stats()["totals"]`` at
the window's ends).  A program without a span or counter has no key for
it, so its reading is ``None`` and the metric is left out of the line."""


def delta(run, key: str) -> float:
    """The window's increase of ``totals[key]`` (0 where there is none)."""
    return run.stats_b.get(key, 0) - run.stats_a.get(key, 0)


def mean_ms(run, name: str):
    """Mean milliseconds of span ``name`` in the window; None for none."""
    n = delta(run, f"span_n.{name}")
    return 1e3 * delta(run, f"span_s.{name}") / n if n > 0 else None
