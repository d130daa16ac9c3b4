"""Engine device functions: the share of decoder-block passes in the window
that ran through the fused elementwise kernels (``fused_blocks``) rather
than their plain versions (``eager_blocks``), from ``session.stats()``.
A program without the two counters reads nothing."""

UNIT = "%"
TRACED = True


def read(run):
    a, b = run.stats_a, run.stats_b
    if "fused_blocks" not in b or "eager_blocks" not in b:
        return None
    fused = b["fused_blocks"] - a.get("fused_blocks", 0)
    eager = b["eager_blocks"] - a.get("eager_blocks", 0)
    total = fused + eager
    return 100.0 * fused / total if total > 0 else None
