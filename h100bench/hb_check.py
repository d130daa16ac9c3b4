"""Whether what the window served is right: a seeded sample of the
requests it finished, the longest among them, run once through the plain
fp32 reference of the config's architecture (``reference`` of
``archs/<model_type>.py``) over each prompt and its served tokens,
teacher-forced.

Every served token is greedy.  Its gap is how far its reference logit
lies below the reference's best at that position.  The numbers compared
are the widest gap and the count of failed requests, each with its
limit.  The control reads the same positions with the reference computed
in fp8 and reports the gap of the token that it would put first.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def choose(records, rng: np.random.Generator, served_target: int,
           max_tokens: int):
    """Finished requests to check: the longest one, then others in a seeded
    order until ``served_target`` served tokens or ``max_tokens`` tokens
    of prompt and output are in."""
    done = [r for r in records
            if r.done_at_end and r.status == "done" and r.out_tokens]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r.spec.prompt) + len(r.out_tokens))
    rest = [done[i] for i in rng.permutation(len(done))
            if done[i] is not longest]
    out = [longest]
    served = len(longest.out_tokens)
    total = len(longest.spec.prompt) + served
    for r in rest:
        if served >= served_target:
            break
        n = len(r.spec.prompt) + len(r.out_tokens)
        if total + n > max_tokens:
            continue
        out.append(r)
        served += len(r.out_tokens)
        total += n
    return out


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token of ``tokens`` (R,) lies below the best of the
    reference's fp32 logits (R, V) at its row, in logit units."""
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    return logits.max(dim=-1).values - logits[rows, tokens]


def gap_readings(reference, weights, cfg: dict, chosen,
                 control: bool = False,
                 block_tokens: int = 16384) -> Dict[str, Optional[float]]:
    """The widest gap of the served tokens of ``chosen`` (and, with
    ``control``, of the fp8 control's picks at the same positions),
    reading ``reference`` (the architecture's plain module: ``logits_at``,
    ``strict_fp32``) on ``weights`` in groups of at most ``block_tokens``
    tokens."""
    reference.strict_fp32()
    out = {"greedy_gap": None, "served_tokens": 0, "requests": len(chosen)}
    if control:
        out["control_greedy_gap"] = None

    def widen(key, value):
        out[key] = value if out[key] is None else max(out[key], value)

    groups: List[list] = [[]]
    size = 0
    for r in chosen:
        n = len(r.spec.prompt) + len(r.out_tokens)
        if groups[-1] and size + n > block_tokens:
            groups.append([])
            size = 0
        groups[-1].append(r)
        size += n
    with torch.no_grad():
        for group in groups:
            seqs, want = [], []
            for r in group:
                toks = list(r.spec.prompt) + list(r.out_tokens[:-1])
                n_p = len(r.spec.prompt)
                seqs.append(torch.tensor(toks, dtype=torch.int64))
                want.append(torch.arange(n_p - 1, n_p - 1 +
                                         len(r.out_tokens)))
            ref = reference.logits_at(weights, cfg, seqs, want)
            ctl = reference.logits_at(weights, cfg, seqs, want,
                                      quant="fp8") \
                if control else [None] * len(group)
            for r, lr, lc in zip(group, ref, ctl):
                served = torch.tensor(r.out_tokens, dtype=torch.int64,
                                      device=lr.device)
                g = gaps(lr, served)
                if out["greedy_gap"] is None or \
                        float(g.max()) > out["greedy_gap"]:
                    out["worst_greedy_gap"] = _worst(lr, served, g, r.spec)
                widen("greedy_gap", float(g.max()))
                out["served_tokens"] += len(served)
                if lc is not None:
                    pick = torch.argmax(lc, dim=-1)
                    widen("control_greedy_gap", float(gaps(lr, pick).max()))
            del ref, ctl
    return out


def _worst(logits, served, g, spec) -> dict:
    """Where a request's widest gap lies: the position, the served token
    and the reference's pick, each with its logit and rank."""
    i = int(torch.argmax(g))
    z = logits[i]
    order = torch.argsort(z, descending=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(z.shape[0], device=z.device)
    s = int(served[i])
    pick = int(order[0])
    return {"position": len(spec.prompt) + i, "gap": float(g[i]),
            "served": [s, float(z[s]), int(rank[s])],
            "pick": [pick, float(z[pick]), int(rank[pick])]}


def judge(readings: dict, failed: int, limits: dict, control: bool = False):
    """(correct, checks): each compared number beside its limit.  A run
    that checked no request, or whose cell has no limit for its gap, is
    not correct.  ``control`` judges the control's readings by the same
    limits."""
    pre = "control_" if control else ""
    checks = {"failed": {"value": failed, "limit": 0}}
    ok = failed == 0
    v = readings.get(pre + "greedy_gap")
    lim = limits.get("greedy_gap")
    if v is not None:
        checks["greedy_gap"] = {"value": v, "limit": lim}
    ok = ok and v is not None and lim is not None and v <= lim
    if readings.get("requests", 0) == 0:
        ok = False
    return ok, checks
