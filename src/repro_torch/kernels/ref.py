"""Plain PyTorch oracles for the serving kernels (the correctness ground
truth), ported from the JAX package's ``kernels/ref.py``.

Each function is the straightforward, memory-naive implementation of the
same contract as its JAX counterpart, on any device; the tests hold them
against the JAX oracles on identical numpy inputs."""

from __future__ import annotations

import math

import torch

# ------------------------------------------------------------ attention


def flash_attention_ref(q, k, v, causal: bool = True, softmax_scale=None):
    """q (B,Sq,H,D), k/v (B,Sk,Hkv,D) → (B,Sq,H,D); fp32 softmax.  The
    causal mask is aligned bottom-right (``tril(k=Sk - Sq)``), as the JAX
    oracle's."""
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    g = h // hkv
    scale = softmax_scale or 1.0 / math.sqrt(d)
    qf = q.reshape(b, sq, hkv, g, d).float() * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens,
                        softmax_scale=None, occupancy=None):
    """Decode attention over a paged KV pool.

    q:            (B, H, D)           — one query token per sequence
    k/v_pages:    (P, page_size, Hkv, D) — the global page pool
    block_tables: (B, pages_per_seq) int — page ids per sequence
    context_lens: (B,) int            — valid token count per sequence
    occupancy:    (B,) bool, optional — False rows are batch padding: their
                  output is exactly zero and nothing they gather (whatever
                  their block-table entries alias) can reach it
    """
    b, h, d = q.shape
    _, page_size, hkv, _ = k_pages.shape
    g = h // hkv
    scale = softmax_scale or 1.0 / math.sqrt(d)
    max_len = block_tables.shape[1] * page_size
    bt = block_tables.long()

    # gather each sequence's pages into a contiguous view
    k_seq = k_pages[bt].reshape(b, max_len, hkv, d).float()
    v_seq = v_pages[bt].reshape(b, max_len, hkv, d).float()

    qf = q.reshape(b, hkv, g, d).float() * scale
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_seq)
    mask = torch.arange(max_len, device=q.device)[None, :] < \
        context_lens.long()[:, None]
    if occupancy is not None:
        mask = mask & occupancy[:, None]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    if occupancy is not None:
        # an all-masked row softmaxes to NaN; pin it to exactly zero
        # probability so padded rows contribute a zero output
        p = torch.where(occupancy[:, None, None, None], p, 0.0)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_seq)
    return out.reshape(b, h, d).to(q.dtype)


def packed_prefill_attention_ref(q, k_pages, v_pages, page_rows, seg_ids,
                                 positions, seg_ctx=None, softmax_scale=None):
    """Packed multi-prompt prefill attention over a paged KV pool.

    q:         (C, H, D)  — packed chunk queries, one lane per prompt token
    k/v_pages: (P, page_size, Hkv, D) — the global page pool
    page_rows: (S, pages_per_seq) int — per-segment block-table rows
    seg_ids:   (C,) int — each lane's segment; -1 lanes are chunk padding:
               their output is exactly zero
    positions: (C,) int — each lane's absolute position in its own
               sequence (lane l sees its segment's keys at positions
               <= positions[l])
    seg_ctx:   (S,) int, optional — accepted for signature parity with
               the kernel (the mask derives visibility from positions)
    """
    del seg_ctx  # visibility is fully determined by (seg_ids, positions)
    c, h, d = q.shape
    _, page_size, hkv, _ = k_pages.shape
    g = h // hkv
    scale = softmax_scale or 1.0 / math.sqrt(d)
    s_max = page_rows.shape[1] * page_size

    # per-lane gather: each lane sees its OWN segment's page run only
    valid = seg_ids >= 0
    lane_rows = page_rows.long()[seg_ids.long().clamp(min=0)]  # (C, pages)
    k_seq = k_pages[lane_rows].reshape(c, s_max, hkv, d).float()
    v_seq = v_pages[lane_rows].reshape(c, s_max, hkv, d).float()

    qf = q.reshape(c, hkv, g, d).float() * scale
    s = torch.einsum("ckgd,cskd->ckgs", qf, k_seq)
    mask = (torch.arange(s_max, device=q.device)[None, :] <=
            positions.long()[:, None]) & valid[:, None]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    # padding lanes softmax all -inf rows to NaN; pin them to exactly zero
    p = torch.where(valid[:, None, None, None], p, 0.0)
    out = torch.einsum("ckgs,cskd->ckgd", p, v_seq)
    return out.reshape(c, h, d).to(q.dtype)


# ------------------------------------------------------------------ SSD


def ssd_ref(x, dt, a, b, c, chunk: int = 128, d_skip=None,
            initial_state=None):
    """Mamba2 SSD (state-space dual): the sequential reference recurrence.

    x: (B,S,H,P); dt: (B,S,H); a: (H,) (negative); b,c: (B,S,G,N).
    Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) fp32).
    ``chunk`` is accepted for signature parity and unused."""
    del chunk
    bsz, s, h, p = x.shape
    _, _, g, n = b.shape
    hg = h // g
    xf = x.float()
    dtf = dt.float()
    bf = b.float().repeat_interleave(hg, dim=2)       # (B,S,H,N)
    cf = c.float().repeat_interleave(hg, dim=2)
    da = torch.exp(dtf * a.float()[None, None, :])    # (B,S,H)
    if initial_state is None:
        state = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                            device=x.device)
    else:
        state = initial_state.float()
    ys = []
    for t in range(s):
        state = state * da[:, t, :, None, None] + \
            (dtf[:, t, :, None, None] * xf[:, t, :, :, None]) * \
            bf[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(xf)
    if d_skip is not None:
        y = y + xf * d_skip.float()[None, None, :, None]
    return y.to(x.dtype), state


def ssd_chunked_ref(x, dt, a, b, c, chunk: int = 128, d_skip=None,
                    initial_state=None):
    """The chunked (dual) form: the parallel algorithm the kernel tiles.
    Mathematically identical to :func:`ssd_ref`; as in the JAX oracle, a
    length that is not a multiple of ``chunk`` runs as one chunk."""
    bsz, s, h, p = x.shape
    _, _, g, n = b.shape
    hg = h // g
    if s % chunk != 0:
        chunk = s
    nc = s // chunk

    xf = x.float().reshape(bsz, nc, chunk, h, p)
    dtf = dt.float().reshape(bsz, nc, chunk, h)
    bf = b.float().repeat_interleave(hg, dim=2).reshape(bsz, nc, chunk, h, n)
    cf = c.float().repeat_interleave(hg, dim=2).reshape(bsz, nc, chunk, h, n)

    da = dtf * a.float()[None, None, None, :]          # (B,nc,Q,H) log-decay
    da_cs = torch.cumsum(da, dim=2)                    # within-chunk cumsum
    da_total = da_cs[:, :, -1]                         # (B,nc,H)

    # intra-chunk (dual, attention-like) term
    seg = da_cs[:, :, :, None, :] - da_cs[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()[None, None, :, :, None]
    l_mat = torch.where(causal, torch.exp(seg), 0.0)
    scores = torch.einsum("bcihs,bcjhs->bcijh", cf, bf)  # C_i · B_j
    y_diag = torch.einsum("bcijh,bcijh,bcjh,bcjhp->bcihp",
                          scores, l_mat, dtf, xf)

    # chunk-local end states
    decay_to_end = torch.exp(da_total[:, :, None, :] - da_cs)  # (B,nc,Q,H)
    states = torch.einsum("bcqhs,bcqh,bcqh,bcqhp->bchps",
                          bf, decay_to_end, dtf, xf)

    # inter-chunk recurrence
    if initial_state is None:
        state = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                            device=x.device)
    else:
        state = initial_state.float()
    prevs = []
    for ci in range(nc):
        prevs.append(state)
        state = state * torch.exp(da_total[:, ci])[:, :, None, None] + \
            states[:, ci]
    prev_states = torch.stack(prevs, dim=1)            # (B,nc,H,P,N)

    # inter-chunk contribution
    y_off = torch.einsum("bcqhs,bcqh,bchps->bcqhp",
                         cf, torch.exp(da_cs), prev_states)

    y = (y_diag + y_off).reshape(bsz, s, h, p)
    if d_skip is not None:
        y = y + x.float() * d_skip.float()[None, None, :, None]
    return y.to(x.dtype), state


# ------------------------------------------------------------- sampling


def sample_tokens_ref(logits, temperature):
    """Greedy rows of the JAX ``sample_tokens_ref``: logits (B, V) and a
    host-side (B,) sequence of temperatures → (tokens (B,) int64,
    logprobs (B,) float32).  ``temperature <= 0`` is an exact
    ``argmax(logits)`` (first index among ties, as ``jnp.argmax``) with
    logprob 0.

    Rows with ``temperature > 0`` need the JAX package's threefry bits to
    reproduce its samples; they are not ported yet and raise."""
    if any(float(t) > 0.0 for t in temperature):
        raise NotImplementedError(
            "sampling with temperature > 0 is not ported yet (ROADMAP A.5: "
            "JAX's threefry bits); only greedy rows are served")
    toks = torch.argmax(logits, dim=-1)
    return toks, torch.zeros(toks.shape, dtype=torch.float32,
                             device=logits.device)
