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


def ssd_quadratic(x, dt, a, b, c, chunk: int = 128, d_skip=None):
    """Mamba2 SSD by its whole-sequence quadratic form in the inputs'
    dtype: y_t = sum over s <= t of exp(L_t - L_s) dt_s (C_t . B_s) x_s
    + D x_t, L the running sum of dt a.  Given fp64 inputs it is the
    fp64 path the fp32 gradient holds measure against.  ``chunk`` is
    accepted for signature parity and unused; no final state is returned
    (``None``)."""
    del chunk
    hg = x.shape[2] // b.shape[2]
    b, c = (t.repeat_interleave(hg, dim=2) for t in (b, c))  # (B,S,H,N)
    run = (dt * a).cumsum(dim=1)                               # (B,S,H)
    seg = run[:, :, None, :] - run[:, None, :, :]              # (B,T,S,H)
    n = x.shape[1]
    later = seg.new_ones((n, n), dtype=torch.bool).tril()[None, :, :, None]
    w = seg.masked_fill(~later, float("-inf")).exp() * dt[:, None] * \
        torch.einsum("bthn,bshn->btsh", c, b)
    y = torch.einsum("btsh,bshp->bthp", w, x)
    if d_skip is not None:
        y = y + x * d_skip[None, None, :, None]
    return y, None


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
    # masked before the exp: above the diagonal seg > 0 can overflow to
    # inf, whose gradient through a where() after the exp is 0 * inf = NaN
    l_mat = torch.exp(seg.masked_fill(~causal, float("-inf")))
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
#
# Replay-exact token selection (DESIGN.md §17).  All randomness is drawn
# from a stateless counter-based PRNG keyed by (request_seed,
# absolute_token_position, stream) — no RNG state advances between steps,
# so ANY resume path (swap scatter, migration replay, watchdog steal) that
# re-enters decode at position t draws exactly what the uninterrupted run
# drew at t.  Streams keep the independent draws of one position apart:
#   0 = target sample   1 = draft proposal
#   2 = accept uniform  3 = residual / bonus sample
#
# The PRNG is JAX's: threefry2x32 with the default ``PRNGKey(0)`` base,
# ``fold_in`` chain and the partitionable counter layout of
# ``jax.random.bits`` / ``uniform`` / ``gumbel`` (``jax/_src/prng.py`` and
# ``jax/_src/random.py``), so the port draws the JAX package's bits.  A
# uint32 word lives in an int64 tensor masked with 0xFFFFFFFF (torch's
# uint32 lacks shifts and adds on some backends); every integer step is
# exact, on the CPU and on the card alike.

STREAM_TARGET, STREAM_DRAFT, STREAM_ACCEPT, STREAM_RESIDUAL = 0, 1, 2, 3

_TINY = 1e-30  # log(_TINY) ~ -69 << the float32 gumbel range (~[-3, 17]),
               # so a one-hot distribution samples its hot index exactly
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_ONE_BITS = 0x3F800000
_F32_TINY = torch.finfo(torch.float32).tiny


def _u32(x, device=None) -> torch.Tensor:
    """A uint32 operand (python int, array or tensor; a negative int32
    wraps as JAX's ``astype(uint32)`` does) as an int64 tensor."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds) on broadcast int64 tensors
    holding uint32 words: key (k1, k2), counter (x1, x2) → two words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = ((x2 << r) | (x2 >> (32 - r))) & _M32
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def prng_key(seed: int = 0, device=None):
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**32): the key
    words (seed >> 32, seed & 0xFFFFFFFF) = (0, seed)."""
    return (torch.zeros((), dtype=torch.int64, device=device),
            _u32(seed, device))


def fold_in(key, data):
    """``jax.random.fold_in`` with a uint32 datum: the block of the
    counter (0, data) under the key (threefry_seed of a 32-bit datum puts
    it in the low word).  Broadcasts over key and data."""
    k1, k2 = key
    return threefry2x32(k1, k2, torch.zeros_like(data), data)


def sample_key_ref(seed, position, stream, device=None):
    """(seed, position, stream) → PRNG key, via a fold_in chain off a fixed
    base.  Pure function of its inputs: the replay keystone.  Operands
    broadcast; the key is a pair of int64 tensors of their shape."""
    k = prng_key(0, device)
    for data in (seed, position, stream):
        k = fold_in(k, _u32(data, device))
    return k


def random_bits(key, n: int):
    """``jax.random.bits(key, (n,))`` (32-bit words, the partitionable
    layout): the block of counter (0, i) for i < n, its two words
    xor-ed.  key words of shape (...) → (..., n)."""
    k1, k2 = key
    lo = torch.arange(n, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1[..., None], k2[..., None],
                          torch.zeros_like(lo), lo)
    return b1 ^ b2


def _scalar_bits(key):
    """``jax.random.bits(key, ())``: the block of counter (0, 0)."""
    k1, k2 = key
    zero = torch.zeros_like(k1)
    b1, b2 = threefry2x32(k1, k2, zero, zero)
    return b1 ^ b2


def uniform_from_bits(bits, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform``'s float32 conversion: the top 23 bits as the
    mantissa of a float in [1, 2), minus 1, scaled to [minval, maxval) in
    float32 and clamped below at minval."""
    f = ((bits >> 9) | _F32_ONE_BITS).to(torch.int32).view(torch.float32)
    f = f - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def uniform(key, n=None):
    """``jax.random.uniform(key)`` (float32 in [0, 1)); ``n`` draws a
    ``(n,)`` vector per key instead of a scalar."""
    bits = _scalar_bits(key) if n is None else random_bits(key, n)
    return uniform_from_bits(bits)


def gumbel(key, n: int):
    """``jax.random.gumbel(key, (n,))`` in its default (``"low"``) mode:
    -log(-log(u)), u uniform on [finfo.tiny, 1).  key (...) → (..., n)."""
    u = uniform_from_bits(random_bits(key, n), _F32_TINY, 1.0)
    return -torch.log(-torch.log(u))


def _rows(x, dtype, device):
    return torch.as_tensor(x, dtype=dtype, device=device).reshape(-1)


def filtered_dist_ref(logits, temperature, top_k, top_p):
    """Rows' post-filter sampling distributions, (R, V) → (R, V) float32;
    the per-row operands are (R,) (tensors, arrays or sequences).

    temperature <= 0 is the greedy sentinel: the distribution is exactly
    one-hot at argmax(logits).  Otherwise logits/temperature are top-k
    masked (keep values >= the k-th largest; top_k == 0 keeps all), then
    top-p nucleus masked (sorted by probability with a stable sort, keep
    while the cumulative mass *before* a token is < top_p — the most
    likely token always survives), then softmaxed.  The mass before a
    token is a cumulative sum whose rounding may differ from XLA's in the
    last bit, so a token whose preceding mass lies within a few ulp of
    top_p may be kept on one side and dropped on the other; a row whose
    boundary is that close is the only one the two can disagree on."""
    logits = logits.float()
    dev = logits.device
    v = logits.shape[-1]
    t = _rows(temperature, torch.float32, dev)
    greedy = t <= 0.0
    safe_t = torch.where(greedy, torch.ones_like(t), t)
    scaled = logits / safe_t[:, None]
    k = _rows(top_k, torch.int64, dev).clamp(0, v)
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = desc.gather(-1, (k - 1).clamp(min=0)[:, None])[:, 0]
    kth = torch.where(k > 0, kth, torch.full_like(kth, float("-inf")))
    neg_inf = torch.full_like(scaled, float("-inf"))
    masked = torch.where(scaled >= kth[:, None], scaled, neg_inf)
    probs = torch.softmax(masked, dim=-1)
    order = torch.argsort(-probs, dim=-1, stable=True)
    sp = probs.gather(-1, order)
    before = torch.cumsum(sp, dim=-1) - sp     # mass strictly before
    p = _rows(top_p, torch.float32, dev)
    keep = torch.empty_like(order, dtype=torch.bool).scatter_(
        -1, order, before < p[:, None])
    dist = torch.softmax(torch.where(keep, masked, neg_inf), dim=-1)
    onehot = torch.zeros_like(dist).scatter_(
        -1, torch.argmax(logits, dim=-1, keepdim=True), 1.0)
    return torch.where(greedy[:, None], onehot, dist)


def gumbel_pick_ref(dist, key):
    """Gumbel-max samples from probability rows (R, V) with one key per
    row → (tokens (R,) int64, logprobs (R,) float32).

    For a one-hot dist the log-prob gap (~69 nats) dwarfs the float32
    gumbel range, so the hot index wins deterministically — greedy rows and
    degenerate residuals stay exact without a separate code path."""
    logp = torch.log(torch.clamp(dist, min=_TINY))
    tok = torch.argmax(logp + gumbel(key, dist.shape[-1]), dim=-1)
    return tok, logp.gather(-1, tok[:, None])[:, 0]


def sample_tokens_ref(logits, temperature, top_k, top_p, seed, position,
                      stream=STREAM_TARGET):
    """Batched replay-exact sampling: logits (B, V) + per-row operands
    (B,) → (tokens (B,) int64, logprobs (B,) float32).  temperature <= 0
    rows are exactly ``argmax(logits)`` (first index among ties, as
    ``jnp.argmax``) with logprob 0; the others draw a gumbel-max sample
    from :func:`filtered_dist_ref` keyed (seed, position, stream)."""
    dev = logits.device
    t = _rows(temperature, torch.float32, dev)
    greedy = t <= 0.0
    dist = filtered_dist_ref(logits, t, top_k, top_p)
    tok, lp = gumbel_pick_ref(dist, sample_key_ref(
        _rows(seed, torch.int64, dev), _rows(position, torch.int64, dev),
        stream, dev))
    tok = torch.where(greedy, torch.argmax(logits, dim=-1), tok)
    return tok, torch.where(greedy, torch.zeros_like(lp), lp)


def spec_verify_rows_ref(p_dist, q_dist, draft_toks, n_draft, seed,
                         base_pos):
    """Rejection-sample speculative decode, row by row in one batch.

    p_dist:     (B, k+1, V) target distributions; p_dist[:, j] predicts the
                token at absolute position base_pos + j
    q_dist:     (B, k, V) draft proposal distributions (same positions)
    draft_toks: (B, k) the draft's proposed tokens
    n_draft:    (B,) how many proposals are live this round (rows past
                n_draft are forced-rejected; n_draft == 0 degenerates to a
                plain sampled decode step from p_dist[:, 0])
    seed, base_pos: (B,) — the row's seed and the absolute position of its
                first emitted token
    Returns (tokens (B, k+1) int64, n_emit (B,) int64, logprobs (B, k+1)
    float32).

    Accept rule: u_j * q_j(tok) < p_j(tok) with u_j ~ U[0,1) keyed
    (seed, base_pos + j, STREAM_ACCEPT).  On the first rejection at j the
    replacement is drawn from normalize(max(p_j - q_j, 0)) (falling back to
    p_j when the residual is empty, i.e. q_j == p_j); if all n_draft
    proposals are accepted the bonus token is drawn from p_dist[n_draft].
    Both cases collapse to one formula by treating the q of the first
    non-live row as zero.  The correction draw is keyed
    (seed, base_pos + j, STREAM_RESIDUAL) — a pure position function, so
    speculative replay is as resume-exact as plain sampling."""
    b, k, v = q_dist.shape
    dev = p_dist.device
    draft = draft_toks.long()
    n_draft = _rows(n_draft, torch.int64, dev)
    seed = _rows(seed, torch.int64, dev)
    base_pos = _rows(base_pos, torch.int64, dev)
    j_idx = torch.arange(k, device=dev)
    p_at = p_dist[:, :k].gather(-1, draft[..., None])[..., 0]     # (B, k)
    q_at = q_dist.gather(-1, draft[..., None])[..., 0]
    u = uniform(sample_key_ref(seed[:, None], base_pos[:, None] + j_idx,
                               STREAM_ACCEPT, dev))
    acc = (u * q_at < p_at) & (j_idx[None, :] < n_draft[:, None])
    # first rejected index (k if all k accepted): the accepted run's length
    j_rej = torch.cumprod(acc.long(), dim=1).sum(dim=1)
    j_rej = torch.minimum(j_rej, n_draft)
    rows = torch.arange(b, device=dev)
    # correction/bonus distribution at j_rej: residual when a live draft was
    # rejected there, p itself when j_rej == n_draft (bonus / plain decode)
    p_rej = p_dist[rows, j_rej]                                   # (B, V)
    q_rej = q_dist[rows, j_rej.clamp(max=k - 1)]
    q_row = torch.where((j_rej < n_draft)[:, None], q_rej,
                        torch.zeros_like(q_rej))
    resid = torch.clamp(p_rej - q_row, min=0.0)
    mass = resid.sum(dim=-1, keepdim=True)
    corr_dist = torch.where(mass > 0.0, resid / torch.clamp(mass, min=_TINY),
                            p_rej)
    corr_tok, corr_lp = gumbel_pick_ref(corr_dist, sample_key_ref(
        seed, base_pos + j_rej, STREAM_RESIDUAL, dev))
    # emitted tokens: the accepted prefix of the draft, then the correction
    at_rej = torch.arange(k + 1, device=dev)[None, :] == j_rej[:, None]
    toks = torch.cat([draft, torch.zeros_like(draft[:, :1])], dim=1)
    toks = torch.where(at_rej, corr_tok[:, None], toks)
    lps = torch.cat([torch.log(torch.clamp(p_at, min=_TINY)),
                     torch.zeros_like(p_at[:, :1])], dim=1)
    lps = torch.where(at_rej, corr_lp[:, None], lps)
    return toks, j_rej + 1, lps
