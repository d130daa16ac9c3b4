"""The KV pool's format and the decoder blocks over it: the device side of a
shard, under the engine's host side (``serving/engine.py``).

The engine hands a stack flat lanes ``x`` (N, d), each with its position
and write target (``wr_page`` / ``wr_slot`` (N,) int64, page -1 writing
nothing), through ``rows`` (one paged row a lane: the decode step, the
dense verify chunk) or ``lanes`` (a packed prefill chunk; a ``chunked``
chunk is one segment), and gets their hidden states (N, d) back.  Inside,
``attend(i, q)`` maps layer i's queries (N, H, .) to (N, H, .).  A new
pool format or block loop is one more stack class, picked in
:func:`stack_class`; the engine is not edited.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops
from ..models.config import options
from ..models.layers import rope_angles
from ..models.mla import rope_table, rotate, softmax_scale
from ..models.moe import dropless_moe
from ..models.params import layer_kinds


def stack_class(cfg, config):
    """The stack that serves ``cfg`` under ``config``: :class:`DenseStack`
    or :class:`LatentStack`.  Raises ``ValueError`` for a family the
    engine does not serve and for what a latent pool does not take."""
    if cfg.family != "dense" and not (cfg.family == "moe" and cfg.use_mla):
        raise ValueError(f"the engine serves dense and MLA models, got "
                         f"{cfg.name!r} (family {cfg.family!r})")
    if not cfg.use_mla:
        return DenseStack
    unsupported = [name for name, on in (
        ("speculative decoding (spec_k)", config.spec_k > 0),
        ("the host swap tier (swap_bytes)", config.swap_bytes > 0),
        ("live migration (watchdog 'migrate')",
         config.watchdog == "migrate")) if on]
    if unsupported:
        raise ValueError(f"{cfg.name!r} serves from a latent pool, which "
                         f"takes no " + ", ".join(unsupported))
    return LatentStack


class _PagedStack:
    """What both pool formats share: the model, the spans and the
    counters the engine's ``stats()`` reports."""

    k_pages = v_pages = None
    # whether ``rows`` can be captured into a CUDA graph (its launches
    # depend on the shapes alone) and replayed (serving/decode_graph.py)
    capturable = False

    def __init__(self, cfg, params, spans):
        self.cfg = cfg
        self.params = params
        self.spans = spans
        # decoder-block passes through the fused kernels (a CUDA engine)
        # and through their plain versions; MLA prefill lanes and the keys
        # they attend; expert-layer passes of the decode calls and their
        # (token, choice) pairs routed to the experts held here (on device)
        self.fused_blocks = 0
        self.eager_blocks = 0
        self.mla_prefill_rows = 0
        self.mla_prefill_keys = 0
        self.moe_decode_passes = 0
        self.moe_pairs = None

    def count_lanes(self, seg, pos) -> None:
        """Count a prefill chunk's live lanes and the keys they attend from
        its host seg_ids and positions (the dense stack counts none)."""

    def _count_blocks(self, x, n: int) -> None:
        if x.is_cuda:
            self.fused_blocks += n
        else:
            self.eager_blocks += n

    def stats(self) -> dict:
        return {"fused_blocks": self.fused_blocks,
                "eager_blocks": self.eager_blocks,
                "mla_prefill_rows": self.mla_prefill_rows,
                "mla_prefill_keys": self.mla_prefill_keys,
                "moe_decode_passes": self.moe_decode_passes,
                "moe_decode_local_pairs": (int(self.moe_pairs)
                                           if self.moe_decode_passes else 0)}


class DenseStack(_PagedStack):
    """GQA attention over a pair of ``(L, num_pages, page, Hkv, D)`` K/V
    pools, updated in place, and the SwiGLU FFN.  Each block's elementwise
    chain runs through the fused ops (``kernels/fused_block.py``): add +
    RMSNorm at ``ln1`` (folding in the previous block's FFN output) and at
    ``ln2``, q/k RMSNorm + RoPE + the K/V store, SiLU * mul; on a CPU
    tensor each is the plain chain, op for op.  Its decode call is
    captured and replayed as one CUDA graph on the card."""

    capturable = True

    def __init__(self, cfg, params, config, spans, to_dev):
        super().__init__(cfg, params, spans)
        dev, dtype = params.embed.device, params.embed.dtype
        kv = (cfg.n_layers, config.num_pages, config.page_size,
              cfg.n_kv_heads, cfg.head_dim)
        self.k_pages = torch.zeros(kv, dtype=dtype, device=dev)
        self.v_pages = torch.zeros(kv, dtype=dtype, device=dev)
        # the paged kernel's split count of the decode step (max_batch
        # rows), passed to every paged call: the verify lanes run as paged
        # rows with the same splits, so a lane sums a row in the decode
        # step's order
        self.decode_splits = ops.paged_splits(
            config.max_batch, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            config.max_pages, dtype, dev)
        self._to_dev = to_dev

    def rows(self, x, tables, ctx, occ, positions, wr_page, wr_slot):
        """One paged row a lane: (N, max_pages) block tables, (N,) context
        lengths counting the lane's own position, (N,) occupancy (an
        unoccupied row attends nothing)."""
        def attend(i, q):
            return ops.paged_attention(q, self.k_pages[i], self.v_pages[i],
                                       tables, ctx, occupancy=occ,
                                       num_splits=self.decode_splits)
        return self.layers(x, positions, wr_page, wr_slot, attend)

    def lanes(self, x, seg_ids, positions, page_rows, seg_ctx, wr_page,
              wr_slot):
        """A packed prefill chunk, its operands as the engine's
        ``_paged_prefill_packed`` takes them."""
        def attend(i, q):
            return ops.packed_prefill_attention(
                q, self.k_pages[i], self.v_pages[i], page_rows, seg_ids,
                positions, seg_ctx)
        return self.layers(x, positions, wr_page, wr_slot, attend)

    def layers(self, x, positions, wr_page, wr_slot, attend):
        """Every decoder block over the lanes x (N, d); the rope table is
        made once for all of them."""
        cfg = self.cfg
        n = x.shape[0]
        heads = (n, cfg.n_heads, cfg.head_dim)
        kv_heads = (n, cfg.n_kv_heads, cfg.head_dim)
        angles = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        cos, sin = torch.cos(angles), torch.sin(angles)
        r = None
        for i, blk in enumerate(self.params.blocks):
            a, f = blk.attn, blk.ffn
            x, h = ops.add_rms_norm(x, r, blk.ln1)
            q = ops.qk_norm_rope_write(
                (h @ a.wq).view(heads), (h @ a.wk).view(kv_heads),
                (h @ a.wv).view(kv_heads),
                a.q_norm if cfg.qk_norm else None,
                a.k_norm if cfg.qk_norm else None, cos, sin,
                self.k_pages[i], self.v_pages[i], wr_page, wr_slot)
            out = attend(i, q)
            x, h = ops.add_rms_norm(x, out.reshape(n, -1) @ a.wo, blk.ln2)
            r = ops.silu_mul(h @ f.wi_gate, h @ f.wi_up) @ f.wo
        self._count_blocks(x, len(self.params.blocks))
        return x + r

    def pages_to_host(self, page_ids: np.ndarray):
        """K and V of the given pages, all layers, as host arrays
        ``(n, L, page, Hkv, D)`` in the arena's dtype: one gather each and
        one synchronous device→host copy — when this returns the bytes are
        on the host (bf16 as its 16-bit patterns)."""
        idx = self._to_dev(page_ids.astype(np.int64))
        out = []
        for pool in (self.k_pages, self.v_pages):
            t = pool[:, idx].transpose(0, 1).contiguous()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            a = t.cpu().numpy()
            out.append(a.view(np.uint16) if a.dtype == np.int16 else a)
        return out[0], out[1]

    def pages_from_host(self, page_ids: np.ndarray, k_np, v_np) -> None:
        """Scatter host pages ``(n, L, page, Hkv, D)`` (as from
        :meth:`pages_to_host`) into the given device pages and wait until
        the writes are done."""
        idx = self._to_dev(page_ids.astype(np.int64))
        for pool, a in ((self.k_pages, k_np), (self.v_pages, v_np)):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if pool.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            t = t.to(pool.device)
            if pool.dtype == torch.bfloat16:
                t = t.view(torch.bfloat16)
            pool[:, idx] = t.transpose(0, 1)
        if self.k_pages.is_cuda:
            torch.cuda.synchronize(self.k_pages.device)


class LatentStack(_PagedStack):
    """MLA (DeepSeek-V2) over one latent pool ``(L, num_pages, page, rank
    + rope)``: each token's RMS-normed latent and its roped key dimensions,
    read by every head (``kernels/mla_attention.py``).  The FFN is the
    dense SwiGLU or, in an expert layer, the dropless expert layer of the
    experts this device holds (``models/moe.py`` ``dropless_moe``).  A
    latent pool takes no verify chunk and moves no page to the host
    (:func:`stack_class` refuses them).  Its decode call runs eagerly:
    the expert layer sizes its groups from the routing."""

    def __init__(self, cfg, params, config, spans, to_dev):
        super().__init__(cfg, params, spans)
        dev = params.embed.device
        h, rank = cfg.n_heads, cfg.kv_lora_rank
        self.latent_pages = torch.zeros(
            (cfg.n_layers, config.num_pages, config.page_size,
             rank + cfg.rope_head_dim), dtype=params.embed.dtype, device=dev)
        self.blocks = list(params.head_blocks) + list(params.blocks)
        self.kinds = layer_kinds(cfg)
        self.n_moe_layers = sum(k.endswith("moe") for k in self.kinds)
        # (H, nope, rank) and (H, rank, v): views of w_uk / w_uv, no copy
        self.absorb = [
            (blk.attn.w_uk.view(rank, h, cfg.nope_head_dim).permute(1, 2, 0),
             blk.attn.w_uv.view(rank, h, cfg.v_head_dim).permute(1, 0, 2))
            for blk in self.blocks]
        self.scale = softmax_scale(cfg)
        self.interleaved = options(cfg).rope_interleaved
        self.moe_pairs = torch.zeros((), dtype=torch.int64, device=dev)
        # every MLA call (decode rows, prefill lanes) takes the decode
        # step's splits, so a position is summed in one order
        self.decode_splits = ops.mla_splits(
            config.max_batch, h, config.max_pages * config.page_size, dev)

    def _attend(self, tables, ctx, occupancy, prefill: bool):
        def attend(i, q):
            return ops.mla_attention(
                q, self.latent_pages[i], tables, ctx, occupancy=occupancy,
                scale=self.scale, rank=self.cfg.kv_lora_rank,
                num_splits=self.decode_splits, prefill=prefill)
        return attend

    def rows(self, x, tables, ctx, occ, positions, wr_page, wr_slot):
        """The decode step's rows; counts expert passes and routed pairs."""
        self.moe_decode_passes += self.n_moe_layers
        return self.layers(x, positions, wr_page, wr_slot,
                           self._attend(tables, ctx, occ, prefill=False),
                           self.moe_pairs)

    def lanes(self, x, seg_ids, positions, page_rows, seg_ctx, wr_page,
              wr_slot):
        """A packed prefill chunk, as :meth:`DenseStack.lanes`: one MLA row
        a lane (its segment's block run, context = position + 1; padding
        lanes unoccupied)."""
        attend = self._attend(
            page_rows[seg_ids.clamp(min=0).long()].contiguous(),
            (positions + 1).to(torch.int32), seg_ids >= 0, prefill=True)
        return self.layers(x, positions, wr_page, wr_slot, attend, None)

    def count_lanes(self, seg, pos) -> None:
        live = seg >= 0
        self.mla_prefill_rows += int(live.sum())
        self.mla_prefill_keys += int((pos[live].astype(np.int64) + 1).sum())

    def layers(self, x, positions, wr_page, wr_slot, attend, pairs):
        """Every MLA decoder block over the lanes x (N, d): q_a → RMSNorm
        → q_b; kv_a → the latent RMSNorm and the key rope stored into the
        latent pool (``ops.mla_latent_store``: page -1 writes nothing);
        q_nope absorbed through W_uk, q_rope roped; ``attend(i, q)`` over
        the latent pages (N, H, rank); W_uv, o_proj.  Lanes with page -1
        route to no expert; ``pairs`` (or None) counts the routed pairs.
        Spans ``mla.attend`` and ``moe.dispatch`` time each attention's
        and each expert pass's host side."""
        cfg = self.cfg
        n = x.shape[0]
        h, nope = cfg.n_heads, cfg.nope_head_dim
        cos, sin = rope_table(cfg, positions)
        live = wr_page >= 0
        r = None
        for i, (blk, kind) in enumerate(zip(self.blocks, self.kinds)):
            a, f = blk.attn, blk.ffn
            uk, uv = self.absorb[i]
            x, hn = ops.add_rms_norm(x, r, blk.ln1)
            with self.spans.span("mla.attend"):
                q = ops.add_rms_norm(hn @ a.w_dq, None, a.q_norm)[1] @ a.w_uq
                q = q.view(n, h, -1)
                ops.mla_latent_store(hn @ a.w_dkv, a.kv_norm, cos, sin,
                                     self.latent_pages[i], wr_page, wr_slot,
                                     interleaved=self.interleaved)
                q = torch.cat([
                    torch.bmm(q[..., :nope].transpose(0, 1), uk)
                    .transpose(0, 1),
                    rotate(q[..., nope:], cos, sin, self.interleaved)],
                    dim=-1)
                o = torch.bmm(attend(i, q).transpose(0, 1), uv)
                o = o.transpose(0, 1).reshape(n, -1) @ a.wo
            x, hn = ops.add_rms_norm(x, o, blk.ln2)
            if kind.endswith("moe"):
                with self.spans.span("moe.dispatch"):
                    r = dropless_moe(f, cfg, hn, live, pairs)
            else:
                r = ops.silu_mul(hn @ f.wi_gate, hn @ f.wi_up) @ f.wo
        self._count_blocks(x, len(self.blocks))
        return x + r
