"""Model factory: config → model instance, and the speculative draft
derived from a served target."""

from __future__ import annotations

from ..configs.base import ModelConfig
from .encdec import WhisperEncDec
from .hybrid import Zamba2LM
from .params import DecoderParams
from .ssm import Mamba2LM
from .transformer import DecoderLM


def build_model(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg)
    if cfg.family == "ssm":
        return Mamba2LM(cfg)
    if cfg.family == "hybrid":
        return Zamba2LM(cfg)
    if cfg.family == "encdec":
        return WhisperEncDec(cfg)
    raise ValueError(f"unknown model family {cfg.family!r}")


def derive_draft(model, params, spec_draft: str = "auto",
                 n_layers: int = 0):
    """Derive a speculative-decoding DRAFT model from a served target.

    ``spec_draft="auto"`` (the only mode, engine v1) slices the target:
    the draft shares the target's embedding, final norm and lm_head and
    keeps the FIRST ``n_layers`` transformer blocks (default: half the
    target's, minimum 1).  No training, no second checkpoint — the draft's
    parameters are the target's own tensors (the same storage; its block
    list holds the target's first blocks), so the draft costs no extra
    parameter memory.  Returns ``(draft_model, draft_params)``.

    Dense family only (the engine's latent pool takes no speculative
    decoding); targets that
    front-load non-attention layers (``first_dense_layers``) are rejected
    rather than sliced into a different architecture."""
    cfg = model.cfg
    if spec_draft != "auto":
        raise ValueError(f"unknown spec_draft {spec_draft!r}; engine v1 "
                         f"only derives drafts ('auto')")
    if cfg.family != "dense":
        raise ValueError(f"spec drafts require a dense target, got family "
                         f"{cfg.family!r}")
    if getattr(cfg, "first_dense_layers", 0):
        raise ValueError("spec drafts cannot slice a model with "
                         "first_dense_layers != 0")
    n = n_layers if n_layers > 0 else max(1, cfg.n_layers // 2)
    if n > cfg.n_layers:
        raise ValueError(f"spec_draft_layers ({n}) exceeds the target's "
                         f"n_layers ({cfg.n_layers})")
    dparams = DecoderParams(params.embed, params.final_norm, params.lm_head,
                            list(params.blocks)[:n])
    return build_model(cfg.replace(n_layers=n)), dparams
