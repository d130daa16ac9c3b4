"""The port's opt-in model settings beside the registry's ``ModelConfig``.

``configs/base.py`` is a verbatim copy of the JAX package's, which has
none of them, so they live on a subclass: :class:`ModelConfig` adds
fields whose defaults are the registry's behaviour (plain rope, greedy
top-k renormalised, every expert held).  Code that reads one takes the
config through :func:`options`, which hands a registry config over as the
subclass with every added field at its default.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

from ..configs import base


@dataclass(frozen=True)
class ModelConfig(base.ModelConfig):
    # routing of the dropless expert layer (models/moe.py dropless_moe):
    # "greedy" top-k over all experts, or "group_limited_greedy" (top-k
    # inside the topk_group of n_group expert groups with the best single
    # score); chosen weights renormalised (norm_topk_prob) or multiplied by
    # routed_scaling_factor
    topk_method: str = "greedy"
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    # the routed experts this device holds, first_expert .. first_expert +
    # experts_held - 1 (0: all n_experts); the router keeps n_experts
    experts_held: int = 0
    first_expert: int = 0
    # YaRN rope scaling of the MLA rope head (DeepSeek-V2's rope_scaling;
    # yarn_factor 0: plain rope), and the published code's reading of the
    # rope dimensions as interleaved pairs (de-interleaved before
    # rotate-half)
    yarn_factor: float = 0.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0
    yarn_original_max_position: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    rope_interleaved: bool = False

    @property
    def n_experts_held(self) -> int:
        """Routed experts whose weights this device holds."""
        return self.experts_held or self.n_experts


@functools.lru_cache(maxsize=None)
def options(cfg) -> ModelConfig:
    """``cfg`` as a :class:`ModelConfig`: itself, or a registry config
    with every opt-in field at its default."""
    if isinstance(cfg, ModelConfig):
        return cfg
    return ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)})
