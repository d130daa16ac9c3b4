"""Logical-axis sharding rules on DTensor, ported from the JAX package's
``parallel/sharding.py`` (MaxText-style).

Model code names the axes of parameters and activations with *logical*
names ("embed", "heads", "mlp", "batch", ...).  A rule table maps each
logical name to mesh axes.  :func:`resolve` turns a tensor's logical axes
into the reference's ``PartitionSpec`` as a plain tuple, one entry per
dimension (``None``, a mesh-axis name, or a tuple of names), dropping a
mesh axis where the dimension is not divisible by its size
(replicate-fallback) or where an earlier dimension already took it.  It
reads only the mesh's axis sizes by name, so it is pure: a
``DeviceMesh``, a mapping ``{name: size}``, or any object whose ``shape``
is such a mapping will do.

:func:`placements` turns a spec into DTensor placements on a
``DeviceMesh``: ``Shard(dim)`` on every mesh dimension the spec names for
tensor dimension ``dim``, ``Replicate()`` elsewhere.  DTensor splits a
tensor dimension that several mesh dimensions shard in mesh-dimension
order (the first is the outer split), which is the reference's order for
``("pod", "data")`` on ``("pod", "data", "model")``; a spec that names
them in another order raises.

The rule table is the hillclimbing surface of the reference: alternative
sharding schemes are alternative rule tables (:data:`PRESETS`)."""

from __future__ import annotations

import threading
from collections.abc import Mapping
from contextlib import contextmanager, nullcontext
from typing import Dict, Optional, Sequence, Tuple, Union

from torch import nn
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

from .dtensor_ops import unshard

MeshAxes = Union[str, Tuple[str, ...], None]

# Default logical→mesh rules.  ('pod', 'data') both act as the DP/FSDP axes;
# 'model' is the TP/EP/SP axis.
DEFAULT_RULES: Dict[str, MeshAxes] = {
    # --- weights ---
    "vocab": "model",            # embedding/output vocab dim (TP)
    "embed": ("data",),          # FSDP: shard d_model dim of weights over DP
    "embed_no_fsdp": None,
    "heads": "model",            # attention heads (TP)
    "kv_heads": "model",         # GQA KV heads (TP; falls back if indivisible)
    "head_dim": None,
    "mlp": "model",              # FFN hidden (TP)
    "experts": "model",          # MoE expert dim (EP)
    "expert_mlp": None,          # per-expert hidden (kept local under EP)
    "kv_lora": None,             # MLA compressed dim (small; replicated)
    "q_lora": None,
    "ssm_state": None,
    "conv_dim": "model",
    "layers": None,              # scan axis — never sharded
    # --- activations ---
    "batch": ("pod", "data"),
    "seq": None,
    # KV-cache length dim: sequence-parallel by default (kv_heads=8 cannot
    # split over model=16, but seq can); preset "kv_tp" flips it.
    "decode_seq": "model",
    "act_embed": None,
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_mlp": "model",
    "act_vocab": "model",
    "act_experts": "model",
}

# Alternative schemes — deltas over DEFAULT_RULES.
PRESETS: Dict[str, Dict[str, MeshAxes]] = {
    "baseline": {},
    # shard weights' embed over BOTH pod and data (deeper FSDP; less memory,
    # more all-gather)
    "fsdp_pod": {"embed": ("pod", "data")},
    # megatron-pure: no FSDP, pure TP (more memory, fewer collectives)
    "tp_only": {"embed": None},
    # TP over KV heads instead of sequence-parallel cache
    "kv_tp": {"decode_seq": None},
    # sequence-parallel TP (Korthikanti et al.): activations between TP
    # regions shard over 'model' along seq
    "sp_act": {"seq": "model"},
    # expert+data mixed EP (experts over both axes when divisible)
    "ep_wide": {"experts": ("data", "model")},
    # inference-replicated weights: no FSDP/TP all-gathers on the decode
    # path; experts stay EP
    "serve_replicated": {
        "vocab": None, "embed": None, "heads": None, "kv_heads": None,
        "mlp": None, "conv_dim": None, "kv_lora": None, "q_lora": None,
        "act_heads": None, "act_kv_heads": None, "act_mlp": None,
        "act_vocab": None,
    },
}

_local = threading.local()


def _current():
    return (getattr(_local, "mesh", None),
            getattr(_local, "rules", None) or DEFAULT_RULES)


def _axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, a mapping, or an object
    whose ``shape`` is a mapping (as a JAX mesh's is)."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(mesh.shape)


@contextmanager
def axis_rules(mesh, rules: Optional[Dict[str, MeshAxes]] = None,
               preset: str = "baseline"):
    """Activate a mesh and a logical rule table on this thread.  With a
    ``DeviceMesh`` the block also runs under DTensor's implicit
    replication, so the plain tensors the model makes (positions, masks)
    meet DTensor parameters as replicated values."""
    table = dict(DEFAULT_RULES)
    table.update(PRESETS.get(preset, {}))
    if rules:
        table.update(rules)
    prev = (getattr(_local, "mesh", None), getattr(_local, "rules", None))
    _local.mesh, _local.rules = mesh, table
    replicate = nullcontext()
    if getattr(mesh, "mesh_dim_names", None) is not None:
        replicate = implicit_replication()
    try:
        with replicate:
            yield table
    finally:
        _local.mesh, _local.rules = prev


def resolve(logical_axes: Sequence[Optional[str]],
            shape: Optional[Sequence[int]] = None, mesh=None,
            rules: Optional[Dict[str, MeshAxes]] = None) -> tuple:
    """Logical axes → the spec as a tuple, dropping indivisible mesh axes
    and axes an earlier dimension already took."""
    cmesh, crules = _current()
    sizes = _axis_sizes(mesh if mesh is not None else cmesh)
    rules = rules or crules
    parts = []
    used = set()
    for i, name in enumerate(logical_axes):
        entry: MeshAxes = rules.get(name) if name else None
        if entry is None:
            parts.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        good = [a for a in axes if a in sizes and a not in used]
        if shape is not None and good:
            total = 1
            for a in good:
                total *= sizes[a]
            if shape[i] % total != 0:
                good = []          # replicate-fallback
        used.update(good)
        parts.append(tuple(good) if len(good) > 1
                     else (good[0] if good else None))
    return tuple(parts)


def placements(spec: Sequence, mesh) -> tuple:
    """A spec (as :func:`resolve` gives it) → DTensor placements on
    ``mesh``, one per mesh dimension."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"spec {tuple(spec)} shards dim {dim} over {axes}, but "
                f"DTensor splits one dimension in mesh order {tuple(names)}")
        for i in order:
            out[i] = Shard(dim)
    return tuple(out)


def param_sharding(specs: Dict[str, tuple], mesh, shapes=None,
                   rules: Optional[Dict[str, MeshAxes]] = None):
    """``{name: logical axes}`` → ``{name: placements}``; ``shapes``
    (``{name: shape}`` or tensors) gives the divisibility fallback."""
    out = {}
    for name, axes in specs.items():
        shape = None if shapes is None else tuple(
            getattr(shapes[name], "shape", shapes[name]))
        out[name] = placements(resolve(axes, shape, mesh, rules), mesh)
    return out


def shard_params(module: nn.Module, specs: Dict[str, tuple], mesh,
                 rules: Optional[Dict[str, MeshAxes]] = None) -> nn.Module:
    """Replace each parameter of ``module`` in place by a DTensor placed by
    its logical axes (``specs`` keyed as ``flatten_params``), the
    counterpart of ``jax.device_put(params, p_sh)``.  Returns the
    module."""
    for name, p in list(module.named_parameters()):
        key = name.replace(".", "/")
        owner = module
        *path, leaf = name.split(".")
        for part in path:
            owner = getattr(owner, part)
        place = placements(resolve(specs[key], p.shape, mesh, rules), mesh)
        dt = distribute_tensor(p.detach(), mesh, place)
        setattr(owner, leaf, nn.Parameter(dt, requires_grad=p.requires_grad))
    return module


def constrain(x, *logical_axes):
    """Redistribute a DTensor activation to its logical axes' placements.
    With no mesh active, or for a plain tensor, ``x`` comes back as it
    is, so model code runs unchanged on one device."""
    mesh, rules = _current()
    if mesh is None or getattr(mesh, "mesh_dim_names", None) is None:
        return x
    if not isinstance(x, DTensor):
        return x
    place = placements(resolve(logical_axes, x.shape, mesh, rules), mesh)
    if tuple(x.placements) == place:
        return x
    return x.redistribute(mesh, place)


def split_dim(x, dim: int, n: int, m: int):
    """``x`` with dimension ``dim`` (of size ``n * m``) reshaped to
    ``(n, m)``.  A DTensor split more ways on ``dim`` than ``n`` allows
    (GQA's few kv heads: the fused ``n * m`` divides where ``n`` does not)
    is replicated on that dimension first, the resharding XLA makes
    implicitly."""
    dim = dim % x.ndim
    shape = tuple(x.shape[:dim]) + (n, m) + tuple(x.shape[dim + 1:])
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    ways = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            ways *= x.device_mesh.size(i)
    return (unshard(x, dim) if n % ways else x).reshape(shape)
