"""Optimizers on flat dicts of tensors, ported from the JAX package's
``train/optimizer.py``.

* AdamW — fp32 m/v (the default for every arch except llama3-405b).
* Adafactor — factored second moment with bf16 accumulators, the 405B
  memory plan (DESIGN.md §4).

The parameters are a flat dict ``{name: tensor}`` (the trainer passes
:func:`repro_torch.models.params.flatten_params`: the live
``nn.Parameter`` tensors under their ``/``-joined names).  The state is the
reference's layout keyed by those names: ``{"m": {name: t}, "v": {name:
t}, "count"}`` and ``{"f": {name/"v" | name/"vr", name/"vc": t},
"count"}``, ``count`` an int32 0-d tensor; joined with ``/`` its keys are
the reference's tree paths (``m/blocks/0/attn/wq``, ``f/.../wq/vr``).  The
arithmetic follows the reference's order: fp32 moments, bias correction
from ``count``, decoupled weight decay folded into the step, then the
parameter's dtype.  Unlike the reference, ``update`` writes the parameters
and the moments in place (a trainer at full width cannot hold a second
copy of either) and returns the state it was given, with ``count``
advanced.

Both expose ``abstract_state(param_shapes, param_specs)``: the state's
tensors on ``meta`` (shapes and dtypes equal, leaf for leaf, to what
``init`` builds) and their logical axes, which the dry run places on the
mesh.  ``init`` places each moment as its parameter is placed: a DTensor
parameter (``parallel.sharding.shard_params``) gets DTensor moments of
the same placements (Adafactor's factored rows and columns keep the
split of the dimensions they keep)."""

from __future__ import annotations

import math

import torch
from torch.distributed import tensor as dtensor
from torch.distributed.tensor import DTensor, Replicate, Shard


def _count(params):
    """A zero int32 0-d tensor on the parameters' device."""
    return torch.zeros((), dtype=torch.int32,
                       device=next(iter(params.values())).device)


def _zeros_placed(p, shape, dtype, kept):
    """Zeros of ``shape`` on ``p``'s device; for a DTensor ``p`` placed as
    ``p`` is, ``kept`` mapping each dimension of ``p`` to the new
    tensor's (absent: dropped, that mesh dimension replicates)."""
    if not isinstance(p, DTensor):
        return torch.zeros(shape, dtype=dtype, device=p.device)
    place = [Shard(kept[pl.dim]) if pl.is_shard() and pl.dim in kept
             else Replicate() for pl in p.placements]
    return dtensor.zeros(shape, dtype=dtype, device_mesh=p.device_mesh,
                         placements=place)


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _abstract_count():
    return torch.empty((), dtype=torch.int32, device="meta")


class AdamW:
    def __init__(self, lr=3e-4, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, schedule=None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.schedule = schedule

    def init(self, params):
        def zeros():
            return {k: torch.zeros_like(p, dtype=torch.float32)
                    for k, p in params.items()}
        return {"m": zeros(), "v": zeros(), "count": _count(params)}

    def abstract_state(self, param_shapes, param_specs):
        """(state on ``meta``, its logical axes): fp32 m and v shaped as
        their parameters and specced as them, ``count`` a 0-d int32."""
        def f32():
            return {k: _meta(p.shape, torch.float32)
                    for k, p in param_shapes.items()}
        shapes = {"m": f32(), "v": f32(), "count": _abstract_count()}
        specs = {"m": dict(param_specs), "v": dict(param_specs),
                 "count": ()}
        return shapes, specs

    @torch.no_grad()
    def update(self, grads, state, params):
        count = state["count"] + 1
        lr = self.lr if self.schedule is None else self.schedule(count)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** count.float()
        bc2 = 1 - b2 ** count.float()
        for k, p in params.items():
            g32, m, v = grads[k].float(), state["m"][k], state["v"][k]
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * g32.square())
            step = (m / bc1) / ((v / bc2).sqrt() + self.eps)
            step = step + self.weight_decay * p.float()
            p.copy_(p.float() - lr * step)
        return {"m": state["m"], "v": state["v"], "count": count}


class Adafactor:
    """Factored second-moment optimizer (Shazeer & Stern 2018), bf16
    accumulators by default."""

    def __init__(self, lr=1e-3, decay=0.8, eps=1e-30, weight_decay=0.0,
                 acc_dtype=torch.bfloat16, schedule=None):
        self.lr, self.decay, self.eps = lr, decay, eps
        self.weight_decay = weight_decay
        self.acc_dtype = acc_dtype
        self.schedule = schedule

    def _factored(self, shape) -> bool:
        return len(shape) >= 2

    def _parts(self, shape):
        """{part: (shape, {kept dim of the parameter: dim of the part})}."""
        n = len(shape)
        if not self._factored(shape):
            return {"v": (tuple(shape), {d: d for d in range(n)})}
        return {"vr": (tuple(shape[:-1]), {d: d for d in range(n - 1)}),
                "vc": (tuple(shape[:-2]) + tuple(shape[-1:]),
                       {**{d: d for d in range(n - 2)}, n - 1: n - 2})}

    def init(self, params):
        f = {}
        for k, p in params.items():
            for part, (shape, kept) in self._parts(p.shape).items():
                f[f"{k}/{part}"] = _zeros_placed(p, shape, self.acc_dtype,
                                                 kept)
        return {"f": f, "count": _count(params)}

    def abstract_state(self, param_shapes, param_specs):
        """(state on ``meta``, its logical axes): per leaf ``vr`` / ``vc``
        (specs: the parameter's without its last, and without its
        next-to-last, axis) or ``v``, in the accumulator dtype."""
        shapes, specs = {}, {}
        for k, p in param_shapes.items():
            ax = tuple(param_specs[k])
            for part, (shape, _) in self._parts(p.shape).items():
                shapes[f"{k}/{part}"] = _meta(shape, self.acc_dtype)
                specs[f"{k}/{part}"] = {"v": ax, "vr": ax[:-1],
                                        "vc": ax[:-2] + ax[-1:]}[part]
        return ({"f": shapes, "count": _abstract_count()},
                {"f": specs, "count": ()})

    @torch.no_grad()
    def update(self, grads, state, params):
        count = state["count"] + 1
        lr = self.lr if self.schedule is None else self.schedule(count)
        beta = 1.0 - (count.float() + 1.0) ** (-self.decay)

        f = state["f"]
        for k, p in params.items():
            g32 = grads[k].float()
            g2 = g32.square() + self.eps
            if self._factored(p.shape):
                fr, fc = f[f"{k}/vr"], f[f"{k}/vc"]
                vr = beta * fr.float() + (1 - beta) * g2.mean(dim=-1)
                vc = beta * fc.float() + (1 - beta) * g2.mean(dim=-2)
                denom = (vr[..., None] * vc[..., None, :]) / torch.clamp(
                    vr.mean(dim=-1)[..., None, None], min=self.eps)
                step = g32 * torch.rsqrt(denom + self.eps)
                fr.copy_(vr)
                fc.copy_(vc)
            else:
                fv = f[f"{k}/v"]
                v = beta * fv.float() + (1 - beta) * g2
                step = g32 * torch.rsqrt(v + self.eps)
                fv.copy_(v)
            # relative step clipping (Adafactor's update clipping, d=1)
            rms = torch.sqrt(step.square().mean() + 1e-30)
            step = step / torch.clamp(rms, min=1.0)
            p2 = p.float() - lr * step
            if self.weight_decay:
                p2 = p2 - lr * self.weight_decay * p.float()
            p.copy_(p2)
        return {"f": state["f"], "count": count}


def make_optimizer(name: str, **kw):
    if name == "adamw":
        return AdamW(**kw)
    if name == "adafactor":
        return Adafactor(**kw)
    raise ValueError(name)


def cosine_schedule(base_lr: float, warmup: int = 100, total: int = 10000,
                    min_frac: float = 0.1):
    """Linear warmup to ``base_lr`` over ``warmup`` updates, then a cosine
    down to ``min_frac`` of it at ``total``; ``count`` an int tensor, the
    result an fp32 tensor on its device."""
    def fn(count):
        c = count.float()
        warm = c / max(warmup, 1)
        prog = torch.clamp((c - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi *
                                                               prog))
        return base_lr * torch.where(c < warmup, warm, cos)
    return fn
