"""The training loop, ported from the JAX package's ``train/loop.py``: one
eager step (optional microbatch gradient accumulation), async
checkpointing, failure injection and retry, straggler tracking, resume.

On the card every attention and SSD forward of ``loss_fn`` runs the
hand-written kernel (through its ``autograd.Function``; the backward is
the plain version's vector-Jacobian product) and each block is
rematerialised under ``cfg.remat == "full"``, so a dense block launches
the flash kernel twice a step: in the forward and in the recompute.

The parameters are the model's own module, unfrozen; the optimizer and
the checkpoint see them as the flat dict of the live tensors that
:func:`flatten_params` gives, and the optimizer updates them in place.
A step that fails (the failure hook, or a non-finite loss) raises
:class:`TransientFailure` before the update, so its retry starts from
unchanged parameters, as the reference's functional step does.

With ``mesh`` (a ``DeviceMesh``) the step is the sharded one: the
parameters are DTensors placed by their logical axes
(``parallel.sharding.shard_params``), the moments follow them, the batch
is split by ``("batch", "seq")`` and the model runs under
``axis_rules(mesh)`` (the baseline table), where its ``constrain`` sites
redistribute activations and the kernels run on local shards
(``local_map``).  A checkpoint's manifest carries the parameters' logical
axes, and ``restore`` places every leaf on the current mesh."""

from __future__ import annotations

import math
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch
from torch import nn
from torch.distributed.tensor import distribute_tensor

from ..checkpoint.manager import CheckpointManager
from ..data.pipeline import DataPipeline
from ..models import build_model
from ..models.params import (flatten_params, param_specs, resolve_device,
                             unflatten_params)
from ..parallel.sharding import axis_rules, placements, resolve, \
    shard_params
from .fault_tolerance import StragglerWatchdog, TransientFailure, \
    retrying_step
from .optimizer import cosine_schedule, make_optimizer


@dataclass
class TrainState:
    params: nn.Module
    opt_state: dict
    step: int = 0


class Trainer:
    def __init__(self, cfg, *, seed: int = 0, global_batch: int = 8,
                 seq_len: int = 64, microbatches: int = 1,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 50, keep: int = 3,
                 lr: float = 3e-4, warmup: int = 20, total_steps: int = 1000,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 device=None, mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.specs = param_specs(cfg)
        self.model = build_model(cfg)
        self.optimizer = make_optimizer(
            cfg.optimizer, schedule=cosine_schedule(lr, warmup, total_steps))
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.microbatches = microbatches
        if global_batch % microbatches:
            raise ValueError(f"global_batch {global_batch} is not a "
                             f"multiple of microbatches {microbatches}")
        self.pipeline = DataPipeline(seed, global_batch, seq_len,
                                     cfg.vocab_size, prefetch=2)
        self.ckpt = (CheckpointManager(checkpoint_dir, keep=keep)
                     if checkpoint_dir else None)
        self.checkpoint_every = checkpoint_every
        self.watchdog = StragglerWatchdog()
        self.failure_hook = failure_hook
        self.losses: List[float] = []

    # ------------------------------------------------------------ step fn
    def _rules(self):
        """The mesh's rule context, or nothing without a mesh."""
        if self.mesh is None:
            return nullcontext()
        return axis_rules(self.mesh)

    def _place_batch(self, tokens):
        if self.mesh is None:
            return tokens
        spec = resolve(("batch", "seq"), tokens.shape, self.mesh)
        return distribute_tensor(tokens, self.mesh,
                                 placements(spec, self.mesh))

    def _loss_and_grads(self, params: nn.Module, tokens):
        """(mean loss, {name: gradient}) over the global batch; with k
        microbatches the fp32 gradients are summed and divided by k."""
        flat = flatten_params(params)
        leaves = list(flat.values())
        k = self.microbatches

        def grads_of(toks):
            loss = self.model.loss_fn(params, {"tokens": toks})
            return loss.detach(), torch.autograd.grad(loss, leaves)

        if k == 1:
            loss, grads = grads_of(tokens)
        else:
            mb = tokens.reshape(k, tokens.shape[0] // k, tokens.shape[1])
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            for toks in mb:
                loss_i, g_i = grads_of(toks)
                loss = loss + loss_i
                for acc, g in zip(grads, g_i):
                    acc.add_(g)
            loss = loss / k
            grads = [g / k for g in grads]
        return loss, dict(zip(flat, grads))

    # ------------------------------------------------------------- control
    def _params(self):
        """Seed-0 weights, sharded on the mesh when there is one."""
        params = self.model.init(0, self.device)
        if self.mesh is not None:
            shard_params(params, self.specs, self.mesh)
        return params

    def init_state(self) -> TrainState:
        params = self._params()
        opt_state = self.optimizer.init(flatten_params(params))
        return TrainState(params, opt_state, 0)

    def restore(self, step: Optional[int] = None) -> TrainState:
        """The state saved at ``step`` (default the latest), the data
        pipeline sought to where that step left it."""
        if self.mesh is None:
            flat, opt_state, manifest = self.ckpt.restore(
                step, device=self.device)
        else:
            flat_shapes = flatten_params(self.model.abstract_params()[0])
            opt_specs = self.optimizer.abstract_state(flat_shapes,
                                                      self.specs)[1]
            flat, opt_state, manifest = self.ckpt.restore(
                step, mesh=self.mesh, param_specs=self.specs,
                opt_specs=opt_specs, resolve_fn=resolve)
        params = unflatten_params(self._params(), flat)
        self.pipeline.seek(manifest["data_index"])
        return TrainState(params, opt_state, manifest["step"])

    def restore_or_init(self) -> TrainState:
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            return self.restore()
        return self.init_state()

    def train(self, state: TrainState, num_steps: int) -> TrainState:
        state.params.requires_grad_(True)
        step_once = retrying_step(self._run_one, max_retries=3)
        target = state.step + num_steps
        while state.step < target:
            tokens = next(self.pipeline)
            t0 = time.perf_counter()
            state = step_once(state, tokens)
            self.watchdog.observe(time.perf_counter() - t0)
            if (self.ckpt is not None and
                    state.step % self.checkpoint_every == 0):
                self.ckpt.save(state.step, flatten_params(state.params),
                               state.opt_state,
                               data_index=self.pipeline.index,
                               param_specs=self.specs)
        if self.ckpt is not None:
            self.ckpt.save(state.step, flatten_params(state.params),
                           state.opt_state, data_index=self.pipeline.index,
                           param_specs=self.specs, block=True)
        return state

    def _run_one(self, state: TrainState, tokens) -> TrainState:
        if self.failure_hook is not None:
            self.failure_hook(state.step)   # may raise TransientFailure
        with self._rules():
            loss, grads = self._loss_and_grads(
                state.params, self._place_batch(
                    torch.from_numpy(tokens).to(self.device)))
            loss = float(loss.full_tensor() if hasattr(loss, "full_tensor")
                         else loss)
            if not math.isfinite(loss):
                raise TransientFailure(f"non-finite loss at step "
                                       f"{state.step}")
            opt = self.optimizer.update(grads, state.opt_state,
                                        flatten_params(state.params))
        self.losses.append(loss)
        return TrainState(state.params, opt, state.step + 1)

    def close(self):
        self.pipeline.close()
        if self.ckpt is not None:
            self.ckpt.wait()
