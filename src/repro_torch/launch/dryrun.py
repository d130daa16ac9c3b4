"""Dry run of one (arch x shape x mesh) cell at production scale, ported
from the JAX package's ``launch/dryrun.py``.

    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k

The reference lowers and compiles the step for 256 (or 512) placeholder
devices and reads XLA's cost and memory analyses.  Here the step runs
eagerly on ``meta`` DTensors on a ``fake`` process group of that world
size (rank 0; ``torch.testing``'s ``FakeStore``): parameters, optimizer
state, batch and cache are placed by the rule table
(``parallel.sharding``), one train, prefill or decode step runs, and a
dispatch mode tallies what rank 0 would execute:

* ``flops_per_device`` — FLOPs of the local aten ops (the registry of
  ``torch.utils.flop_counter``).  The mode defers every DTensor op to
  DTensor and counts the local ops it issues, so the count is the local
  shard's, not the global op's (``FlopCounterMode`` around a DTensor
  matmul reports the global FLOPs);
* ``bytes_accessed_per_device`` — operand plus output bytes of the local
  aten ops, views excluded (``"bytes_basis": "unfused aten ops"``: XLA
  counts after fusion, so these bytes run higher);
* ``collectives`` — the c10d collectives by the reference's five kinds,
  output bytes and count (send / recv count as ``collective-permute``);
* ``memory`` — exact argument and output bytes per device; no peak is
  measured (``peak_bytes`` null, with the reason).

The HLO parser has no counterpart: :func:`collective_bytes_from_ops`
tallies (op name, output bytes) pairs.  The fake group and NCCL cannot
both be the default group of one process, so a process that holds the card
runs the dry run in a subprocess."""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..configs import get_config
from ..configs.base import SHAPES
from ..models import build_model
from ..models.params import flatten_params
from ..parallel.sharding import axis_rules, placements, resolve, \
    shard_params
from ..train.optimizer import make_optimizer
from .mesh import make_mesh, production_shape

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# substrings of an op's name (underscores dropped) → its kind
_KINDS = (("reducescatter", "reduce-scatter"), ("allreduce", "all-reduce"),
          ("allgather", "all-gather"), ("alltoall", "all-to-all"),
          ("collectivepermute", "collective-permute"),
          ("send", "collective-permute"), ("recv", "collective-permute"))
_NAMESPACES = ("_c10d_functional", "c10d", "c10d_functional")


def _collective_kind(name: str):
    """The reference's kind of a collective op's name, or None."""
    flat = name.replace("_", "").lower()
    for key, kind in _KINDS:
        if key in flat:
            return kind
    return None


def collective_bytes_from_ops(ops):
    """Sum the output bytes of every collective among ``ops`` (pairs of op
    name and output bytes, as the dry run records them).  Returns
    ``{kind: {"bytes": int, "count": int}}`` over the five kinds."""
    out = {k: {"bytes": 0, "count": 0} for k in COLLECTIVES}
    for name, nbytes in ops:
        if name.split(".")[0] not in _NAMESPACES:
            continue
        kind = _collective_kind(name.split(".", 1)[-1])
        if kind is None:
            continue
        out[kind]["bytes"] += int(nbytes)
        out[kind]["count"] += 1
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class LocalTally(TorchDispatchMode):
    """A dispatch mode that counts rank 0's local work: FLOPs, operand and
    output bytes of aten ops, and collectives (name, output bytes).  A
    DTensor op is handed back to DTensor (``NotImplemented``), whose
    local ops then come through here; DTensor's shape inference on fake
    tensors is not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collective_ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = tree_flatten((args, kwargs))[0]
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(isinstance(a, FakeTensor) for a in flat):
            return out
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        if func.namespace in _NAMESPACES:
            self.collective_ops.append((f"{func.namespace}.{func.__name__}",
                                        sum(_nbytes(o) for o in outs)))
            return out
        if func.overloadpacket in flop_registry:
            self.flops += int(flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
        if not func.is_view and func.__name__.split(".")[0] not in (
                "empty", "empty_strided", "detach"):
            ins = [a for a in flat if isinstance(a, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        return out


def _local_bytes(tensors) -> int:
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in tensors)


def fake_group(world_size: int) -> None:
    """Bring up the ``fake`` process group of ``world_size`` as rank 0
    (re-made if a fake group of another size is up)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is up; run the dry run "
                               "in a process of its own")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _place(tensors, axes, mesh):
    return {k: distribute_tensor(
        t, mesh, placements(resolve(axes[k], t.shape, mesh), mesh))
        for k, t in tensors.items()}


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                preset: str = "baseline", verbose: bool = True,
                scan_layers: bool = False, overrides=None,
                donate: bool = False):
    """Run one cell's step on ``meta`` DTensors on the fake group; return
    the reference's record (``scan_layers`` and ``donate`` are recorded
    only: the port keeps one module per layer and runs eagerly)."""
    cfg = get_config(arch).replace(scan_layers=scan_layers,
                                   **(overrides or {}))
    shape = cfg.shapes().get(shape_name)
    if shape is None:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "skipped": True,
                "reason": ("long_500k needs sub-quadratic attention"
                           if shape_name == "long_500k" else "not applicable")}
    model = build_model(cfg)
    dims, axes = production_shape(multi_pod)
    n_chips = int(np.prod(dims))
    fake_group(n_chips)
    mesh = make_mesh(dims, axes, "cpu")
    t0 = time.time()
    tally = LocalTally()
    with axis_rules(mesh, preset=preset):
        params, specs = model.abstract_params()
        shard_params(params, specs, mesh)
        batch = _place(model.input_specs(shape), model.input_axes(shape),
                       mesh)
        flat = flatten_params(params)
        args = list(flat.values()) + list(batch.values())
        if shape.kind == "train":
            optimizer = make_optimizer(cfg.optimizer)
            opt_shapes, opt_specs = optimizer.abstract_state(flat, specs)
            opt_state = {k: v if k == "count" else _place(v, opt_specs[k],
                                                          mesh)
                         for k, v in opt_shapes.items()}
            args += [t for k, v in opt_state.items() if k != "count"
                     for t in v.values()] + [opt_state["count"]]
            t_lower = time.time() - t0
            with tally:
                params.requires_grad_(True)
                loss = model.loss_fn(params, batch)
                grads = torch.autograd.grad(loss, list(flat.values()))
                opt_state = optimizer.update(dict(zip(flat, grads)),
                                             opt_state, flat)
            outs = list(flat.values()) + [loss] + [
                t for k, v in opt_state.items() if k != "count"
                for t in v.values()] + [opt_state["count"]]
        elif shape.kind == "prefill":
            t_lower = time.time() - t0
            with tally, torch.no_grad():
                logits, _ = model.logits_fn(params, batch)
            outs = [logits]
        else:  # decode
            cache = _place(model.init_cache(shape.global_batch,
                                            shape.seq_len, device="meta"),
                           model.cache_specs(), mesh)
            args += list(cache.values())
            t_lower = time.time() - t0
            with tally, torch.no_grad():
                logits, cache = model.decode_step(params, cache, batch)
            outs = [logits] + list(cache.values())
    t_step = time.time() - t0 - t_lower
    colls = collective_bytes_from_ops(tally.collective_ops)
    record = {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "multi_pod": multi_pod,
        "preset": preset,
        "scan_layers": scan_layers,
        "n_chips": n_chips,
        "mesh": dict(zip(axes, dims)),
        "flops_per_device": float(tally.flops),
        "bytes_accessed_per_device": float(tally.bytes),
        "bytes_basis": "unfused aten ops",
        "memory": {
            "argument_bytes": _local_bytes(args),
            "output_bytes": _local_bytes(outs),
            "temp_bytes": None,
            "peak_bytes": None,
            "peak_note": ("not measured: the step runs on meta tensors, "
                          "which allocate nothing"),
        },
        "collectives": colls,
        "collective_bytes_per_device": sum(
            v["bytes"] for v in colls.values()),
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_step, 2),
        "optimizer": cfg.optimizer if shape.kind == "train" else None,
    }
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} × "
              f"{'x'.join(map(str, dims))} preset={preset}: step "
              f"{t_step:.1f}s, flops/dev={record['flops_per_device']:.3e}, "
              f"bytes/dev={record['bytes_accessed_per_device']:.3e}, "
              f"coll/dev={record['collective_bytes_per_device']:.3e}B")
        print("  memory:", record["memory"])
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="architecture id")
    ap.add_argument("--shape", default=None, help="shape name")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch × shape) cell")
    ap.add_argument("--preset", default="baseline")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (e.g. remat=none)")
    ap.add_argument("--donate", action="store_true")
    ap.add_argument("--scan", action="store_true")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("true", "True"):
            v = True
        if v in ("false", "False"):
            v = False
        overrides[k] = v

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    # small → large so the sweep yields results early
    size_order = [
        "whisper-base", "tinyllama-1.1b", "zamba2-1.2b", "mamba2-1.3b",
        "olmoe-1b-7b", "qwen3-8b", "qwen3-32b", "deepseek-v2-236b",
        "qwen2-vl-72b", "llama3-405b",
    ]
    archs = size_order if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]
    cells = [(arch, shape, mp) for mp in meshes for arch in archs
             for shape in shapes]

    failures = 0
    for arch, shape, mp in cells:
        tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}__{args.preset}"
        path = outdir / f"{tag}.json"
        if args.skip_existing and path.exists() and \
                "error" not in json.loads(path.read_text()):
            continue
        try:
            rec = dryrun_cell(arch, shape, multi_pod=mp, preset=args.preset,
                              overrides=overrides, donate=args.donate,
                              scan_layers=args.scan)
        except Exception:
            failures += 1
            rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                   "error": traceback.format_exc()}
            print(f"[dryrun] FAILED {tag}")
            traceback.print_exc()
        path.write_text(json.dumps(rec, indent=2))
    print(f"[dryrun] wrote {len(cells)} records to {outdir}; "
          f"{failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
