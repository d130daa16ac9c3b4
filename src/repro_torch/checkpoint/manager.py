"""Checkpointing for fault tolerance, ported from the JAX package's
``checkpoint/manager.py`` with its layout and manifest:

  * **atomic**: write to ``step_N.tmp/`` then ``os.replace`` → ``step_N/``;
    a crash mid-write never corrupts the latest checkpoint;
  * **async**: ``save()`` copies every tensor to the host before it returns
    and hands the files to a writer thread; the copy is what makes that
    safe, since the optimizer updates parameters and moments in place;
  * **self-describing**: ``params.npz``, ``opt_state.npz`` and a
    ``manifest.json`` with the step, the data index, the time, ``extra``
    and ``param_specs``;
  * **bounded**: keeps the last ``keep`` checkpoints.

The parameters are a flat dict ``{name: tensor}`` (``flatten_params``), the
optimizer state a dict of such dicts and tensors (``{"m": {name: t}, ...,
"count": t}``); both are written under ``/``-joined keys
(``m/blocks/0/attn/wq``) and restored in the same shape.  numpy has no
bfloat16, so a bf16 tensor is stored as its bits (``uint16``) and named in
the file's ``__bfloat16__`` entry; a restored tensor equals the saved one
byte for byte.  ``restore(device=...)`` puts the tensors on one device;
``restore(mesh=..., param_specs=..., opt_specs=..., resolve_fn=...)`` is
the reference's elastic path: every leaf becomes a DTensor placed on the
*current* mesh by its logical axes (``parallel.sharding.resolve`` and
``placements``), whatever mesh saved it.  DTensor leaves are saved as
their full tensors: ``save`` gathers them (a collective, so every rank of
the mesh calls it) and rank 0 copies them to the host and writes.  Under
a process group the save is published to every rank together: the
``wait()`` that ends it (the next ``save``, ``latest_step``,
``restore`` or ``close``) returns on no rank before rank 0's step is on
disk, and raises on every rank if rank 0's write failed."""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from ..models.params import resolve_device

_BF16 = "__bfloat16__"


def flatten_tree(tree, prefix=""):
    """A tree (dicts of tensors) → ``{"a/b/c": leaf}``."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _group(flat: Dict[str, Any]):
    """The optimizer state's shape back from its keys: ``{"m/a/b": t,
    "count": c}`` → ``{"m": {"a/b": t}, "count": c}``."""
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        head, sep, rest = key.partition("/")
        if sep:
            out.setdefault(head, {})[rest] = value
        else:
            out[head] = value
    return out


def _rank() -> Optional[int]:
    """This process's rank, or None without a process group."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_initialized() else None


def _to_host(tree, writes: bool) -> Dict[str, np.ndarray]:
    """Owned host copies of every leaf (a DTensor's full tensor, gathered
    on every rank), bf16 as its bits, plus the list of the bf16 keys;
    ``{}`` where ``writes`` is false."""
    out, bf16 = {}, []
    for k, v in flatten_tree(tree).items():
        if isinstance(v, DTensor):
            v = v.full_tensor()
        if not writes:
            continue
        t = v.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            bf16.append(k)
            out[k] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            out[k] = t.numpy()
    out[_BF16] = np.array(bf16, dtype=np.str_)
    return out


def _from_host(arrays, device) -> Dict[str, torch.Tensor]:
    bf16 = set(arrays[_BF16].tolist())
    out = {}
    for k in arrays.files:
        if k == _BF16:
            continue
        t = torch.from_numpy(np.array(arrays[k]))
        if k in bf16:
            t = t.view(torch.bfloat16)
        out[k] = t.to(device)
    return out


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._unpublished = False    # a save the ranks have not synced

    # ---------------------------------------------------------------- save
    def save(self, step: int, params, opt_state, *, data_index: int = 0,
             param_specs=None, extra: Optional[dict] = None,
             block: bool = False) -> None:
        self.wait()  # one in-flight save at a time
        writes = _rank() in (None, 0)
        # snapshot to host BEFORE returning (updated in place afterwards)
        flat_p = _to_host(params, writes)
        flat_o = _to_host(opt_state, writes)
        manifest = {
            "step": step,
            "data_index": data_index,
            "time": time.time(),
            "extra": extra or {},
            "param_specs": {k: list(v) for k, v in
                            flatten_tree(param_specs or {}).items()},
        }

        def write():
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "params.npz", **flat_p)
            np.savez(tmp / "opt_state.npz", **flat_o)
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)           # atomic publish
            self._gc()

        self._unpublished = True
        if writes and self.async_save and not block:
            self._writer = threading.Thread(target=self._guarded,
                                            args=(write,), daemon=True)
            self._writer.start()
        elif writes:
            self._guarded(write)
        if block or not self.async_save:
            self.wait()

    def _guarded(self, fn):
        try:
            fn()
        except BaseException as e:  # surfaced on next wait()
            self._error = e

    def wait(self):
        """Block until the last save is on disk and raise its error.
        Under a process group every rank calls it after the same saves:
        rank 0 then tells the others how its write ended (a collective,
        so no rank returns before the step is published)."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        err, self._error = self._error, None
        if self._unpublished and _rank() is not None:
            said = [None if err is None else f"{type(err).__name__}: {err}"]
            torch.distributed.broadcast_object_list(said, src=0)
            if err is None and said[0] is not None:
                err = RuntimeError(f"rank 0 failed to write the "
                                   f"checkpoint: {said[0]}")
        self._unpublished = False
        if err is not None:
            raise err

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self):
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                if not p.name.endswith(".tmp")]

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self.all_steps()
        return max(steps) if steps else None

    def restore(self, step: Optional[int] = None, *, mesh=None,
                param_specs=None, opt_specs=None, resolve_fn=None,
                device=None) -> Tuple[Any, Any, dict]:
        """Load (params, opt_state, manifest) of ``step`` (default the
        latest), in the shapes :meth:`save` was given.  Without ``mesh``
        the tensors land on ``device`` (``None`` = the card).  With
        ``mesh`` every leaf is a DTensor on it, placed by
        ``placements(resolve_fn(axes, shape, mesh), mesh)`` with ``axes`` from
        ``param_specs`` / ``opt_specs`` (``{name: axes}``, the optimizer's
        nested as its state; a leaf without axes is replicated): the
        elastic-resume path."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        dev = resolve_device(device) if mesh is None \
            else resolve_device(mesh.device_type)
        path = self.dir / f"step_{step}"
        manifest = json.loads((path / "manifest.json").read_text())
        with np.load(path / "params.npz") as f:
            params = _place(_from_host(f, dev), mesh, param_specs,
                            resolve_fn)
        with np.load(path / "opt_state.npz") as f:
            opt_state = _group(_place(_from_host(f, dev), mesh, opt_specs,
                                      resolve_fn))
        return params, opt_state, manifest


def _place(flat, mesh, specs, resolve_fn):
    """Each leaf of ``flat`` distributed on ``mesh`` by its logical axes
    (``flat`` as it is without a mesh)."""
    if mesh is None:
        return flat
    if resolve_fn is None:
        raise ValueError("restore(mesh=...) needs resolve_fn")
    from ..parallel.sharding import placements
    axes = flatten_tree(specs or {})
    out = {}
    for k, t in flat.items():
        ax = tuple(axes.get(k, ()) or (None,) * t.dim())
        out[k] = distribute_tensor(
            t, mesh, placements(resolve_fn(ax, tuple(t.shape), mesh), mesh))
    return out
