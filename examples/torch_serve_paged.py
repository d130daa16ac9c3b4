"""End-to-end serving example on the torch port: a sharded serving session
over SMR-managed paged KV pools + SCOT prefix caches, with concurrent
client threads.

    PYTHONPATH=src python examples/torch_serve_paged.py --device cpu \\
        --smr IBR --shards 2 --eviction lru --requests 12
    PYTHONPATH=src python examples/torch_serve_paged.py \\
        --no-reduced --dtype bfloat16          # TinyLlama-1.1B on the card

The port's counterpart of ``examples/serve_paged.py``: the same flags and
defaults, the same ``ServingConfig`` (128 pages of 8, ``max_batch=4``,
``max_seq_len=256``), the same ``run_serving_workload`` call (the port's
verbatim copy of ``core/workload.py``) and the same printed lines.  It
differs where the port's serve launcher (``repro_torch.launch.serve``)
does:

* no ``--backend``: the port's ``ServingConfig`` has no such field, the
  kernels dispatch by device; the first printed line names the device
  where the reference's names the backend;
* ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
  PyTorch versions): with no card, the default raises rather than fall
  back to the CPU;
* ``--reduced/--no-reduced``: the reduced TinyLlama config in fp32 by
  default, as the reference serves; ``--no-reduced`` serves the published
  widths;
* ``--dtype`` overrides the config's dtype;
* weights are seeded random, ``model.init(7, device=...)``.

The pieces are reusable: :func:`build` gives (cfg, model, params,
ServingConfig), :func:`serving_config` the config alone, :func:`workload`
the keyword arguments of ``run_serving_workload``, :func:`run` drives a
session, and :class:`Recorder` wraps a session so that each submitted
prompt keeps its handle (``run_serving_workload`` returns totals only).
:func:`main` prints the reference's lines and returns the result, the
session's stats and every prompt's tokens."""

from __future__ import annotations

import argparse
import threading

from repro_torch import api, serving
from repro_torch.configs import get_config
from repro_torch.core.workload import run_serving_workload
from repro_torch.models import build_model


def parse(argv=None):
    ap = argparse.ArgumentParser()
    # every choice list is a registry query — scheme names (NR excluded:
    # it never reclaims, so the page pool would leak dry), traversal
    # policies, and the serving admission/eviction policies
    ap.add_argument("--smr", default="IBR",
                    choices=api.schemes(reclaims=True))
    ap.add_argument("--shards", type=int, default=2,
                    help="independent SMR domains (pool + prefix cache + "
                         "scheme instance per shard)")
    ap.add_argument("--shard-smr", default="per_shard",
                    choices=["per_shard", "shared"],
                    help="per_shard: each shard reclaims independently "
                         "(stall isolation); shared: one scheme instance "
                         "spans all shards")
    ap.add_argument("--admission", default="fifo",
                    choices=api.admission_policies())
    ap.add_argument("--eviction", default="fifo",
                    choices=api.eviction_policies())
    ap.add_argument("--scheduler", default="chunked",
                    choices=api.scheduler_policies(),
                    help="chunked-prefill fairness: 'chunked' bounds how "
                         "long one prompt's ingestion can stall in-flight "
                         "decoders; 'oneshot' is the stall-prone baseline; "
                         "'packed' executes chunked's grants as one "
                         "multi-segment chunk per step")
    ap.add_argument("--device", default="cuda",
                    help="device the session serves on; 'cpu' runs the "
                         "kernels' plain PyTorch versions")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced config in fp32 (default); --no-reduced "
                         "serves the published config")
    ap.add_argument("--dtype", default=None,
                    choices=("float32", "bfloat16"))
    ap.add_argument("--chunk-tokens", type=int, default=16,
                    help="per-step prefill token budget (page multiple)")
    ap.add_argument("--long-prompts", type=int, default=2,
                    help="long prompts mixed into the request stream (the "
                         "TTFT/ITL interference workload; 0 disables)")
    ap.add_argument("--prefix-traversal", default=None,
                    choices=api.traversal_policies(),
                    help="prefix-cache bucket traversal policy (default: "
                         "negotiated — SCOT iff the scheme is robust); "
                         "'waitfree' demos the paper's §4 variant on the "
                         "admission path")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--clients", type=int, default=3)
    # fault tolerance (DESIGN.md §14)
    ap.add_argument("--fault", action="append", default=[],
                    metavar="KIND:K=V,...",
                    help="schedule a chaos fault (repeatable), e.g. "
                         "'stall:shard=0,after_done=4,duration_s=2' or "
                         "'crash:shard=1,at_step=200'; kinds: "
                         + ", ".join(api.fault_kinds()))
    ap.add_argument("--watchdog", default="migrate",
                    choices=["migrate", "observe", "off"],
                    help="shard watchdog mode: degraded shards lose their "
                         "router slot and (migrate) their sequences move "
                         "to healthy shards via the SMR-safe handoff")
    ap.add_argument("--timeout-s", type=float, default=None,
                    help="per-request deadline (expired requests are "
                         "cancelled through the normal cancel path)")
    ap.add_argument("--pace-s", type=float, default=0.0,
                    help="per-client gap between submissions — stretches "
                         "the run so mid-run faults land under live "
                         "traffic")
    # host swap tier + priority preemption (DESIGN.md §15)
    ap.add_argument("--swap-bytes", type=int, default=0,
                    help="per-shard host swap arena bytes (0 disables); "
                         "with --eviction swap, admission pressure "
                         "preempts lower-priority active sequences into "
                         "the arena and resumes them bit-identically")
    ap.add_argument("--priority-class", action="append", default=[],
                    metavar="NAME:K=V,...",
                    help="define a priority class (repeatable), e.g. "
                         "'interactive:priority=10,ttft_slo_s=2' or "
                         "'batch:priority=0'; requests cycle through the "
                         "defined classes")
    return ap.parse_args(argv)


def build(args):
    """(cfg, model, params, ServingConfig) for parsed ``args``; the
    weights are ``model.init(7)`` on ``args.device``."""
    cfg = get_config("tinyllama-1.1b")
    if args.reduced:
        cfg = cfg.reduced().replace(dtype="float32")
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    model = build_model(cfg)
    params = model.init(7, device=args.device)
    return cfg, model, params, serving_config(args)


def serving_config(args):
    """The example's ``ServingConfig`` for parsed ``args``."""
    return serving.ServingConfig(
        smr=args.smr, num_shards=args.shards, shard_smr=args.shard_smr,
        num_pages=128, page_size=8, max_batch=4, max_seq_len=256,
        admission=args.admission, eviction=args.eviction,
        scheduler=args.scheduler,
        prefill_chunk_tokens=args.chunk_tokens,
        prefix_traversal=args.prefix_traversal,
        watchdog=args.watchdog,
        default_timeout_s=args.timeout_s,
        faults=tuple(args.fault) or None,
        swap_bytes=args.swap_bytes,
        priority_classes=tuple(args.priority_class) or None)


def workload(args) -> dict:
    """The keyword arguments of the example's ``run_serving_workload``
    call (every one but the session)."""
    class_names = [serving.parse_priority_class(c).name
                   for c in args.priority_class]
    classes = None
    if class_names:
        # long-prompt inserts change the count, so size the class list
        # to the requests the workload will actually submit
        total = args.requests + args.long_prompts
        classes = [class_names[i % len(class_names)] for i in range(total)]
    return dict(n_requests=args.requests, clients=args.clients,
                shared_prefix_len=16, tail_len=4,
                distinct_prefixes=max(2, args.shards),
                max_new_tokens=args.max_new, wait_each=True,
                long_prompts=args.long_prompts, long_prompt_len=192,
                pace_s=args.pace_s, priority_classes=classes)


def run(session, args):
    """Drive ``session`` (a session or a :class:`Recorder`) with the
    example's client threads; returns the ``ServingWorkloadResult``."""
    return run_serving_workload(session, **workload(args))


class Recorder:
    """A session as ``run_serving_workload`` sees it (``submit`` and
    ``stats``), keeping every submitted prompt beside its handle, in
    submission order.  Wraps any session with that surface."""

    def __init__(self, session):
        self.session = session
        self.handles = []           # (prompt as submitted, handle)
        self._lock = threading.Lock()

    def submit(self, prompt, **kwargs):
        handle = self.session.submit(prompt, **kwargs)
        with self._lock:
            self.handles.append((list(prompt), handle))
        return handle

    def stats(self):
        return self.session.stats()

    def streams(self):
        """[(prompt, generated tokens)] in submission order."""
        with self._lock:
            return [(p, list(h.out_tokens)) for p, h in self.handles]


def report(args, res, stats) -> None:
    """The reference's printed lines."""
    print(f"scheme={args.smr} shards={args.shards} "
          f"admission={args.admission} eviction={args.eviction} "
          f"scheduler={args.scheduler}/{args.chunk_tokens}tok "
          f"device={args.device} "
          f"requests={res.requests} generated={res.tokens} tokens "
          f"in {res.duration_s:.2f}s ({res.tok_per_s:.1f} tok/s, "
          f"prefix hits={res.prefix_hits}, "
          f"ttft_p99={res.ttft_p99_s * 1e3:.1f}ms, "
          f"itl_p99={res.itl_p99_s * 1e3:.1f}ms)")
    if args.fault or res.migrations or res.failed:
        print(f"faults: migrations={res.migrations} failed={res.failed} "
              f"cancelled={res.cancelled} "
              f"heartbeat_misses={res.heartbeat_misses} "
              f"degraded_steps={res.degraded_steps}")
    if args.swap_bytes or res.preemptions:
        print(f"swap: preemptions={res.preemptions} "
              f"swapped_out={res.swapped_out} pages "
              f"swapped_in={res.swapped_in} pages")
    for name, agg in sorted(res.per_class.items()):
        print(f"  class {name}: requests={agg['requests']} "
              f"completed={agg['completed']} cancelled={agg['cancelled']} "
              f"ttft_p99={agg['ttft_p99_s'] * 1e3:.1f}ms")
    print("totals:", stats["totals"])
    for shard in stats["shards"]:
        pc = shard["prefix_cache"]
        print(f"  shard {shard['shard']}: steps={shard['steps']} "
              f"pool_free={shard['pool']['free']} "
              f"cache(hits={pc['hits']} entries={pc['entries']} "
              f"eviction={pc['eviction']}) "
              f"smr(retired={shard['smr']['retired']} "
              f"reclaimed={shard['smr']['reclaimed']})")


def main(argv=None):
    """Serve the example's workload and print the reference's lines;
    returns ``{"result", "stats", "streams"}`` (``streams``: each
    prompt with its tokens, in submission order)."""
    args = parse(argv)
    _, model, params, config = build(args)
    with serving.serve(model, params, config, device=args.device) as session:
        rec = Recorder(session)
        res = run(rec, args)
        stats = session.stats()
    report(args, res, stats)
    return {"result": res, "stats": stats, "streams": rec.streams()}


if __name__ == "__main__":
    main()
