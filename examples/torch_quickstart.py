"""Quickstart on the torch port: the paper's technique in 60 seconds —
through ``repro_torch.api``, the one construction surface.

    PYTHONPATH=src python examples/torch_quickstart.py

The demos of ``examples/quickstart.py``, in the same order and printing
the same lines, on the port's copies of the host modules
(``repro_torch.api``, ``repro_torch.core``, ``repro_torch.serving``).
Nothing here touches a device; the last line of the serving demo names
``examples/torch_serve_paged.py`` as the full engine.
"""

import threading

from repro_torch import api
from repro_torch.core import UseAfterFreeError


def demo_scot_traversals():
    print("== SCOT: Harris' list under Hazard Pointers ==")
    lst = api.build("HList", smr="HP",
                    smr_kwargs={"retire_scan_freq": 1})  # SCOT negotiated on
    for k in [3, 1, 4, 1, 5, 9, 2, 6]:
        lst.insert(k)
    assert lst.search(4) and not lst.search(7)
    lst.delete(4)
    print("   list:", lst.snapshot())
    print("   stats:", lst.stats(), lst.smr.stats())


def demo_negotiation():
    print("== Capability negotiation: illegal pairs fail fast ==")
    try:
        api.build("HList", smr="HP", traversal="optimistic")
    except api.IncompatiblePairError as e:
        print("   rejected:", str(e)[:72], "...")
    ok, _ = api.compatible("HList", "EBR", "optimistic")
    print(f"   HList+EBR+optimistic legal: {ok} "
          f"(robust schemes: {api.schemes(robust=True)})")


def demo_waitfree():
    print("== §4 wait-free traversals: a stalled writer can't block ==")
    smr = api.scheme("HP", retire_scan_freq=1)
    lst = api.build("HList", smr=smr, traversal="waitfree")
    for k in range(0, 40, 2):
        lst.insert(k)

    stall = threading.Event()
    stalled = threading.Event()

    def stalled_writer():
        # logically delete key 20 (mark its edge) then stall INSIDE the
        # guard, before the physical unlink — the adversarial schedule
        with smr.guard() as ctx:
            node = lst.get_node(20, ctx)
            nxt, _ = node.next_ref().get()
            node.next_ref().compare_exchange(nxt, False, nxt, True)
            stalled.set()
            stall.wait(timeout=30)

    t = threading.Thread(target=stalled_writer, daemon=True)
    t.start()
    stalled.wait(timeout=30)
    hits = sum(lst.search(k) for k in range(40))  # readers sail past the mark
    stats = lst.stats()
    print(f"   searches done under a stalled writer: {hits} hits, "
          f"restarts={stats['restarts']}, "
          f"escalations={stats['wf_escalations']}")
    stall.set()
    t.join(timeout=10)


def demo_figure1_bug():
    print("== Figure 1: the pre-paper bug (allow_unsafe=True) ==")
    lst = api.build("HList", smr="HP", smr_kwargs={"retire_scan_freq": 1},
                    traversal="optimistic", allow_unsafe=True)
    caught = []

    def churn(i):
        import random
        r = random.Random(i)
        try:
            for _ in range(30000):
                if caught:
                    return
                k = r.randrange(12)
                (lst.insert if r.random() < 0.5 else lst.delete)(k)
        except (UseAfterFreeError, AssertionError) as e:
            caught.append(e)

    ts = [threading.Thread(target=churn, args=(i,)) for i in range(4)]
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    sys.setswitchinterval(old)
    print(f"   use-after-free caught: {caught[:1]!r}"
          if caught else "   (race did not fire this run — rerun)")


def demo_robustness():
    print("== Robustness: stalled thread, EBR vs IBR ==")
    for scheme in ("EBR", "IBR"):
        lst = api.build("HList", smr=scheme,
                        smr_kwargs={"retire_scan_freq": 8, "epoch_freq": 8})
        smr = lst.smr
        smr.begin_op()          # main thread "stalls" inside an operation
        smr.protect(lst.head.next_ref(), 0)

        def churn():
            for i in range(3000):
                lst.insert(i % 256)
                lst.delete(i % 256)

        t = threading.Thread(target=churn)
        t.start()
        t.join()
        print(f"   {scheme}: garbage while stalled = "
              f"{smr.not_yet_reclaimed()} nodes")
        smr.end_op()


def demo_serving_surface():
    print("== Serving sessions: one config, sharded SMR domains ==")
    from repro_torch import serving
    # registry-resolved policy names, validated at config construction
    print("   admission:", api.admission_policies(),
          " eviction:", api.eviction_policies(),
          " scheduler:", api.scheduler_policies())
    cfg = serving.ServingConfig(smr="IBR", num_shards=2, eviction="lru",
                                admission="priority",
                                prefill_chunk_tokens=32)
    print("   config:", cfg.summary())
    try:
        serving.ServingConfig(smr="NR")
    except ValueError as e:
        print("   rejected:", str(e)[:60], "...")
    try:
        # chunk boundaries must stay page-aligned (prefix-cache reuse)
        serving.ServingConfig(prefill_chunk_tokens=12, page_size=8,
                              max_seq_len=256)
    except ValueError as e:
        print("   rejected:", str(e)[:60], "...")
    # shared page-aligned prefixes land on the same shard's cache
    router = serving.PrefixRouter(num_shards=2, page_size=8)
    shared = list(range(100, 108))
    a, b = router.shard_of(shared + [1, 2]), router.shard_of(shared + [9])
    print(f"   router: shared-prefix prompts co-located "
          f"(shard {a} == shard {b}); run "
          f"examples/torch_serve_paged.py "
          f"--shards 2 for the full engine")


def demo_nm_tree():
    print("== Natarajan-Mittal tree with SCOT (IBR) ==")
    tree = api.build("NMTree", smr="IBR")
    for k in range(1, 20, 2):
        tree.insert(k)
    tree.delete(7)
    print("   tree:", tree.snapshot())
    print("   stats:", tree.stats())


if __name__ == "__main__":
    demo_scot_traversals()
    demo_negotiation()
    demo_waitfree()
    demo_serving_surface()
    demo_nm_tree()
    demo_robustness()
    demo_figure1_bug()
    print("done.")
