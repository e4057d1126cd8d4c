"""Whether a garbage collection inside a CUDA graph capture, one that
finalizes an earlier graph or trainer left dead in a reference cycle,
invalidates the capture; each variant in a process of its own, one result
line each:

- ``toy {global,thread_local} graph``: a dead cycle holding a captured graph,
  collected inside another capture in that capture mode;
- ``toy global pinned``: the same with a pinned host buffer an async copy used;
- ``trainer FIXED FORCE``: an OU trainer (``chip_smoke.py``'s bench config)
  trains 20 steps in graphs of 10 and profiles one replay, as ``[graph]``
  does, and is left dead; a second trainer then captures its chunk, with a
  collection forced inside the capture when FORCE is 1. FIXED 0 takes out
  ``inference/chunk.py``'s collection before the capture and its switching
  off of the collector during it.

    python3 tools/capture_gc_check.py        # on one GPU, about two minutes
"""
import gc
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def toy(mode, what):
    import torch

    class Holder:
        pass

    def make():
        x = torch.zeros(1 << 20, device="cuda")
        h = Holder()
        h.me = h
        if what == "graph":
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = x * 2 + 1
            g.replay()
            h.g, h.y = g, y
        else:  # pinned buffer used by an async copy
            p = torch.ones(1 << 20).pin_memory()
            x.copy_(p, non_blocking=True)
            h.p = p
        h.x = x
        torch.cuda.synchronize()

    make()
    x2 = torch.ones(1 << 20, device="cuda")
    g2 = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g2, capture_error_mode=mode):
            z = x2 * 3
            n = gc.collect()
            z = z + 1
        g2.replay()
        torch.cuda.synchronize()
        print(f"RESULT toy {what} {mode}: capture ok (collected {n})")
    except RuntimeError as e:
        print(f"RESULT toy {what} {mode}: capture FAILED: {str(e).splitlines()[0]}")


def trainer(fixed, force):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import viforsdes_tpu_torch as vt
    from viforsdes_tpu_torch.inference import chunk as chunk_mod

    if not fixed:
        class NoGC:
            collect = staticmethod(lambda: 0)
            disable = staticmethod(lambda: None)
            enable = staticmethod(lambda: None)
            isenabled = staticmethod(lambda: False)
        chunk_mod.gc = NoGC
    t1 = cs.make_trainer(vt, "auto", 20, steps_per_call=10)
    t1.train(update_interval=10)
    c1 = t1._train_chunks[10]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        c1(20)
        torch.cuda.synchronize()
    del t1, c1
    if force:
        orig = torch.cuda.CUDAGraph.capture_begin

        def capture_begin(self, *a, **k):
            orig(self, *a, **k)
            print(f"collected inside the capture: {gc.collect()}")
        torch.cuda.CUDAGraph.capture_begin = capture_begin
    t2 = cs.make_trainer(vt, "auto", 20, steps_per_call=10)
    try:
        h = t2.train(update_interval=10).evidence_lower_bound_history
        print(f"RESULT trainer fixed={fixed} force={force}: ok, {len(h)} steps, last ELBO {h[-1]:.4f}")
    except RuntimeError as e:
        print(f"RESULT trainer fixed={fixed} force={force}: FAILED: {str(e).splitlines()[0]}")


if __name__ == "__main__":
    if len(sys.argv) > 1:
        kind, *args = sys.argv[1:]
        if kind == "toy":
            toy(*args)
        else:
            trainer(args[0] == "1", args[1] == "1")
        sys.exit(0)
    runs = [["toy", "global", "graph"], ["toy", "thread_local", "graph"], ["toy", "global", "pinned"],
            ["trainer", "0", "0"], ["trainer", "0", "1"], ["trainer", "1", "1"]]
    for r in runs:
        t0 = time.time()
        p = subprocess.run([sys.executable, __file__, *r], capture_output=True, text=True, timeout=300)
        res = [l for l in p.stdout.splitlines() if l.startswith(("RESULT", "collected"))]
        print(r, f"rc={p.returncode} {time.time() - t0:.1f} s", *res, sep="\n  ")
        if p.returncode:
            print(p.stderr[-1500:])
