"""Time the SSD scan's backward kernel (``ssd_scan_bwd``) on the card, a
whole call and each of its launches, at the training paths' shapes.

    python experiments/ssd_bwd_split.py [--trees DIR ...] [--rounds N]
        [--dtypes ...] [--models NAME[:S] ...] [--plans S,K ...]
        [--random-state]

Each tree (a checkout's root; default: this one) is timed in its own
process with ``DIR/src`` first on the path, the trees in turn for
``--rounds`` rounds (one card, one call: A, B, B, A, ...), so that two
versions are compared on the same card. A call is timed by CUDA events
behind a sleep (the device running 20 calls back to back, warm L2; the
median of 3); the launches by one ``torch.profiler`` window of 20 calls,
each kernel's device microseconds a call (a window whose kernel count is
not a whole number of calls is reported as such). ``--plans`` also times
other (slices, K split) plans than ``bwd_plan``'s; ``--random-state``
gives h0 and dh_final random values (else zero and none). Prints one line
a (tree, shape, dtype, plan) and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

# (model, S, H, P, N, G, chunk): the backward's rows in chip_smoke.py
SHAPES = [("mamba2-780m", 1024, 48, 64, 128, 1, 256),
          ("mamba2-780m", 271, 48, 64, 128, 1, 256),
          ("hymba-1.5b", 640, 50, 64, 16, 1, 64),
          ("hymba-1.5b", 31, 50, 64, 16, 1, 64)]


def events_ms(fn, iters=20):
    import time
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(min(max(2 * host_s, 1e-3), 2.0) * 2e9)
    out = []
    for _ in range(3):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e) / iters)
    return statistics.median(out)


def split_us(fn, iters=20):
    """{kernel name: device us a call} from one profiler window, or None
    where the window's kernels are not a whole number of calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and getattr(e, "self_device_time_total", 0) > 0]
    if any(e.count % iters for e in rows):
        return None
    out = {}
    for e in rows:
        m = re.search(r"(\w+_kernel)", e.key)
        name = m.group(1) if m else e.key[:40]
        out[name] = round(out.get(name, 0.0)
                          + e.self_device_time_total / iters, 2)
    return out


def run_here(rounds_tag: str, plans, dtypes, random_state: bool) -> None:
    import torch
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.kernels.ssd_scan import _forward, ssd_scan_bwd
    gen = torch.Generator().manual_seed(5)
    dev = torch.device("cuda")
    own_plan = getattr(ssd_mod, "bwd_plan", None)
    cases = [(shape, dtype, plan) for shape in SHAPES for dtype in dtypes
             for plan in (plans or [None])]
    for (model, S, H, P, N, G, chunk), dtype, plan in cases:
        if plan is not None:
            ssd_mod.bwd_plan = lambda *a, _p=plan, **k: ssd_mod.SsdBwdPlan(
                _p[0], -(-(a[2] // a[3]) // _p[0]), _p[1])
        else:
            ssd_mod.bwd_plan = own_plan
        xbc = (torch.randn((1, S, H * P + 2 * G * N), generator=gen)
               * 0.5).to(dev, dtype)
        x = xbc[..., :H * P].unflatten(-1, (H, P))
        B_ = xbc[..., H * P:H * P + G * N].unflatten(-1, (G, N))
        C_ = xbc[..., H * P + G * N:].unflatten(-1, (G, N))
        dt = (torch.rand((1, S, H), generator=gen) * 0.1 + 0.001).to(dev)
        A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
        h0 = (torch.randn((1, H, P, N), generator=gen) * 0.2).to(dev) \
            if random_state else torch.zeros((1, H, P, N), device=dev)
        dy = torch.randn((1, S, H, P), generator=gen).to(dev)
        dh = torch.randn((1, H, P, N), generator=gen).to(dev) \
            if random_state else None
        args = (x, dt, A, B_, C_, h0)
        scratch = _forward(*args, chunk)[2]

        def call():
            return ssd_scan_bwd(*args, dy, dh, chunk=chunk,
                                scratch=scratch)
        try:
            ms = events_ms(call)
        except RuntimeError as e:          # a plan the card refuses
            print(json.dumps({"tree": rounds_tag, "model": model, "S": S,
                              "plan": plan, "error": str(e)}), flush=True)
            continue
        split = split_us(call)
        print(json.dumps({"tree": rounds_tag, "model": model, "S": S,
                          "dtype": str(dtype).split(".")[-1],
                          "plan": plan, "ms": round(ms, 4),
                          "launch_us": split}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="*", default=[])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--plans", nargs="*", default=[],
                    help="slices,k_split pairs to time beside bwd_plan's")
    ap.add_argument("--dtypes", nargs="*", default=["bfloat16", "float32"])
    ap.add_argument("--models", nargs="*", default=None)
    ap.add_argument("--random-state", action="store_true",
                    help="random h0 and dh_final (chip_smoke's short rows)")
    ap.add_argument("--tag", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.models:
        SHAPES[:] = [s for s in SHAPES if f"{s[0]}:{s[1]}" in args.models
                     or s[0] in args.models]
    if args.tag is not None:
        import torch
        plans = [tuple(int(v) for v in p.split(",")) for p in args.plans]
        run_here(args.tag, [None] + plans if plans else [],
                 [getattr(torch, d) for d in args.dtypes], args.random_state)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = args.trees or [root]
    for r in range(args.rounds):
        order = trees if r % 2 == 0 else trees[::-1]
        for t in order:
            env = dict(os.environ, PYTHONPATH=os.path.join(
                os.path.abspath(t), "src"))
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--tag", f"{os.path.basename(os.path.abspath(t))}"
                            f" round {r}", "--plans", *args.plans,
                            "--dtypes", *args.dtypes, "--models",
                            *(args.models or [f"{s[0]}:{s[1]}"
                                              for s in SHAPES]),
                            *(["--random-state"] if args.random_state
                              else [])],
                           env=env, check=True)


if __name__ == "__main__":
    main()
