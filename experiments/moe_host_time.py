"""moe_gemm's host time a launch and a MoE decode step's wall time, two
source trees of the PyTorch port side by side, on one CUDA card.

    python experiments/moe_host_time.py --trees OLD NEW [--pairs 10]

OLD and NEW are checkouts of the repository (each with its ``src/``). The
script runs ``--pairs`` rounds, each one child process a tree, in the
order OLD, NEW in even rounds and NEW, OLD in odd ones, so a drift of the
card or the host falls on both alike. A child imports ``repro_torch``
from its tree alone (each tree builds its kernels into its own
``build/``), makes granite-moe-3b-a800m at full width and depth in bf16
with random weights (seed 0), prefills a 64-token prompt (seed 0) and
reads:

- ``host_us``: the host's side of one ``moe_gemm`` launch (the wrapper's
  checks, its plan, the kernel's tensor maps, the enqueue): 50
  back-to-back calls of layer 0's up product at its B=1 decode inputs,
  with no synchronise, over the host clock; the median of 5 such loops.
- ``step_ms``: a decode step's wall time at B=1: 8 steps after 4 to warm
  up, synchronised, over the host clock; the median of 5 such runs.

It prints each child's reading, then for each metric the median of each
tree and of the rounds' differences (NEW less OLD) with their range. The
readings are host times: they vary with the host's load more than device
times do.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

MODEL = "granite-moe-3b-a800m"


def child() -> None:
    import numpy as np
    import torch
    from repro_torch import clock
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import apply_norm
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import InferenceEngine

    cfg = get_config(MODEL)
    model = Model(cfg, dtype=torch.bfloat16, seed=0)
    eng = InferenceEngine(model, max_len=1024)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, 64)
    st = eng.start({"tokens": prompt.astype(np.int32)[None]})
    eng.generate(st, 4)
    torch.cuda.synchronize()
    steps = []
    for _ in range(5):
        t0 = clock.monotonic()
        eng.generate(st, 8)
        torch.cuda.synchronize()
        steps.append((clock.monotonic() - t0) / 8 * 1e3)

    lp = tf.layer_params(model.segments[0].tree(), 0)
    p = lp["moe"]
    x1 = torch.randn((1, 1, cfg.d_model), device=model.device,
                     dtype=model.dtype)
    xf = apply_norm(lp["ln2"], x1).reshape(1, -1)
    w, ids, _ = moe.route(p, cfg, xf, aux=False)
    d = moe.dispatch(xf, w, ids, p["w_up"].shape[0])
    moe_gemm(d.xs, p["w_up"], d.offsets)
    hosts = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = clock.monotonic()
        for _ in range(50):
            moe_gemm(d.xs, p["w_up"], d.offsets)
        hosts.append((clock.monotonic() - t0) / 50 * 1e6)
        torch.cuda.synchronize()
    print(json.dumps({"host_us": statistics.median(hosts),
                      "step_ms": statistics.median(steps)}))


def run(tree: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"),
               PYTHONHASHSEED="0")
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--child"], env=env, cwd=tree, check=True,
                         capture_output=True, text=True, timeout=600).stdout
    return json.loads(out.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child()
        return
    if not args.trees:
        ap.error("--trees OLD NEW is required")
    old, new = (os.path.abspath(t) for t in args.trees)
    got = {old: [], new: []}
    for i in range(args.pairs):
        for tree in ((old, new) if i % 2 == 0 else (new, old)):
            r = run(tree)
            got[tree].append(r)
            print(f"round {i} {'new' if tree == new else 'old'}: host "
                  f"{r['host_us']:.1f} us a moe_gemm launch, step "
                  f"{r['step_ms']:.2f} ms", flush=True)
    for key, unit in (("host_us", "us"), ("step_ms", "ms")):
        a = [r[key] for r in got[old]]
        b = [r[key] for r in got[new]]
        diff = [y - x for x, y in zip(a, b)]
        print(f"{key}: old median {statistics.median(a):.2f} {unit} (range "
              f"{min(a):.2f}-{max(a):.2f}), new median "
              f"{statistics.median(b):.2f} (range {min(b):.2f}-{max(b):.2f});"
              f" new less old a round: median {statistics.median(diff):+.2f}"
              f" {unit}, range {min(diff):+.2f} to {max(diff):+.2f}, "
              f"{sum(x > 0 for x in diff)} of {len(diff)} rounds longer")


if __name__ == "__main__":
    main()
