"""Compare ``flash_prefill`` and ``flash_prefill_bwd`` between checkouts on
the card: ptxas's registers and spills of every kernel of the two sources,
and the null path's (no key limit) device ms in alternating rounds.

    python experiments/prefill_limit_ab.py --trees OLD NEW [--rounds N]

Each tree's two sources are compiled with this checkout's ``nvcc`` flags
(``build.NVCC_FLAGS``, all four compilers at once) and each kernel's
registers and spill-store bytes are printed side by side (a null
instantiation ``<...,false>`` under its name without the flag), the
key-limit instantiations (``<...,true>``) where a tree has them. Then each tree runs
in its own process with ``DIR/src`` first on the path, the trees in turn
for ``--rounds`` rounds (A, B, B, A, ...; one card, one call), timing by
CUDA events behind a sleep (``chip_smoke.events_ms``: 20 calls back to
back, warm L2, the median of 3) the bf16 rows of ``chip_smoke.py`` that a
key limit must not move: ``flash_prefill`` at qwen2-vl-2b's (12/2, 128)
and llama3.2-1b's (32/8, 64), Sq=291 over a 1024-position cache, and
``flash_prefill_bwd`` at qwen2-vl-2b's B=1 S=512 and llama3.2-1b's B=4
S=256. Prints each row's times by round, and its median and quartiles by
tree, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("flash_prefill", "flash_prefill_bwd")
# (row, kernel, B, Sq, Sk, H, KV, dh)
ROWS = [("qwen2-vl-2b (12/2, 128) Sq=291", "fwd", 1, 291, 1024, 12, 2, 128),
        ("llama3.2-1b (32/8, 64) Sq=291", "fwd", 1, 291, 1024, 32, 8, 64),
        ("qwen2-vl-2b (12/2, 128) B=1 S=512", "bwd", 1, 512, 512, 12, 2, 128),
        ("llama3.2-1b (32/8, 64) B=4 S=256", "bwd", 4, 256, 256, 32, 8, 64)]


def registers(trees):
    """{tree: {kernel: (registers, spill bytes)}} from ptxas."""
    sys.path.insert(0, HERE)
    from chip_smoke import ptxas_report
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path
    out, procs = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for i, tree in enumerate(trees):
            for name in SOURCES:
                src = os.path.join(tree, "src/repro_torch/kernels/csrc",
                                   f"{name}.cu")
                so = os.path.join(tmp, f"{i}-{name}.so")
                procs.append((tree, subprocess.Popen(
                    [nvcc_path(), *NVCC_FLAGS, "-o", so, src], text=True,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        for tree, p in procs:
            log, _ = p.communicate()
            if p.returncode:
                raise SystemExit(f"nvcc failed in {tree}:\n{log}")
            # a null instantiation <..., false> under the name the kernel
            # had before the flag, so the two trees' rows pair up
            out.setdefault(tree, {}).update(
                (fn.replace(",false>", ">"), (r, n))
                for fn, r, n in ptxas_report(log))
    return out


def events_ms(fn, iters=20):
    """``chip_smoke.events_ms`` (importing it would put this checkout's
    ``src`` first on the path)."""
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


def run_here() -> None:
    """Time ROWS with this process's ``repro_torch``; print one JSON line."""
    import torch
    from repro_torch.kernels import flash_prefill as fp
    dev, dt = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(3)
    got = {}
    for row, kind, B, Sq, Sk, H, KV, dh in ROWS:
        q = torch.randn((B, Sq, H, dh), generator=gen).to(dev, dt)
        k = torch.randn((B, Sk, KV, dh), generator=gen).to(dev, dt)
        v = torch.randn((B, Sk, KV, dh), generator=gen).to(dev, dt)
        if kind == "fwd":
            got[row] = events_ms(lambda: fp.flash_prefill(q, k, v,
                                                          kv_len=Sq))
            continue
        dout = torch.randn((B, Sq, H, dh), generator=gen).to(dev, dt)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
        out = fp._forward(q, k, v, 0, Sk, None, lse)
        got[row] = events_ms(lambda: fp.flash_prefill_bwd(q, k, v, out, dout,
                                                          lse))
    print("ROWS " + json.dumps(got))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--here", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.here:
        run_here()
        return
    trees = [os.path.abspath(t) for t in args.trees]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    regs = registers(trees)
    names = sorted({n for t in trees for n in regs[t]})
    for n in names:
        print(f"ptxas {n}: " + "; ".join(
            f"{os.path.basename(t)} " + (
                f"{regs[t][n][0]} registers, {regs[t][n][1]} B spilled"
                if n in regs[t] else "none") for t in trees))
    times = {t: {} for t in trees}
    for r in range(args.rounds):
        for tree in (trees if r % 2 == 0 else trees[::-1]):
            env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
            res = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--here", "--trees", tree], env=env,
                                 cwd=tree, capture_output=True, text=True)
            line = [ln for ln in res.stdout.splitlines()
                    if ln.startswith("ROWS ")]
            if res.returncode or not line:
                raise SystemExit(f"{tree} round {r}:\n{res.stdout}\n"
                                 f"{res.stderr[-3000:]}")
            for row, ms in json.loads(line[0][5:]).items():
                times[tree].setdefault(row, []).append(ms)
                print(f"round {r} {os.path.basename(tree)} {row}: {ms:.5f} ms")
    for row, *_ in ROWS:
        print(f"{row}: " + "; ".join(
            f"{os.path.basename(t)} median {statistics.median(times[t][row]):.5f}"
            f" (quartiles {statistics.quantiles(times[t][row], n=4)[0]:.5f}-"
            f"{statistics.quantiles(times[t][row], n=4)[2]:.5f})"
            for t in trees))


if __name__ == "__main__":
    main()
