#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. It re-executes itself with ``PYTHONHASHSEED=0`` when that is
unset, so the MMLU-style prompts (seeded from ``hash()``) have the same
lengths in every run. It

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and prints the build time;
3. holds each kernel against its plain PyTorch version at its paths'
   shapes, in float32 and bfloat16, and times the kernel, the plain version
   and, for attention, ``F.scaled_dot_product_attention`` on the same work
   (a yardstick the port never calls; for a prefill from position 0 also
   with ``is_causal``, and the faster of the two counts), beside the least
   time the card could take, with the prefill's TFLOP/s and share of it;
4. runs the paper's edge request on full-width gemma3-270m, on full-width,
   full-depth mamba2-780m and on full-width deepseek-v3-671b cut to its
   three dense MLA layers (random weights from a seed), each in bf16 and
   in fp32: client A misses (Case 1) and uploads, client B resumes a
   partial hit (Case 4), then adopts A's full prompt (Case 5), and a
   poisoned catalog falls back to local prefill; it checks the cases and
   the tokens and that the path's kernels ran on it as often as the path
   needs (counts set to 0 just before each path and read just after);
5. profiles a prefill and 8 decode steps of each model, then one prefill
   alone (its device time and its attention kernel's share), and checks the
   card's fp32 logits against the same model on the CPU (mamba2-780m cut
   to 4 layers there, deepseek-v3-671b to 1);
6. prints the kernels' JSON line, then ``{"ok": true, ...}`` last.

Any failed check raises: the script then exits non-zero and prints no
result line. It needs the card and the repository beside it.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

MEM_BW = 3.35e12                   # H100 SXM HBM3, bytes/s
PEAK = {"float32": 67e12, "bfloat16": 989e12}   # FLOP/s: fp32 FMA, bf16 TC
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
PREFILL_SHAPES = [(512, 0), (64, 448)]          # (Sq, q_offset), kv_len 512
DECODE_KV_LENS = [1, 300, 1024]
CACHE_LEN, H, KV, DH = 1024, 4, 1, 256
# flash_prefill at MLA's widths: deepseek-v3's 128 heads, keys 192, values 128
MLA_PREFILL = dict(H=128, KV=128, dh=192, dv=128)
# mla_decode at deepseek-v3's widths: (kv_len, window) over a 1024 cache
MLA_H, MLA_R, MLA_DR, MLA_SCALE = 128, 512, 64, 1.0 / 192 ** 0.5
MLA_DECODE_CASES = [(1, None), (300, None), (1024, None), (700, 256)]
# ssd_scan at mamba2-780m's widths: (S, random h0); chunk 256, one B/C group
SSD_SHAPES = [(271, False), (48, True), (1024, True)]
SSD_H, SSD_P, SSD_N, SSD_G, SSD_CHUNK = 48, 64, 128, 1, 256
SSD_TOL = dict(atol=2e-4, rtol=1e-3)           # tests/test_kernels.py:86-89
MAX_NEW = 16
SOURCES = {   # kernel -> (its CUDA source, the TPU kernel it replaces)
    "flash_prefill": ("src/repro_torch/kernels/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_prefill.py:84"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:67"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:66"),
    "mla_decode": ("src/repro_torch/kernels/csrc/mla_decode.cu",
                   "src/repro/kernels/mla_decode.py:25"),
}
# the configurations the paths run, with the depth each is cut to (None:
# the config's own) and the depth of the CPU cross-check
PATHS = [("gemma3-270m", None, None), ("mamba2-780m", None, 4),
         ("deepseek-v3-671b", 3, 1)]


def device_line():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return smi


def build_phase():
    from repro_torch import clock
    from repro_torch.kernels import build
    t0 = clock.monotonic()
    logs = build.build_all()
    dt = clock.monotonic() - t0
    print(f"build: {dt:.1f} s for {sorted(build.KERNELS)} "
          f"(built now: {sorted(logs)})")
    for name, log in sorted(logs.items()):
        funcs = ptxas_report(log)
        spilled = [f"{fn} ({n} B)" for fn, _, n in funcs if n]
        print(f"  {name}: {len(funcs)} kernels, max "
              f"{max([r for _, r, _ in funcs] or [0])} registers/thread, "
              f"spilling: {', '.join(spilled) or 'none'}")
        for fn, regs, _ in funcs:
            print(f"    {fn}: {regs} registers")


def ptxas_report(log):
    """[(kernel, registers, spill-store bytes)] from ``nvcc -Xptxas -v``:
    each "Compiling entry function" line, with the registers and spills
    reported after it. Kernel names are cut to their template arguments."""
    import re
    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"\d+([a-z_]+kernel)I(\w*?)EEv", m.group(1))
            name = m.group(1)
            if k:
                args = k.group(2).replace("13__nv_bfloat16", "bf16,")
                args = re.sub(r"Li(\d+)E", r"\1,", re.sub(r"^f", "float,", args))
                name = f"{k.group(1)}<{args.rstrip(',')}>"
            out.append([name, 0, 0])
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out[-1][2] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1][1] = int(m.group(1))
    return [tuple(f) for f in out]


def time_ms(fn, iters=50, warmup=5):
    """Median of per-call CUDA-event times, in ms. For a call whose host
    work outlasts its kernels this is the host's dispatch time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _dev_us(e):
    """Self device time of a profiler row (the name differs by version)."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _device_rows(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _dev_us(e) > 0]


def device_ms(fn, iters=20, windows=3):
    """Device time per call, in ms: the profiler's kernel and copy time
    over ``iters`` back-to-back calls (warm L2), divided by ``iters``; the
    median of ``windows`` windows. The profiler now and then records none
    or only part of a window's device events, so no window is trusted
    alone: an empty one is left out, and all empty fails the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(_dev_us(e) for e in _device_rows(prof))
        if us > 0:
            times.append(us / iters / 1e3)
    if not times:
        raise RuntimeError("the profiler recorded no device time")
    return statistics.median(times)


def kernels_per_call(fn, iters=5):
    """CUDA kernels one call of ``fn`` launches, from the profiler's device
    rows over ``iters`` calls (0 if the profiler recorded none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in _device_rows(prof)) / iters


def bound(nbytes, flops, dtype):
    t_b, t_f = nbytes / MEM_BW * 1e3, flops / PEAK[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def _err(out, ref, atol, rtol):
    """(max |out - ref|, whether every element is within atol + rtol|ref|)."""
    import torch
    torch.cuda.synchronize()
    return ((out.float() - ref.float()).abs().max().item(),
            torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol))


def prefill_checks(dname, dt, gen, H, KV, dh, dv, cache_len, shapes, tag):
    """flash_prefill against its plain version over a [1, cache_len, KV, .]
    cache, at each (Sq, q_offset) with kv_len = q_offset + Sq. Returns
    {(Sq, q_offset): row}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_plain)
    dev = torch.device("cuda")
    k = torch.randn((1, cache_len, KV, dh), generator=gen).to(dev, dt)
    v = torch.randn((1, cache_len, KV, dv), generator=gen).to(dev, dt)
    es = k.element_size()
    rows = {}
    for sq, off in shapes:
        q = torch.randn((1, sq, H, dh), generator=gen).to(dev, dt)
        kv_len = off + sq
        args = dict(q_offset=off, kv_len=kv_len)
        err, ok = _err(flash_prefill(q, k, v, **args),
                       flash_prefill_plain(q, k, v, **args), TOL[dname],
                       TOL[dname])
        ms = device_ms(lambda: flash_prefill(q, k, v, **args))
        call_ms = time_ms(lambda: flash_prefill(q, k, v, **args))
        plain_ms = device_ms(lambda: flash_prefill_plain(q, k, v, **args))
        # yardstick: SDPA on the live keys with the same causal mask and,
        # when the queries start at 0, with is_causal (no explicit mask, so
        # its fused backends may run); the faster call is library_ms
        qpos = off + torch.arange(sq, device=dev)
        mask = torch.arange(kv_len, device=dev)[None, :] <= qpos[:, None]
        qs = q.transpose(1, 2)
        ks, vs = (t[:, :kv_len].transpose(1, 2) for t in (k, v))
        libs = {"sdpa mask": device_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True))}
        if off == 0:
            libs["sdpa is_causal"] = device_ms(
                lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=True, enable_gqa=True))
        lib_name = min(libs, key=libs.get)
        lib_ms = libs[lib_name]
        pairs = sum(min(kv_len, off + i + 1) for i in range(sq))
        nbytes = es * (q.numel() + sq * H * dv + kv_len * KV * (dh + dv))
        flops = 2 * (dh + dv) * H * pairs
        b_ms, b_by = bound(nbytes, flops, dname)
        print(f"flash_prefill {tag} {dname} Sq={sq} q_offset={off} "
              f"kv_len={kv_len}: max_abs_err={err:.3g} (tol {TOL[dname]}) "
              f"device ms: kernel {ms:.4f} plain {plain_ms:.4f} "
              + " ".join(f"{n} {t:.4f}" for n, t in libs.items())
              + f" bound {b_ms:.5f} ({b_by}); {flops / ms / 1e9:.1f} TFLOP/s,"
              f" {b_ms / ms:.3f} of the bound, {ms / lib_ms:.2f}x the "
              f"best library call ({lib_name}); kernel call {call_ms:.4f} ms"
              f" (events)")
        if not ok:
            raise AssertionError(f"flash_prefill {tag} {dname} Sq={sq} "
                                 f"off={off}: max err {err}")
        rows[(sq, off)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               library_ms=lib_ms, bound_ms=b_ms,
                               bound_by=b_by)
    return rows


def kernel_checks():
    """The attention kernels against their plain versions at their paths'
    shapes. Returns the per-kernel rows for the JSON line (timed at the
    serving dtype, bf16, and the gemma3-270m path's cold prefill and
    300-key decode)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(1)
    rows = {"flash_prefill": {"max_abs_err": 0.0},
            "flash_decode": {"max_abs_err": 0.0}}
    for dname, dt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        r = rows["flash_prefill"]
        for tag, geo, cache_len in (
                ("(256, 256)", dict(H=H, KV=KV, dh=DH, dv=DH), CACHE_LEN),
                ("(192, 128)", MLA_PREFILL, 512)):
            got = prefill_checks(dname, dt, gen, **geo, cache_len=cache_len,
                                 shapes=PREFILL_SHAPES, tag=tag)
            r["max_abs_err"] = max([r["max_abs_err"]]
                                   + [g["max_abs_err"] for g in got.values()])
            if dname == "bfloat16" and geo["dh"] == DH:
                r.update({k: v for k, v in got[(512, 0)].items()
                          if k != "max_abs_err"})
        k = torch.randn((1, CACHE_LEN, KV, DH), generator=gen).to(dev, dt)
        v = torch.randn((1, CACHE_LEN, KV, DH), generator=gen).to(dev, dt)
        es = k.element_size()
        q1 = torch.randn((1, H, DH), generator=gen).to(dev, dt)
        for kv_len in DECODE_KV_LENS:
            err, ok = _err(flash_decode(q1, k, v, kv_len=kv_len),
                           flash_decode_plain(q1, k, v, kv_len=kv_len),
                           TOL[dname], TOL[dname])
            ms = device_ms(lambda: flash_decode(q1, k, v, kv_len=kv_len))
            call_ms = time_ms(lambda: flash_decode(q1, k, v, kv_len=kv_len))
            plain_ms = device_ms(
                lambda: flash_decode_plain(q1, k, v, kv_len=kv_len))
            qs = q1[:, :, None]
            ks, vs = (t[:, :kv_len].transpose(1, 2) for t in (k, v))
            lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, enable_gqa=True))
            nbytes = es * (2 * q1.numel() + 2 * kv_len * KV * DH)
            b_ms, b_by = bound(nbytes, 4 * DH * H * kv_len, dname)
            print(f"flash_decode {dname} kv_len={kv_len}: max_abs_err="
                  f"{err:.3g} (tol {TOL[dname]}) device ms: kernel {ms:.4f}"
                  f" plain {plain_ms:.4f} sdpa {lib_ms:.4f} bound "
                  f"{b_ms:.5f} ({b_by}); kernel call {call_ms:.4f} ms "
                  f"(events)")
            if not ok:
                raise AssertionError(f"flash_decode {dname} kv_len={kv_len}"
                                     f": max err {err}")
            r = rows["flash_decode"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if dname == "bfloat16" and kv_len == 300:
                r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by)
    return rows


def mla_checks():
    """mla_decode against mla_decode_plain at deepseek-v3's widths (128
    heads, R 512, Dr 64) over a 1024-position latent cache. Returns the
    row for the JSON line (timed in bf16 at kv_len 300). The yardstick is
    SDPA on [q_lat; q_rope] against [ckv; krope] with v = ckv, one kv
    head, the same scale; the concatenations are made outside the timing."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.mla_decode import mla_decode, mla_decode_plain
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(3)
    row = {"max_abs_err": 0.0}
    for dname, dt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        ckv, krope = (torch.randn((1, CACHE_LEN, w), generator=gen).to(dev, dt)
                      for w in (MLA_R, MLA_DR))
        q_lat, q_rope = (torch.randn((1, MLA_H, w), generator=gen).to(dev, dt)
                         for w in (MLA_R, MLA_DR))
        es = ckv.element_size()
        for kv_len, win in MLA_DECODE_CASES:
            args = dict(kv_len=kv_len, window=win, scale=MLA_SCALE)
            err, ok = _err(mla_decode(q_lat, q_rope, ckv, krope, **args),
                           mla_decode_plain(q_lat, q_rope, ckv, krope, **args),
                           TOL[dname], TOL[dname])
            ms = device_ms(lambda: mla_decode(q_lat, q_rope, ckv, krope,
                                              **args))
            n_k = kernels_per_call(lambda: mla_decode(q_lat, q_rope, ckv,
                                                      krope, **args))
            call_ms = time_ms(lambda: mla_decode(q_lat, q_rope, ckv, krope,
                                                 **args))
            plain_ms = device_ms(lambda: mla_decode_plain(
                q_lat, q_rope, ckv, krope, **args))
            lo = max(0, kv_len - win) if win else 0
            qs = torch.cat([q_lat, q_rope], -1)[:, :, None]
            ks = torch.cat([ckv, krope], -1)[:, None, lo:kv_len]
            vs = ckv[:, None, lo:kv_len]
            lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, scale=MLA_SCALE, enable_gqa=True))
            live = kv_len - lo
            nbytes = es * (MLA_H * (2 * MLA_R + MLA_DR)
                           + live * (MLA_R + MLA_DR))
            flops = MLA_H * live * (2 * (MLA_R + MLA_DR) + 2 * MLA_R)
            b_ms, b_by = bound(nbytes, flops, dname)
            print(f"mla_decode {dname} H={MLA_H} R={MLA_R} Dr={MLA_DR} "
                  f"kv_len={kv_len} window={win}: max_abs_err={err:.3g} "
                  f"(tol {TOL[dname]}) device ms: kernel {ms:.4f} plain "
                  f"{plain_ms:.4f} sdpa {lib_ms:.4f} bound {b_ms:.5f} "
                  f"({b_by}); {flops / ms / 1e9:.2f} TFLOP/s, {b_ms / ms:.3f}"
                  f" of the bound, {n_k:g} CUDA kernels a call; kernel call "
                  f"{call_ms:.4f} ms (events)")
            if not ok:
                raise AssertionError(f"mla_decode {dname} kv_len={kv_len} "
                                     f"window={win}: max err {err}")
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if dname == "bfloat16" and kv_len == 300:
                row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by)
    return row


def ssd_inputs(S, dtype, random_h0, gen):
    """ssd_scan's inputs as mamba2-780m's prefill gives them: x, B and C
    are views of one conv output [1, S, H*P + 2*G*N] in the model dtype;
    dt and A follow the model's init (dt in [0.001, 0.1], A = -1..-48)."""
    import math
    import torch
    dev = torch.device("cuda")
    hp, gn = SSD_H * SSD_P, SSD_G * SSD_N
    xbc = (torch.randn((1, S, hp + 2 * gn), generator=gen) * 0.5).to(
        dev, dtype)
    x = xbc[..., :hp].unflatten(-1, (SSD_H, SSD_P))
    B_ = xbc[..., hp:hp + gn].unflatten(-1, (SSD_G, SSD_N))
    C_ = xbc[..., hp + gn:].unflatten(-1, (SSD_G, SSD_N))
    lo, hi = math.log(0.001), math.log(0.1)
    dt = torch.exp(torch.rand((1, S, SSD_H), generator=gen) * (hi - lo)
                   + lo).to(dev)
    A = -torch.arange(1, SSD_H + 1, dtype=torch.float32, device=dev)
    h0 = torch.randn((1, SSD_H, SSD_P, SSD_N), generator=gen) * 0.2 \
        if random_h0 else torch.zeros((1, SSD_H, SSD_P, SSD_N))
    return x, dt, A, B_, C_, h0.to(dev)


def ssd_work(S, es):
    """(bytes, flops) the chunked scan needs for S positions: each input
    read once, each output written once; per chunk of L positions the
    causal half of C.B once per group, and per head the scores times x,
    C.h_in and the state update."""
    H, P, N, G = SSD_H, SSD_P, SSD_N, SSD_G
    nbytes = (es * S * (H * P + 2 * G * N) + 4 * S * H + 4 * H
              + 4 * S * H * P + 2 * 4 * H * P * N)
    flops = 0
    for t0 in range(0, S, SSD_CHUNK):
        L = min(SSD_CHUNK, S - t0)
        flops += G * L * (L + 1) * N + H * (L * (L + 1) * P + 4 * L * N * P)
    return nbytes, flops


def ssd_checks():
    """ssd_scan against ssd_scan_plain at mamba2-780m's shapes. Returns
    the row for the JSON line (timed in bf16 at S=271, the cold path)."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    gen = torch.Generator(device="cpu").manual_seed(2)
    row = {"max_abs_err": 0.0, "library_ms": None}
    for dname, dt_ in (("float32", torch.float32),
                       ("bfloat16", torch.bfloat16)):
        for S, random_h0 in SSD_SHAPES:
            args = ssd_inputs(S, dt_, random_h0, gen)
            y, h = ssd_scan(*args, chunk=SSD_CHUNK)
            yr, hr = ssd_scan_plain(*args, chunk=SSD_CHUNK)
            torch.cuda.synchronize()
            err = max((y - yr).abs().max().item(), (h - hr).abs().max().item())
            ok = torch.allclose(y, yr, **SSD_TOL) and \
                torch.allclose(h, hr, **SSD_TOL)
            ms = device_ms(lambda: ssd_scan(*args, chunk=SSD_CHUNK))
            n_k = kernels_per_call(lambda: ssd_scan(*args, chunk=SSD_CHUNK))
            call_ms = time_ms(lambda: ssd_scan(*args, chunk=SSD_CHUNK))
            plain_ms = device_ms(lambda: ssd_scan_plain(*args,
                                                        chunk=SSD_CHUNK))
            nbytes, flops = ssd_work(S, args[0].element_size())
            b_ms, b_by = bound(nbytes, flops, dname)
            print(f"ssd_scan {dname} S={S} h0={'random' if random_h0 else 0}"
                  f": max_abs_err={err:.3g} (atol 2e-4, rtol 1e-3; max |y| "
                  f"{yr.abs().max().item():.3g}) device ms: kernel {ms:.4f} "
                  f"plain {plain_ms:.4f} bound {b_ms:.5f} ({b_by}); "
                  f"{flops / ms / 1e9:.2f} TFLOP/s, {b_ms / ms:.3f} of the "
                  f"bound, {n_k:g} CUDA kernels a call; kernel call "
                  f"{call_ms:.4f} ms (events)")
            if not ok:
                raise AssertionError(f"ssd_scan {dname} S={S}: max err {err}")
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if dname == "bfloat16" and S == 271:
                row.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by)
    return row


def edge_path(model, label, expect, max_len=1024):
    """The paper's edge request through the port's EdgeClient. ``expect``
    maps the wrappers of this model's path to the launches the requests
    need: their counts are set to 0 just before the requests and read just
    after, and must equal it. Returns the launch counts and the prompts."""
    import numpy as np
    import torch
    from repro_torch.config import CacheConfig
    from repro_torch.core.client import EdgeClient
    from repro_torch.core.server import CacheServer
    from repro_torch.data.mmlu import MMLUGenerator
    from repro_torch.data.tokenizer import WordHashTokenizer
    from repro_torch.models.model import padded_vocab
    from repro_torch.serving.engine import InferenceEngine

    cfg = model.cfg
    gen = MMLUGenerator(WordHashTokenizer(cfg.vocab), n_shot=5)
    p_a = gen.prompt("astronomy", 0).segments
    p_b = gen.prompt("astronomy", 1).segments
    p_c = gen.prompt("virology", 7).segments
    server = CacheServer(CacheConfig())

    def client(name, srv=server):
        return EdgeClient(name, InferenceEngine(model, max_len=max_len),
                          srv, CacheConfig())

    # warm-up on a throwaway server: cuBLAS handles, allocator, kernels
    client("warm", CacheServer(CacheConfig())).infer(
        gen.prompt("anatomy", 3).segments, max_new_tokens=2,
        upload_on_miss=False)

    for k in expect:
        k.launches = 0
    a, b = client("A"), client("B")
    r_miss = a.infer(p_a, MAX_NEW)
    b.sync_catalog()
    r_part = b.infer(p_b, MAX_NEW)
    r_full = b.infer(p_a, MAX_NEW)
    poisoned = client("P")
    for key in p_c.keys(poisoned.meta):
        poisoned.catalog.register(key.digest)
    r_fp = poisoned.infer(p_c, MAX_NEW, upload_on_miss=False)
    launches = {k.__name__: k.launches for k in expect}

    # references outside the counted run: cold local prefills of B and C
    cold = client("cold", CacheServer(CacheConfig()))
    r_cold_b = cold.infer(p_b, MAX_NEW, upload_on_miss=False)
    r_cold_c = cold.infer(p_c, MAX_NEW, upload_on_miss=False)

    got = [r.case for r in (r_miss, r_part, r_full, r_fp)]
    print(f"[{label}] prompt tokens A={len(p_a.token_ids)} "
          f"B={len(p_b.token_ids)} C={len(p_c.token_ids)}; cases {got}")
    for tag, r in (("A miss", r_miss), ("B partial", r_part),
                   ("B full", r_full), ("P false-positive", r_fp),
                   ("B cold", r_cold_b)):
        t = r.timings
        print(f"[{label}] {tag}: case {r.case} matched {r.matched_tokens}/"
              f"{r.prompt_tokens} ttft {r.ttft_s * 1e3:.2f} ms ttlt "
              f"{r.ttlt_s * 1e3:.2f} ms up {r.blob_bytes_up} B down "
              f"{r.blob_bytes_down} B fp={r.false_positive} | fetch "
              f"{t['fetch_s'] * 1e3:.2f} restore {t['restore_s'] * 1e3:.2f}"
              f" prefill {t['prefill_s'] * 1e3:.2f} decode "
              f"{t['decode_s'] * 1e3:.2f} ms for {len(r.output_tokens)} tok"
              f" ({t['decode_s'] / max(len(r.output_tokens), 1) * 1e3:.2f} "
              f"ms/tok) upload {t['upload_s'] * 1e3:.2f} ms")
    print(f"[{label}] launches on the main path: {launches}")
    print(f"[{label}] A's blobs on the server (tokens: bytes): "
          + ", ".join(f"{k.n_tokens}: {len(server.get(k.digest))}"
                      for k in p_a.keys(a.meta)))
    if got != [1, 4, 5, 1] or not r_fp.false_positive:
        raise AssertionError(f"[{label}] cases {got}, fp {r_fp.false_positive}")
    want = {k.__name__: n for k, n in expect.items()}
    if launches != want or min(launches.values()) <= 0:
        raise AssertionError(f"[{label}] launches {launches}, the path "
                             f"needs {want}")

    # what a full hit's restore costs, phase by phase (A's full blob)
    from repro_torch import clock
    from repro_torch.core import packer, state_io
    full_key = p_a.keys(a.meta)[0]
    blob = server.get(full_key.digest)
    template = InferenceEngine(model, max_len=max_len).new_cache()
    torch.cuda.synchronize()
    t0 = clock.monotonic()
    raw = state_io._decompress(blob)
    t1 = clock.monotonic()
    payload = packer.unpackb(raw)
    t2 = clock.monotonic()
    state_io.restore_state(payload, template)
    torch.cuda.synchronize()                        # waits for the copies
    t3 = clock.monotonic()
    print(f"[{label}] full-hit restore of a {len(blob)} B blob ({len(raw)} B "
          f"raw): zlib {(t1 - t0) * 1e3:.2f} ms, msgpack decode "
          f"{(t2 - t1) * 1e3:.2f} ms, host->device restore "
          f"{(t3 - t2) * 1e3:.2f} ms")

    # resumed vs cold logits for B, outside the client
    eng = InferenceEngine(model, max_len=max_len)
    toks = np.asarray(p_b.token_ids, np.int32)[None]
    cold_st = eng.start({"tokens": toks})
    pre = eng.start({"tokens": toks[:, :r_part.matched_tokens]})
    res_st = eng.resume({"tokens": toks[:, r_part.matched_tokens:]},
                        pre.cache, r_part.matched_tokens)
    dlogit = float(np.abs(res_st.last_logits - cold_st.last_logits).max())
    agree = {
        "resumed_vs_cold": sum(x == y for x, y in zip(
            r_part.output_tokens, r_cold_b.output_tokens)),
        "adopted_vs_cold": sum(x == y for x, y in zip(
            r_full.output_tokens, r_miss.output_tokens)),
        "fallback_vs_cold": sum(x == y for x, y in zip(
            r_fp.output_tokens, r_cold_c.output_tokens)),
    }
    print(f"[{label}] tokens agreeing of {MAX_NEW}: {agree}; max |logit| "
          f"resumed-vs-cold {dlogit:.3g}; B's suffix prefill again, outside "
          f"the client: {res_st.timings['prefill_wall'] * 1e3:.2f} ms (the "
          f"client's: {r_part.timings['prefill_s'] * 1e3:.2f} ms)")
    lg = cold_st.last_logits
    well_formed = (lg.shape == (1, padded_vocab(cfg.vocab))
                   and np.isfinite(lg).all()
                   and all(len(r.output_tokens) == MAX_NEW
                           and all(0 <= t < cfg.vocab for t in r.output_tokens)
                           for r in (r_miss, r_part, r_full, r_fp)))
    if not well_formed:
        raise AssertionError(f"[{label}] malformed output: logits "
                             f"{lg.shape}, finite {np.isfinite(lg).all()}")
    if model.dtype == torch.float32 and min(agree.values()) != MAX_NEW:
        raise AssertionError(f"[{label}] resumed/adopted/fallback outputs "
                             f"differ from cold: {agree}")
    return launches, p_a, p_b


def where_time_goes(model, prompt):
    """Device time by kernel over one prefill and 8 decode steps (bf16)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import clock
    from repro_torch.serving.engine import InferenceEngine
    eng = InferenceEngine(model, max_len=1024)
    toks = np.asarray(prompt.token_ids, np.int32)[None]
    for _ in range(2):
        eng.generate(eng.start({"tokens": toks}), 4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = clock.monotonic()
        st = eng.start({"tokens": toks})
        t1 = clock.monotonic()
        eng.generate(st, 8)
        torch.cuda.synchronize()
        t2 = clock.monotonic()
    kern = sorted(((_dev_us(e), e.key, e.count) for e in _device_rows(prof)),
                  reverse=True)
    busy = sum(us for us, _, _ in kern)
    wall_us = (t2 - t0) * 1e6
    print(f"profile ({model.cfg.name} bf16, prefill {toks.shape[1]} tok + 8 "
          f"decode steps): "
          f"wall {wall_us / 1e3:.2f} ms (prefill {(t1 - t0) * 1e3:.2f} ms, "
          f"decode {(t2 - t1) / 8 * 1e3:.2f} ms/step under the profiler),"
          f" device busy {busy / 1e3:.3f} ms, idle share "
          f"{1 - busy / wall_us:.3f}")
    for us, key, n in kern[:12]:
        print(f"  {us / 1e3:9.3f} ms  x{n:<5d} {key[:90]}")
    host = sorted(((e.self_cpu_time_total, e.key, e.count)
                   for e in prof.key_averages()), reverse=True)
    print("  host (self CPU time, same window):")
    for us, key, n in host[:8]:
        print(f"  {us / 1e3:9.3f} ms  x{n:<5d} {key[:90]}")
    # one prefill alone: its device time and the attention kernel's share
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = clock.monotonic()
        eng.start({"tokens": toks})
        torch.cuda.synchronize()
        t1 = clock.monotonic()
    rows = _device_rows(prof)
    att = sum(_dev_us(e) for e in rows if "flash_prefill" in e.key
              or "ssd_" in e.key)
    print(f"  prefill alone: wall {(t1 - t0) * 1e3:.2f} ms, device busy "
          f"{sum(_dev_us(e) for e in rows) / 1e3:.3f} ms, of which "
          f"flash_prefill / ssd_scan's kernels {att / 1e3:.3f} ms")
    # the head alone: [1, d] x [d, vocab] in bf16
    x = torch.randn((1, 1, model.cfg.d_model), device="cuda",
                    dtype=model.dtype)
    tied = model.cfg.tie_embeddings
    w = model.embed.t() if tied else model.head
    head_ms = device_ms(lambda: x @ w)
    head_bytes = w.numel() * w.element_size()
    print(f"{'tied' if tied else 'untied'} head matmul alone: "
          f"{head_ms:.4f} ms on the device for {head_bytes / 1e6:.1f} MB "
          f"of weights (bytes bound {head_bytes / MEM_BW * 1e3:.4f} ms)")


def cpu_cross_check(model_fp32, prompt, n_layers):
    """The first ``n_layers`` of the fp32 model on the card and on the CPU
    (the plain path), on the same prompt: last logits within 1e-4."""
    import numpy as np
    import torch
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import InferenceEngine
    cfg = cut(model_fp32.cfg, n_layers)
    sd = {k: (t[:n_layers] if k.startswith("segments.") else t)
          for k, t in model_fp32.state_dict().items()}
    toks = np.asarray(prompt.token_ids, np.int32)[None]
    logits = {}
    for dev in ("cuda", "cpu"):
        m = Model(cfg, dtype=torch.float32, device=dev, seed=None)
        m.load_state_dict({k: t.to(dev) for k, t in sd.items()})
        logits[dev] = InferenceEngine(m, max_len=1024).start(
            {"tokens": toks}).last_logits
    err = float(np.abs(logits["cpu"] - logits["cuda"]).max())
    scale = float(np.abs(logits["cpu"][:, :cfg.vocab]).max())
    same = int(logits["cpu"].argmax()) == int(logits["cuda"].argmax())
    print(f"cpu cross-check ({cfg.name} fp32, {n_layers} of "
          f"{model_fp32.cfg.n_layers} layers, {toks.shape[1]} tokens): max "
          f"|logit cuda - cpu| {err:.3g} (max |logit| {scale:.3g}, tol 1e-4) "
          f"argmax equal {same}")
    if err > 1e-4 or not same:
        raise AssertionError(f"card and CPU disagree: {err}")


def cut(cfg, n_layers):
    """``cfg`` at ``n_layers`` layers; a deepseek-style config keeps them
    all dense MLA (its MoE segment empty)."""
    if cfg.family == "moe":
        from repro_torch.configs.deepseek_v3_671b import dense_cut
        return dense_cut(cfg, n_layers)
    return cfg.replace(n_layers=n_layers)


def model_pair(name, n_layers=None):
    """fp32 and bf16 copies of one randomly initialised model on the card
    (seed 0, drawn once on the host; the bf16 copy is the fp32 one cast,
    and keeps the parameters the model holds in fp32), at its config's
    depth or cut to ``n_layers``."""
    import torch
    from repro_torch import clock
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config(name)
    if n_layers is not None:
        cfg = cut(cfg, n_layers)
    t0 = clock.monotonic()
    m32 = Model(cfg, dtype=torch.float32, seed=0)
    m16 = Model(cfg, dtype=torch.bfloat16, seed=None)
    m16.load_state_dict(m32.state_dict())
    n = sum(t.numel() for t in m32.parameters()) / 1e6
    extra = {"ssm": cfg.ssm} if cfg.family == "ssm" else \
        {"mla": cfg.mla, "dense_ff": cfg.moe.dense_ff} if cfg.uses_mla else {}
    print(f"model {cfg.name}: L={cfg.n_layers} d={cfg.d_model} "
          f"H={cfg.n_heads} KV={cfg.n_kv_heads} dh={cfg.dh} ff={cfg.d_ff} "
          f"vocab={cfg.vocab} tied={cfg.tie_embeddings} {extra}, "
          f"{n:.1f}M params, random weights (seed 0), made in "
          f"{clock.monotonic() - t0:.1f} s")
    return m32, m16


def main():
    if os.environ.get("PYTHONHASHSEED") is None:     # pin prompt lengths
        os.execve(sys.executable, [sys.executable] + sys.argv,
                  dict(os.environ, PYTHONHASHSEED="0"))
    device_line()
    import torch
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.mla_decode import mla_decode
    from repro_torch.kernels.ssd_scan import ssd_scan
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_phase()
    rows = kernel_checks()
    rows["ssd_scan"] = ssd_checks()
    rows["mla_decode"] = mla_checks()

    def needs(cfg):
        """Launches each path needs: 4 requests of MAX_NEW decode steps;
        3 prefills with a KV cache (A's miss, B's suffix, the fallback),
        6 with a recurrent state (and A's 3 shorter ranges at upload)."""
        L, steps = cfg.n_layers, 4 * MAX_NEW
        if cfg.family == "ssm":
            return {ssd_scan: 6 * L}
        decode = mla_decode if cfg.uses_mla else flash_decode
        return {flash_prefill: 3 * L, decode: steps * L}

    launches, launches32 = {}, {}
    for name, n_layers, cross_layers in PATHS:
        m32, m16 = model_pair(name, n_layers)
        expect = needs(m32.cfg)
        for k, n in edge_path(m16, f"{name} bf16", expect)[0].items():
            launches[k] = launches.get(k, 0) + n
        got, p_a, p_b = edge_path(m32, f"{name} fp32", expect)
        for k, n in got.items():
            launches32[k] = launches32.get(k, 0) + n
        where_time_goes(m16, p_a)
        cpu_cross_check(m32, p_b, cross_layers or m32.cfg.n_layers)
        del m32, m16
        torch.cuda.empty_cache()

    out = []
    for name in ("flash_prefill", "flash_decode", "ssd_scan", "mla_decode"):
        r = rows[name]
        out.append({"name": name, "route": "cuda", "source": SOURCES[name][0],
                    "replaces": SOURCES[name][1], "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(f"main-path launches, all paths: bf16 {launches}, fp32 "
          f"{launches32}")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
