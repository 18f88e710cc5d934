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
   flash_prefill also at B=4 (the batched prefill), and the two decode
   kernels with one kv_len a row read from device memory (four slots of
   0, 1, 300 and 1024 keys, with and without a window); both attention
   kernels also at the (H, KV, dh) of llama3.2-1b, qwen2-vl-2b, qwen3-4b,
   yi-6b and nemotron-4-15b (a 291-token prefill, a 31-token resume at
   253, a decode at 300 keys; timed in bf16 at the prefill and the
   decode), and at hymba-1.5b's (25/5, 64) as its ring feeds them:
   flash_prefill on the linearised ring with the window of 1024 (cold
   prefills of 128 + 291 and 128 + 1095 rows, 31-token resumes over 381
   and over 1024 ring slots), the ring gather timed beside it, and
   flash_decode over a full ring with no window (B=1, and B=4 rows of
   their own kv_len); ssd_scan also at hymba's SSM widths (50 heads,
   state 16, chunk 64); both attention kernels also at
   granite-moe-3b-a800m's (24/8, 64), GQA 3; moe_gemm, the grouped
   expert GEMM, at granite-moe-3b-a800m's and deepseek-v3-671b's expert
   shapes (up/gate and down) for a decode step at B=1 and B=4 and a
   512-row prefill bucket (8 rows a token), with empty groups, beside its
   plain version and ``torch._grouped_mm``;
3b. on an empty card, deepseek-v3-671b at full width cut to its three
   dense MLA layers and its first MoE layer (15.1B parameters), drawn in
   bf16 only: a Case 1 miss, a Case 5 hit with Case 1's tokens, a Case 4;
4. runs the paper's edge request on full-width gemma3-270m, on full-width
   mamba2-780m cut to 24 of its 48 layers (for the script's time), on
   full-width deepseek-v3-671b cut to its
   three dense MLA layers, on full-width, full-depth llama3.2-1b and
   qwen2-vl-2b (text prompts: M-RoPE with its three position components
   equal), on full-width hymba-1.5b cut to 8 of its 32 layers (a ring KV
   cache of 1024 slots and an SSM state a layer, 128 meta tokens), and on
   full-width, full-depth granite-moe-3b-a800m (32 MoE layers of 40
   experts, top 8) (random weights from a seed), each in bf16 and
   in fp32: client A misses (Case 1) and uploads, client B resumes a
   partial hit (Case 4), then adopts A's full prompt (Case 5), and a
   poisoned catalog falls back to local prefill; it checks the cases and
   the tokens and that the path's kernels ran on it as often as the path
   needs (counts set to 0 just before each path and read just after), and
   that each request's span tree, projected onto the Table-3 columns
   (``Breakdown.from_spans``), agrees with its timings within max(0.5 ms,
   2%); the same Cases run three times more, untraced, traced and
   untraced (``Tracer(enabled=False)``), their TTFT printed beside.
   Then, per model and dtype: A's uploads must be v3 ``PC3`` containers
   (chunks and bytes per range printed); A's full blob is restored phase
   by phase (container split, header decode, digests, inflate, unpack,
   placement on the card); B's partial hit runs again monolithic and
   streamed (``overlap=True``: the suffix prefill layer group by layer
   group as the chunks land), with TTFT, transfer-visible, restore,
   compute and hidden seconds, launch counts that must be equal, and in
   fp32 the same 16 tokens as the monolithic and the cold run; and B
   against a server whose every blob has one flipped byte must fall back
   to local prefill (the cold run's tokens in fp32). Then the fabric
   phase, per model and dtype: 3 peer daemons (``python -m
   repro_torch.core.net.daemon``, one process each, replication factor 2)
   reached over TCP through a ``PeerDirectory``; A misses and uploads by
   placement, the daemons replicate, B gets Case 4 monolithic and
   streamed (one frame a chunk) and Case 5, the daemon that served the
   Case 5 is shut down and B asks again (a Case 5 from the replica or a
   Case-1 fallback; the fast fail is timed), and a client without a
   catalog pays GETs for a prompt never uploaded while one with a catalog
   pays none; fp32 tokens must equal the in-process run's, the launches
   what the requests need, the spans project onto the timings (B's Case 5
   tree holds the daemon's folded spans), and every daemon must exit 0;
   on hymba-1.5b then a request past the ring's wrap (24-shot prompts of
   ~1,100 tokens: A's miss, B's Case 4 monolithic and streamed from a
   prefix that already fills the ring, B's Case 5; fp32 tokens equal to
   cold);
5. profiles a prefill and 8 decode steps of each model, then one prefill
   alone (its device time and its attention kernel's share) and the head
   matmul's share of a decode step (granite-moe-3b-a800m's decode step
   also by part: attention, route, sort, moe_gemm, combine, host), and
   checks the card's fp32 logits against the same model on the CPU
   (mamba2-780m cut to 4 layers there, deepseek-v3-671b to 1,
   llama3.2-1b, qwen2-vl-2b, hymba-1.5b and granite-moe-3b-a800m to 2);
   on
   qwen2-vl-2b the reference's VLM round trip (stub patch embeddings at
   image positions, one prefill against a prefill and a resume, then a
   decode) must agree in fp32 within its test's tolerance;
6. serves 8 requests over a pool of 4 slots (``BatchedEngine`` and the
   continuous-batching ``Scheduler``) on each of those models and on
   full-width gemma3-1b (mamba2-780m and gemma3-1b cut to 8 layers,
   llama3.2-1b, qwen2-vl-2b, hymba-1.5b and granite-moe-3b-a800m to 4,
   granite's MoE layers kept; hymba's fourth request
   960 tokens, past its ring's wrap), in bf16 and fp32: prompts cut to
   mixed lengths, so slots decode at their own positions and recycle; fp32
   tokens must equal sequential runs; it prints tokens/s, TTFT and TTLT
   percentiles and decode ms per step at B=1 and B=4, and checks that a
   decode step launches the decode kernel once a layer and, on
   gemma3-270m and the deepseek cut, that a ``Scheduler`` step of traced
   requests runs the aten ops and decode launches an untraced one does
   (its CUDA kernels printed beside); a qwen2-vl-2b decode step must make
   the host's kernel launch calls of the same step with standard rope
   plus its M-RoPE band gathers (2 a layer), and no more device-to-host
   copies than a llama3.2-1b step, nor may a granite-moe-3b-a800m step;
6b. runs qwen3-4b, yi-6b and nemotron-4-15b at full width cut to 2
   layers: a Case 1 miss and a Case 5 hit in fp32 with a cold run's
   tokens, one bf16 request, the CPU cross-check at 1 layer; then
   ``python -m repro_torch.launch.serve``: a server process and a client
   process at llama3.2-1b's full width (``--no-reduced``) on 3 prompts of
   one domain, both exiting 0;
7. once every other phase has run (after a gateway phase the profiler
   loses device events, so every profiler reading comes before), for
   gemma3-270m and the deepseek cut, in bf16 and fp32, serves the
   OpenAI-compatible gateway
   (``repro_torch.gateway.Gateway``, 4 slots, ``max_len`` 1024) over 3
   supervised peer daemons (``Fabric.tcp``): the three workload mixes of
   ``repro_torch.workloads`` (16 requests each at 12 a second, 8 new
   tokens, every other one SSE) from client threads over HTTP, a tenant
   over its rate quota (429), a one-slot gateway held by a stream (503),
   and a prompt asked again once its blob's primary peer is killed (then
   ``check_and_restart``); fp32 tokens must equal a direct
   ``BatchedEngine`` + ``Scheduler`` run, each mix must have a hit served
   by a peer, the kernels must launch from the gateway's engine thread
   (the decode kernel once a layer a traced scheduler step), and every
   daemon must exit 0; a fresh prompt asked twice down one keep-alive
   socket must leave a ``/v1/traces/<id>`` tree from the HTTP front door
   through the engine thread to a daemon, the second root ``follows`` the
   first; ``/v1/decisions`` must hold closed records (regret, savings);
   after ``inject {corrupt_chunks: 1}`` on every daemon a streamed client
   must fall through a corrupt stream and ``/v1/flight`` must hold its
   ``chunk_error`` dump; once, ``python -m repro_torch.obs.console
   --once`` watches the gateway, its daemons and one dead daemon (a row a
   live daemon, ``DOWN`` for the dead one);
8. the chaos phase, on gemma3-270m in bf16 and fp32: 3 supervised
   daemons, ``FaultSchedule.generate(0, ...)`` over 29 steps replayed by a
   ``FaultDriver`` (a partition, delayed acks, a stall, corrupt chunks, a
   bandwidth collapse and a kill, each healed 3 steps later), one request
   a step from a streamed ``EdgeClient``; every request answered, fp32
   tokens equal to a cold run, attempts, flight dumps and TTFT p50 / max
   by the faults live, and every daemon's exit code 0;
9. prints the kernels' JSON line, then ``{"ok": true, ...}`` last.

Any failed check raises: the script then exits non-zero and prints no
result line. It needs the card and the repository beside it.
"""
from __future__ import annotations

import gc
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
# the decode kernels with one kv_len a row: four slots at their own
# positions (a row of 0 keys among them), with and without a window
ROW_KV_LENS, ROW_WINDOWS = [0, 1, 300, 1024], [None, 256]
PREFILL_BATCH = 4                  # flash_prefill as the batched prefill runs it
# the dense configs' attention widths (H, KV, dh), at their edge request's
# shapes: a cold 291-token prefill and a 31-token resume at 253 over a
# 1024-position cache, and a decode at 300 keys
DENSE_WIDTHS = {"llama3.2-1b": (32, 8, 64), "qwen2-vl-2b": (12, 2, 128),
                "qwen3-4b": (32, 8, 128), "yi-6b": (32, 4, 128),
                "nemotron-4-15b": (48, 8, 128),
                "granite-moe-3b-a800m": (24, 8, 64)}
DENSE_PREFILL_SHAPES = [(291, 0), (31, 253)]
# hymba-1.5b's attention (H, KV, dh) and window over its ring of 1024
# slots. flash_prefill reads the ring linearised: (Sq, q_offset) over a
# buffer of q_offset + Sq keys (the ring's live slots, then the new
# ones), with the window: the 5-shot edge request's cold prefill of 128 +
# 291 rows and its 31-token resume at 128 + 253, the 24-shot request's
# cold 128 + 1095 rows and its 31-token resume past the wrap (1024 ring
# slots before it); the timed ones. flash_decode over the full ring with
# no window (B=1), and B=4 rows of their own kv_len
HYMBA_ATTN, HYMBA_WINDOW = (25, 5, 64), 1024
HYMBA_PREFILL_SHAPES = [(419, 0), (31, 381), (1223, 0), (31, 1024)]
HYMBA_PREFILL_TIMED = [(419, 0), (31, 1024)]
HYMBA_ROW_KV_LENS = [1024, 420, 1024, 700]
# the resumes' ring gathers: (new keys, the ring's next position): the
# 5-shot resume at 128 + 253 (not wrapped), the 24-shot one at 128 + 1057
HYMBA_GATHERS = [(31, 381), (31, 1185)]
# ssd_scan at its paths' widths: (S, random h0) at each geometry (heads,
# head dim, state, B/C groups, chunk); mamba2-780m's, then hymba-1.5b's
# SSM branch (its cold 5-shot prefill of 128 + 291 rows, a 31-token
# resume, the cold 24-shot prefill of 128 + 1095 rows)
SSD_GEOS = {"mamba2-780m": (dict(H=48, P=64, N=128, G=1, chunk=256),
                            [(271, False), (48, True), (1024, True)]),
            "hymba-1.5b": (dict(H=50, P=64, N=16, G=1, chunk=64),
                           [(419, False), (31, True), (1223, True)])}
SSD_TOL = dict(atol=2e-4, rtol=1e-3)           # tests/test_kernels.py:86-89
# moe_gemm at its paths' shapes: (model, product, K, N, stored experts,
# experts the router picks from); each at M = 8 x tokens rows: a decode
# step at B=1 and B=4, and a 512-row prefill bucket, rows routed top-8 to
# distinct experts by a seed (the padded experts, and at decode most
# others, get none)
MOE_SHAPES = [("granite-moe-3b-a800m", "up/gate", 1536, 512, 48, 40),
              ("granite-moe-3b-a800m", "down", 512, 1536, 48, 40),
              ("deepseek-v3-671b", "up/gate", 7168, 2048, 256, 256),
              ("deepseek-v3-671b", "down", 2048, 7168, 256, 256)]
MOE_TOKENS, MOE_TOP_K = (1, 4, 512), 8
# the row of moe_gemm in the JSON line: granite's up product at B=1 decode
MOE_ROW = ("granite-moe-3b-a800m", "up/gate", 1)
MAX_NEW = 16
# the batched phase: a pool of BATCH slots serves one request per entry of
# BATCH_CUTS, its prompt cut to that many tokens (None: the whole prompt)
BATCH = 4
BATCH_CUTS = [None, 64, 200, None, 128, 250, None, 96]
BATCH_DOMAINS = ["astronomy", "virology", "anatomy", "nutrition"]
DECODE_STEPS = 20                  # timed decode_batch steps at B=1 and B=4
# a traced Scheduler step against an untraced one: steps a profiler
# window, windows a side, and new tokens a request, enough for every
# window to see all BATCH slots decoding
TRACE_ITERS, TRACE_WINDOWS = 1, 2
TRACE_STEPS = 1 + TRACE_ITERS * TRACE_WINDOWS + 8
# the host's kernel launch calls as the profiler names them: the runtime's
# (<<<>>>, cudaLaunchKernelEx for clusters) and the driver's
LAUNCH_APIS = ("cudaLaunchKernel", "cuLaunchKernel",
               "cudaLaunchCooperativeKernel")
# the fabric phase: peer daemons, ring owners a key, their gossip and
# replication pump period, and each TCP link's timeout (a recv)
FABRIC_PEERS, FABRIC_REPL, GOSSIP_S, FABRIC_TIMEOUT_S = 3, 2, 0.1, 30.0
# the gateway phase: requests a mix, their rate (a second), new tokens each,
# and the bound on a replay client thread; a mix fails when more than
# GATEWAY_SHED_MAX of its requests are shed (503)
GATEWAY_N, GATEWAY_RATE, MAX_NEW_GW, GATEWAY_JOIN_S = 16, 12.0, 8, 300.0
GATEWAY_SHED_MAX = GATEWAY_N // 8
# the chaos phase: supervised daemons, the schedule's seed, steps (one
# request each) and the steps a fault lives; each link's recv timeout,
# a dead peer's suspect window and each request's deadline, in seconds;
# the prompts it cycles through (CHAOS_DOMAINS x 2 questions). Seed 0 at
# 29 steps applies every kind (at 30 its stall targets a peer killed the
# step before, and is skipped)
CHAOS_PEERS, CHAOS_SEED, CHAOS_STEPS, CHAOS_HEAL = 3, 0, 29, 3
CHAOS_TIMEOUT_S, CHAOS_COOLDOWN_S, CHAOS_DEADLINE_S = 2.0, 1.0, 30.0
CHAOS_DOMAINS, CHAOS_PROMPTS = ("anatomy", "virology", "astronomy"), 6
CHAOS_KINDS = ("kill", "partition", "corrupt", "stall", "bandwidth",
               "delay_ack")
# the kinds a daemon applies to chunk streams only, and to single-frame
# replies only (the others act on every op)
CHAOS_STREAM, CHAOS_REPLY = ("corrupt", "stall"), ("delay_ack",)
# an op this slow shows a bandwidth collapse (an unthrottled transfer on
# the loopback takes milliseconds)
CHAOS_SLOW_S = 0.5
CHAOS_PATH = "gemma3-270m"         # the configuration the chaos phase runs
SOURCES = {   # kernel -> (its CUDA source, the TPU kernel it replaces)
    "flash_prefill": ("src/repro_torch/kernels/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_prefill.py:84"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:67"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:66"),
    "mla_decode": ("src/repro_torch/kernels/csrc/mla_decode.cu",
                   "src/repro/kernels/mla_decode.py:25"),
    # no TPU kernel: the reference's expert FFN calls jax.lax.ragged_dot
    "moe_gemm": ("src/repro_torch/kernels/csrc/moe_gemm.cu",
                 "src/repro/models/moe.py:93"),
}
# the configurations the paths run: the depth each is cut to (None: the
# config's own), the depth of the CPU cross-check, whether the edge request
# runs on it, and the depth of its batched phase (every configuration runs
# one). mamba2-780m runs 24 of its 48 layers, and its batched phase 8, to
# keep the script's time (at full depth its edge and fabric phases took
# 143-159 s of a 869-999 s script once hymba-1.5b joined); hymba-1.5b
# runs 8 of its 32 layers since granite-moe-3b-a800m joined (its phases
# took 209.8 s at 32)
PATHS = [("gemma3-270m", None, None, True, None),
         ("mamba2-780m", 24, 4, True, 8),
         ("deepseek-v3-671b", 3, 1, True, None),
         ("llama3.2-1b", None, 2, True, 4),
         ("qwen2-vl-2b", None, 2, True, 4),
         ("hymba-1.5b", 8, 2, True, 4),
         ("granite-moe-3b-a800m", None, 2, True, 4),
         ("gemma3-1b", None, None, False, 8)]
# a windowed model's request past its ring's wrap: WRAP_SHOTS-shot prompts
# of WRAP_DOMAIN (A: question 0, 1095 tokens; B: question 1, 1057 of its
# 1088 tokens shared), with 128 meta tokens past hymba's window of 1024,
# served with WRAP_MAX_LEN; the batched phase cuts A to BATCH_WRAP_CUT
# tokens for its fourth request
WRAP_SHOTS, WRAP_DOMAIN, WRAP_MAX_LEN, BATCH_WRAP_CUT = \
    24, "astronomy", 2048, 960
# dense configs whose full depth does not fit the card in fp32 and bf16
# together (nemotron-4-15b: ~62 GB in fp32 alone): full width, cut to
# WIDE_LAYERS layers, a Case 1 miss and a Case 5 hit in fp32, one bf16
# request, and the CPU cross-check at 1 layer
WIDE_PATHS, WIDE_LAYERS = ("qwen3-4b", "yi-6b", "nemotron-4-15b"), 2
# the launcher's client at full width (``--no-reduced``) against its server
SERVE_ARCH, SERVE_PROMPTS, SERVE_WAIT_S = "llama3.2-1b", 3, 600
# the VLM round trip (tests/test_mrope_vlm.py): the reference's tolerance
VLM_TOL = dict(atol=2e-5, rtol=1e-4)
# the configurations the gateway phase serves, after every other phase
# (mamba2-780m waits: a hit's restore blocks the engine thread ~0.85 s)
GATEWAY_PATHS = ("gemma3-270m", "deepseek-v3-671b")


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


def device_ms(fn, iters=20, windows=3, tries=12):
    """Device time per call, in ms: the profiler's kernel and copy time
    over ``iters`` back-to-back calls (warm L2), divided by ``iters``; the
    median of ``windows`` windows. The profiler now and then records none
    or only part of a window's device events, so no window is trusted
    alone: windows are taken (at most ``tries``) until ``windows`` of them
    are whole, and the median is over those. A whole window holds device
    events, a multiple of ``iters`` of them (each call launches the same
    work), and no fewer than any window before it. When no window is
    whole, the run fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    got, seen = [], []                 # (device events, ms a call)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = _device_rows(prof)
        n = sum(e.count for e in rows)
        seen.append(n)
        if n and n % iters == 0:
            got.append((n, sum(_dev_us(e) for e in rows) / iters / 1e3))
            if len([1 for m, _ in got if m == max(seen)]) == windows:
                break
    most = max(seen)
    whole = [ms for n, ms in got if n == most]
    if not whole:
        raise RuntimeError(f"the profiler recorded no whole window in "
                           f"{tries} (device events a window of {iters} "
                           f"calls: {seen})")
    return statistics.median(whole)


def profile_call(fn, iters=5):
    """(CUDA kernels, device ms) of one call of ``fn``, from the profiler's
    device rows over ``iters`` calls (0 if the profiler recorded none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    return (sum(e.count for e in rows) / iters,
            sum(_dev_us(e) for e in rows) / iters / 1e3)


def launch_calls(prof):
    """Kernel launch calls the host made in a profile (its runtime and
    driver rows named in LAUNCH_APIS)."""
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith(LAUNCH_APIS))


def kernels_per_call(fn, iters=5):
    """CUDA kernels one call of ``fn`` launches (profiler device rows)."""
    return profile_call(fn, iters)[0]


def path_launches(cfg, prefills, decode_steps):
    """Launches by wrapper name of a path of ``prefills`` prefills and
    ``decode_steps`` decoded tokens: each runs every layer once, through
    ssd_scan (an SSM, a hybrid) and flash_prefill, and flash_decode or
    mla_decode (all but an SSM), and moe_gemm three times a MoE layer (up,
    gate, down)."""
    L = cfg.n_layers
    out = {}
    if cfg.family in ("ssm", "hybrid"):
        out["ssd_scan"] = prefills * L
    if cfg.family != "ssm":
        out["flash_prefill"] = prefills * L
        out["mla_decode" if cfg.uses_mla else "flash_decode"] = \
            decode_steps * L
    n_moe = L - cfg.moe.first_k_dense if cfg.family == "moe" else 0
    if n_moe:
        out["moe_gemm"] = 3 * n_moe * (prefills + decode_steps)
    return out


def bound(nbytes, flops, dtype):
    t_b, t_f = nbytes / MEM_BW * 1e3, flops / PEAK[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def _err(out, ref, atol, rtol):
    """(max |out - ref|, whether every element is within atol + rtol|ref|)."""
    import torch
    torch.cuda.synchronize()
    return ((out.float() - ref.float()).abs().max().item(),
            torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol))


def prefill_checks(dname, dt, gen, H, KV, dh, dv, cache_len, shapes, tag,
                   B=1, timed=True, window=None):
    """flash_prefill against its plain version over a [B, cache_len, KV, .]
    cache, at each (Sq, q_offset) with kv_len = q_offset + Sq and
    ``window`` (None for none), each timed unless ``timed`` is False.
    Returns {(Sq, q_offset): row}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_plain)
    dev = torch.device("cuda")
    k = torch.randn((B, cache_len, KV, dh), generator=gen).to(dev, dt)
    v = torch.randn((B, cache_len, KV, dv), generator=gen).to(dev, dt)
    es = k.element_size()
    rows = {}
    for sq, off in shapes:
        q = torch.randn((B, sq, H, dh), generator=gen).to(dev, dt)
        kv_len = off + sq
        args = dict(q_offset=off, kv_len=kv_len, window=window)
        err, ok = _err(flash_prefill(q, k, v, **args),
                       flash_prefill_plain(q, k, v, **args), TOL[dname],
                       TOL[dname])
        if not ok:
            raise AssertionError(f"flash_prefill {tag} {dname} B={B} "
                                 f"Sq={sq} off={off}: max err {err}")
        if not timed:
            print(f"flash_prefill {tag} {dname} B={B} Sq={sq} q_offset={off}"
                  f" kv_len={kv_len} window={window}: max_abs_err="
                  f"{err:.3g} (tol "
                  f"{TOL[dname]}; not timed)")
            rows[(sq, off)] = dict(max_abs_err=err)
            continue
        ms = device_ms(lambda: flash_prefill(q, k, v, **args))
        call_ms = time_ms(lambda: flash_prefill(q, k, v, **args))
        plain_ms = device_ms(lambda: flash_prefill_plain(q, k, v, **args))
        # yardstick: SDPA on the live keys with the same causal (and
        # window) mask and, when the queries start at 0 and no window cuts
        # a key, with is_causal (no explicit mask, so its fused backends
        # may run); the faster call is library_ms
        qpos = off + torch.arange(sq, device=dev)
        kpos = torch.arange(kv_len, device=dev)[None, :]
        mask = kpos <= qpos[:, None]
        if window:
            mask = mask & (kpos > qpos[:, None] - window)
        qs = q.transpose(1, 2)
        ks, vs = (t[:, :kv_len].transpose(1, 2) for t in (k, v))
        libs = {"sdpa mask": device_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True))}
        if off == 0 and (not window or kv_len <= window):
            libs["sdpa is_causal"] = device_ms(
                lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=True, enable_gqa=True))
        lib_name = min(libs, key=libs.get)
        lib_ms = libs[lib_name]
        pairs = sum(min(kv_len, off + i + 1)
                    - (max(0, off + i + 1 - window) if window else 0)
                    for i in range(sq))
        nbytes = es * B * (sq * H * (dh + dv) + kv_len * KV * (dh + dv))
        flops = 2 * (dh + dv) * H * pairs * B
        b_ms, b_by = bound(nbytes, flops, dname)
        print(f"flash_prefill {tag} {dname} B={B} Sq={sq} q_offset={off} "
              f"kv_len={kv_len} window={window}: max_abs_err={err:.3g} (tol "
              f"{TOL[dname]}) "
              f"device ms: kernel {ms:.4f} plain {plain_ms:.4f} "
              + " ".join(f"{n} {t:.4f}" for n, t in libs.items())
              + f" bound {b_ms:.5f} ({b_by}); {flops / ms / 1e9:.1f} TFLOP/s,"
              f" {b_ms / ms:.3f} of the bound, {ms / lib_ms:.2f}x the "
              f"best library call ({lib_name}); kernel call {call_ms:.4f} ms"
              f" (events)")
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
            # the batched fresh prefill: B rows from position 0
            got = prefill_checks(dname, dt, gen, **geo, cache_len=cache_len,
                                 shapes=PREFILL_SHAPES[:1], tag=tag,
                                 B=PREFILL_BATCH)
            r["max_abs_err"] = max(r["max_abs_err"], got[(512, 0)]["max_abs_err"])
        r = rows["flash_decode"]
        for kv_len in DECODE_KV_LENS:
            got = decode_check(dname, dt, gen, H, KV, DH, kv_len,
                               "(256, 256)")
            r["max_abs_err"] = max(r["max_abs_err"], got["max_abs_err"])
            if dname == "bfloat16" and kv_len == 300:
                r.update({k: v for k, v in got.items() if k != "max_abs_err"})
        r["max_abs_err"] = max(r["max_abs_err"],
                               decode_rows_check(dname, dt, gen))
        # the dense configs' widths: checked in both dtypes, timed in the
        # serving dtype (bf16) at the cold prefill and the decode only
        timed = dname == "bfloat16"
        for name, (h, kv, dh) in DENSE_WIDTHS.items():
            tag = f"{name} ({h}/{kv}, {dh})"
            got = {}
            for i, shape in enumerate(DENSE_PREFILL_SHAPES):
                got.update(prefill_checks(dname, dt, gen, h, kv, dh, dh,
                                          CACHE_LEN, [shape], tag,
                                          timed=timed and i == 0))
            rows["flash_prefill"]["max_abs_err"] = max(
                [rows["flash_prefill"]["max_abs_err"]]
                + [g["max_abs_err"] for g in got.values()])
            r["max_abs_err"] = max(r["max_abs_err"], decode_check(
                dname, dt, gen, h, kv, dh, 300, tag, timed)["max_abs_err"])
        errs = hymba_attention_checks(dname, dt, gen, timed)
        for name in rows:
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                            errs[name])
    return rows


def hymba_attention_checks(dname, dt, gen, timed):
    """Both attention kernels at hymba-1.5b's widths as its ring feeds
    them (HYMBA_PREFILL_SHAPES on the linearised buffer with the window,
    decode over the full ring with no window, B=1 and B=4), checked in
    ``dname`` and timed (the HYMBA_PREFILL_TIMED shapes and the B=1
    decode) when ``timed``; then, timed, each of HYMBA_GATHERS's ring
    gathers beside the flash_prefill call it feeds. Returns each kernel's
    largest error."""
    import torch
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.models.attention import ring_gather
    h, kv, dh = HYMBA_ATTN
    tag = f"hymba-1.5b ({h}/{kv}, {dh}) ring"
    errs = {"flash_prefill": 0.0, "flash_decode": 0.0}
    for sq, off in HYMBA_PREFILL_SHAPES:
        got = prefill_checks(dname, dt, gen, h, kv, dh, dh, off + sq,
                             [(sq, off)], tag, window=HYMBA_WINDOW,
                             timed=timed and (sq, off) in HYMBA_PREFILL_TIMED)
        errs["flash_prefill"] = max(errs["flash_prefill"],
                                    got[(sq, off)]["max_abs_err"])
    errs["flash_decode"] = max(
        decode_check(dname, dt, gen, h, kv, dh, HYMBA_WINDOW, tag,
                     timed)["max_abs_err"],
        decode_rows_check(dname, dt, gen, h, kv, dh, HYMBA_ROW_KV_LENS,
                          [None], tag))
    if not timed:
        return errs
    dev = torch.device("cuda")
    for sq, start in HYMBA_GATHERS:
        off = min(start, HYMBA_WINDOW)     # the ring's live slots
        ring = [torch.randn((1, HYMBA_WINDOW, kv, dh), generator=gen).to(
            dev, dt) for _ in range(2)]
        new = [torch.randn((1, sq, kv, dh), generator=gen).to(dev, dt)
               for _ in range(2)]
        q = torch.randn((1, sq, h, dh), generator=gen).to(dev, dt)
        kb, vb = (ring_gather(r, n, start) for r, n in zip(ring, new))
        if kb.shape[1] != off + sq:
            raise AssertionError(f"ring gather at {start}: {kb.shape[1]} "
                                 f"keys, not {off + sq}")
        g_ms = device_ms(lambda: [ring_gather(r, n, start)
                                  for r, n in zip(ring, new)])
        k_ms = device_ms(lambda: flash_prefill(
            q, kb, vb, q_offset=off, kv_len=off + sq, window=HYMBA_WINDOW))
        nbytes = 2 * 2 * (off + sq) * kv * dh * kb.element_size()
        print(f"ring gather {tag} {dname} at position {start} (ring "
              f"{HYMBA_WINDOW} slots, {off} live, {sq} new; k and v): "
              f"device ms {g_ms:.4f} (bytes bound "
              f"{nbytes / MEM_BW * 1e3:.5f}) beside its flash_prefill call "
              f"{k_ms:.4f}; gather / kernel {g_ms / k_ms:.2f}")
    return errs


def decode_check(dname, dt, gen, H, KV, dh, kv_len, tag, timed=True):
    """flash_decode against its plain version for one query a head over a
    [1, CACHE_LEN, KV, dh] cache at ``kv_len`` keys, timed (unless
    ``timed`` is False) beside SDPA on the live keys and the bound.
    Returns the row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    dev = torch.device("cuda")
    k = torch.randn((1, CACHE_LEN, KV, dh), generator=gen).to(dev, dt)
    v = torch.randn((1, CACHE_LEN, KV, dh), generator=gen).to(dev, dt)
    q = torch.randn((1, H, dh), generator=gen).to(dev, dt)
    err, ok = _err(flash_decode(q, k, v, kv_len=kv_len),
                   flash_decode_plain(q, k, v, kv_len=kv_len), TOL[dname],
                   TOL[dname])
    if not ok:
        raise AssertionError(f"flash_decode {tag} {dname} kv_len={kv_len}: "
                             f"max err {err}")
    if not timed:
        print(f"flash_decode {tag} {dname} kv_len={kv_len}: max_abs_err="
              f"{err:.3g} (tol {TOL[dname]}; not timed)")
        return dict(max_abs_err=err)
    ms = device_ms(lambda: flash_decode(q, k, v, kv_len=kv_len))
    call_ms = time_ms(lambda: flash_decode(q, k, v, kv_len=kv_len))
    plain_ms = device_ms(lambda: flash_decode_plain(q, k, v, kv_len=kv_len))
    qs = q[:, :, None]
    ks, vs = (t[:, :kv_len].transpose(1, 2) for t in (k, v))
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, enable_gqa=True))
    nbytes = k.element_size() * (2 * q.numel() + 2 * kv_len * KV * dh)
    b_ms, b_by = bound(nbytes, 4 * dh * H * kv_len, dname)
    print(f"flash_decode {tag} {dname} kv_len={kv_len}: max_abs_err="
          f"{err:.3g} (tol {TOL[dname]}) device ms: kernel {ms:.4f} plain "
          f"{plain_ms:.4f} sdpa {lib_ms:.4f} bound {b_ms:.5f} ({b_by}); "
          f"{ms / lib_ms:.2f}x sdpa; kernel call {call_ms:.4f} ms (events)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by)


def decode_rows_check(dname, dt, gen, H=H, KV=KV, DH=DH, lens=ROW_KV_LENS,
                      windows=ROW_WINDOWS, tag="(256, 256)"):
    """flash_decode with one kv_len a row, read from device memory: a pool
    of len(lens) slots (by default at (256, 256), with and without a
    window) against the plain version. Returns the largest error."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain,
                                                  live_mask)
    dev = torch.device("cuda")
    B, kv_max = len(lens), max(lens)
    k = torch.randn((B, CACHE_LEN, KV, DH), generator=gen).to(dev, dt)
    v = torch.randn((B, CACHE_LEN, KV, DH), generator=gen).to(dev, dt)
    q = torch.randn((B, H, DH), generator=gen).to(dev, dt)
    row_lens, lens = lens, torch.tensor(lens, dtype=torch.int32, device=dev)
    worst = 0.0
    for win in windows:
        args = dict(kv_len=lens, window=win, kv_max=kv_max)
        err, ok = _err(flash_decode(q, k, v, **args),
                       flash_decode_plain(q, k, v, kv_len=lens, window=win),
                       TOL[dname], TOL[dname])
        ms = device_ms(lambda: flash_decode(q, k, v, **args))
        plain_ms = device_ms(lambda: flash_decode_plain(q, k, v, kv_len=lens,
                                                        window=win))
        mask = live_mask(lens, CACHE_LEN, win, dev)[:, None, None, :]
        qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True))
        live = int(live_mask(lens, CACHE_LEN, win, "cpu").sum())
        nbytes = k.element_size() * (2 * q.numel() + 2 * live * KV * DH)
        b_ms, b_by = bound(nbytes, 4 * DH * H * live, dname)
        print(f"flash_decode {tag} {dname} B={B} kv_len per row {row_lens} "
              f"window={win}: max_abs_err={err:.3g} (tol {TOL[dname]}) "
              f"device ms: kernel {ms:.4f} plain {plain_ms:.4f} sdpa (mask) "
              f"{lib_ms:.4f} bound {b_ms:.5f} ({b_by})")
        if not ok:
            raise AssertionError(f"flash_decode {dname} per-row kv_len "
                                 f"window={win}: max err {err}")
        worst = max(worst, err)
    return worst


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
        row["max_abs_err"] = max(row["max_abs_err"],
                                 mla_rows_check(dname, dt, gen))
    return row


def mla_rows_check(dname, dt, gen):
    """mla_decode with one kv_len a row, read from device memory: a pool of
    len(ROW_KV_LENS) slots at deepseek-v3's widths against the plain
    version, with and without a window. Returns the largest error."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import live_mask
    from repro_torch.kernels.mla_decode import mla_decode, mla_decode_plain
    dev = torch.device("cuda")
    B = len(ROW_KV_LENS)
    ckv, krope = (torch.randn((B, CACHE_LEN, w), generator=gen).to(dev, dt)
                  for w in (MLA_R, MLA_DR))
    q_lat, q_rope = (torch.randn((B, MLA_H, w), generator=gen).to(dev, dt)
                     for w in (MLA_R, MLA_DR))
    lens = torch.tensor(ROW_KV_LENS, dtype=torch.int32, device=dev)
    qs = torch.cat([q_lat, q_rope], -1)[:, :, None]
    ks = torch.cat([ckv, krope], -1)[:, None]
    worst = 0.0
    for win in ROW_WINDOWS:
        args = dict(kv_len=lens, window=win, scale=MLA_SCALE)
        err, ok = _err(
            mla_decode(q_lat, q_rope, ckv, krope, kv_max=max(ROW_KV_LENS),
                       **args),
            mla_decode_plain(q_lat, q_rope, ckv, krope, **args),
            TOL[dname], TOL[dname])
        ms = device_ms(lambda: mla_decode(q_lat, q_rope, ckv, krope,
                                          kv_max=max(ROW_KV_LENS), **args))
        plain_ms = device_ms(lambda: mla_decode_plain(q_lat, q_rope, ckv,
                                                      krope, **args))
        mask = live_mask(lens, CACHE_LEN, win, dev)[:, None, None, :]
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, ckv[:, None], attn_mask=mask, scale=MLA_SCALE,
            enable_gqa=True))
        live = int(live_mask(lens, CACHE_LEN, win, "cpu").sum())
        nbytes = ckv.element_size() * (B * MLA_H * (2 * MLA_R + MLA_DR)
                                       + live * (MLA_R + MLA_DR))
        flops = MLA_H * live * (2 * (MLA_R + MLA_DR) + 2 * MLA_R)
        b_ms, b_by = bound(nbytes, flops, dname)
        print(f"mla_decode {dname} B={B} H={MLA_H} kv_len per row "
              f"{ROW_KV_LENS} window={win}: max_abs_err={err:.3g} (tol "
              f"{TOL[dname]}) device ms: kernel {ms:.4f} plain {plain_ms:.4f}"
              f" sdpa (mask) {lib_ms:.4f} bound {b_ms:.5f} ({b_by})")
        if not ok:
            raise AssertionError(f"mla_decode {dname} per-row kv_len "
                                 f"window={win}: max err {err}")
        worst = max(worst, err)
    return worst


def moe_offsets(tokens, E, picked, gen, dev):
    """Group offsets [E + 1] int32 on ``dev`` of ``tokens`` x MOE_TOP_K
    rows, each token's rows routed to distinct experts among the first
    ``picked`` (the others, padded experts among them, get none); and the
    number of experts with rows."""
    import torch
    ids = torch.rand((tokens, picked), generator=gen).argsort(-1)[
        :, :MOE_TOP_K]
    sizes = torch.bincount(ids.reshape(-1), minlength=E)
    offsets = torch.cat([torch.zeros(1, dtype=torch.long), sizes.cumsum(0)])
    return offsets.to(dev, torch.int32), int((sizes > 0).sum())


def moe_checks():
    """moe_gemm against moe_gemm_plain at each of MOE_SHAPES for MOE_TOKENS
    tokens (M = 8 rows a token), in fp32 and bf16, each with empty groups.
    The tolerance is TOL of max(1, max |plain|): both sum K products of
    unit-scale rows, ~N(0, 1) outputs. Timed: the kernel in both dtypes;
    in bf16 also the plain version (by CUDA events around each call: its
    loop reads the offsets on the host, and the profiler's windows of it
    lose device events) and ``torch._grouped_mm`` (the card's PyTorch, a
    yardstick the port never calls), beside the bound: the
    rows, the weights of the experts that have rows, and the output,
    over 3.35 TB/s, or 2 M K N flops. Returns the row for the JSON line
    (MOE_ROW)."""
    import torch
    from repro_torch.kernels.moe_gemm import moe_gemm, moe_gemm_plain
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    wgen = torch.Generator(device=dev).manual_seed(4)
    row = {"max_abs_err": 0.0}
    grouped = getattr(torch, "_grouped_mm", None)
    for name, prod, K, N, E, picked in MOE_SHAPES:
        w32 = torch.randn((E, K, N), generator=wgen, device=dev) / K ** 0.5
        for dname, dt in (("float32", torch.float32),
                          ("bfloat16", torch.bfloat16)):
            w = w32 if dt == torch.float32 else w32.to(dt)
            for tokens in MOE_TOKENS:
                M = tokens * MOE_TOP_K
                offsets, live = moe_offsets(tokens, E, picked, gen, dev)
                xs = torch.randn((M, K), generator=gen).to(dev, dt)
                out = moe_gemm(xs, w, offsets)
                ref = moe_gemm_plain(xs, w, offsets)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                scale = max(1.0, ref.float().abs().max().item())
                ms = device_ms(lambda: moe_gemm(xs, w, offsets))
                es = xs.element_size()
                nbytes = es * (M * K + live * K * N + M * N) + 4 * (E + 1)
                b_ms, b_by = bound(nbytes, 2 * M * K * N, dname)
                times = f"kernel {ms:.4f}"
                plain_ms = lib_ms = None
                if dt == torch.bfloat16:
                    plain_ms = time_ms(lambda: moe_gemm_plain(xs, w,
                                                              offsets))
                    times += f" plain {plain_ms:.4f} (CUDA events)"
                    if grouped is not None:
                        try:
                            lib = grouped(xs, w, offs=offsets[1:])
                            lib_err = (lib.float() - ref.float()).abs(
                                ).max().item()
                            lib_ms = device_ms(lambda: grouped(
                                xs, w, offs=offsets[1:]))
                            times += (f" torch._grouped_mm {lib_ms:.4f} "
                                      f"(max err {lib_err:.3g})")
                        except RuntimeError as e:
                            times += f" torch._grouped_mm refused: {e}"
                print(f"moe_gemm {name} {prod} {dname} M={M} ({tokens} "
                      f"tokens x top-{MOE_TOP_K}) K={K} N={N} E={E}, "
                      f"{live} experts with rows: max_abs_err={err:.3g} "
                      f"(tol {TOL[dname]} x {scale:.3g}) device ms: {times}"
                      f" bound {b_ms:.5f} ({b_by}); {b_ms / ms:.3f} of the "
                      f"bound, {nbytes / ms / 1e6:.0f} GB/s")
                if err > TOL[dname] * scale or \
                        torch.count_nonzero(out[int(offsets[-1]):]):
                    raise AssertionError(f"moe_gemm {name} {prod} {dname} "
                                         f"M={M}: max err {err}")
                row["max_abs_err"] = max(row["max_abs_err"], err)
                if (name, prod, tokens) == MOE_ROW and \
                        dt == torch.bfloat16:
                    row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=b_ms, bound_by=b_by)
            del w
        del w32
        torch.cuda.empty_cache()
    return row


def ssd_inputs(S, dtype, random_h0, gen, H, P, N, G, chunk):
    """ssd_scan's inputs as a prefill of the SSM (``H`` heads of ``P``,
    state ``N``, ``G`` B/C groups) gives them: x, B and C are views of one
    conv output [1, S, H*P + 2*G*N] in the model dtype; dt and A follow
    the model's init (dt in [0.001, 0.1], A = -1..-H)."""
    import math
    import torch
    dev = torch.device("cuda")
    hp, gn = H * P, G * N
    xbc = (torch.randn((1, S, hp + 2 * gn), generator=gen) * 0.5).to(
        dev, dtype)
    x = xbc[..., :hp].unflatten(-1, (H, P))
    B_ = xbc[..., hp:hp + gn].unflatten(-1, (G, N))
    C_ = xbc[..., hp + gn:].unflatten(-1, (G, N))
    lo, hi = math.log(0.001), math.log(0.1)
    dt = torch.exp(torch.rand((1, S, H), generator=gen) * (hi - lo)
                   + lo).to(dev)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
    h0 = torch.randn((1, H, P, N), generator=gen) * 0.2 \
        if random_h0 else torch.zeros((1, H, P, N))
    return x, dt, A, B_, C_, h0.to(dev)


def ssd_work(S, es, H, P, N, G, chunk):
    """(bytes, flops) the chunked scan needs for S positions: each input
    read once, each output written once; per chunk of L positions the
    causal half of C.B once per group, and per head the scores times x,
    C.h_in and the state update."""
    nbytes = (es * S * (H * P + 2 * G * N) + 4 * S * H + 4 * H
              + 4 * S * H * P + 2 * 4 * H * P * N)
    flops = 0
    for t0 in range(0, S, chunk):
        L = min(chunk, S - t0)
        flops += G * L * (L + 1) * N + H * (L * (L + 1) * P + 4 * L * N * P)
    return nbytes, flops


def ssd_checks():
    """ssd_scan against ssd_scan_plain at each geometry of SSD_GEOS.
    Returns the row for the JSON line (timed in bf16 at mamba2-780m's
    S=271, the cold path) and hymba-1.5b's bf16 rows by S."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    gen = torch.Generator(device="cpu").manual_seed(2)
    row = {"max_abs_err": 0.0, "library_ms": None}
    for name, (geo, shapes) in SSD_GEOS.items():
        chunk = geo["chunk"]
        tag = "H={H} P={P} N={N} G={G} chunk={chunk}".format(**geo)
        for dname, dt_ in (("float32", torch.float32),
                           ("bfloat16", torch.bfloat16)):
            for S, random_h0 in shapes:
                args = ssd_inputs(S, dt_, random_h0, gen, **geo)
                y, h = ssd_scan(*args, chunk=chunk)
                yr, hr = ssd_scan_plain(*args, chunk=chunk)
                torch.cuda.synchronize()
                err = max((y - yr).abs().max().item(),
                          (h - hr).abs().max().item())
                ok = torch.allclose(y, yr, **SSD_TOL) and \
                    torch.allclose(h, hr, **SSD_TOL)
                ms = device_ms(lambda: ssd_scan(*args, chunk=chunk))
                n_k = kernels_per_call(lambda: ssd_scan(*args, chunk=chunk))
                call_ms = time_ms(lambda: ssd_scan(*args, chunk=chunk))
                plain_ms = device_ms(lambda: ssd_scan_plain(*args,
                                                            chunk=chunk))
                nbytes, flops = ssd_work(S, args[0].element_size(), **geo)
                b_ms, b_by = bound(nbytes, flops, dname)
                print(f"ssd_scan {name} ({tag}) {dname} S={S} h0="
                      f"{'random' if random_h0 else 0}"
                      f": max_abs_err={err:.3g} (atol 2e-4, rtol 1e-3; "
                      f"max |y| "
                      f"{yr.abs().max().item():.3g}) device ms: kernel "
                      f"{ms:.4f} plain {plain_ms:.4f} bound {b_ms:.5f} "
                      f"({b_by}); {flops / ms / 1e9:.2f} TFLOP/s, "
                      f"{b_ms / ms:.3f} of the bound, {n_k:g} CUDA kernels "
                      f"a call; kernel call {call_ms:.4f} ms (events)")
                if not ok:
                    raise AssertionError(f"ssd_scan {name} {dname} S={S}: "
                                         f"max err {err}")
                row["max_abs_err"] = max(row["max_abs_err"], err)
                if dname == "bfloat16" and name == "mamba2-780m" and \
                        S == 271:
                    row.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by)
    return row


GC_FREED = []                      # (objects, seconds) a collect_profiles


def collect_profiles():
    """Free earlier profiler windows' events now, before a timed phase.
    Their events hold reference cycles (a parent and its children), so
    only the cyclic collector frees them. Left to itself, that collection
    runs inside a later phase and holds every thread meanwhile. Records
    what it freed and how long it took (GC_FREED, printed at the end)."""
    import time
    t0 = time.perf_counter()
    GC_FREED.append((gc.collect(), time.perf_counter() - t0))


def edge_path(model, label, expect, max_len=1024):
    """The paper's edge request through the port's EdgeClient. ``expect``
    maps the wrappers of this model's path to the launches the requests
    need: their counts are set to 0 just before the requests and read just
    after, and must equal it. Each request's span tree must project onto
    its timings (``trace_check``), and the same Cases run untraced,
    traced and untraced again, their TTFT beside. Then the PC3 uploads, the full-hit
    restore by phase, B's streamed Case 4 beside the monolithic one and a
    request against corrupt chunks. Returns the main path's launch counts,
    the streamed path's, and the prompts."""
    collect_profiles()
    import numpy as np
    import torch
    from repro_torch.config import CacheConfig
    from repro_torch.core.client import EdgeClient
    from repro_torch.core.server import CacheServer
    from repro_torch.data.mmlu import MMLUGenerator
    from repro_torch.data.tokenizer import WordHashTokenizer
    from repro_torch.models.model import padded_vocab
    from repro_torch.obs.ledger import LEDGER
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving.engine import InferenceEngine

    cfg = model.cfg
    gen = MMLUGenerator(WordHashTokenizer(cfg.vocab), n_shot=5)
    p_a = gen.prompt("astronomy", 0).segments
    p_b = gen.prompt("astronomy", 1).segments
    p_c = gen.prompt("virology", 7).segments
    server = CacheServer(CacheConfig())
    # the streamed requests below measure the stream: no local baseline
    # learned by an earlier phase's fabric clients may cut it (without a
    # perf model the watchdog reads the process's decision ledger)
    LEDGER.clear()

    def client(name, srv=server, overlap=False, tracer=None):
        return EdgeClient(name, InferenceEngine(model, max_len=max_len),
                          srv, CacheConfig(), overlap=overlap, tracer=tracer)

    # warm-up on a throwaway server: cuBLAS handles, allocator, kernels
    client("warm", CacheServer(CacheConfig())).infer(
        gen.prompt("anatomy", 3).segments, max_new_tokens=2,
        upload_on_miss=False)

    def cases_again(tracer):
        """The four Cases once more, with A's uploads in place and no
        upload of their own: A's miss on an empty server, B's partial and
        full hits and P's false positive on ``server``. Returns (client,
        result) pairs."""
        ca = client("A", CacheServer(CacheConfig()), tracer=tracer)
        cb, cp = client("B", tracer=tracer), client("P", tracer=tracer)
        cb.sync_catalog()
        for key in p_c.keys(cp.meta):
            cp.catalog.register(key.digest)
        return [(c, c.infer(p, MAX_NEW, upload_on_miss=False))
                for c, p in ((ca, p_a), (cb, p_b), (cb, p_a), (cp, p_c))]

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
    trace_check(label, [(a, r_miss), (b, r_part), (b, r_full),
                        (poisoned, r_fp)])

    # the same Cases untraced, then traced, then untraced again: on and
    # off take turns, after the counted run has met every shape once
    off1 = [r for _, r in cases_again(Tracer(enabled=False))]
    traced2 = cases_again(None)
    off2 = [r for _, r in cases_again(Tracer(enabled=False))]
    on2 = [r for _, r in traced2]
    print(f"[{label}] TTFT ms, tracer off / on / off / on (the counted "
          f"run): " + "; ".join(
              f"Case {r.case} {a.ttft_s * 1e3:.2f} / {b.ttft_s * 1e3:.2f} / "
              f"{c.ttft_s * 1e3:.2f} / {r.ttft_s * 1e3:.2f}"
              for r, a, b, c in zip((r_miss, r_part, r_full, r_fp),
                                    off1, on2, off2)))
    for runs, traced in ((off1, False), (on2, True), (off2, False)):
        if [o.case for o in runs] != [1, 4, 5, 1] or \
                any(bool(o.trace_id) != traced for o in runs):
            raise AssertionError(f"[{label}] repeated cases "
                                 f"{[o.case for o in runs]}")
        if model.dtype == torch.float32 and any(
                o.output_tokens != r.output_tokens
                for r, o in zip((r_miss, r_part, r_full, r_fp), runs)):
            raise AssertionError(f"[{label}] repeated tokens differ")
    trace_check(label, traced2)

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
    if got != [1, 4, 5, 1] or not r_fp.false_positive:
        raise AssertionError(f"[{label}] cases {got}, fp {r_fp.false_positive}")
    want = {k.__name__: n for k, n in expect.items()}
    if launches != want or min(launches.values()) <= 0:
        raise AssertionError(f"[{label}] launches {launches}, the path "
                             f"needs {want}")

    # A's uploads: every range a PC3 container
    from repro_torch import clock
    from repro_torch.core import state_io
    sizes = []
    for key in p_a.keys(a.meta):
        blob = server.get(key.digest)
        if not state_io.is_chunked(blob):
            raise AssertionError(f"[{label}] A's {key.n_tokens}-token blob "
                                 f"is not a PC3 container")
        sizes.append(f"{key.n_tokens}: {len(state_io.split_container(blob)) - 1}"
                     f" chunks, {len(blob)} B")
    print(f"[{label}] A's PC3 uploads (codec {state_io.default_codec()}, "
          f"{CacheConfig().chunk_layers} layer a chunk; tokens: data chunks, "
          f"bytes): " + "; ".join(sizes))

    # what a full hit's restore costs, phase by phase (A's full blob)
    blob = server.get(p_a.keys(a.meta)[0].digest)
    template = InferenceEngine(model, max_len=max_len).new_cache()
    torch.cuda.synchronize()
    t0 = clock.monotonic()
    chunks = state_io.split_container(blob)
    t1 = clock.monotonic()
    rest = state_io.ChunkedRestorer(a.meta)
    for c in chunks:
        rest.feed(c)
    t2 = clock.monotonic()
    rest.result(template)
    torch.cuda.synchronize()                        # waits for the copies
    t3 = clock.monotonic()
    ph = {k: v * 1e3 for k, v in rest.phase_s.items()}
    print(f"[{label}] full-hit restore of a {len(blob)} B PC3 blob "
          f"({len(chunks) - 1} data chunks, {rest.bytes_inflated} B "
          f"inflated): container split {(t1 - t0) * 1e3:.2f} ms, header "
          f"decode {ph['header']:.2f} ms, digests {ph['digest']:.2f} ms, "
          f"inflate {ph['inflate']:.2f} ms, unpack {ph['unpack']:.2f} ms, "
          f"placement (host->device, synchronised) {(t3 - t2) * 1e3:.2f} ms;"
          f" total {(t3 - t0) * 1e3:.2f} ms")

    # a streamed Case 4 for B beside the monolithic one, each path's
    # launches counted alone
    for k in expect:
        k.launches = 0
    mono = client("M")
    mono.sync_catalog()
    r_mono = mono.infer(p_b, MAX_NEW, upload_on_miss=False)
    mono_launches = {k.__name__: k.launches for k in expect}
    for k in expect:
        k.launches = 0
    stream = client("S", overlap=True)
    stream.sync_catalog()
    r_str = stream.infer(p_b, MAX_NEW, upload_on_miss=False)
    str_launches = {k.__name__: k.launches for k in expect}
    for tag, r, ln in (("monolithic", r_mono, mono_launches),
                       ("streamed", r_str, str_launches)):
        t = r.timings
        print(f"[{label}] B partial, {tag}: case {r.case} matched "
              f"{r.matched_tokens} ttft {r.ttft_s * 1e3:.2f} ms | fetch "
              f"(transfer-visible) {t['fetch_s'] * 1e3:.2f} restore "
              f"{t['restore_s'] * 1e3:.2f} prefill (compute) "
              f"{t['prefill_s'] * 1e3:.2f} hidden "
              f"{t.get('hidden_s', 0.0) * 1e3:.2f} stream "
              f"{t.get('stream_s', 0.0) * 1e3:.2f} ms; {r.chunks_down} chunks;"
              f" launches {ln}")
    str_agree = {
        "streamed_vs_monolithic": sum(x == y for x, y in zip(
            r_str.output_tokens, r_mono.output_tokens)),
        "streamed_vs_cold": sum(x == y for x, y in zip(
            r_str.output_tokens, r_cold_b.output_tokens))}
    print(f"[{label}] streamed tokens agreeing of {MAX_NEW}: {str_agree}")
    if not r_str.streamed or (r_str.case, r_mono.case) != (4, 4) or \
            r_str.matched_tokens != r_mono.matched_tokens:
        raise AssertionError(f"[{label}] streamed Case 4: streamed "
                             f"{r_str.streamed}, cases {r_str.case}/"
                             f"{r_mono.case}")
    if str_launches != mono_launches or min(str_launches.values()) <= 0:
        raise AssertionError(f"[{label}] streamed launches {str_launches}, "
                             f"monolithic {mono_launches}")
    if model.dtype == torch.float32 and min(str_agree.values()) != MAX_NEW:
        raise AssertionError(f"[{label}] streamed tokens differ: "
                             f"{str_agree}")

    # one byte of a stored chunk flipped in every blob: local prefill
    bad_server = CacheServer(CacheConfig())
    for key, blob in server.store.items():
        chunks = state_io.split_container(blob)
        i = len(chunks) // 2                        # a data chunk
        c = bytearray(chunks[i])
        c[len(c) // 2] ^= 0xFF
        chunks[i] = bytes(c)
        bad_server.put(key, state_io.pack_container(chunks))
    bad = client("X", srv=bad_server, overlap=True)
    bad.sync_catalog()
    r_bad = bad.infer(p_b, MAX_NEW, upload_on_miss=False)
    bad_agree = sum(x == y for x, y in zip(r_bad.output_tokens,
                                           r_cold_b.output_tokens))
    print(f"[{label}] corrupt chunks: case {r_bad.case} matched "
          f"{r_bad.matched_tokens} unreadable blobs {r_bad.unreadable_blobs}"
          f" ttft {r_bad.ttft_s * 1e3:.2f} ms; tokens agreeing with cold "
          f"{bad_agree} of {MAX_NEW}")
    if r_bad.case != 1 or r_bad.matched_tokens or not r_bad.unreadable_blobs:
        raise AssertionError(f"[{label}] a corrupt chunk was not a miss")
    if model.dtype == torch.float32 and bad_agree != MAX_NEW:
        raise AssertionError(f"[{label}] fallback tokens differ from cold")

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
    refs = {"A": r_miss.output_tokens, "B": r_cold_b.output_tokens,
            "C": r_cold_c.output_tokens}
    return launches, str_launches, (p_a, p_b, p_c), refs


def wrapped_ring_path(model, label, expect):
    """A windowed model's edge request past its ring's wrap (WRAP_SHOTS-
    shot prompts, ``max_len`` WRAP_MAX_LEN): A misses (the cold prefill
    runs past the wrap) and uploads each range's own state; B resumes a
    partial hit whose prefix already fills the ring (its cache position
    past the window), monolithic and streamed; B adopts A's full prompt.
    The counts are set to 0 just before and read just after, and must be
    what the requests need; fp32 tokens must equal a cold run's. Returns
    the launch counts."""
    collect_profiles()
    import torch
    from repro_torch.config import CacheConfig
    from repro_torch.core.client import EdgeClient
    from repro_torch.core.server import CacheServer
    from repro_torch.data.mmlu import MMLUGenerator
    from repro_torch.data.tokenizer import WordHashTokenizer
    from repro_torch.obs.ledger import LEDGER
    from repro_torch.serving.engine import InferenceEngine

    cfg = model.cfg
    gen = MMLUGenerator(WordHashTokenizer(cfg.vocab), n_shot=WRAP_SHOTS)
    p_a, p_b = (gen.prompt(WRAP_DOMAIN, i).segments for i in (0, 1))
    server = CacheServer(CacheConfig())
    LEDGER.clear()                     # no learned baseline cuts the stream

    def client(name, srv=server, overlap=False):
        return EdgeClient(name, InferenceEngine(model, max_len=WRAP_MAX_LEN),
                          srv, CacheConfig(), overlap=overlap)

    for k in expect:
        k.launches = 0
    a, b, s = client("A"), client("B"), client("S", overlap=True)
    r_miss = a.infer(p_a, MAX_NEW)
    b.sync_catalog()
    s.sync_catalog()
    r_part = b.infer(p_b, MAX_NEW, upload_on_miss=False)
    LEDGER.clear()
    r_str = s.infer(p_b, MAX_NEW, upload_on_miss=False)
    r_full = b.infer(p_a, MAX_NEW, upload_on_miss=False)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in expect}
    r_cold = client("cold", CacheServer(CacheConfig())).infer(
        p_b, MAX_NEW, upload_on_miss=False)
    runs = (("A miss", r_miss), ("B partial, monolithic", r_part),
            ("B partial, streamed", r_str), ("B full", r_full),
            ("B cold", r_cold))
    for tag, r in runs:
        t = r.timings
        print(f"[{label}] past the wrap, {tag}: case {r.case} matched "
              f"{r.matched_tokens}/{r.prompt_tokens} (cache positions "
              f"{model.cache_len(r.matched_tokens) if r.matched_tokens else 0}"
              f"/{model.cache_len(r.prompt_tokens)}, ring {cfg.window}) ttft "
              f"{r.ttft_s * 1e3:.2f} ms ttlt {r.ttlt_s * 1e3:.2f} ms up "
              f"{r.blob_bytes_up} B down {r.blob_bytes_down} B | fetch "
              f"{t['fetch_s'] * 1e3:.2f} restore {t['restore_s'] * 1e3:.2f} "
              f"prefill {t['prefill_s'] * 1e3:.2f} decode "
              f"{t['decode_s'] * 1e3:.2f} ms "
              f"({t['decode_s'] / MAX_NEW * 1e3:.2f} ms/tok) upload "
              f"{t['upload_s'] * 1e3:.2f} ms")
    agree = {tag: sum(x == y for x, y in zip(r.output_tokens, ref))
             for tag, r, ref in (
                 ("resumed_vs_cold", r_part, r_cold.output_tokens),
                 ("streamed_vs_cold", r_str, r_cold.output_tokens),
                 ("adopted_vs_miss", r_full, r_miss.output_tokens))}
    ranges = len(p_a.keys(a.meta))
    want = path_launches(cfg, ranges + 2, 4 * MAX_NEW)
    print(f"[{label}] past the wrap: tokens agreeing of {MAX_NEW}: {agree};"
          f" launches {launches}, the requests need {want}")
    if [r.case for _, r in runs[:4]] != [1, 4, 4, 5] or not r_str.streamed \
            or model.cache_len(r_part.matched_tokens) <= cfg.window or \
            model.cache_len(r_miss.prompt_tokens) <= cfg.window:
        raise AssertionError(f"[{label}] past the wrap: cases "
                             f"{[r.case for _, r in runs]}, matched "
                             f"{r_part.matched_tokens}")
    if launches != want:
        raise AssertionError(f"[{label}] past the wrap: launches {launches}")
    if model.dtype == torch.float32 and min(agree.values()) != MAX_NEW:
        raise AssertionError(f"[{label}] past the wrap: tokens differ "
                             f"{agree}")
    return launches


def trace_check(label, runs):
    """Each (client, result): the result's span tree, projected onto the
    Table-3 columns (``Breakdown.from_spans``), must equal ``wall`` and
    agree with ``timings`` phase by phase within max(0.5 ms, 2%). The
    spans carry the timings' own values, so that shows each span is
    there once. The spans' own clock readings are then held against the
    timings: every span of the client lies inside its root ``infer``
    span; each ``redis.attempt`` lasts at least the transfer it reports
    (``component_s``); and the root lasts at least its spans that run
    one after another on the request's thread (bloom, the attempts, a
    prefill that is not streamed, decode)."""
    from repro_torch.core.metrics import Breakdown
    pairs = (("bloom", "bloom_s"), ("redis", "fetch_s"),
             ("p_decode", "prefill_s"), ("r_decode", "decode_s"))
    eps = 1e-6                         # float rounding of clock readings
    worst, slack_att, slack_root = 0.0, float("inf"), float("inf")
    for c, r in runs:
        spans = c.tracer.trace(r.trace_id) or []
        bd = Breakdown.from_spans(spans)
        if not spans or bd != r.wall:
            raise AssertionError(f"[{label}] no span tree for {r.trace_id}")
        for col, key in pairs:
            d = abs(getattr(bd, col) - r.timings[key])
            worst = max(worst, d)
            if d > max(5e-4, 0.02 * r.timings[key]):
                raise AssertionError(f"[{label}] span projection {col} "
                                     f"{getattr(bd, col)} against timings "
                                     f"{key} {r.timings[key]}")
        roots = [x for x in spans if not x["parent"]]
        if [x["name"] for x in roots] != ["infer"]:
            raise AssertionError(f"[{label}] roots {roots}")
        t0, end = roots[0]["t0"], roots[0]["t0"] + roots[0]["dur"]
        serial = 0.0
        for x in spans:
            a = x["attrs"]
            if a.get("remote"):        # a peer's clock, re-anchored
                continue
            if x["t0"] < t0 - eps or x["t0"] + x["dur"] > end + eps:
                raise AssertionError(f"[{label}] span {x['name']} lies "
                                     f"outside its root: {x}")
            if x["name"] == "redis.attempt":
                slack_att = min(slack_att, x["dur"] - a["component_s"])
                serial += x["dur"]
            elif a.get("component") in ("bloom", "r_decode") or (
                    a.get("component") == "p_decode"
                    and a.get("kind") != "streamed"):
                serial += x["dur"]
        slack_root = min(slack_root, roots[0]["dur"] - serial)
    if slack_att < -eps or slack_root < -eps:
        raise AssertionError(f"[{label}] span clocks: an attempt lasts "
                             f"{slack_att} s less than its transfer, or a "
                             f"root {slack_root} s less than its serial "
                             f"spans")
    print(f"[{label}] span projection: {len(runs)} requests, Breakdown "
          f"from spans against timings (bloom, fetch, prefill, decode), "
          f"largest gap {worst * 1e3:.6f} ms (bound max(0.5 ms, 2%); the "
          f"spans carry the timings' values); span clocks: every span "
          f"inside its root, least slack of an attempt over its transfer "
          + (f"{slack_att * 1e3:.3f} ms" if slack_att != float("inf")
             else "(no attempt)")
          + f", of a root over its serial spans {slack_root * 1e3:.3f} ms")


def spawn_fleet(n):
    """``n`` peer daemons (``python -m repro_torch.core.net.daemon``), each
    its own process on 127.0.0.1: {peer_id: (process, (host, port))} once
    each has printed PEER-READY. set_neighbors wires the ring (replication
    factor FABRIC_REPL) and their gossip threads."""
    from repro_torch.core.net.link import TCPPeerLink
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    fleet = {}
    try:
        for i in range(n):
            pid = f"peer{i}"
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.core.net.daemon",
                 "--peer-id", pid, "--port", "0", "--gossip-interval",
                 str(GOSSIP_S)], env=env, stdout=subprocess.PIPE, text=True)
            fleet[pid] = (proc, None)
            line = proc.stdout.readline().split()
            if line[:2] != ["PEER-READY", pid]:
                raise AssertionError(f"daemon {pid} printed {line}")
            fleet[pid] = (proc, (line[2], int(line[3])))
        peers = {pid: list(addr) for pid, (_, addr) in fleet.items()}
        for pid, (_, addr) in fleet.items():
            link = TCPPeerLink(pid, *addr, timeout=FABRIC_TIMEOUT_S)
            resp = link.request("set_neighbors", {
                "peers": peers, "ring": sorted(peers),
                "repl_factor": FABRIC_REPL})[0]
            link.close()
            if not resp["ok"]:
                raise AssertionError(f"set_neighbors on {pid}: {resp}")
    except BaseException:
        kill_fleet(fleet)
        raise
    return fleet


def stop_daemon(fleet, pid):
    """``shutdown`` one daemon and wait for it: it must exit 0."""
    from repro_torch.core.net.link import TCPPeerLink
    proc, addr = fleet.pop(pid)
    link = TCPPeerLink(pid, *addr, timeout=FABRIC_TIMEOUT_S)
    try:
        if link.request("shutdown", {})[0].get("bye") != pid:
            raise AssertionError(f"daemon {pid} refused shutdown")
    finally:
        link.close()
    rc = proc.wait(timeout=30)
    proc.stdout.close()
    if rc != 0:
        raise AssertionError(f"daemon {pid} exited {rc}")


def kill_fleet(fleet):
    """Stop what is left of a fleet, whatever went wrong before."""
    for proc, _ in fleet.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
    fleet.clear()


def fabric_settle(fleet, digests, timeout_s=120.0):
    """Wait until every daemon has pushed its pending replication and
    handoffs and every owner holds its digests (the gossip threads pump
    them every GOSSIP_S). Returns the seconds it took."""
    import time
    from repro_torch import clock
    from repro_torch.core.cluster.placement import PlacementPolicy
    from repro_torch.core.net.link import TCPPeerLink
    ring = PlacementPolicy(sorted(fleet))
    links = {pid: TCPPeerLink(pid, *addr, timeout=FABRIC_TIMEOUT_S)
             for pid, (_, addr) in fleet.items()}
    t0 = clock.monotonic()
    try:
        while True:
            pending = sum(ln.request("health", {})[0]["repl"]["pending"]
                          for ln in links.values())
            held = {pid: set(ln.request("csync", {"since": 0})[0]["keys"])
                    for pid, ln in links.items()}
            missing = [d for d in digests
                       for pid in ring.ring_order(d)[:FABRIC_REPL]
                       if d not in held[pid]]
            if not pending and not missing:
                return clock.monotonic() - t0
            if clock.monotonic() - t0 > timeout_s:
                raise AssertionError(f"replication did not settle: "
                                     f"{pending} pending, {len(missing)} "
                                     f"missing")
            time.sleep(GOSSIP_S)
    finally:
        for ln in links.values():
            ln.close()


def stream_waits(fleet, pid, digest, load=None):
    """A blob fetched again as a chunk stream whose ``on_chunk`` only keeps
    each frame's wait (no decoding in the socket loop): on this thread
    with no work between frames, or, with ``load``, on a worker thread
    while this one runs ``load()`` over and over, as a streamed hit's
    suffix prefill runs beside its pump. Returns (wall seconds, each
    frame's wait, loads run). Tells the wire's part of a streamed fetch
    from the decoding's and the consumer's."""
    import threading
    from repro_torch import clock
    from repro_torch.core.net.link import TCPPeerLink
    link = TCPPeerLink(pid, *fleet[pid][1], timeout=FABRIC_TIMEOUT_S)
    gaps, err, done, loads = [], [], threading.Event(), 0

    def read():
        try:
            link.request_stream("get_chunks", {"key": digest},
                                lambda c, dt, nb: gaps.append(dt))
        except BaseException as e:     # re-raised on this thread
            err.append(e)
        finally:
            done.set()
    try:
        t0 = clock.monotonic()
        if load is None:
            read()
        else:
            worker = threading.Thread(target=read, daemon=True)
            worker.start()
            while not done.is_set():
                load()
                loads += 1
            worker.join()
        wall = clock.monotonic() - t0
    finally:
        link.close()
    if err:
        raise err[0]
    return wall, gaps, loads


def frame_waits(gaps):
    """One line for a stream's per-frame waits (ms), the longest's index."""
    i = max(range(len(gaps)), key=gaps.__getitem__)
    return (f"{len(gaps)} frames waited {sum(gaps) * 1e3:.2f} ms in all, "
            f"median {statistics.median(gaps) * 1e3:.3f}, max "
            f"{gaps[i] * 1e3:.3f} at frame {i}")


def fabric_path(model, label, expect, prompts, refs, max_len=1024):
    """The edge request behind a real wire: FABRIC_PEERS daemon processes
    over TCP, clients on the card reaching them through a PeerDirectory of
    TCPPeerLinks with wall clocks. Client A misses prompt A and uploads
    each range to its placement owners; the peers replicate; client B
    gets Case 4 on prompt B monolithic and streamed (one frame a chunk)
    and Case 5 on prompt A; the peer that served the Case 5 is shut down
    and B asks for A again (a Case 5 from the replica, or a Case-1
    fallback; the dead peer's fast fail is timed); a client without a
    catalog pays GETs on prompt C, never uploaded, and one with a catalog
    pays none. ``expect`` maps the path's wrappers to their launches a
    prefill and a decoded token (counts set to 0 just before the requests
    and read just after; they must equal what the requests need). fp32
    tokens must equal the single-server run's (``refs``). Returns the
    launch counts."""
    collect_profiles()
    import numpy as np
    import torch
    from repro_torch import clock
    from repro_torch.config import CacheConfig
    from repro_torch.core.client import EdgeClient
    from repro_torch.core.cluster.directory import PeerDirectory
    from repro_torch.core.cluster.placement import PlacementPolicy
    from repro_torch.core.net.link import TCPPeerLink
    from repro_torch.core.netsim import WallClock
    from repro_torch.obs.ledger import LEDGER
    from repro_torch.serving.engine import InferenceEngine

    p_a, p_b, p_c = prompts
    ccfg = CacheConfig()
    t_phase = clock.monotonic()
    fleet = spawn_fleet(FABRIC_PEERS)
    peers0 = list(fleet)
    try:
        def client(name, **kw):
            links = [TCPPeerLink(pid, *addr, timeout=FABRIC_TIMEOUT_S)
                     for pid, (_, addr) in sorted(fleet.items())]
            d = PeerDirectory(links, ccfg, clock=WallClock())
            return EdgeClient(name, InferenceEngine(model, max_len=max_len),
                              d, ccfg, **kw)

        def sync(c):
            c.directory.last_sync_t = -1e18
            c.sync_catalog()

        for k in expect:
            k.launches = 0
        a = client("A")
        runs = [("A miss", a.infer(p_a, MAX_NEW))]
        settle_s = fabric_settle(fleet, [k.digest for k in p_a.keys(a.meta)])
        b, s = client("B"), client("S", overlap=True)
        sync(b)
        sync(s)
        runs.append(("B partial, monolithic", b.infer(p_b, MAX_NEW)))
        # the streamed Case 4 is measured whole: A's miss taught the
        # ledger a local baseline that the watchdog would cut it against
        LEDGER.clear()
        gaps = []                      # seconds waited for each chunk frame
        record_chunk = s.directory.record_chunk
        s.directory.record_chunk = lambda pid, nb, dt, observe=True: (
            gaps.append(dt), record_chunk(pid, nb, dt, observe))
        runs.append(("B partial, streamed", s.infer(p_b, MAX_NEW)))
        runs.append(("B full", b.infer(p_a, MAX_NEW)))
        served = runs[-1][1].served_by
        stop_daemon(fleet, served)
        runs.append((f"B full, {served} shut down", b.infer(p_a, MAX_NEW)))
        nocat, cat = client("N", use_catalog=False), client("K")
        sync(nocat)
        sync(cat)
        runs.append(("C, no catalog", nocat.infer(p_c, MAX_NEW,
                                                  upload_on_miss=False)))
        runs.append(("C, catalog", cat.infer(p_c, MAX_NEW,
                                             upload_on_miss=False)))
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in expect}
        trace_check(label + " fabric", [(c, res) for c, (_, res) in zip(
            (a, b, s, b, b, nocat, cat), runs)])
        remote = [d for d in b.tracer.trace(runs[3][1].trace_id)
                  if d["proc"].startswith("peer:")]
        if not remote:
            raise AssertionError(f"[{label}] fabric: B's Case 5 trace holds "
                                 f"no daemon span")
        # the streamed Case 4's blob read again, its frames' waits alone
        # and beside the suffix prefill (after the counts are read: these
        # prefills are not the path's), from a live owner
        st_res = runs[2][1]
        digest = next(k.digest for k in p_b.keys(s.meta)
                      if k.n_tokens == st_res.matched_tokens)
        holder = next(pid for pid in
                      [st_res.served_by] + PlacementPolicy(
                          sorted(peers0)).ring_order(digest)
                      if pid in fleet)
        suffix = np.asarray(p_b.token_ids[st_res.matched_tokens:],
                            np.int32)[None]
        alone = stream_waits(fleet, holder, digest)
        beside = stream_waits(fleet, holder, digest, load=lambda: (
            s.engine.start({"tokens": suffix}), torch.cuda.synchronize()))
        health = {}
        for pid, (_, addr) in fleet.items():
            link = TCPPeerLink(pid, *addr, timeout=FABRIC_TIMEOUT_S)
            health[pid] = link.request("health", {})[0]
            link.close()
        for pid in sorted(fleet):
            stop_daemon(fleet, pid)
    finally:
        kill_fleet(fleet)

    r = dict(runs)
    for tag, res in runs:
        t = res.timings
        print(f"[{label}] fabric {tag}: case {res.case} matched "
              f"{res.matched_tokens}/{res.prompt_tokens} served_by "
              f"{res.served_by or '-'} attempts {res.fetch_attempts} "
              f"(dead {int(res.extra.get('dead_peer_failures', 0))}) | "
              f"fetch over the socket {t['fetch_s'] * 1e3:.2f} ms, down "
              f"{res.blob_bytes_down} B, up {res.blob_bytes_up} B, "
              f"{res.chunks_down} chunks | restore {t['restore_s'] * 1e3:.2f}"
              f" prefill {t['prefill_s'] * 1e3:.2f} decode "
              f"{t['decode_s'] * 1e3:.2f} upload {t['upload_s'] * 1e3:.2f} "
              f"ms | ttft {res.ttft_s * 1e3:.2f} ttlt {res.ttlt_s * 1e3:.2f}"
              f" ms" + (f" | streamed: hidden {t.get('hidden_s', 0) * 1e3:.2f}"
                        f" of {t.get('stream_s', 0) * 1e3:.2f} ms"
                        if res.streamed else ""))
    print(f"[{label}] fabric stream frames (ms): the streamed Case 4 "
          f"(pump decoding, consumer running): {frame_waits(gaps)}; the "
          f"blob read again from {holder}, appending only, alone on this "
          f"thread: {alone[0] * 1e3:.2f} wall, {frame_waits(alone[1])}; on "
          f"a thread beside {beside[2]} suffix prefills here: "
          f"{beside[0] * 1e3:.2f} wall, {frame_waits(beside[1])}")
    after = r[f"B full, {served} shut down"]
    print(f"[{label}] fabric: replication settled {settle_s * 1e3:.0f} ms "
          f"after A's uploads; the dead peer's fast fail took "
          f"{after.extra.get('dead_peer_s', 0.0) * 1e3:.3f} ms; daemons: "
          + "; ".join(f"{pid} {h['n_entries']} blobs {h['stored_bytes']} B, "
                      f"pushed {h['repl']['repl_pushed']}, handoffs "
                      f"{h['repl']['handoffs']}"
                      for pid, h in sorted(health.items()))
          + f"; phase {clock.monotonic() - t_phase:.1f} s")
    print(f"[{label}] fabric launches: {launches}; hedged GETs fired/won "
          f"(a GET outlasting max(its estimate x the peer's p95 "
          f"actual/estimate, 1.5 before 4 samples, 50 ms) fires the "
          f"plan's next wall-link holder): "
          + ", ".join(f"{c.name} {c.hedges}/{c.hedge_wins}"
                      for c in (a, b, s, nocat, cat)))

    got = [res.case for _, res in runs]
    min_match = ccfg.min_match_tokens
    n_c = len([k for k in p_c.keys(a.meta) if k.n_tokens >= min_match])
    mono, stream = r["B partial, monolithic"], r["B partial, streamed"]
    if got[:4] != [1, 4, 4, 5] or after.case not in (1, 5) or \
            after.served_by == served or \
            not after.extra.get("dead_peer_failures") or \
            not stream.streamed or mono.streamed or \
            stream.matched_tokens != mono.matched_tokens or \
            got[5:] != [1, 1] or runs[6][1].fetch_attempts != 0 or \
            runs[5][1].fetch_attempts != n_c * (FABRIC_PEERS - 1):
        raise AssertionError(f"[{label}] fabric cases {got}, after the "
                             f"shutdown {after.case} from {after.served_by}, "
                             f"attempts {[x.fetch_attempts for _, x in runs]}")
    agree = {tag: sum(x == y for x, y in zip(
        res.output_tokens, refs["A" if "full" in tag or tag.startswith("A")
                                else "B" if tag.startswith("B") else "C"]))
        for tag, res in runs}
    print(f"[{label}] fabric tokens agreeing with the single-server run, "
          f"of {MAX_NEW}: {agree}")
    if model.dtype == torch.float32 and min(agree.values()) != MAX_NEW:
        raise AssertionError(f"[{label}] fabric tokens differ: {agree}")
    prefills = sum(res.matched_tokens < res.prompt_tokens
                   for _, res in runs)
    if model.has_recurrent_state:      # A's shorter ranges at upload
        prefills += len(p_a.keys(a.meta, ccfg.max_ranges,
                                 ccfg.range_stride)) - 1
    want = path_launches(model.cfg, prefills, len(runs) * MAX_NEW)
    if launches != want:
        raise AssertionError(f"[{label}] fabric launches {launches}, the "
                             f"requests need {want}")
    return launches


def batched_path(model, label, max_len=1024):
    """Continuous batching: ``BatchedEngine(batch_size=BATCH)`` and the
    ``Scheduler`` serve one request per entry of BATCH_CUTS (MMLU-style
    prompts, some cut, so that slots sit at different positions and
    recycle), MAX_NEW tokens each. The counts are set to 0 just before the
    run and read just after: each decode step launches the decode kernel
    once a layer, the prefills launch flash_prefill once a layer per
    batched prefill (an SSM: ssd_scan once a layer per request, each
    prompt prefilled alone at its exact length), and moe_gemm three times
    a MoE layer per decode step and per batched prefill. The tokens are held
    against sequential ``InferenceEngine`` runs (equal in fp32, counted in
    bf16). Then a steady Scheduler step with its requests traced must run
    what an untraced one runs (``sched_kernels``); one decode_batch step's
    launches, and decode ms per step at B=1 and B=BATCH. Returns the
    run's launch counts."""
    collect_profiles()
    import numpy as np
    import torch
    from repro_torch import clock
    from repro_torch.data.mmlu import MMLUGenerator
    from repro_torch.data.tokenizer import WordHashTokenizer
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.mla_decode import mla_decode
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving.engine import BatchedEngine, InferenceEngine
    from repro_torch.serving.scheduler import Request, Scheduler

    cfg = model.cfg
    L = cfg.n_layers
    kernels = (flash_prefill, flash_decode, ssd_scan, mla_decode, moe_gemm)
    decode_k = None if cfg.family == "ssm" else \
        mla_decode if cfg.uses_mla else flash_decode
    gen = MMLUGenerator(WordHashTokenizer(cfg.vocab), n_shot=5)
    prompts = []
    for i, cut_to in enumerate(BATCH_CUTS):
        toks = np.asarray(gen.prompt(BATCH_DOMAINS[i % len(BATCH_DOMAINS)],
                                     i).segments.token_ids, np.int32)
        prompts.append(toks[:cut_to])
    if cfg.window:                     # one request past the ring's wrap
        toks = MMLUGenerator(WordHashTokenizer(cfg.vocab),
                             n_shot=WRAP_SHOTS).prompt(WRAP_DOMAIN, 0)
        prompts[3] = np.asarray(toks.segments.token_ids,
                                np.int32)[:BATCH_WRAP_CUT]
    eng = BatchedEngine(model, max_len, BATCH)
    Scheduler(eng).run([Request(tokens=p, max_new_tokens=2)       # warm-up
                        for p in prompts[:BATCH]])
    torch.cuda.synchronize()

    for k in kernels:
        k.launches = 0
    sched = Scheduler(eng)
    stats = sched.run([Request(tokens=p, max_new_tokens=MAX_NEW)
                       for p in prompts])
    launches = {k.__name__: k.launches for k in kernels}
    rep = sched.report()
    outs = [stats[i].output_tokens for i in range(len(prompts))]

    single = InferenceEngine(model, max_len=max_len)
    for p in prompts:              # warm-up: each prompt's shapes once
        single.generate(single.start({"tokens": p[None]}), 1)
    torch.cuda.synchronize()
    t0 = clock.monotonic()
    seq = [single.generate(single.start({"tokens": p[None]}),
                           MAX_NEW)[0].tolist() for p in prompts]
    seq_s = clock.monotonic() - t0
    agree = [sum(x == y for x, y in zip(a, b)) for a, b in zip(outs, seq)]
    print(f"[{label}] batched: {len(prompts)} requests over {BATCH} slots, "
          f"prompts {[len(p) for p in prompts]} tokens, {MAX_NEW} new each;"
          f" {sched.n_steps} decode steps, wall {rep.wall_s * 1e3:.2f} ms, "
          f"{rep.throughput_tok_s:.1f} tokens/s (sequential engine: "
          f"{len(prompts) * MAX_NEW / seq_s:.1f} tokens/s, "
          f"{seq_s * 1e3:.2f} ms); TTFT p50/p90/p99 "
          f"{rep.ttft_p50 * 1e3:.2f}/{rep.ttft_p90 * 1e3:.2f}/"
          f"{rep.ttft_p99 * 1e3:.2f} ms, TTLT p50/p99 "
          f"{rep.latency_p50 * 1e3:.2f}/{rep.latency_p99 * 1e3:.2f} ms, "
          f"queue wait p50 {rep.queue_wait_p50 * 1e3:.2f} ms")
    print(f"[{label}] batched tokens agreeing with sequential runs, of "
          f"{MAX_NEW} a request: {agree}; launches {launches}")
    well_formed = all(len(o) == MAX_NEW and all(0 <= t < cfg.vocab
                                                for t in o) for o in outs)
    if not well_formed or rep.n_requests != len(prompts):
        raise AssertionError(f"[{label}] batched outputs malformed")
    if model.dtype == torch.float32 and outs != seq:
        raise AssertionError(f"[{label}] batched tokens differ from "
                             f"sequential runs: {agree}")
    # a recurrent state takes one exact prefill a request; padded batched
    # prefills launch flash_prefill once a layer per batch
    n_pre = len(prompts)
    if not model.has_recurrent_state:
        n_pre = launches["flash_prefill"] // L
        if n_pre <= 0 or launches["flash_prefill"] % L:
            raise AssertionError(f"[{label}] flash_prefill launched "
                                 f"{launches['flash_prefill']} times, not a "
                                 f"multiple of {L} layers")
    want = path_launches(cfg, n_pre, sched.n_steps)
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"[{label}] {name} launched "
                                 f"{launches[name]} times, the run needs {n}")

    def sched_kernels(tracer):
        """Steady Scheduler steps (every slot decoding), their requests
        traced under ``tracer`` or untraced (None), over TRACE_WINDOWS
        profiler windows of TRACE_ITERS steps each. A step's aten ops,
        decode kernel launches and kernel launch calls on the host
        (``launch_calls``) must be the same in every window; its CUDA
        kernels on the device (the most of the windows) are printed only,
        since a device window may lose or misplace a few events. The
        requests then run to their end, so the traced ones emit their
        slot spans."""
        from torch.profiler import ProfilerActivity, profile
        sch = Scheduler(eng, tracer=tracer)
        root = tracer.start("batch") if tracer is not None else None
        for p in prompts[:BATCH]:
            sch.submit(Request(tokens=p, max_new_tokens=TRACE_STEPS,
                               trace=root.ctx if root is not None else None))
        sch.step()                     # admission: the slots' prefills
        counts, dev = [], []
        for _ in range(TRACE_WINDOWS):
            n0 = decode_k.launches if decode_k else 0
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(TRACE_ITERS):
                    sch.step()
                torch.cuda.synchronize()
            counts.append((sum(e.count for e in prof.key_averages()
                               if e.key.startswith("aten::")) / TRACE_ITERS,
                           (decode_k.launches - n0) / TRACE_ITERS
                           if decode_k else 0,
                           launch_calls(prof) / TRACE_ITERS))
            dev.append(sum(e.count for e in _device_rows(prof))
                       / TRACE_ITERS)
        sch.run()
        if root is not None:
            root.end()
            names = {d["name"] for d in tracer.trace(root.trace_id)}
            if not {"slot.prefill", "slot.decode"} <= names:
                raise AssertionError(f"[{label}] traced requests left no "
                                     f"slot spans: {names}")
        if len(set(counts)) != 1:
            raise AssertionError(f"[{label}] steady steps differ: {counts}")
        return counts[0], max(dev)

    (c_off, k_off), (c_on, k_on) = \
        sched_kernels(None), sched_kernels(Tracer(proc="batch"))
    print(f"[{label}] a Scheduler step at B={BATCH}, tracer off / on: "
          f"aten ops {c_off[0]:g} / {c_on[0]:g}, decode launches "
          f"{c_off[1]:g} / {c_on[1]:g}, kernel launch calls on the host "
          f"{c_off[2]:g} / {c_on[2]:g} (checked equal); CUDA kernels on "
          f"the device, the most of {TRACE_WINDOWS} profiler windows, "
          f"{k_off:g} / {k_on:g} (printed only)")
    if c_on != c_off or c_on[0] <= 0 or c_on[2] <= 0:
        raise AssertionError(f"[{label}] a traced step ran {c_on} "
                             f"(aten ops, decode launches, launch "
                             f"calls), an untraced one {c_off}")

    collect_profiles()

    def step_ms(B):
        """Median wall ms of a decode_batch step of B slots (the logits
        reach the host each step), the decode launches of one step, and
        one step's CUDA kernels and device ms (profiler)."""
        e = BatchedEngine(model, max_len, B)
        e.prefill_slots(list(range(B)), prompts[:B])
        toks = np.full(B, 5, np.int32)
        for _ in range(3):
            e.decode_batch(toks)
        n0 = decode_k.launches if decode_k else 0
        e.decode_batch(toks)
        one = (decode_k.launches - n0) if decode_k else 0
        times = []
        for _ in range(DECODE_STEPS):
            t0 = clock.monotonic()
            e.decode_batch(toks)
            times.append(clock.monotonic() - t0)
        n_k, dev_ms = profile_call(lambda: e.decode_batch(toks))
        return statistics.median(times) * 1e3, one, n_k, dev_ms

    (ms1, one1, k1, d1), (ms4, one4, k4, d4) = step_ms(1), step_ms(BATCH)
    print(f"[{label}] decode_batch ms per step (median of {DECODE_STEPS}): "
          f"B=1 {ms1:.2f}, B={BATCH} {ms4:.2f}; one step's CUDA kernels / "
          f"device ms: B=1 {k1:g} / {d1:.3f}, B={BATCH} {k4:g} / {d4:.3f} "
          f"(idle share {1 - d1 / ms1:.3f}, {1 - d4 / ms4:.3f}); decode "
          f"launches in one step: B=1 {one1}, B={BATCH} {one4} ({L} layers)")
    if decode_k is not None and (one1, one4) != (L, L):
        raise AssertionError(f"[{label}] one decode step launched "
                             f"{decode_k.__name__} {one1} / {one4} times, "
                             f"not once a layer ({L})")
    return launches


def _replay_one(port, wl, stream, out):
    """One chat request of a mix over HTTP (``http.client``): SSE read line
    by line (client-seen TTFT at the first token), or unary (the cache
    meta comes with it). Records status, tokens, ttft_s, ttlt_s, and
    t_status: when the status line came (``clock.monotonic``)."""
    import http.client
    from repro_torch import clock
    t0 = clock.monotonic()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/v1/chat/completions",
                     json.dumps(wl.body(stream=stream)),
                     {"Content-Type": "application/json",
                      "X-Tenant": wl.tenant})
        resp = conn.getresponse()
        out["status"] = resp.status
        out["t_status"] = clock.monotonic()
        if resp.status != 200:
            out["retry_after"] = resp.getheader("Retry-After")
            resp.read()
            return
        if not stream:
            body = json.loads(resp.read())
            out["ttlt_s"] = clock.monotonic() - t0
            out["tokens"] = body["choices"][0]["token_ids"]
            out["cache"] = body["cache"]
            return
        tokens = []
        while True:
            line = resp.readline()
            if not line or line.strip() == b"data: [DONE]":
                break
            if not line.startswith(b"data: "):
                continue
            choice = json.loads(line[6:])["choices"][0]
            if "token_id" in choice:
                if not tokens:
                    out["ttft_s"] = clock.monotonic() - t0
                tokens.append(choice["token_id"])
        out["ttlt_s"] = clock.monotonic() - t0
        out["tokens"] = tokens
    finally:
        conn.close()


def replay(port, wls):
    """Each request of a mix on its own client thread at its arrival
    offset; every other one SSE (the even ones), the rest unary.
    Returns (results, wall seconds, the replay's start)."""
    import threading
    import time
    from repro_torch import clock
    results = [dict() for _ in wls]
    t0 = clock.monotonic()

    def worker(i, wl):
        delay = wl.arrival_s - (clock.monotonic() - t0)
        if delay > 0:
            time.sleep(delay)
        try:
            _replay_one(port, wl, i % 2 == 0, results[i])
        except Exception as e:         # recorded, then raised by the check
            results[i]["error"] = repr(e)

    threads = [threading.Thread(target=worker, args=(i, wl), daemon=True)
               for i, wl in enumerate(wls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(GATEWAY_JOIN_S)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a replay client did not finish in "
                             f"{GATEWAY_JOIN_S} s")
    return results, clock.monotonic() - t0, t0


def _http_json(port, path):
    """GET ``path`` from the gateway; the JSON body (status 200)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            raise AssertionError(f"GET {path}: {resp.status} {body[:200]}")
        return json.loads(body)
    finally:
        conn.close()


def traced_pair(gw, label):
    """A fresh chat prompt twice down one keep-alive connection (its
    uploads drained between the two, so the second is a hit fetched from
    a daemon, not from the broker's recent blobs); the second's
    ``/v1/traces/<id>`` must be one tree rooted at ``gw.request`` (its
    root ``follows`` the first's), with the engine thread's resolve and
    slot spans and a daemon's folded spans. Returns what it saw."""
    import http.client
    import time
    from repro_torch import clock
    port = gw.port
    body = {"messages": [
        {"role": "system", "content": "a prompt traced end to end"},
        {"role": "user", "content": "which spans does it leave"}],
        "max_tokens": MAX_NEW_GW}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    ids = []
    try:
        for i in range(2):
            if i:
                gw.engine.fetcher.flush_uploads(GATEWAY_JOIN_S)
            conn.request("POST", "/v1/chat/completions", json.dumps(body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            got = json.loads(resp.read())
            if resp.status != 200 or not got["cache"].get("trace_id"):
                raise AssertionError(f"[{label}] traced request: "
                                     f"{resp.status} {got}")
            ids.append((got["id"], got["cache"]))
    finally:
        conn.close()
    t0 = clock.monotonic()
    while True:                        # the root ends after the reply
        docs = [_http_json(port, f"/v1/traces/{rid}") for rid, _ in ids]
        roots = [[d for d in doc["spans"] if not d["parent"]]
                 for doc in docs]
        if all(len(r) == 1 for r in roots):
            break
        if clock.monotonic() - t0 > 5.0:
            raise AssertionError(f"[{label}] trace roots {roots}")
        time.sleep(0.01)
    doc, cache = docs[1], ids[1][1]
    names = sorted({d["name"] for d in doc["spans"]})
    procs = sorted({d["proc"] for d in doc["spans"]})
    follows = roots[1][0]["attrs"].get("follows")
    if doc["trace_id"] != cache["trace_id"] or \
            roots[1][0]["name"] != "gw.request" or \
            follows != roots[0][0]["span"] or \
            not {"gw.resolve", "net.get", "slot.prefill",
                 "slot.decode"} <= set(names) or \
            not any(p.startswith("peer:") for p in procs) or \
            not cache["matched_tokens"]:
        raise AssertionError(f"[{label}] trace tree: names {names}, procs "
                             f"{procs}, follows {follows}, cache {cache}")
    return {"n_spans": doc["n_spans"], "names": names, "procs": procs,
            "follows": follows}


def _ms(xs, q):
    """The q-th percentile of seconds ``xs``, in ms."""
    import numpy as np
    return float(np.percentile(xs, q)) * 1e3 if len(xs) else float("nan")


def _longest(samples, t0, t1):
    """The longest of ``(end, seconds)`` samples that overlap [t0, t1]:
    ``(seconds, end)``, or ``(0.0, t1)`` when none does."""
    return max(((dt, end) for end, dt in samples
                if end >= t0 and end - dt <= t1), default=(0.0, t1))


def gateway_path(model, label, smi, max_len=1024, console=False):
    """The serving front door on the card: FABRIC_PEERS peer daemons under
    the port's supervisor (``Fabric.tcp``) and ``Gateway(model, fabric,
    batch_size=BATCH, max_len=1024)``. Each mix of the port's
    ``workloads`` (GATEWAY_N requests at GATEWAY_RATE a second, MAX_NEW_GW
    tokens, every other one SSE) is replayed from client threads over
    HTTP; then a tenant over its rate quota must get 429 with
    Retry-After; one peer is killed (``fabric.kill``) and a cached prompt
    must still be answered, after which ``check_and_restart`` must bring
    the peer back; a one-slot gateway with no queue must answer 503 while
    a stream holds its slot. Tokens are held against a fresh
    ``BatchedEngine`` + ``Scheduler`` with no cache (equal in fp32,
    counted in bf16); each mix must have a unary request served by a peer
    (``matched_tokens > 0``); every daemon must exit 0 at ``stop()``. The
    counts are set to 0 just before the gateway's traffic and read just
    after: flash_prefill must have launched, and the decode kernel once a
    layer a scheduler step, with the gateway's tracer on. Tracing: two
    cached prompts down one keep-alive connection, the second's
    ``/v1/traces/<id>`` must be one tree from the HTTP front door through
    the engine thread to a daemon, its root ``follows`` the first's;
    ``/v1/decisions`` must hold closed records (regret and savings
    printed); after ``inject {corrupt_chunks: 1}`` on every daemon a
    streamed client in the gateway's process must fall through a corrupt
    stream, and ``/v1/flight`` must hold its ``chunk_error`` dump. With
    ``console``, ``python -m repro_torch.obs.console --once`` then watches
    the gateway and its daemons (``console_check``). Returns the launch
    counts."""
    collect_profiles()
    import http.client
    import time
    import numpy as np
    import torch
    from repro_torch import clock
    from repro_torch.config import CacheConfig
    from repro_torch.core.client import EdgeClient
    from repro_torch.core.cluster.placement import PlacementPolicy
    from repro_torch.core.fabric import Fabric
    from repro_torch.gateway import Gateway, TenantQuota, protocol
    from repro_torch.obs.flight import CHUNK_ERROR
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.mla_decode import mla_decode
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.serving.engine import BatchedEngine
    from repro_torch.serving.scheduler import Request, Scheduler
    from repro_torch.workloads import MIXES

    kernels = (flash_prefill, flash_decode, ssd_scan, mla_decode)
    decode_k = mla_decode if model.cfg.uses_mla else flash_decode
    fp32 = model.dtype == torch.float32
    t_phase = clock.monotonic()
    mixes = {name: MIXES[name](GATEWAY_N, seed=0, rate_per_s=GATEWAY_RATE,
                               max_new_tokens=MAX_NEW_GW)
             for name in ("support", "rag", "agent")}
    # a prompt no mix shares: answered cold, its blobs replicated, then
    # asked again once its blob's primary owner is dead (never fetched
    # before, so the engine's broker holds no copy of it)
    probe = MIXES["support"](1, seed=1, max_new_tokens=MAX_NEW_GW)[0]
    fabric = Fabric.tcp(n_peers=FABRIC_PEERS, gossip_interval_s=GOSSIP_S,
                        request_timeout_s=FABRIC_TIMEOUT_S)
    gw = Gateway(model, fabric=fabric, batch_size=BATCH, max_len=max_len,
                 quotas={"over-quota": TenantQuota(rate_per_s=0.001,
                                                   burst=1)})
    tok = gw.tokenizer

    def direct(wls):                   # no gateway, no cache, this thread
        reqs = [Request(tokens=np.asarray(protocol.tokenize_messages(
            tok, wl.messages).token_ids, np.int32),
            max_new_tokens=wl.max_new_tokens) for wl in wls]
        Scheduler(BatchedEngine(model, max_len, BATCH)).run(reqs)
        return [r.stats.output_tokens for r in reqs]

    def direct_segs(segs):
        req = Request(tokens=np.asarray(segs.token_ids, np.int32),
                      max_new_tokens=MAX_NEW_GW)
        Scheduler(BatchedEngine(model, max_len, 1)).run([req])
        return req.stats.output_tokens

    want = {name: direct(wls) for name, wls in mixes.items()}
    torch.cuda.synchronize()
    out, shed = {}, {}
    with fabric:
        gw.start()
        try:
            for k in kernels:
                k.launches = 0
            for name, wls in mixes.items():
                out[name] = replay(gw.port, wls)
            over = mixes["support"][0]
            over.tenant = "over-quota"
            first, second = {}, {}
            _replay_one(gw.port, over, False, first)
            _replay_one(gw.port, over, False, second)
            shed[429] = (first.get("status"), second.get("status"),
                         second.get("retry_after"))
            cold, dead = {}, {}
            _replay_one(gw.port, probe, False, cold)
            gw.engine.fetcher.flush_uploads(GATEWAY_JOIN_S)
            segs = protocol.tokenize_messages(tok, probe.messages)
            digest = max(segs.keys(gw.engine.fetcher.meta),
                         key=lambda k: k.n_tokens).digest
            victim, replica = PlacementPolicy(sorted(
                fabric.peer_ids())).ring_order(digest)[:2]
            t_repl = clock.monotonic()
            while not fabric.supervisor.request(replica, "get",
                                                {"key": digest})["ok"]:
                if clock.monotonic() - t_repl > GATEWAY_JOIN_S:
                    raise AssertionError(f"[{label}] {replica} never got "
                                         f"its replica")
                time.sleep(GOSSIP_S)
            fabric.kill(victim, hard=True)
            _replay_one(gw.port, probe, False, dead)
            restarted = fabric.supervisor.check_and_restart()
            alive = fabric.supervisor.health()
            tree = traced_pair(gw, label)
            torch.cuda.synchronize()
            launches = {k.__name__: k.launches for k in kernels}
            n_steps = gw.engine.sched.n_steps
            decisions = _http_json(gw.port, "/v1/decisions")
            if console:
                console_check(gw.port, fabric.supervisor.addresses())
            # a corrupt stream in the gateway's process: a streamed
            # client's partial hit (the support mix's system prompt is
            # cached) against daemons that flip their next chunk
            for pid in fabric.peer_ids():
                fabric.supervisor.inject_faults(
                    pid, chaos={"corrupt_chunks": 1})
            ask = mixes["support"][0]
            corrupt_segs = protocol.tokenize_messages(
                tok, ask.messages[:-1] + (
                    ("user", "a question asked once, of a corrupt fleet"),))
            sc = EdgeClient("streamed",
                            InferenceEngine(model, max_len=max_len),
                            fabric.directory(), CacheConfig(), overlap=True)
            sc.sync_catalog()
            r_corrupt = sc.infer(corrupt_segs, MAX_NEW_GW,
                                 upload_on_miss=False)
            for pid in fabric.peer_ids():
                fabric.supervisor.inject_faults(pid, reset=True)
            flight = _http_json(gw.port, "/v1/flight")
            fstats = dict(gw.engine.fetcher.stats)
            restore_ts = list(gw.engine.fetcher.restore_s)
            fetch_ts = list(gw.engine.fetcher.fetch_s)
            step_ts = list(gw.engine.step_s)
            step_r_ts = list(gw.engine.step_after_restore_s)
            report = gw.report()
            http_stats = dict(gw.server.stats)
        finally:
            gw.stop()
    codes = fabric.supervisor.exit_codes()

    # 503: one slot, no queue, a stream holding it (its own engine)
    one = Gateway(model, batch_size=1, max_len=max_len, max_inflight=1,
                  queue_depth=0).start()
    try:
        hold = http.client.HTTPConnection("127.0.0.1", one.port, timeout=120)
        hold.request("POST", "/v1/completions", json.dumps(
            {"prompt": "hold the only slot " * 8, "max_tokens": 256,
             "stream": True}), {"Content-Type": "application/json"})
        held = hold.getresponse()
        line = held.readline()
        while line and b"token_id" not in line:
            line = held.readline()     # admitted once its first token is out
        if not line:
            raise AssertionError(f"[{label}] the held stream ended early")
        extra = {}
        _replay_one(one.port, probe, False, extra)
        held.read()
        hold.close()
        shed[503] = (extra.get("status"), extra.get("retry_after"))
    finally:
        one.stop()

    restore_s = [dt for _, dt in restore_ts]
    fetch_s = [dt for _, dt in fetch_ts]
    step_s = [dt for _, dt in step_ts]
    step_r_s = [dt for _, dt in step_r_ts]
    steps_ts = step_ts + step_r_ts
    agree, hits = {}, {}
    for name, (res, wall, t0) in out.items():
        # a burst past the slots and the queue is shed (503, Retry-After),
        # at most GATEWAY_SHED_MAX of a mix; anything else but a whole
        # answer fails the phase
        bad = [r for r in res if "error" in r or not (
            r.get("status") == 200
            and len(r.get("tokens", ())) == MAX_NEW_GW
            or r.get("status") == 503 and r.get("retry_after"))]
        if bad:
            raise AssertionError(f"[{label}] gateway {name}: failed "
                                 f"requests {bad[:3]}")
        shed[name] = sum(r["status"] == 503 for r in res)
        for i, r in enumerate(res):
            if r["status"] != 503:
                continue
            # what held the engine thread in the second before the shed
            t = r["t_status"]
            it_s, it_end = _longest(steps_ts, t - 1.0, t)
            get_s, get_end = _longest(fetch_ts, t - 1.0, t)
            print(f"[{label}] gateway {name} shed request {i} at "
                  f"+{(t - t0) * 1e3:.1f} ms: the longest engine iteration "
                  f"in the second before {it_s * 1e3:.3f} ms (ended "
                  f"+{(it_end - t0) * 1e3:.1f}), the longest GET "
                  f"{get_s * 1e3:.3f} ms (ended +{(get_end - t0) * 1e3:.1f})")
        agree[name] = [sum(x == y for x, y in zip(r["tokens"], w))
                       for r, w in zip(res, want[name])
                       if r["status"] == 200]
        hits[name] = [r["cache"] for r in res if "cache" in r
                      and r["cache"]["matched_tokens"] > 0]
        ttft = [r["ttft_s"] for r in res if "ttft_s" in r]
        ttlt = [r["ttlt_s"] for r in res if r["status"] == 200]
        print(f"[{label}] gateway {name} on {smi}: {len(res)} requests in "
              f"{wall * 1e3:.1f} ms ({GATEWAY_RATE:g}/s, {MAX_NEW_GW} new, "
              f"SSE {len(ttft)}, shed 503 {shed[name]}); client TTFT (SSE) "
              f"p50/p99 "
              f"{_ms(ttft, 50):.2f}/{_ms(ttft, 99):.2f} ms, TTLT p50/p99 "
              f"{_ms(ttlt, 50):.2f}/{_ms(ttlt, 99):.2f} ms; unary hits "
              f"{len(hits[name])} of "
              f"{sum('cache' in r for r in res)} answered "
              f"(matched {[h['matched_tokens'] for h in hits[name]]} "
              f"from {sorted({h['served_by'] for h in hits[name]})})")
    print(f"[{label}] gateway fetcher: {fstats}; shed: 429 {shed[429]}, "
          f"503 {shed[503]}; http {http_stats}; report shed "
          f"{report.shed_requests}")
    print(f"[{label}] gateway engine thread: restore ms per hit p50/max "
          f"{_ms(restore_s, 50):.3f}/{_ms(restore_s, 100):.3f} "
          f"({len(restore_s)} hits), GET ms p50/max {_ms(fetch_s, 50):.3f}/"
          f"{_ms(fetch_s, 100):.3f} ({len(fetch_s)} GETs); iteration ms "
          f"(inbox, resolves, one step) p50/p99 with a hit's restore "
          f"{_ms(step_r_s, 50):.3f}/"
          f"{_ms(step_r_s, 99):.3f} ({len(step_r_s)}) beside "
          f"{_ms(step_s, 50):.3f}/{_ms(step_s, 99):.3f} without "
          f"({len(step_s)})")
    recent = [r for r in decisions["recent"] if r.get("outcome")]
    tot = decisions["totals"]
    chunk_dumps = [d for d in flight["dumps"] if d["reason"] == CHUNK_ERROR
                   and d["context"].get("client") == "streamed"]
    print(f"[{label}] gateway trace of a hit down a kept-alive socket: "
          f"{tree['n_spans']} spans from {tree['procs']}, names "
          f"{tree['names']}; its root follows the previous request's "
          f"({tree['follows']})")
    print(f"[{label}] gateway decisions: {tot['commits']} closed of "
          f"{tot['decisions']}, regret {tot['regret_s'] * 1e3:.3f} ms, "
          f"savings {tot['savings_s'] * 1e3:.3f} ms in all, wins "
          f"{tot['wins']}, locals {tot['locals']}, learned local prefill "
          f"{(tot['prefill_s_per_tok'] or 0) * 1e6:.3f} us a token; "
          f"decode launches {launches[decode_k.__name__]} over {n_steps} "
          f"steps of {model.cfg.n_layers} layers")
    print(f"[{label}] gateway flight after inject corrupt_chunks=1 on "
          f"every daemon: a streamed client's request matched "
          f"{r_corrupt.matched_tokens} after {r_corrupt.unreadable_blobs} "
          f"corrupt streams; /v1/flight holds {len(flight['dumps'])} dumps, "
          f"{len(chunk_dumps)} chunk_error from it "
          f"({[d['context'].get('peer') for d in chunk_dumps]})")
    if not recent or any(r["outcome"].get("regret_s") is None
                         for r in recent):
        raise AssertionError(f"[{label}] gateway decisions not closed")
    if not chunk_dumps or not r_corrupt.unreadable_blobs:
        raise AssertionError(f"[{label}] gateway flight: no chunk_error "
                             f"dump after the corrupt streams")
    if fp32 and r_corrupt.output_tokens != direct_segs(corrupt_segs):
        raise AssertionError(f"[{label}] corrupt-stream fallback tokens "
                             f"differ from a direct run")
    if launches[decode_k.__name__] != n_steps * model.cfg.n_layers:
        raise AssertionError(f"[{label}] gateway decode launches "
                             f"{launches[decode_k.__name__]}, {n_steps} "
                             f"traced steps need {n_steps * model.cfg.n_layers}")
    print(f"[{label}] gateway tokens agreeing with direct runs, of "
          f"{MAX_NEW_GW}: {agree}; a fresh prompt cold "
          f"{cold.get('cache')}, then with its primary {victim} dead: status "
          f"{dead.get('status')} cache {dead.get('cache')}; restarted "
          f"{restarted}, health {alive}; daemons exit {codes}; launches "
          f"{launches}; phase {clock.monotonic() - t_phase:.1f} s")

    if any(shed[name] > GATEWAY_SHED_MAX for name in out):
        raise AssertionError(f"[{label}] gateway shed more than "
                             f"{GATEWAY_SHED_MAX} of {GATEWAY_N} requests "
                             f"in a mix: {shed}")
    if fp32 and any(a != MAX_NEW_GW for v in agree.values() for a in v):
        raise AssertionError(f"[{label}] gateway tokens differ from direct "
                             f"runs: {agree}")
    missing = [name for name, h in hits.items()
               if not any(x["served_by"].startswith("peer") for x in h)]
    if missing:
        raise AssertionError(f"[{label}] gateway: no peer-served hit in "
                             f"{missing}")
    if shed[429][:2] != (200, 429) or not shed[429][2] or \
            shed[503][0] != 503 or not shed[503][1]:
        raise AssertionError(f"[{label}] gateway shedding: {shed}")
    if cold.get("status") != 200 or dead.get("status") != 200 or \
            dead["tokens"] != cold["tokens"] or restarted != [victim] or \
            not alive[victim]:
        raise AssertionError(f"[{label}] gateway dead-peer drill: {dead}, "
                             f"restarted {restarted}, health {alive}")
    if fp32 and dead["tokens"] != direct([probe])[0]:
        raise AssertionError(f"[{label}] gateway dead-peer tokens differ")
    if any(c != 0 for c in codes.values()):
        raise AssertionError(f"[{label}] gateway daemons exit {codes}")
    if launches["flash_prefill"] <= 0 or launches[decode_k.__name__] <= 0:
        raise AssertionError(f"[{label}] gateway launches {launches}")
    return launches


def chaos_path(model, label, smi, max_len=1024):
    """The fault schedule replayed against the port's fabric: CHAOS_PEERS
    supervised daemons (``PeerSupervisor``), a ``FaultDriver`` over
    ``FaultSchedule.generate(CHAOS_SEED, ...)`` (every injectable kind:
    kill and revive, partition, corrupt chunks, stalled streams, a
    bandwidth collapse, delayed acks, each healed CHAOS_HEAL steps
    later), and one request a step from a port ``EdgeClient`` (streamed
    partial hits, hedged GETs, a deadline of CHAOS_DEADLINE_S) over the
    supervisor's directory, cycling through CHAOS_PROMPTS MMLU-style
    prompts. Every request must be answered (MAX_NEW tokens); fp32 tokens
    must equal a cold local run's; every daemon must exit 0; and every
    kind must be met by a request: one that sent the faulted peer, while
    the fault was live, an op the fault acts on (a chunk stream for
    corrupt and stall, a single-frame reply for delay_ack, any op for the
    others). Prints, by the fault kinds live at each request: requests,
    attempts by result (the fallthroughs), flight dumps by reason, TTFT
    p50 / max, and the requests that met the fault. The counts are set to
    0 just before the requests and read just after. Returns the launch
    counts."""
    collect_profiles()
    import time
    import numpy as np
    import torch
    from repro_torch import clock
    from repro_torch.chaos import FaultDriver, FaultSchedule
    from repro_torch.config import CacheConfig
    from repro_torch.core.client import EdgeClient
    from repro_torch.core.cluster.directory import PeerDirectory
    from repro_torch.core.net.supervisor import PeerSupervisor
    from repro_torch.core.netsim import WallClock
    from repro_torch.core.server import CacheServer
    from repro_torch.data.mmlu import MMLUGenerator
    from repro_torch.data.tokenizer import WordHashTokenizer
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.mla_decode import mla_decode
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.obs.flight import FLIGHT
    from repro_torch.obs.ledger import LEDGER
    from repro_torch.serving.engine import InferenceEngine

    kernels = (flash_prefill, flash_decode, ssd_scan, mla_decode)
    t_phase = clock.monotonic()
    gen = MMLUGenerator(WordHashTokenizer(model.cfg.vocab), n_shot=2)
    n_q = CHAOS_PROMPTS // len(CHAOS_DOMAINS)
    pool = [gen.prompt(d, q).segments for d in CHAOS_DOMAINS
            for q in range(n_q)]
    # a question of each domain that no request of the pool asks: a
    # probe's partial hit on its domain's prefix, streamed
    fresh = [gen.prompt(d, n_q).segments for d in CHAOS_DOMAINS]
    engine = InferenceEngine(model, max_len=max_len)
    cold = EdgeClient("cold", engine, CacheServer(CacheConfig()),
                      CacheConfig())
    want, want_fresh = ([cold.infer(p, MAX_NEW, upload_on_miss=False)
                         .output_tokens for p in ps] for ps in (pool, fresh))

    def acts_on(kind, stream):
        """Whether a fault of ``kind`` acts on an op (a chunk stream or a
        single-frame reply)."""
        return stream if kind in CHAOS_STREAM else \
            not stream if kind in CHAOS_REPLY else True

    def probe(ev, step):
        """Requests aimed at the faulted peer alone, while its fault is
        live: a client whose directory holds that peer's link only and
        keeps no catalog, so every range is asked of it (the step's pool
        prompt first, then each fresh question). They stop at the first
        that shows the fault: a dead attempt at the peer (kill,
        partition), a corrupt one (corrupt), or for the slowing kinds an
        attempt cut short, or an op the fault acts on that lasted the
        fault's seconds (stall, delay_ack) or CHAOS_SLOW_S (bandwidth).
        Returns a row a request."""
        link = next(ln for ln in sup.links() if ln.peer_id == ev.peer)
        pc = EdgeClient(f"probe-{ev.peer}", engine, PeerDirectory(
            [link], clock=WallClock(),
            suspect_cooldown_s=CHAOS_COOLDOWN_S), CacheConfig(),
            overlap=True, use_catalog=False)
        slow = ev.args.get("seconds") or CHAOS_SLOW_S
        out = []
        try:
            for p, ref in [(pool[step % len(pool)],
                            want[step % len(pool)])] + list(
                                zip(fresh, want_fresh)):
                r = pc.infer(p, MAX_NEW, upload_on_miss=False,
                             deadline_s=CHAOS_DEADLINE_S)
                rec = LEDGER.get(r.trace_id) or {"attempts": []}
                res = [a["result"] for a in rec["attempts"]]
                durs = [x["dur"] for x in pc.tracer.trace(r.trace_id) or []
                        if x["name"].startswith("net.")
                        and x["attrs"].get("peer") == ev.peer
                        and acts_on(ev.kind, bool(x["attrs"].get("stream")))]
                if ev.kind in ("kill", "partition"):
                    shown = "dead" in res
                elif ev.kind == "corrupt":
                    shown = "corrupt" in res
                else:
                    shown = any(x in ("cancelled", "dead", "deadline")
                                for x in res) or max(durs, default=0) >= slow
                out.append({"ttft": r.ttft_s, "results": res,
                            "longest": max(durs, default=0.0),
                            "shown": shown,
                            "ok": len(r.output_tokens) == MAX_NEW,
                            "same": r.output_tokens == ref})
                if shown:
                    break
        finally:
            link.close()
        return out
    LEDGER.clear()
    FLIGHT.clear()
    sup = PeerSupervisor.fleet(CHAOS_PEERS, gossip_interval_s=GOSSIP_S,
                               request_timeout_s=CHAOS_TIMEOUT_S)
    sched = FaultSchedule.generate(CHAOS_SEED, sorted(sup.procs),
                                   n_steps=CHAOS_STEPS,
                                   heal_after=CHAOS_HEAL)
    if FaultSchedule.from_json(sched.to_json()).event_order() != \
            sched.event_order():
        raise AssertionError(f"[{label}] chaos schedule JSON round trip")
    rows, live, probes = [], {}, []    # live: peer -> {kind}
    faults = {ev.fingerprint() for ev in sched.faults()}
    with sup:
        d = sup.directory(suspect_cooldown_s=CHAOS_COOLDOWN_S)
        c = EdgeClient("chaos", engine, d, CacheConfig(), overlap=True)
        drv = FaultDriver(sup, sched)
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        for step in range(CHAOS_STEPS):
            # the catalog sync first, then this step's faults: the request
            # is the first to reach a peer faulted at its step
            d.last_sync_t = -1e18
            c.sync_catalog()
            for ev in drv.advance(step):
                if ev in drv.skipped:  # aimed at a peer that is down
                    continue
                kinds = live.setdefault(ev.peer, set())
                if ev.kind == "revive":        # a fresh daemon, no faults
                    kinds.clear()
                elif ev.kind == "heal":
                    kinds -= {"partition", "corrupt", "stall", "delay_ack"}
                elif ev.kind == "bandwidth" and ev.args.get("bps") is None:
                    kinds.discard("bandwidth")
                else:
                    kinds.add(ev.kind)
                if ev.fingerprint() in faults:  # not a heal or a lift
                    probes.append((ev, probe(ev, step)))
            before = {id(x) for x in FLIGHT.dumps()}
            p = pool[step % len(pool)]
            r = c.infer(p, MAX_NEW, deadline_s=CHAOS_DEADLINE_S)
            rec = LEDGER.get(r.trace_id) or {"attempts": []}
            dumps = [x for x in FLIGHT.dumps() if id(x) not in before]
            rows.append({
                "kinds": sorted(set().union(*live.values())) or ["none"],
                "live": {pid: set(k) for pid, k in live.items()},
                "ttft": r.ttft_s, "case": r.case,
                "attempts": [(a["peer"], a["result"])
                             for a in rec["attempts"]],
                # the request's ops to each peer: (peer, a stream)
                "ops": [(x["attrs"].get("peer"), bool(x["attrs"].get(
                    "stream"))) for x in c.tracer.trace(r.trace_id) or []
                    if x["name"].startswith("net.")],
                "dumps": [(x["reason"], x["context"].get("peer"))
                          for x in dumps],
                "ok": len(r.output_tokens) == MAX_NEW,
                "same": r.output_tokens == want[step % len(pool)]})
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in kernels}
        drv.finish()
        drv.heal_all()
        repaired = sup.check_and_restart()
        time.sleep(GOSSIP_S)
        healthy = sup.health()
        cal = sup.fleet_calibration()
        hedges = (c.hedges, c.hedge_wins, c.stream_cancels)
    codes = sup.exit_codes()
    fp32 = model.dtype == torch.float32
    by_kind = {}
    for row in rows:
        for kind in row["kinds"]:
            by_kind.setdefault(kind, []).append(row)
    print(f"[{label}] chaos on {smi}: schedule seed {CHAOS_SEED}, "
          f"{len(sched.events)} events over {CHAOS_STEPS} steps "
          f"({sched.event_order()}); applied {len(drv.applied)}, skipped "
          f"{[e.fingerprint() for e in drv.skipped]}; supervised restarts "
          f"after the schedule {repaired}")
    met = {}                           # kind -> requests that met it
    for kind, rs in sorted(by_kind.items()):
        tt = [x["ttft"] for x in rs]
        att, dumps, at_peer, named = {}, {}, {}, 0
        met[kind] = 0
        for x in rs:
            faulted = {pid for pid, k in x["live"].items() if kind in k}
            for pid, res in x["attempts"]:
                att[res] = att.get(res, 0) + 1
                if pid in faulted:
                    at_peer[res] = at_peer.get(res, 0) + 1
            for reason, pid in x["dumps"]:
                dumps[reason] = dumps.get(reason, 0) + 1
                named += pid in faulted
            met[kind] += any(pid in faulted and acts_on(kind, stream)
                             for pid, stream in x["ops"])
        print(f"[{label}] chaos {kind}: {len(rs)} requests, cases "
              f"{[x['case'] for x in rs]}, attempts {att}, flight dumps "
              f"{dumps}, TTFT p50/max {_ms(tt, 50):.2f}/{_ms(tt, 100):.2f}"
              f" ms" + ("" if kind == "none" else
                        f"; met by {met[kind]} (an op to the faulted peer "
                        f"that the fault acts on), attempts at that peer "
                        f"{at_peer}, dumps naming it {named}"))
    for ev, out in probes:
        print(f"[{label}] chaos probe of {ev.fingerprint()}: "
              f"{len(out)} requests at {ev.peer} alone, attempt results "
              f"{[x['results'] for x in out]}, longest op the fault acts on"
              f" {[round(x['longest'] * 1e3, 2) for x in out]} ms, TTFT "
              f"{[round(x['ttft'] * 1e3, 2) for x in out]} ms; fault shown "
              f"{out[-1]['shown']}")
    rows_all = rows + [x for _, out in probes for x in out]
    answered = sum(x["ok"] for x in rows_all)
    same = sum(x["same"] for x in rows_all)
    print(f"[{label}] chaos: {answered} of {len(rows_all)} requests "
          f"answered ({len(rows)} a step, {len(rows_all) - len(rows)} "
          f"probes), tokens equal to a cold run {same} of {len(rows_all)}; "
          f"hedges fired/won {hedges[0]}/{hedges[1]}, streams cut "
          f"{hedges[2]}; ledger {LEDGER.totals()}; links learned "
          + "; ".join(f"{pid} {sorted(v.get('links', {}))}"
                      for pid, v in sorted(cal.items()))
          + f"; daemons exit {codes}; launches {launches}; phase "
          f"{clock.monotonic() - t_phase:.1f} s")
    if answered != len(rows_all) or (fp32 and same != len(rows_all)):
        raise AssertionError(f"[{label}] chaos: answered {answered}, same "
                             f"tokens {same} of {len(rows_all)}")
    shown = {ev.kind for ev, out in probes if out[-1]["shown"]}
    if shown != set(CHAOS_KINDS):
        raise AssertionError(f"[{label}] chaos: no probe showed the fault "
                             f"kinds {set(CHAOS_KINDS) - shown}")
    if not all(healthy.values()) or any(c != 0 for c in codes.values()):
        raise AssertionError(f"[{label}] chaos: health {healthy}, daemons "
                             f"exit {codes}")
    if launches["flash_prefill"] <= 0 or launches["flash_decode"] <= 0:
        raise AssertionError(f"[{label}] chaos launches {launches}")
    LEDGER.clear()
    return launches


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
    try:
        head_ms, clock_name = device_ms(lambda: x @ w), "profiler"
    except RuntimeError as e:
        # on some models the profiler records half of this call's device
        # events in every window (PERF.md §7); the call is device-bound,
        # so CUDA events around each call time it. This line only: the
        # kernels' rows take no such fallback
        head_ms, clock_name = time_ms(lambda: x @ w), f"CUDA events: {e}"
    head_bytes = w.numel() * w.element_size()
    # a decode step's device time, from 4 steps alone
    st = eng.start({"tokens": toks})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.generate(st, 4)
        torch.cuda.synchronize()
    step_ms = sum(_dev_us(e) for e in _device_rows(prof)) / 4 / 1e3
    print(f"{'tied' if tied else 'untied'} head matmul alone: "
          f"{head_ms:.4f} ms on the device for {head_bytes / 1e6:.1f} MB "
          f"of weights (bytes bound {head_bytes / MEM_BW * 1e3:.4f} ms; "
          f"timed by the {clock_name}); a decode step's device time "
          f"{step_ms:.4f} ms (profiler, 4 steps), the head "
          f"{head_ms / step_ms:.3f} of it")


def cpu_cross_check(model_fp32, prompt, n_layers):
    """The first ``n_layers`` of the fp32 model on the card and on the CPU
    (the plain path), on the same prompt: last logits within 1e-4."""
    import numpy as np
    from repro_torch.serving.engine import InferenceEngine
    toks = np.asarray(prompt.token_ids, np.int32)[None]
    logits = {}
    for dev in ("cuda", "cpu"):
        m = cut_model(model_fp32, n_layers, dev)
        cfg = m.cfg
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


def vlm_roundtrip(models):
    """The reference's VLM round trip (``tests/test_mrope_vlm.py``) at
    full width on the card: a prefill from 16 stub patch embeddings whose
    image patches (positions 4..7) share a temporal index on a 2x2
    height/width grid, against a prefill of 10 and a resume of 6, then
    one decode step on each. fp32 must agree within VLM_TOL; bf16 is
    printed beside."""
    import numpy as np
    import torch
    for m in models:
        cfg, S = m.cfg, 16
        rng = np.random.default_rng(1)
        embeds = (rng.normal(size=(1, S, cfg.d_model)) * 0.02).astype(
            np.float32)
        pos_t, pos_h, pos_w = np.arange(S), np.arange(S), np.arange(S)
        pos_h[4:8] = [4, 4, 5, 5]
        pos_w[4:8] = [4, 5, 4, 5]
        positions = np.stack([pos_t, pos_h, pos_w])[:, None, :]

        def inputs(sl):
            return {"embeds": embeds[:, sl], "positions": positions[:, :, sl]}
        lg, c1 = m.prefill(inputs(slice(None)), m.init_cache(1, 24))
        _, c2 = m.prefill(inputs(slice(0, 10)), m.init_cache(1, 24))
        lg2, c2 = m.prefill(inputs(slice(10, None)), c2, start_pos=10,
                            resume=True)
        tok = np.asarray([[7]], np.int32)
        d1, _ = m.decode_step(c1, tok, S)
        d2, _ = m.decode_step(c2, tok, S)
        torch.cuda.synchronize()
        fp32 = m.dtype == torch.float32
        errs = {}
        for tag, a, b in (("prefill", lg, lg2), ("decode", d1, d2)):
            a, b = a[:, :cfg.vocab], b[:, :cfg.vocab]
            errs[tag] = ((a - b).abs().max().item(),
                         torch.allclose(a, b, **VLM_TOL),
                         bool(torch.isfinite(a).all()))
        print(f"[{cfg.name} {'fp32' if fp32 else 'bf16'}] VLM round trip "
              f"(16 stub embeddings, M-RoPE image positions; one-shot vs 10 "
              f"+ resume of 6): " + "; ".join(
                  f"{tag} max |logit diff| {e:.3g} within {VLM_TOL} {ok}"
                  for tag, (e, ok, _) in errs.items())
              + f" ({'checked' if fp32 else 'printed only'})")
        if not all(fin for _, _, fin in errs.values()) or \
                fp32 and not all(ok for _, ok, _ in errs.values()):
            raise AssertionError(f"[{cfg.name}] VLM round trip: {errs}")


def step_host_calls(model, label):
    """The host's kernel launch calls (``LAUNCH_APIS``) and the device's
    device-to-host copies of one ``decode_batch`` step of BATCH slots at
    their own positions, each the same in two one-step profiler windows."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import BatchedEngine
    e = BatchedEngine(model, 1024, BATCH)
    rng = np.random.default_rng(0)
    e.prefill_slots(list(range(BATCH)), [
        rng.integers(3, model.cfg.vocab, n) for n in (40, 9, 77, 20)])
    toks = np.full(BATCH, 5, np.int32)
    for _ in range(3):
        e.decode_batch(toks)
    torch.cuda.synchronize()
    seen = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            e.decode_batch(toks)
            torch.cuda.synchronize()
        seen.append((launch_calls(prof), sum(
            e_.count for e_ in prof.key_averages() if "DtoH" in e_.key)))
    if seen[0] != seen[1]:
        raise AssertionError(f"[{label}] one decode step's host calls "
                             f"differ between windows: {seen}")
    return seen[0]


def moe_host_check(model, label, llama_calls):
    """A MoE model's ``decode_batch`` step makes no more device-to-host
    copies than a llama3.2-1b step (``llama_calls``): the MoE layers read
    nothing on the host."""
    calls, dtoh = step_host_calls(model, label)
    print(f"[{label}] a decode_batch step at B={BATCH}: kernel launch calls "
          f"on the host {calls} ({model.cfg.n_layers} MoE layers), "
          f"device-to-host copies {dtoh} (llama3.2-1b at 4 layers: "
          f"{llama_calls[0]} launch calls, {llama_calls[1]} copies)")
    if dtoh > llama_calls[1]:
        raise AssertionError(f"[{label}] a MoE decode step made {dtoh} "
                             f"device-to-host copies, llama3.2-1b's "
                             f"{llama_calls[1]}")


def mrope_check(model, llama_calls):
    """M-RoPE adds no host sync to a decode step: a step of ``model``
    (qwen2-vl-2b) makes the kernel launch calls of the same step with the
    config's rope set to ``standard`` (the same weights) plus the band
    gather's, one ``index_select`` for q and one for k a layer, and no
    more device-to-host copies than a llama3.2-1b step (``llama_calls``)."""
    import torch
    from repro_torch.models.model import Model
    cfg = model.cfg
    twin = Model(cfg.replace(rope="standard", mrope_sections=()),
                 dtype=model.dtype, device=model.device, seed=None)
    twin.load_state_dict(model.state_dict(), assign=True)
    label = f"{cfg.name} {'bf16' if model.dtype != torch.float32 else 'fp32'}"
    (m_calls, m_copies) = step_host_calls(model, label)
    (s_calls, s_copies) = step_host_calls(twin, label + " standard rope")
    extra = 2 * cfg.n_layers
    print(f"[{label}] a decode_batch step at B={BATCH}: kernel launch calls "
          f"on the host {m_calls} with M-RoPE, {s_calls} with standard rope "
          f"(+{m_calls - s_calls}, the band gathers: {extra} = 2 x "
          f"{cfg.n_layers} layers); device-to-host copies {m_copies} "
          f"(standard {s_copies}, llama3.2-1b {llama_calls[1]})")
    if m_calls != s_calls + extra or m_copies > llama_calls[1]:
        raise AssertionError(f"[{label}] M-RoPE step: calls {m_calls} vs "
                             f"{s_calls} + {extra}, copies {m_copies} vs "
                             f"llama's {llama_calls[1]}")


def wide_path(name, launches, launches32):
    """``name`` at full width cut to WIDE_LAYERS layers: in fp32 client A
    misses (Case 1, uploads) and client B adopts A's prompt (Case 5), both
    with the tokens of a cold run; in bf16 one Case 1 request, its tokens
    printed. The counts are set to 0 just before each dtype's requests
    and read just after: one prefill and MAX_NEW decode steps a request,
    once a layer. Then the CPU cross-check at 1 layer."""
    collect_profiles()
    import torch
    from repro_torch import clock
    from repro_torch.config import CacheConfig
    from repro_torch.core.client import EdgeClient
    from repro_torch.core.server import CacheServer
    from repro_torch.data.mmlu import MMLUGenerator
    from repro_torch.data.tokenizer import WordHashTokenizer
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.serving.engine import InferenceEngine
    t0 = clock.monotonic()
    m32, m16 = model_pair(name, WIDE_LAYERS)
    L = m32.cfg.n_layers
    gen = MMLUGenerator(WordHashTokenizer(m32.cfg.vocab), n_shot=5)
    p_a = gen.prompt("astronomy", 0).segments
    for m, total in ((m32, launches32), (m16, launches)):
        fp32 = m is m32
        label = f"{name} at {L} layers {'fp32' if fp32 else 'bf16'}"
        server = CacheServer(CacheConfig())

        def client(cname, srv=server):
            return EdgeClient(cname, InferenceEngine(m, max_len=1024), srv,
                              CacheConfig())
        client("warm", CacheServer(CacheConfig())).infer(
            gen.prompt("anatomy", 3).segments, max_new_tokens=2,
            upload_on_miss=False)
        for k in (flash_prefill, flash_decode):
            k.launches = 0
        runs = [client("A").infer(p_a, MAX_NEW)]
        if fp32:
            b = client("B")
            b.sync_catalog()
            runs.append(b.infer(p_a, MAX_NEW))
        got = {k.__name__: k.launches for k in (flash_prefill, flash_decode)}
        want = {"flash_prefill": L, "flash_decode": len(runs) * MAX_NEW * L}
        for k in got:
            total[k] += got[k]
        cold = client("cold", CacheServer(CacheConfig())).infer(
            p_a, MAX_NEW, upload_on_miss=False)
        for r in runs:
            print(f"[{label}] case {r.case} matched {r.matched_tokens}/"
                  f"{r.prompt_tokens} ttft {r.ttft_s * 1e3:.2f} ms ttlt "
                  f"{r.ttlt_s * 1e3:.2f} ms; tokens {r.output_tokens}")
        print(f"[{label}] cold run's tokens {cold.output_tokens}; launches "
              f"{got} (the requests need {want})")
        if [r.case for r in runs] != ([1, 5] if fp32 else [1]) or \
                got != want:
            raise AssertionError(f"[{label}] cases "
                                 f"{[r.case for r in runs]}, launches {got}")
        if any(len(r.output_tokens) != MAX_NEW or not all(
                0 <= t < m.cfg.vocab for t in r.output_tokens)
               for r in runs + [cold]):
            raise AssertionError(f"[{label}] malformed output")
        if fp32 and any(r.output_tokens != cold.output_tokens for r in runs):
            raise AssertionError(f"[{label}] tokens differ from the cold run")
    cpu_cross_check(m32, p_a, 1)
    del m32, m16
    torch.cuda.empty_cache()
    print(f"[{name}] seconds: {clock.monotonic() - t0:.1f} (weights "
          f"included)")


def moe_step_split(model, prompt):
    """A MoE model's decode step (B=1) by part: the step's wall ms (host
    clock, 8 steps) and device ms (profiler, 4 steps), and each part of
    one layer timed alone at that layer's decode inputs (layer 0, the
    cache after the prompt): the attention sublayer, and the MoE's route,
    sort (``dispatch``), the three moe_gemm products, the gated
    activation and the combine. For each part its wall ms a call (host
    clock over 20 back-to-back calls and a synchronise: the host's
    dispatch where that is longer than the kernels, as in a decode step)
    and its device ms and CUDA kernels a call (the profiler over 20 calls,
    ``profile_call``; a window that loses events reads low, and the
    kernel count shows it). Layers times a part is its share of the
    step; the rest is the norms, residual adds, embedding and head."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import clock
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.models import attention as attn
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import activation, apply_norm
    from repro_torch.serving.engine import InferenceEngine
    collect_profiles()
    cfg, L = model.cfg, model.cfg.n_layers
    eng = InferenceEngine(model, max_len=1024)
    st = eng.start({"tokens": np.asarray(prompt.token_ids, np.int32)[None]})
    eng.generate(st, 4)
    torch.cuda.synchronize()
    t0 = clock.monotonic()
    eng.generate(st, 8)
    torch.cuda.synchronize()
    wall = (clock.monotonic() - t0) / 8 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.generate(st, 4)
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    busy = sum(_dev_us(e) for e in rows) / 4 / 1e3
    n_kern = sum(e.count for e in rows) / 4
    lp = tf.layer_params(model.segments[0].tree(), 0)
    lc = tf.layer_params(st.cache["segments"][0], 0)
    p = lp["moe"]
    x1 = torch.randn((1, 1, cfg.d_model), device=model.device,
                     dtype=model.dtype)
    xf = apply_norm(lp["ln2"], x1).reshape(1, -1)
    w, ids, _ = moe.route(p, cfg, xf, aux=False)
    d = moe.dispatch(xf, w, ids, p["w_up"].shape[0])
    up, gate = (moe_gemm(d.xs, p[k], d.offsets) for k in ("w_up", "w_gate"))
    h = activation(gate, cfg.act) * up
    y = moe_gemm(h, p["w_down"], d.offsets)
    parts = {
        "attention sublayer": lambda: attn.attn_decode(
            lp["attn"], cfg, apply_norm(lp["ln1"], x1), st.pos, lc),
        "route": lambda: moe.route(p, cfg, xf, aux=False),
        "sort": lambda: moe.dispatch(xf, w, ids, p["w_up"].shape[0]),
        "moe_gemm x3": lambda: (moe_gemm(d.xs, p["w_up"], d.offsets),
                                moe_gemm(d.xs, p["w_gate"], d.offsets),
                                moe_gemm(h, p["w_down"], d.offsets)),
        "activation": lambda: activation(gate, cfg.act) * up,
        "combine": lambda: moe.combine(y, d),
    }
    def part_wall(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        t0 = clock.monotonic()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (clock.monotonic() - t0) / iters * 1e3

    got = {name: (part_wall(fn),) + profile_call(fn, iters=20)[::-1]
           for name, fn in parts.items()}
    moe_wall, moe_dev = (sum(g[i] for name, g in got.items()
                             if name != "attention sublayer") * L
                         for i in (0, 1))
    att = got["attention sublayer"]
    print(f"[{cfg.name} {str(model.dtype)[6:]}] decode step (B=1, {L} "
          f"layers): wall {wall:.2f} ms, device {busy:.3f} ms in "
          f"{n_kern:g} CUDA kernels (idle share {1 - busy / wall:.3f}); "
          f"a layer's parts, wall ms / device ms (CUDA kernels) a call: "
          + ", ".join(f"{n} {w:.4f} / {d:.4f} ({k:g})"
                      for n, (w, d, k) in got.items())
          + f"; x {L} layers, wall / device: attention {att[0] * L:.2f} / "
          f"{att[1] * L:.3f} ms, MoE {moe_wall:.2f} / {moe_dev:.3f} ms "
          f"(moe_gemm {got['moe_gemm x3'][0] * L:.2f} / "
          f"{got['moe_gemm x3'][1] * L:.3f}), the rest "
          f"{wall - moe_wall - att[0] * L:.2f} / "
          f"{busy - moe_dev - att[1] * L:.3f} ms")


def moe_cut_path(smi):
    """deepseek-v3-671b at full width cut to its three dense MLA layers and
    its first MoE layer (``moe_cut``; 15.1B parameters, ~30 GB), drawn in
    bf16 on the card (an fp32 copy beside it would not fit): A misses
    (Case 1) and uploads, B adopts A's prompt (Case 5, the tokens of Case
    1) and resumes a partial hit (Case 4, printed). The counts are set to
    0 just before the requests and read just after: flash_prefill and
    mla_decode once a layer a prefill and a decode step, moe_gemm three
    times. The model is freed at the end. Returns the launches."""
    collect_profiles()
    import numpy as np
    import torch
    from repro_torch import clock
    from repro_torch.config import CacheConfig
    from repro_torch.configs import get_config
    from repro_torch.configs.deepseek_v3_671b import moe_cut
    from repro_torch.core.client import EdgeClient
    from repro_torch.core.server import CacheServer
    from repro_torch.data.mmlu import MMLUGenerator
    from repro_torch.data.tokenizer import WordHashTokenizer
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.mla_decode import mla_decode
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.models.model import Model, padded_vocab
    from repro_torch.serving.engine import InferenceEngine
    t0 = clock.monotonic()
    cfg = moe_cut(get_config("deepseek-v3-671b"), 1)
    label = f"{cfg.name} moe_cut(1) bf16"
    torch.cuda.reset_peak_memory_stats()
    m = Model(cfg, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in m.parameters()) / 1e6
    print(f"[{label}] L={cfg.n_layers} ({cfg.moe.first_k_dense} dense MLA, "
          f"{cfg.n_layers - cfg.moe.first_k_dense} MoE: {cfg.moe}), "
          f"{cfg.param_count() / 1e6:.1f}M params by param_count, {n:.1f}M "
          f"stored, random weights (seed 0) drawn in bf16 in "
          f"{clock.monotonic() - t0:.1f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB ({smi})")
    gen = MMLUGenerator(WordHashTokenizer(cfg.vocab), n_shot=5)
    p_a = gen.prompt("astronomy", 0).segments
    p_b = gen.prompt("astronomy", 1).segments
    server = CacheServer(CacheConfig())

    def client(name, srv=server):
        return EdgeClient(name, InferenceEngine(m, max_len=1024), srv,
                          CacheConfig())
    client("warm", CacheServer(CacheConfig())).infer(
        gen.prompt("anatomy", 3).segments, max_new_tokens=2,
        upload_on_miss=False)
    kernels = (flash_prefill, mla_decode, moe_gemm)
    for k in kernels:
        k.launches = 0
    t1 = clock.monotonic()
    r1 = client("A").infer(p_a, MAX_NEW)
    b = client("B")
    b.sync_catalog()
    r5 = b.infer(p_a, MAX_NEW)
    r4 = b.infer(p_b, MAX_NEW)
    launches = {k.__name__: k.launches for k in kernels}
    want = path_launches(cfg, 2, 3 * MAX_NEW)
    for tag, r in (("A miss", r1), ("B full", r5), ("B partial", r4)):
        t = r.timings
        print(f"[{label}] {tag}: case {r.case} matched {r.matched_tokens}/"
              f"{r.prompt_tokens} ttft {r.ttft_s * 1e3:.2f} ms ttlt "
              f"{r.ttlt_s * 1e3:.2f} ms up {r.blob_bytes_up} B down "
              f"{r.blob_bytes_down} B | restore {t['restore_s'] * 1e3:.2f} "
              f"prefill {t['prefill_s'] * 1e3:.2f} decode "
              f"{t['decode_s'] / max(len(r.output_tokens), 1) * 1e3:.2f} "
              f"ms/tok; tokens {r.output_tokens}")
    print(f"[{label}] launches {launches} (the requests need {want}); "
          f"requests {clock.monotonic() - t1:.1f} s")
    if [r.case for r in (r1, r5, r4)] != [1, 5, 4]:
        raise AssertionError(f"[{label}] cases "
                             f"{[r.case for r in (r1, r5, r4)]}")
    if launches != want:
        raise AssertionError(f"[{label}] launches {launches}, the path "
                             f"needs {want}")
    if r5.output_tokens != r1.output_tokens:
        raise AssertionError(f"[{label}] Case 5 tokens {r5.output_tokens} "
                             f"differ from Case 1's {r1.output_tokens}")
    eng = InferenceEngine(m, max_len=1024)
    lg = eng.start({"tokens": np.asarray(p_b.token_ids, np.int32)[None]}
                   ).last_logits
    if lg.shape != (1, padded_vocab(cfg.vocab)) or \
            not np.isfinite(lg).all() or any(
                len(r.output_tokens) != MAX_NEW or not all(
                    0 <= t < cfg.vocab for t in r.output_tokens)
                for r in (r1, r5, r4)):
        raise AssertionError(f"[{label}] malformed output")
    del m, eng
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{label}] seconds: {clock.monotonic() - t0:.1f} (weights "
          f"included)")
    return launches


def serve_check():
    """``python -m repro_torch.launch.serve``: a ``server`` process, and a
    ``client`` process at SERVE_ARCH's full width (``--no-reduced``) on
    the card working SERVE_PROMPTS prompts of one domain over TCP (a miss,
    then partial hits). The client must exit 0 with a case line a prompt,
    and the server 0 after SIGINT."""
    import re
    import signal
    from repro_torch import clock
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    t0 = clock.monotonic()
    srv = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "server",
         "--port", "0"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        first = srv.stdout.readline()
        port = re.search(r"tcp://127\.0\.0\.1:(\d+)", first)
        if port is None:
            raise AssertionError(f"serve server printed {first!r}")
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "client",
             "--port", port.group(1), "--arch", SERVE_ARCH, "--no-reduced",
             "--prompts", str(SERVE_PROMPTS), "--domains", "1"], env=env,
            capture_output=True, text=True, timeout=SERVE_WAIT_S)
    finally:
        srv.send_signal(signal.SIGINT)
        try:
            out, err = srv.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            srv.kill()
            out, err = srv.communicate()
    lines = cli.stdout.splitlines()
    for line in lines:
        print(f"[serve client] {line}")
    print(f"[serve server] exit {srv.returncode}: "
          f"{(first + out).strip().splitlines()[-1]}; both processes "
          f"{clock.monotonic() - t0:.1f} s")
    cases = [int(m.group(1)) for m in (re.search(r" case=(\d)", ln)
                                       for ln in lines) if m]
    if cli.returncode != 0 or srv.returncode != 0 or \
            len(cases) != SERVE_PROMPTS or cases[0] != 1 or \
            4 not in cases or "(L=16 d=2048) on cuda" not in lines[0]:
        raise AssertionError(f"serve: client exit {cli.returncode} cases "
                             f"{cases}, server exit {srv.returncode}; "
                             f"{cli.stderr[-2000:]} {err[-2000:]}")


def console_check(port, addresses):
    """``python -m repro_torch.obs.console --once`` against the gateway on
    ``port`` and its daemons (``addresses``: {peer_id: (host, port)}) plus
    one dead daemon: a row a live daemon, and DOWN for the dead one."""
    import socket
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{sk.getsockname()[1]}"
    peers = [f"{h}:{p}" for h, p in addresses.values()] + [dead]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.console", "--once",
         "--gateway", f"127.0.0.1:{port}", "--peers", ",".join(peers)],
        env=env, capture_output=True, text=True, timeout=60)
    lines = proc.stdout.splitlines()
    for line in lines:
        print(f"[console --once] {line}")
    rows = {pid: any(ln.split()[:2] == [pid, f"{h}:{p}"] for ln in lines)
            for pid, (h, p) in addresses.items()}
    down = [ln for ln in lines if ln.split() == [dead, "DOWN"]]
    if proc.returncode != 0 or not all(rows.values()) or len(down) != 1 or \
            f"gateway http://127.0.0.1:{port}" not in lines:
        raise AssertionError(f"console: exit {proc.returncode}, daemon rows "
                             f"{rows}, DOWN rows {down}; {proc.stderr}")


def cut_model(model, n_layers, device="cuda"):
    """``model`` cut to its first ``n_layers`` layers (its weights and
    dtypes) on ``device``."""
    from repro_torch.models.model import Model
    m = Model(cut(model.cfg, n_layers), dtype=model.dtype, device=device,
              seed=None)
    m.load_state_dict({k: (t[:n_layers] if k.startswith("segments.")
                           else t).to(device)
                       for k, t in model.state_dict().items()})
    return m


def cut(cfg, n_layers):
    """``cfg`` at ``n_layers`` layers; a deepseek-style config (leading
    dense MLA layers) keeps them all dense MLA, its MoE segment empty. A
    MoE config with no leading dense layer (granite) keeps its MoE
    layers."""
    if cfg.moe.first_k_dense and cfg.uses_mla:
        from repro_torch.configs.deepseek_v3_671b import dense_cut
        return dense_cut(cfg, n_layers)
    return cfg.replace(n_layers=n_layers)


def model_pair(name, n_layers=None):
    """fp32 and bf16 copies of one randomly initialised model on the card
    (seed 0, drawn once on the card; the bf16 copy is the fp32 one cast,
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
        {"ssm": cfg.ssm, "window": cfg.window,
         "meta_tokens": cfg.n_meta_tokens} if cfg.family == "hybrid" else \
        {"mla": cfg.mla, "dense_ff": cfg.moe.dense_ff} if cfg.uses_mla else \
        {"moe": cfg.moe} if cfg.family == "moe" else {}
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
    smi = device_line()
    import torch
    from repro_torch import clock
    t_script = clock.monotonic()
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.mla_decode import mla_decode
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.kernels.ssd_scan import ssd_scan
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_phase()
    rows = kernel_checks()
    rows["ssd_scan"] = ssd_checks()
    rows["mla_decode"] = mla_checks()
    print(f"kernel checks: {clock.monotonic() - t_script:.1f} s after the "
          f"device line")
    rows["moe_gemm"] = moe_checks()
    print(f"moe_gemm checks: {clock.monotonic() - t_script:.1f} s after the "
          f"device line")

    wrappers = {k.__name__: k for k in (flash_prefill, flash_decode,
                                        ssd_scan, mla_decode, moe_gemm)}

    def needs(cfg):
        """Launches each path needs, by wrapper: 4 requests of MAX_NEW
        decode steps; 3 prefills with a KV cache (A's miss, B's suffix,
        the fallback), 6 with a recurrent state (and A's 3 shorter ranges
        at upload)."""
        recurrent = cfg.family in ("ssm", "hybrid")
        return {wrappers[n]: c for n, c in path_launches(
            cfg, 6 if recurrent else 3, 4 * MAX_NEW).items()}

    launches = {k: 0 for k in SOURCES}
    launches32 = dict(launches)
    # first, on an empty card: deepseek-v3 with its first MoE layer, bf16
    for k, n in moe_cut_path(smi).items():
        launches[k] += n
    served = []                        # (name, bf16, fp32) of GATEWAY_PATHS
    llama_calls = None                 # a llama3.2-1b decode step's host calls
    for name, n_layers, cross_layers, edge, batched_layers in PATHS:
        t_model = clock.monotonic()
        m32, m16 = model_pair(name, n_layers)
        expect = needs(m32.cfg)
        for m, total in ((m16, launches), (m32, launches32)):
            label = f"{name} {'bf16' if m is m16 else 'fp32'}"
            t0 = clock.monotonic()
            if edge:
                got, streamed, prompts, refs = edge_path(m, label, expect)
                t1 = clock.monotonic()
                fab = fabric_path(m, label, expect, prompts, refs)
                for k in got:
                    total[k] += got[k] + streamed[k] + fab[k]
            t2 = clock.monotonic()
            if m.cfg.window:
                for k, n in wrapped_ring_path(m, label, expect).items():
                    total[k] += n
            t3 = clock.monotonic()
            full = m
            if batched_layers:
                m = cut_model(m, batched_layers)
            for k, n in batched_path(m, label + (
                    f" at {batched_layers} of {full.cfg.n_layers} layers (cut"
                    f" to keep the script's time)" if batched_layers
                    else "")).items():
                total[k] += n
            if m.dtype == torch.bfloat16 and name == "llama3.2-1b":
                llama_calls = step_host_calls(m, label)
            if m.dtype == torch.bfloat16 and m.cfg.rope == "mrope":
                mrope_check(m, llama_calls)
            if m.dtype == torch.bfloat16 and m.cfg.family == "moe" and \
                    not m.cfg.uses_mla:
                moe_host_check(m, label, llama_calls)
            print(f"[{label}] seconds: "
                  + (f"edge {t1 - t0:.1f}, fabric {t2 - t1:.1f}, "
                     if edge else "")
                  + (f"past the wrap {t3 - t2:.1f}, " if m.cfg.window else "")
                  + f"batched {clock.monotonic() - t3:.1f}")
            del m, full
        if edge:
            where_time_goes(m16, prompts[0])
            if m16.cfg.family == "moe" and not m16.cfg.uses_mla:
                moe_step_split(m16, prompts[0])
            cpu_cross_check(m32, prompts[1], cross_layers or m32.cfg.n_layers)
        if m32.cfg.family == "vlm":
            vlm_roundtrip((m32, m16))
        if name in GATEWAY_PATHS:
            served.append((name, m16, m32))
        del m32, m16
        torch.cuda.empty_cache()
        print(f"[{name}] all its phases, both dtypes: "
              f"{clock.monotonic() - t_model:.1f} s")
    for name in WIDE_PATHS:
        wide_path(name, launches, launches32)
    serve_check()
    # the gateway phases come last: after one, the profiler loses device
    # events from its windows (PERF.md §7), and every profiler reading
    # above is taken before; the first also runs the console against its
    # fleet
    for i, (name, m16, m32) in enumerate(served):
        for m, total in ((m16, launches), (m32, launches32)):
            label = f"{name} {'bf16' if m is m16 else 'fp32'}"
            for k, n in gateway_path(m, label, smi,
                                     console=i == 0 and m is m16).items():
                total[k] += n
    # the chaos phase, after the gateway phases, on gemma3-270m
    for name, m16, m32 in served:
        if name != CHAOS_PATH:
            continue
        for m, total in ((m16, launches), (m32, launches32)):
            label = f"{name} {'bf16' if m is m16 else 'fp32'}"
            for k, n in chaos_path(m, label, smi).items():
                total[k] += n
    del served

    out = []
    for name in SOURCES:
        r = rows[name]
        out.append({"name": name, "route": "cuda", "source": SOURCES[name][0],
                    "replaces": SOURCES[name][1], "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(f"main-path launches, all paths: bf16 {launches}, fp32 "
          f"{launches32}; script {clock.monotonic() - t_script:.1f} s after "
          f"the device line")
    most = max(GC_FREED)
    print(f"cyclic garbage collected before the timed phases: "
          f"{sum(n for n, _ in GC_FREED)} objects in "
          f"{sum(t for _, t in GC_FREED):.3f} s over {len(GC_FREED)} "
          f"collections, the largest {most[0]} objects in {most[1]:.3f} s")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
