"""Serving launcher: run the cache server, or an edge client, over TCP.

  # terminal 1 — the "cache box" (no torch needed to serve blobs)
  PYTHONPATH=src python -m repro_torch.launch.serve server --port 7077

  # terminal 2..N — edge clients working an MMLU stream, on the card
  PYTHONPATH=src python -m repro_torch.launch.serve client --port 7077 \
      --arch llama3.2-1b --no-reduced --prompts 10

The port's counterpart of ``repro.launch.serve``. The client runs the
config's ``reduced()`` variant unless ``--no-reduced`` asks for its full
width and depth (the reference's ``--reduced`` is a ``store_true`` that
defaults to true, so it can never be turned off), with random weights
from ``--seed``, on ``--device`` (default ``cuda``: a machine without a
card raises, it never falls back to the CPU). ``--arch`` offers the
configs the edge client serves: every one but the encoder-decoder
(whisper-base), which ``EdgeClient`` refuses. The server stops cleanly
on SIGINT or SIGTERM and exits 0.
"""
from __future__ import annotations

import argparse
import signal
import threading

from repro_torch.config import CacheConfig
from repro_torch.configs import get_config, list_archs
from repro_torch.core.server import CacheServer
from repro_torch.core.transport import TCPTransport, serve_tcp
from repro_torch.data.mmlu import MMLU_DOMAINS, MMLUGenerator
from repro_torch.data.tokenizer import WordHashTokenizer

STATS_EVERY_S = 5.0


def run_server(args) -> None:
    server = CacheServer(CacheConfig())
    port, shutdown = serve_tcp(server, host=args.host, port=args.port)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    print(f"cache server on tcp://{args.host}:{port} (ctrl-c to stop)",
          flush=True)
    try:
        while not stop.wait(STATS_EVERY_S):
            s = server.handle("stats", {})
            print(f"  entries={s['n_entries']} "
                  f"stored={s['stored_bytes'] / 1e6:.1f}MB {s['stats']}",
                  flush=True)
    finally:
        shutdown()
    print("cache server stopped", flush=True)


def run_client(args) -> None:
    from repro_torch.core.client import EdgeClient
    from repro_torch.core.perfmodel import PI_ZERO_2W
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import InferenceEngine
    cfg = get_config(args.arch)
    exec_cfg = cfg.reduced() if args.reduced else cfg
    model = Model(exec_cfg, seed=args.seed, device=args.device)
    print(f"client-{args.seed}: {exec_cfg.name} (L={exec_cfg.n_layers} "
          f"d={exec_cfg.d_model}) on {model.device}", flush=True)
    eng = InferenceEngine(model, max_len=1024)
    tr = TCPTransport(args.host, args.port)
    client = EdgeClient(f"client-{args.seed}", eng, tr, CacheConfig(),
                        perf=PI_ZERO_2W, perf_cfg=cfg)
    gen = MMLUGenerator(WordHashTokenizer(exec_cfg.vocab), n_shot=args.n_shot)
    try:
        for p in gen.stream(args.prompts, MMLU_DOMAINS[:args.domains]):
            client.sync_catalog()
            client.catalog.last_sync_t = -1e18
            r = client.infer(p.segments, max_new_tokens=args.max_new)
            print(f"{p.domain:28s} case={r.case} "
                  f"matched={r.matched_tokens}/{r.prompt_tokens} "
                  f"wall TTFT={r.wall.ttft * 1e3:7.1f}ms "
                  f"redis={r.wall.redis * 1e3:6.1f}ms", flush=True)
    finally:
        tr.close()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("server")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=7077)
    c = sub.add_parser("client")
    c.add_argument("--host", default="127.0.0.1")
    c.add_argument("--port", type=int, default=7077)
    c.add_argument("--arch", default="gemma3-270m", choices=[
        a for a in list_archs() if get_config(a).family != "encdec"])
    c.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="the config's reduced() variant (default), or "
                        "--no-reduced for its full width and depth")
    c.add_argument("--device", default="cuda")
    c.add_argument("--prompts", type=int, default=10)
    c.add_argument("--domains", type=int, default=3)
    c.add_argument("--n-shot", type=int, default=2)
    c.add_argument("--max-new", type=int, default=8)
    c.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    if args.cmd == "server":
        run_server(args)
    else:
        run_client(args)


if __name__ == "__main__":
    main()
