"""Training launcher: any registered arch, reduced or at full size.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --steps 100
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --no-reduced --steps 3 --ckpt /tmp/llama.ck

Counterpart of ``repro.launch.train``: the config's ``reduced()``
variant unless ``--no-reduced`` asks for its full width and depth (the
reference's ``--reduced`` is a ``store_true`` with ``default=True``, so
it can never train a full config; here it is a ``BooleanOptionalAction``
with the same default), ``Model(cfg, remat=True)`` in fp32 with weights
from ``--seed``, AdamW with bf16 moments, batches from the synthetic
MMLU stream, and with ``--ckpt`` a checkpoint of ``{"params": ...,
"opt": ...}`` in the reference's format after the last step. It runs on
``--device`` (default ``cuda``; a machine without a card needs
``--device cpu``), every family included: the SSM and hybrid families'
scan has its backward kernel there (``ssd_scan_bwd``).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import clock
from repro_torch.configs import get_config, list_archs
from repro_torch.models.model import Model
from repro_torch.params import to_tree
from repro_torch.training import AdamWState, adamw, make_train_step
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import lm_batches


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b", choices=list_archs())
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def checkpoint_tree(model: Model, state: AdamWState, host: bool = False):
    """``{"params", "opt"}`` as the reference's launcher saves them; with
    ``host`` every leaf copied to the CPU."""
    def tree(d):
        return to_tree({k: t.detach().cpu() if host else t
                        for k, t in d.items()})
    count = state.count.cpu() if host else state.count
    return {"params": tree(model.state_dict()),
            "opt": AdamWState(count, tree(state.mu), tree(state.nu))}


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device=args.device, seed=args.seed, remat=True)
    n = sum(p.numel() for p in model.parameters())
    print(f"training {cfg.name}: {n / 1e6:.1f}M params on {model.device}",
          flush=True)
    opt = adamw(lr=args.lr, moment_dtype=torch.bfloat16)
    state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(model, opt)
    data = lm_batches(cfg, args.batch, args.seq)
    t0 = clock.monotonic()
    for step in range(1, args.steps + 1):
        state, m = step_fn(state, next(data))
        if step % args.log_every == 0 or step == 1:
            loss = float(m["loss"])
            print(f"step {step:5d} loss={loss:.4f} "
                  f"({(clock.monotonic() - t0) / step * 1e3:.0f} ms/step)",
                  flush=True)
    if args.ckpt:
        t1 = clock.monotonic()
        # to the host first, and the card's memory freed, before the
        # (host-bound) serialization
        tree = checkpoint_tree(model, state, host=True)
        del model, state, step_fn
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        print(f"writing {args.ckpt}: state on the host in "
              f"{clock.monotonic() - t1:.1f} s", flush=True)
        digest = ckpt.save(args.ckpt, tree, args.steps)
        print(f"saved {args.ckpt}, digest {digest}, "
              f"{clock.monotonic() - t1:.1f} s", flush=True)


if __name__ == "__main__":
    main()
