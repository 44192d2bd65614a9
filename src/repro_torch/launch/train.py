"""Training launcher: the train step on the synthetic Markov LM stream.

  python -m repro_torch.launch.train --arch bert-large --optimizer vr_adam \
      --batch 256 --seq 128 --steps 3
  python -m repro_torch.launch.train --arch bert-large --smoke --device cpu --steps 4

``--optimizer`` takes any name of ``core/vrgd.py::make_optimizer`` (default:
the config's).
Runs on the CUDA card unless ``--device cpu`` is given.  Weights are random
(from ``torch.Generator`` seeded with the config's seed): no checkpoint
ships with the repo.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.configs import ARCH_MODULES, get_config, get_smoke
from repro_torch.data import lm_batches
from repro_torch.serve.engine import resolve_device
from repro_torch.train import train_loop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCH_MODULES))
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--optimizer", default="")
    ap.add_argument("--lr", type=float, default=0.0)
    ap.add_argument("--k", type=int, default=0)
    ap.add_argument("--gamma", type=float, default=-1.0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.batch:
        cfg = cfg.replace(global_batch=args.batch)
    if args.seq:
        cfg = cfg.replace(seq_len=args.seq)
    kw = {"total_steps": args.steps}
    if args.optimizer:
        kw["name"] = args.optimizer
    if args.lr:
        kw["lr"] = args.lr
    if args.k:
        kw["k"] = args.k
    if args.gamma >= 0:
        kw["gamma"] = args.gamma
    cfg = cfg.replace(optimizer=dataclasses.replace(cfg.optimizer, **kw))

    m = cfg.model
    stream = lm_batches(m.vocab_size, cfg.global_batch, cfg.seq_len)
    print(f"training {m.name} on {device}: opt={cfg.optimizer.name} k={cfg.optimizer.k} "
          f"gamma={cfg.optimizer.gamma} batch={cfg.global_batch} seq={cfg.seq_len}", flush=True)
    _state, hist = train_loop(cfg, stream, steps=args.steps, log_every=args.log_every,
                              log_gsnr=cfg.optimizer.is_vr, device=device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(hist, f, indent=1)


if __name__ == "__main__":
    main()
