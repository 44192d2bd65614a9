"""Serving launcher: batched decode of a seeded random-weight model.

  python -m repro_torch.launch.serve                       # internlm2-1.8b, full width, on the card
  python -m repro_torch.launch.serve --smoke --device cpu  # reduced config on the CPU

Weights are random (normal, std 1/sqrt(fan_in), from a torch.Generator
seeded with the config's seed), since no checkpoint ships with the repo.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_MODULES, get_config, get_smoke
from repro_torch.models import init_params
from repro_torch.serve import Engine
from repro_torch.serve.engine import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=sorted(ARCH_MODULES))
    ap.add_argument("--smoke", action="store_true", help="run the reduced config")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    params = init_params(cfg.model, gen, device=device)
    eng = Engine(cfg, params, cache_len=args.prompt_len + args.new_tokens + 8, device=device)
    prompts = np.random.default_rng(cfg.seed).integers(
        0, cfg.model.vocab_size, size=(args.batch, args.prompt_len))
    t0 = time.perf_counter()
    res = eng.generate(prompts, args.new_tokens, temperature=args.temperature)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.model.name} device={device} generated {res.tokens.shape} in {dt:.2f}s "
          f"({args.batch * res.steps / dt:.1f} tok/s)")
    for i in range(min(2, args.batch)):
        print(f"  req{i}: {res.tokens[i].tolist()}")


if __name__ == "__main__":
    main()
