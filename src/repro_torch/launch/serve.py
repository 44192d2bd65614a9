"""Serving launcher: batched decode of a seeded random-weight model.

  python -m repro_torch.launch.serve                       # internlm2-1.8b, full width, on the card
  python -m repro_torch.launch.serve --arch granite-20b    # 20 B params, held in bf16
  python -m repro_torch.launch.serve --smoke --device cpu  # reduced config on the CPU
  python -m repro_torch.launch.serve --arch whisper-small --smoke --device cpu
  torchrun --nproc_per_node 4 -m repro_torch.launch.serve --smoke --device cpu \
      --mesh 2,2 --dist-backend gloo            # sharded serving on a (2, 2) grid

Every registered architecture runs: the MoE (mixtral-8x22b,
llama4-maverick-400b-a17b), recurrent (recurrentgemma-9b, xlstm-1.3b) and
cross-attention ones (whisper-small, llama-3.2-vision-11b) too.  The last
two take their stub inputs, frame or patch embeddings (B, n, d_model) of a
standard normal drawn from the seed (``stub_inputs``).

Weights are random (normal, std 1/sqrt(fan_in), from a torch.Generator
seeded with the config's seed), since no checkpoint ships with the repo.
They are held in the config's ``parallel.param_dtype``, or in bf16 (rounded
as drawn) where that would take more than half the card's memory
(``weight_dtype``): granite-20b's f32 weights take 81 GB, its bf16 40.6 GB.

``--mesh D,M`` (with ``--dist-backend``, under torchrun's D x M ranks)
serves on a (data, model) grid: each rank draws the weights from the seed,
keeps its blocks (train/trainer.py::grid_params: the reference's rules),
serves its data index's rows of the batch from its blocks of the cache
(the reference's cache rule), and rank 0 prints the whole batch's tokens.
The decoder-only attention, RG-LRU and MoE models run there; the
cross-attention and xLSTM ones raise (ROADMAP A9.4b).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_MODULES, get_config, get_smoke
from repro_torch.launch.mesh import DIST_BACKENDS, init_grid_mesh
from repro_torch.models import init_params
from repro_torch.serve import Engine
from repro_torch.serve.engine import resolve_device


def weight_dtype(cfg, device: torch.device) -> torch.dtype:
    """The dtype the weights are held in: ``cfg.parallel.param_dtype``, or
    bfloat16 on a card where those weights would take more than half its
    memory."""
    dtype = getattr(torch, cfg.parallel.param_dtype)
    if device.type == "cuda":
        size = cfg.model.param_count() * torch.finfo(dtype).bits // 8
        if size > torch.cuda.get_device_properties(device).total_memory / 2:
            return torch.bfloat16
    return dtype


def stub_shapes(model) -> dict:
    """The per-row shapes of a model's stub inputs, the cross-attention's
    source, as lm_batches' ``extra`` takes them: {"image": (n_image_tokens,
    d)} for a vlm, {"frames": (n_frames, d)} for an encoder-decoder, else {}."""
    extra = {}
    if model.n_image_tokens:
        extra["image"] = (model.n_image_tokens, model.d_model)
    if model.encoder is not None:
        extra["frames"] = (model.encoder.n_frames, model.d_model)
    return extra


def stub_inputs(cfg, batch: int, rng: np.random.Generator):
    """The stub inputs of a model that takes them, f32 standard normal as
    the reference's launcher draws them (``stub_shapes`` per row), else
    None."""
    shapes = stub_shapes(cfg.model)
    return {name: rng.standard_normal((batch, *shape), dtype=np.float32)
            for name, shape in shapes.items()} or None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=sorted(ARCH_MODULES))
    ap.add_argument("--smoke", action="store_true", help="run the reduced config")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--dist-backend", default=None, choices=DIST_BACKENDS,
                    help="the process-group backend of --mesh's ranks (torchrun)")
    ap.add_argument("--mesh", default="",
                    help="D,M: serve on a (data, model) grid of the ranks, the weights and "
                         "the KV cache sharded by the reference's rules (needs --dist-backend)")
    args = ap.parse_args(argv)

    if args.mesh and args.dist_backend is None:
        ap.error("--mesh needs --dist-backend (nccl or gloo)")
    mesh = None
    if args.mesh:
        try:
            data, model = (int(n) for n in args.mesh.split(","))
        except ValueError:
            ap.error(f"--mesh {args.mesh!r}: want D,M")
        mesh = init_grid_mesh(args.dist_backend, data, model, args.device)
        device = mesh.device
    else:
        device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    dtype = weight_dtype(cfg, device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    params = init_params(cfg.model, gen, device=device, dtype=dtype)
    cache_len = args.prompt_len + args.new_tokens + 8
    if mesh is not None:
        from repro_torch.train.trainer import grid_params

        params = grid_params(cfg, params, mesh, device)[0]
    eng = Engine(cfg, params, cache_len=cache_len, device=device)
    rng = np.random.default_rng(cfg.seed)
    prompts = rng.integers(0, cfg.model.vocab_size, size=(args.batch, args.prompt_len))
    extra = stub_inputs(cfg, args.batch, rng)
    t0 = time.perf_counter()
    res = eng.generate(prompts, args.new_tokens, temperature=args.temperature, extra=extra)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    if res is not None:  # on a grid, rank 0 holds the whole batch's result
        where = "" if mesh is None else f" on a {mesh.shape} grid ({mesh.backend})"
        print(f"arch={cfg.model.name} device={device}{where} weights={dtype} generated "
              f"{res.tokens.shape} in {dt:.2f}s ({args.batch * res.steps / dt:.1f} tok/s)")
        for i in range(min(2, args.batch)):
            print(f"  req{i}: {res.tokens[i].tolist()}")
    if mesh is not None:
        mesh.close()


if __name__ == "__main__":
    main()
