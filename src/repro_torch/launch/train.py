"""Training launcher: the train step on the synthetic Markov LM stream.

  python -m repro_torch.launch.train --arch bert-large --optimizer vr_adam \
      --batch 256 --seq 128 --steps 3
  python -m repro_torch.launch.train --arch bert-large --smoke --device cpu --steps 4
  python -m repro_torch.launch.train --arch bert-large --smoke --device cpu --steps 4 \
      --stats-method vmap
  torchrun --nproc_per_node 2 -m repro_torch.launch.train --arch bert-large --smoke \
      --device cpu --dist-backend gloo
  torchrun --nproc_per_node 2 -m repro_torch.launch.train --arch bert-large --smoke \
      --device cpu --gsnr-source data_axis --dist-backend gloo
  torchrun --nproc_per_node 4 -m repro_torch.launch.train --arch bert-large --smoke \
      --device cpu --dist-backend gloo --mesh 2,2

Every registered architecture trains; an encoder-decoder's batches carry
"frames" (B, n_frames, d_model) and a vlm's "image" (B, n_image_tokens,
d_model), standard normal stubs drawn with the tokens, as in the
reference's launcher.
``--optimizer`` takes any name of ``core/vrgd.py::make_optimizer`` (default:
the config's).  ``--stats-method vmap`` takes the k microbatches of a VR
step through one vmapped forward and backward (core/accumulate.py).
``--dist-backend`` trains data-parallel over the ranks torchrun starts (its
RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT environment) over that
process-group backend (nccl: one card per rank; gloo: the CPU, or ranks
that share a card); every rank draws the same global batches and takes its
rows, and rank 0 prints.  With the microbatch GSNR source (the default)
the statistics are those of the config's k microbatches, each spread over
the ranks; ``--gsnr-source data_axis`` takes them from the ranks' gradients
instead (k = the number of ranks) and needs ``--dist-backend``; without it
the microbatch source runs, as in the reference.
``--mesh D,M`` (with ``--dist-backend``) trains on a (data, model) grid of
the D x M ranks torchrun starts instead, the weights sharded FSDP+TP by the
reference's rules (launch/mesh.py::GridMesh, sharding/placement.py):
VR-LAMB with the microbatch source and the scan method.
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
from repro_torch.launch.mesh import DIST_BACKENDS, GridMesh, init_data_mesh, init_grid_mesh
from repro_torch.launch.serve import stub_shapes
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
    ap.add_argument("--stats-method", default="scan", choices=("scan", "vmap"),
                    help="k microbatches one after another, or one vmapped backward over them")
    ap.add_argument("--gsnr-source", default="microbatch", choices=("microbatch", "data_axis"),
                    help="GSNR groups: the k microbatches (each spread over the ranks under "
                         "--dist-backend), or the ranks' gradients (k = the number of ranks; "
                         "needs --dist-backend)")
    ap.add_argument("--dist-backend", default=None, choices=DIST_BACKENDS,
                    help="train data-parallel over torchrun's ranks with this process-group "
                         "backend")
    ap.add_argument("--mesh", default="",
                    help="D,M: train on a (data, model) grid of the ranks, the weights sharded "
                         "FSDP+TP (needs --dist-backend)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    if args.gsnr_source == "data_axis" and args.dist_backend is None:
        ap.error("--gsnr-source data_axis needs --dist-backend (nccl or gloo)")
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
    elif args.dist_backend is not None:
        mesh = init_data_mesh(args.dist_backend, args.device)
        device = mesh.device
    else:
        device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.batch:
        cfg = cfg.replace(global_batch=args.batch)
    if args.seq:
        cfg = cfg.replace(seq_len=args.seq)
    kw = {"total_steps": args.steps, "gsnr_source": args.gsnr_source,
          "stats_method": args.stats_method}
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
    stream = lm_batches(m.vocab_size, cfg.global_batch, cfg.seq_len,
                        extra=stub_shapes(m) or None)
    rank0 = mesh is None or mesh.rank == 0
    if rank0:
        o = cfg.optimizer
        if isinstance(mesh, GridMesh):
            k = f"{o.k} (microbatch source) on a {mesh.shape} grid ({mesh.backend})"
        elif mesh is not None and o.is_vr and o.gsnr_source == "data_axis":
            k = f"{mesh.size} ({mesh.size} ranks, {mesh.backend}: data_axis source)"
        else:
            k = f"{o.k} (microbatch source)"
            if mesh is not None:
                k += f" on {mesh.size} ranks ({mesh.backend})"
        print(f"training {m.name} on {device}: opt={o.name} k={k} "
              f"gamma={cfg.optimizer.gamma} batch={cfg.global_batch} seq={cfg.seq_len}",
              flush=True)
    _state, hist = train_loop(cfg, stream, steps=args.steps, log_every=args.log_every,
                              log_gsnr=cfg.optimizer.is_vr, device=device, mesh=mesh)
    if args.out and rank0:
        with open(args.out, "w") as f:
            json.dump(hist, f, indent=1)
    if mesh is not None:
        mesh.close()


if __name__ == "__main__":
    main()
