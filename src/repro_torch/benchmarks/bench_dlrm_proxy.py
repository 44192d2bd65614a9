"""Paper Table 5 proxy: DLRM click-through prediction at growing batch, SGD
against VR-SGD (AUC).

Port of ``benchmarks/bench_dlrm_proxy.py``: the DLRM smoke model on a
synthetic latent-factor click stream (a Criteo stand-in), one pass over a
fixed sample budget; the batch grows and the steps shrink, the regime where
the paper's SGD loses AUC past 128k while VR-SGD holds (0.8013 at 512k).
On the card a VR-SGD step is K3 per microbatch, K4 and K8.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.benchmarks.common import emit
from repro_torch.configs import dlrm as dlrm_cfg
from repro_torch.configs.base import OptimizerConfig
from repro_torch.data import CTRModel, ctr_batches
from repro_torch.models import dlrm
from repro_torch.serve.engine import resolve_device
from repro_torch.train.driver import auc, train_optimizer

N_TEST = 8192


def held_out(cfg):
    """The held-out samples as numpy: ``N_TEST`` of CTRModel(seed=0)."""
    model = CTRModel(table_size=cfg.table_size, n_sparse=cfg.n_sparse_features, seed=0)
    return model.sample(N_TEST, np.random.RandomState(123))


def run_point(name, bs, samples_budget, *, params=None, device=None, backend=None,
              callback=None):
    """Optimizer ``name`` ("sgd" or "vr_sgd") at batch ``bs`` over
    ``samples_budget`` samples (at least 8 steps) from ``params`` (default:
    models/dlrm.py::init_params from seed 0); train_optimizer's result with
    the held-out AUC as ``eval`` (``callback`` as train_optimizer's)."""
    device = resolve_device(device)
    cfg = dlrm_cfg.smoke()
    test = held_out(cfg)
    dense, sparse = (torch.as_tensor(test[k], device=device) for k in ("dense", "sparse"))
    loss_fn = dlrm.loss_fn(cfg)

    def eval_auc(p):
        with torch.no_grad():
            scores = dlrm.forward(cfg, p.tree, dense, sparse).cpu().numpy()
        return auc(test["label"], scores)

    steps = max(8, samples_budget // bs)
    if params is None:
        params = dlrm.init_params(cfg, torch.Generator().manual_seed(0))
    return train_optimizer(
        loss_fn, params, ctr_batches(bs, cfg.table_size, cfg.n_sparse_features, seed=0),
        OptimizerConfig(name=name, lr=0.15 * np.sqrt(bs / 256), schedule="poly",
                        warmup_steps=max(2, steps // 10), total_steps=steps,
                        k=min(16, max(4, bs // 64))),
        steps=steps, eval_fn=eval_auc, backend=backend, device=device, callback=callback)


def main(fast: bool = False, *, device=None, backend=None) -> None:
    t0 = time.time()
    sample_budget = (1 << 17) if not fast else (1 << 15)
    batches = [256, 1024, 4096] if not fast else [256, 2048]
    for bs in batches:
        for name in ("sgd", "vr_sgd"):
            out = run_point(name, bs, sample_budget, device=device, backend=backend)
            emit(f"dlrm_{name}_b{bs}", out["s_per_step"] * 1e6,
                 f"auc={out['eval']:.4f};steps={len(out['losses'])}")
    print(f"# bench_dlrm_proxy done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
