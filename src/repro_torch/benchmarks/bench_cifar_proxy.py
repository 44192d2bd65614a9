"""Paper Table 6 / Fig. 3 proxy: large-batch classification.

Port of ``benchmarks/bench_cifar_proxy.py``.  CIFAR-10 with ResNet-56 is
replaced by an anisotropic-Gaussian classification task and an MLP (64 →
128 → 128 → 10, ReLU), as in the reference: the table compares optimizers.
The protocol is the reference's: square-root LR scaling from batch 128, a
fixed sample budget (larger batches take fewer steps), {Momentum, Adam,
LAMB, LARS} × {base, VR}, batches to 32× the base.  On the card the VR
steps run K3 per microbatch, K4 and the update kernel (K5 LAMB, K6 Adam,
K7 LARS, K8 Momentum).
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.benchmarks.common import emit
from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.schedule import sqrt_scaled_lr
from repro_torch.data import classification_batches, classification_data
from repro_torch.serve.engine import resolve_device
from repro_torch.train.driver import train_optimizer

DIM, CLASSES = 64, 10
BASE_BATCH = 128

# tuned so each base optimizer is stable at the base batch (128) but at the
# edge after sqrt scaling to 4096: the paper's Table 6 regime
BASE_LR = {"momentum": 0.15, "adam": 0.02, "lamb": 0.08, "lars": 3.0, "sgd": 0.15}


def init_mlp(gen: torch.Generator, hidden: int = 128, device="cpu"):
    """The MLP's params: normal weights with std 1/sqrt(fan_in), drawn from
    ``gen`` in the order w1, w2, w3; zero biases."""
    def w(i, o):
        return torch.randn((i, o), generator=gen, device=device) / np.sqrt(i)

    w1, w2, w3 = w(DIM, hidden), w(hidden, hidden), w(hidden, CLASSES)
    zeros = lambda n: torch.zeros(n, device=device)  # noqa: E731
    return {"w1": w1, "b1": zeros(hidden), "w2": w2, "b2": zeros(hidden), "w3": w3,
            "b3": zeros(CLASSES)}


def logits_fn(p, x):
    h = F.relu(x @ p["w1"] + p["b1"])
    h = F.relu(h @ p["w2"] + p["b2"])
    return h @ p["w3"] + p["b3"]


def loss_fn(p, batch):
    """(mean cross-entropy of the logits, {})."""
    lg = logits_fn(p, batch["x"])
    return -torch.mean(torch.log_softmax(lg, -1).gather(1, batch["y"].long()[:, None])), {}


def data(n_train: int = 20000, n_test: int = 4000):
    """(x_train, y_train, x_test, y_test) as numpy, the reference's noise
    levels: sqrt-scaled LRs at its Table 6 stress point."""
    xtr, ytr = classification_data(n_train, DIM, CLASSES, seed=0, sample_seed=1, noise=2.5,
                                   label_noise=0.08)
    xte, yte = classification_data(n_test, DIM, CLASSES, seed=0, sample_seed=99, noise=2.5,
                                   label_noise=0.0)
    return xtr, ytr, xte, yte


def run_point(name, bs, samples_budget, splits, *, params=None, device=None, backend=None,
              callback=None):
    """Optimizer ``name`` at batch ``bs`` over ``samples_budget`` samples
    (at least 8 steps) from ``params`` (default: init_mlp from seed 0);
    train_optimizer's result with the test accuracy as ``eval``
    (``callback`` as train_optimizer's)."""
    device = resolve_device(device)
    xtr, ytr, xte, yte = splits
    base = name[3:] if name.startswith("vr_") else name
    lr = sqrt_scaled_lr(BASE_LR[base], bs, BASE_BATCH)
    steps = max(8, samples_budget // bs)
    xte_t, yte_t = torch.as_tensor(xte, device=device), torch.as_tensor(yte, device=device)

    def acc(p):
        with torch.no_grad():
            return float((logits_fn(p.tree, xte_t).argmax(-1) == yte_t).float().mean())

    if params is None:
        params = init_mlp(torch.Generator().manual_seed(0))
    return train_optimizer(
        loss_fn, params, classification_batches(xtr, ytr, bs, seed=1),
        OptimizerConfig(name=name, lr=lr, schedule="cosine", warmup_steps=max(2, steps // 20),
                        total_steps=steps, k=min(32, max(4, bs // 32)), weight_decay=0.0,
                        grad_clip=0.0),
        steps=steps, eval_fn=acc, backend=backend, device=device, callback=callback)


def main(fast: bool = False, *, device=None, backend=None, n_train: int = 20000,
         n_test: int = 4000) -> None:
    t0 = time.time()
    splits = data(n_train, n_test)
    batches = [128, 1024, 4096] if not fast else [128, 2048]
    opts = ["momentum", "adam", "lamb", "lars"] if not fast else ["momentum", "lamb"]
    # a fixed sample budget: steps shrink with batch (the paper's stressor)
    samples_budget = 120 * BASE_BATCH * (4 if not fast else 2)
    for base in opts:
        for bs in batches:
            for name in (base, f"vr_{base}"):
                out = run_point(name, bs, samples_budget, splits, device=device, backend=backend)
                emit(f"cifar_proxy_{name}_b{bs}", out["s_per_step"] * 1e6,
                     f"test_acc={out['eval']:.4f};final_loss={out['final_loss']:.4f};"
                     f"steps={len(out['losses'])}")
    print(f"# bench_cifar_proxy done in {time.time() - t0:.1f}s")


def seed_rows(names=("lamb", "vr_lamb"), bs: int = BASE_BATCH, seeds=range(8),
              fast: bool = False, *, device=None, backend=None) -> None:
    """Each optimizer of ``names`` at batch ``bs`` from init_mlp(seed), for
    each of ``seeds``, under main's protocol: the spread over the init that
    one row of the table is drawn from (``_init<seed>`` rows; seed 0 is
    main's row)."""
    splits = data()
    budget = 120 * BASE_BATCH * (4 if not fast else 2)
    for name in names:
        for seed in seeds:
            out = run_point(name, bs, budget, splits, device=device, backend=backend,
                            params=init_mlp(torch.Generator().manual_seed(seed)))
            emit(f"cifar_proxy_{name}_b{bs}_init{seed}", out["s_per_step"] * 1e6,
                 f"test_acc={out['eval']:.4f};final_loss={out['final_loss']:.4f};"
                 f"steps={len(out['losses'])}")


if __name__ == "__main__":
    main()
