"""Paper §7.2 / Figs. 4-5: linear regression with VR-SGD.

Port of ``benchmarks/bench_linreg.py``: (a) SGD against VR-SGD (Fig. 5a),
(b) the gamma sweep (Fig. 4 upper), (c) the k sweep (Fig. 4 lower).  True
weights W_i = i, w from zero, MSE loss, with mild label noise and feature
anisotropy so that gradient noise is present.  Each step runs on the
port's plan (train/driver.py::train_optimizer): on the card VR-SGD is K3
per microbatch, K4 and K8.
"""
from __future__ import annotations

import itertools
import time

import torch

from repro_torch.benchmarks.common import emit
from repro_torch.configs.base import OptimizerConfig
from repro_torch.data import linreg_data
from repro_torch.serve.engine import resolve_device
from repro_torch.train.driver import train_optimizer

STEPS = 100
BATCH = 2048


def _data(batch=BATCH, noise=1.0, anis=0.7):
    """(x, y, x_test, y_test) as numpy: the training batch (seed 0, label
    noise) and a clean test set (seed 9)."""
    x, y = linreg_data(batch, seed=0, noise=noise, anisotropy=anis)
    xt, yt = linreg_data(batch, seed=9, anisotropy=anis)
    return x, y, xt, yt


def loss_fn(params, batch):
    """(MSE of x @ w, {})."""
    return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2), {}


def _run(name, lr, k=64, gamma=0.1, steps=STEPS, *, batch=BATCH, device=None, backend=None,
         callback=None):
    """``steps`` constant-LR steps of optimizer ``name`` from w = 0 on the
    fixed training batch; train_optimizer's result, with the test MSE as
    ``eval`` and the first step at loss <= 1.5 as ``steps_to_target``
    (``callback`` as train_optimizer's)."""
    device = resolve_device(device)
    x, y, xt, yt = _data(batch)
    test = {"x": torch.as_tensor(xt, device=device), "y": torch.as_tensor(yt, device=device)}

    def eval_fn(params):
        with torch.no_grad():
            return float(loss_fn(params.tree, test)[0])

    return train_optimizer(
        loss_fn,
        {"w": torch.zeros(10)},
        itertools.repeat({"x": x, "y": y}),
        OptimizerConfig(name=name, lr=lr, schedule="constant", warmup_steps=steps, k=k,
                        gamma=gamma),
        steps=steps,
        eval_fn=eval_fn,
        target=1.5,
        backend=backend,
        device=device,
        callback=callback,
    )


def main(fast: bool = False, *, device=None, backend=None, steps: int = STEPS,
         batch: int = BATCH) -> None:
    t0 = time.time()
    kw = dict(steps=steps, batch=batch, device=device, backend=backend)
    # --- Fig. 5a: SGD against VR-SGD
    for name, lr in [("sgd", 0.09), ("vr_sgd", 0.09)]:
        out = _run(name, lr, **kw)
        emit(f"linreg_fig5_{name}", out["s_per_step"] * 1e6,
             f"test={out['eval']:.4f};steps_to_target={out['steps_to_target']}")
    # --- Fig. 4 upper: gamma (the paper's optimum ~ (0.04, 0.2))
    gammas = [0.02, 0.05, 0.1, 0.3, 1.0] if not fast else [0.05, 0.1, 1.0]
    for g in gammas:
        out = _run("vr_sgd", 0.09, gamma=g, **kw)
        emit(f"linreg_fig4_gamma_{g}", out["s_per_step"] * 1e6, f"test={out['eval']:.4f}")
    # --- Fig. 4 lower: k (the paper's optimum ~ [32, 256])
    ks = [4, 16, 64, 256] if not fast else [8, 64]
    for k in ks:
        out = _run("vr_sgd", 0.09, k=k, **kw)
        emit(f"linreg_fig4_k_{k}", out["s_per_step"] * 1e6, f"test={out['eval']:.4f}")
    print(f"# bench_linreg done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
