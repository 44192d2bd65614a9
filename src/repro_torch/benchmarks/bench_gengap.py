"""Paper Tables 2 & 4: the generalization gap, base against VR at large
batch.

Port of ``benchmarks/bench_gengap.py``.  A small LM (the internlm2 smoke at
d_model 128, vocabulary 128, seq 32) trains on a finite pool of 512
sequences from the Markov chain, so it can overfit; the test batch comes
from the same chain, fresh.  The row reports gap = test loss - train loss
for LAMB against VR-LAMB (Table 2) and Momentum against VR-Momentum (the
Table 4 analog); the paper's claim is that VR cuts the gap at large batch.
On the card a VR step is K1/K2 in every layer of every microbatch, K3 per
microbatch, K4 and the update kernel (K5 VR-LAMB, K8 VR-Momentum).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.benchmarks.common import emit
from repro_torch.configs import get_smoke
from repro_torch.data import MarkovLM, lm_batches
from repro_torch.train import eval_loss, make_loss_fn, train_loop

VOCAB, SEQ, BATCH, D_MODEL, K = 128, 32, 256, 128, 16
LR = {"lamb": 6e-3, "vr_lamb": 6e-3, "momentum": 0.15, "vr_momentum": 0.15}


def finite_pool_stream(pool, batch):
    rng = np.random.RandomState(5)
    n = pool["tokens"].shape[0]
    while True:
        idx = rng.randint(0, n, size=batch)
        yield {"tokens": pool["tokens"][idx], "targets": pool["targets"][idx]}


def config(batch: int = BATCH, backend=None):
    """The internlm2 smoke at the bench's width, vocabulary and sequence."""
    cfg0 = get_smoke("internlm2-1.8b").replace(global_batch=batch, seq_len=SEQ)
    cfg0 = cfg0.replace(model=dataclasses.replace(cfg0.model, vocab_size=VOCAB, d_model=D_MODEL))
    if backend is not None:
        cfg0 = cfg0.replace(parallel=dataclasses.replace(cfg0.parallel, backend=backend))
    return cfg0


def pool_and_test(batch: int = 128):
    """The finite training pool (512 sequences, numpy) and one test batch of
    ``batch`` fresh sequences."""
    toks = MarkovLM(VOCAB, seed=0).sample(512, SEQ, np.random.RandomState(1))
    pool = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    test = [next(iter(lm_batches(VOCAB, batch, SEQ, seed=0, stream_seed=999)))]
    return pool, test


def point_config(cfg0, name, steps, k: int = K):
    return cfg0.replace(optimizer=dataclasses.replace(
        cfg0.optimizer, name=name, lr=LR[name], warmup_steps=10, total_steps=steps, k=k))


def run_point(cfg0, name, steps, pool, test_batches, *, k: int = K, state=None, device=None):
    """``steps`` steps of optimizer ``name`` on the pool; returns (train
    loss on the pool's first 128 sequences, test loss, final state)."""
    cfg = point_config(cfg0, name, steps, k)
    loss_fn = make_loss_fn(cfg)
    state, _ = train_loop(cfg, finite_pool_stream(pool, cfg.global_batch), steps=steps,
                          state=state, device=device)
    tr = eval_loss(cfg, loss_fn, state.params, [{k_: v[:128] for k_, v in pool.items()}])
    te = eval_loss(cfg, loss_fn, state.params, test_batches)
    return tr, te, state


def main(fast: bool = False, *, device=None, backend=None, steps: int = 0) -> None:
    """The four points (LAMB, Momentum and their VR forms) at ``steps``
    steps each: 0 takes the protocol's, 180 (60 ``fast``)."""
    t0 = time.time()
    steps = steps or (180 if not fast else 60)
    cfg0 = config(BATCH, backend)
    pool, test_batches = pool_and_test()
    for base, vr in [("lamb", "vr_lamb"), ("momentum", "vr_momentum")]:
        for name in (base, vr):
            tr, te, _ = run_point(cfg0, name, steps, pool, test_batches, device=device)
            emit(f"gengap_{name}_b{BATCH}", 0.0, f"train={tr:.4f};test={te:.4f};gap={te - tr:.4f}")
    print(f"# bench_gengap done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
