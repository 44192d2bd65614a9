"""Paper Table 1 proxy: LM pretraining at scaled batch, LAMB against
VR-LAMB, and the autoscale A/B.

Port of ``benchmarks/bench_bert_proxy.py``.  BERT-large on Wikipedia is
replaced, as in the reference, by the bert smoke made causal on the Markov
stream (vocabulary 128, seq 32): eval loss at a fixed token budget as the
batch grows under sqrt-scaled LR, so larger batches take fewer steps.

The autoscale A/B: fixed k against GSNR-driven autoscaling
(train/autoscale.py) at the same token budget, both fed from one indexed
token cache (data/memmap.py) written once, the budget spanning epochs of
it; the autoscaled arm asks the loader for k × 4 rows a step.  Its record
(the B_simple, k, LR and epoch trajectories) is written to the path the
caller gives, by default ``build/bench_autoscale.json`` of the checkout
(git-ignored); the caches live in a temporary directory beside it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from pathlib import Path

from repro_torch.benchmarks.common import check_plans_agree, emit
from repro_torch.configs import get_smoke
from repro_torch.core.schedule import sqrt_scaled_lr
from repro_torch.data import (
    IndexedPackedDataset,
    TokenCache,
    lm_batches,
    markov_documents,
    write_token_cache,
)
from repro_torch.serve.engine import resolve_device
from repro_torch.train import eval_loss, make_loss_fn, train_loop
from repro_torch.train.autoscale import AutoscalePolicy, autoscale_train_loop

RECORD = Path(__file__).resolve().parents[3] / "build" / "bench_autoscale.json"
BASE_BATCH, BASE_LR = 32, 2.5e-3
POLICY = dict(k_min=2, k_max=16, warmup_steps=3, cooldown=2, hysteresis=1.25, ema_beta=0.8)


def config(backend=None):
    """The bert smoke, causal (next-token loss on the Markov stream),
    vocabulary 128, seq 32."""
    cfg0 = get_smoke("bert-large").replace(seq_len=32)
    cfg0 = cfg0.replace(model=dataclasses.replace(cfg0.model, causal=True, vocab_size=128))
    if backend is not None:
        cfg0 = cfg0.replace(parallel=dataclasses.replace(cfg0.parallel, backend=backend))
    return cfg0


def test_batches(cfg0):
    stream = lm_batches(cfg0.model.vocab_size, 64, cfg0.seq_len, seed=0, stream_seed=777)
    return [next(iter(stream)) for _ in range(4)]


def point_config(cfg0, name, bs, steps):
    return cfg0.replace(global_batch=bs, optimizer=dataclasses.replace(
        cfg0.optimizer, name=name, lr=sqrt_scaled_lr(BASE_LR, bs, BASE_BATCH),
        warmup_steps=max(2, steps // 10), total_steps=steps, k=min(16, max(4, bs // 16))))


def run_point(cfg0, name, bs, steps, tests, *, state=None, device=None):
    """``steps`` steps of optimizer ``name`` at batch ``bs`` on the Markov
    stream; returns (eval loss over ``tests``, final state)."""
    cfg = point_config(cfg0, name, bs, steps)
    stream = lm_batches(cfg.model.vocab_size, bs, cfg.seq_len, seed=0, stream_seed=1)
    state, _ = train_loop(cfg, stream, steps=steps, state=state, device=device)
    return eval_loss(cfg, make_loss_fn(cfg), state.params, tests), state


def autoscale_ab(cfg0, fast: bool, *, record_path=RECORD, device=None) -> dict:
    """Fixed k against autoscaled k at the same token budget, the same model
    and the same on-disk cache; the autoscaled arm must move k at least once
    from the measured B_simple (a run where the policy never fires is a
    vacuous A/B).  Writes the record to ``record_path`` and returns it."""
    device = resolve_device(device)
    seq = cfg0.seq_len
    mb_rows, k0 = 4, 2
    policy = AutoscalePolicy(**POLICY)
    opt = dataclasses.replace(
        cfg0.optimizer, name="vr_adam", lr=1e-3, schedule="constant",
        warmup_steps=0, k=k0, base_batch=mb_rows * k0, lr_scale_rule="sqrt",
    )
    cfg = cfg0.replace(global_batch=mb_rows * k0, optimizer=opt)
    vocab = cfg.model.vocab_size
    mb_tokens = mb_rows * seq  # packed rows: every slot counts to the budget
    budget = (20 if fast else 60) * k0 * mb_tokens
    record_path = Path(record_path)
    record_path.parent.mkdir(parents=True, exist_ok=True)

    with tempfile.TemporaryDirectory(dir=record_path.parent) as work:
        d_train, d_eval = os.path.join(work, "train"), os.path.join(work, "eval")
        # one cache of ~half the budget: each arm crosses epochs
        write_token_cache(markov_documents(vocab, budget // 2, 6, 2 * seq, seed=0, stream_seed=1),
                          d_train, vocab=vocab)
        write_token_cache(markov_documents(vocab, 32 * seq, 6, 2 * seq, seed=0, stream_seed=888),
                          d_eval, vocab=vocab)
        train_cache = TokenCache(d_train)
        eval_ds = IndexedPackedDataset(TokenCache(d_eval), seq_len=seq, batch_rows=32)
        loss_fn = make_loss_fn(cfg)

        # fixed-k arm: train_loop over the indexed stream at k0 x mb_rows
        steps_fixed = budget // (k0 * mb_tokens)
        ds_fixed = IndexedPackedDataset(train_cache, seq_len=seq, batch_rows=k0 * mb_rows, seed=0)
        t0 = time.time()
        state_f, hist_f = train_loop(cfg, ds_fixed.iter_batches(), steps=steps_fixed,
                                     log_every=steps_fixed, device=device)
        wall_fixed = time.time() - t0
        epochs_fixed = int(ds_fixed.state.epoch)
        te_fixed = eval_loss(cfg, loss_fn, state_f.params, eval_ds)

        # autoscaled arm: the same cache, k x mb_rows rows off the pack index
        ds_auto = IndexedPackedDataset(train_cache, seq_len=seq, batch_rows=mb_rows, seed=0)
        t0 = time.time()
        state_a, hist_a = autoscale_train_loop(cfg, ds_auto, policy=policy, loss_fn=loss_fn,
                                               token_budget=budget, device=device)
        wall_auto = time.time() - t0
        te_auto = eval_loss(cfg, loss_fn, state_a.params, eval_ds)
        cache_tokens, cache_docs = int(train_cache.n_tokens), int(train_cache.n_docs)
        del train_cache, eval_ds, ds_fixed, ds_auto

    ks = [row["k"] for row in hist_a]
    n_changes = sum(1 for a, b in zip(ks, ks[1:]) if a != b) + (ks[0] != k0)
    assert len(set(ks)) > 1 or n_changes >= 1, (
        f"autoscale A/B is vacuous: k never moved from {k0} (trajectory {ks})"
    )
    emit("bert_autoscale_fixed", 0.0,
         f"eval_loss={te_fixed:.4f};steps={steps_fixed};k={k0};tokens={budget};"
         f"epochs={epochs_fixed}")
    emit("bert_autoscale_auto", 0.0,
         f"eval_loss={te_auto:.4f};steps={len(hist_a)};k_final={ks[-1]};"
         f"k_changes={n_changes};tokens={hist_a[-1]['tokens']};epochs={hist_a[-1]['epoch']}")
    rec = {
        "config": {
            "model": cfg.model.name, "seq": seq, "vocab": cfg.model.vocab_size,
            "microbatch_rows": mb_rows, "k0": k0, "token_budget": budget,
            "optimizer": opt.name, "lr": opt.lr, "base_batch": opt.base_batch,
            "lr_scale_rule": opt.lr_scale_rule,
        },
        "policy": dataclasses.asdict(policy),
        "data": {"cache_tokens": cache_tokens, "cache_docs": cache_docs,
                 "pack_efficiency": float(hist_a[-1].get("pack_efficiency", 0.0))},
        "fixed": {
            "k": k0, "steps": steps_fixed, "tokens": steps_fixed * k0 * mb_tokens,
            "eval_loss": float(te_fixed), "final_train_loss": float(hist_f[-1]["loss"]),
            "wall_s": wall_fixed, "epochs": epochs_fixed,
        },
        "autoscaled": {
            "steps": len(hist_a), "tokens": int(hist_a[-1]["tokens"]),
            "eval_loss": float(te_auto), "final_train_loss": float(hist_a[-1]["loss"]),
            "wall_s": wall_auto, "k_final": ks[-1], "k_changes": int(n_changes),
            "epochs": int(hist_a[-1]["epoch"]),
            "k_trajectory": ks,
            "b_simple_trajectory": [round(row["b_simple"], 3) for row in hist_a],
            "b_simple_ema_trajectory": [round(row["b_simple_ema"], 3) for row in hist_a],
            "lr_trajectory": [round(row["lr"], 8) for row in hist_a],
            "epoch_trajectory": [int(row["epoch"]) for row in hist_a],
        },
        "plan": cfg.parallel.backend.describe(device),
    }
    check_plans_agree(rec, what="bench_autoscale record")
    with open(record_path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"# wrote {record_path}")
    return rec


def main(fast: bool = False, *, device=None, backend=None, record_path=RECORD) -> None:
    t0 = time.time()
    cfg0 = config(backend)
    seq = cfg0.seq_len
    token_budget = 110 * BASE_BATCH * seq * (2 if not fast else 1)
    tests = test_batches(cfg0)
    batches = [32, 128, 512] if not fast else [32, 256]
    for bs in batches:
        steps = max(10, token_budget // (bs * seq))
        for name in ("lamb", "vr_lamb"):
            te, _ = run_point(cfg0, name, bs, steps, tests, device=device)
            emit(f"bert_proxy_{name}_b{bs}", 0.0, f"eval_loss={te:.4f};steps={steps}")
    autoscale_ab(cfg0, fast, record_path=record_path, device=device)
    print(f"# bench_bert_proxy done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
