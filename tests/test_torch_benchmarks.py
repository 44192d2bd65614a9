"""Port parity: the paper-table benches of ``repro_torch.benchmarks``
against the reference's own pieces.

For each of the five benches one reduced point runs through the port's
bench code and through the reference's pieces (``benchmarks.common.
train_optimizer``, ``benchmarks.bench_cifar_proxy.init_mlp`` / ``loss_fn`` /
``logits_fn``, ``benchmarks.bench_linreg.loss_fn``, ``repro.models.dlrm``,
``repro.train.train_loop`` / ``eval_loss``; none is edited), from the
reference's init carried across as numpy.  Both sides compute in f32.

Tolerances, per bench (f32 math in another summation order):
- linreg: losses and the test MSE rtol 1e-5 over VR-SGD's 100 steps; SGD
  at lr 0.09 reaches a loss of ~1.0 by step 46, then an unstable direction
  grown from rounding takes over and the loss passes 1e8 by step 59, so its
  losses are held only up to its least loss (measured <= 1.2e-6 apart
  there), and steps_to_target exactly on both;
- cifar (VR-LAMB at batch 128, k = 4, 8 steps): losses rtol 1e-4, test
  accuracy within 2 test samples (an argmax can flip on a near tie);
- dlrm (VR-SGD at batch 256, k = 4, 8 steps): losses rtol 1e-5, AUC within
  1e-4;
- gengap (VR-LAMB on the finite pool, 3 steps) and bert_proxy (VR-LAMB at
  batch 32, 3 steps): train, test and eval losses and the gap rtol 1e-4 (the
  GSNR ratio amplifies rounding: tests/test_torch_train.py).
The autoscale A/B runs on the port alone (the reference's A/B writes the
repository's BENCH_autoscale.json): k must move, and the record goes to the
path given and nowhere else.  One torch thread, the smoke configs.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.bench_cifar_proxy as jcifar
import benchmarks.bench_linreg as jlinreg
import benchmarks.common as jcommon
from repro.backend import Backend as JBackend
from repro.configs import dlrm as jdlrm_cfg
from repro.configs import get_smoke as j_get_smoke
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.core import sqrt_scaled_lr as j_sqrt_scaled_lr
from repro.data import ctr_batches as j_ctr_batches
from repro.data import lm_batches as j_lm_batches
from repro.models import dlrm as jdlrm
from repro.models import transformer as jt
from repro.train import eval_loss as j_eval_loss
from repro.train import make_loss_fn as j_make_loss_fn
from repro.train import trainer as jtr
from repro_torch.backend import Backend
from repro_torch.benchmarks import bench_bert_proxy, bench_cifar_proxy, bench_dlrm_proxy
from repro_torch.benchmarks import bench_gengap, bench_linreg, common, run
from repro_torch.models import dlrm
from repro_torch.train import init_state
from repro_torch.train.checkpoint import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small work: one intra-op thread keeps this file from oversubscribing
    the cores the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# linreg (Figs. 4-5)
# ---------------------------------------------------------------------------


def _linreg_reference(name, steps):
    x, y, xt, yt = (jnp.asarray(a) for a in bench_linreg._data())
    return jcommon.train_optimizer(
        jlinreg.loss_fn, {"w": jnp.zeros(10)}, iter(lambda: (x, y), None),
        JOptimizerConfig(name=name, lr=0.09, schedule="constant", warmup_steps=steps, k=64,
                         gamma=0.1),
        steps=steps, eval_fn=lambda p: float(jlinreg.loss_fn(p, (xt, yt))), target=1.5)


@pytest.mark.parametrize("name", ["vr_sgd", "sgd"])
def test_linreg_point_matches_the_reference(name):
    steps = 100 if name == "vr_sgd" else 60
    got = bench_linreg._run(name, 0.09, steps=steps, device="cpu")
    want = _linreg_reference(name, steps)
    assert got["steps_to_target"] == want["steps_to_target"]
    ref = np.asarray(want["losses"])
    if name == "sgd":  # only the steps before the divergence: up to the least loss
        n = int(np.argmin(ref))
        assert 10 < n < steps and ref[-1] > 1e6 * ref[n]
        ref = ref[:n]
    else:
        np.testing.assert_allclose(got["eval"], want["eval"], rtol=1e-5)
    np.testing.assert_allclose(got["losses"][: len(ref)], ref, rtol=1e-5)


# ---------------------------------------------------------------------------
# cifar proxy (Table 6)
# ---------------------------------------------------------------------------


def test_cifar_point_matches_the_reference():
    bs, budget = 128, 8 * 128
    splits = bench_cifar_proxy.data(2000, 500)
    jp = jcifar.init_mlp(jax.random.PRNGKey(0))
    params = {k: torch.tensor(np.asarray(v)) for k, v in jax.device_get(jp).items()}
    got = bench_cifar_proxy.run_point("vr_lamb", bs, budget, splits, params=params,
                                      device="cpu")
    # the reference bench's protocol, step for step
    xtr, ytr, xte, yte = splits
    steps = max(8, budget // bs)
    xte_j, yte_j = jnp.asarray(xte), jnp.asarray(yte)
    want = jcommon.train_optimizer(
        jcifar.loss_fn, jp, jcifar.classification_batches(xtr, ytr, bs, seed=1),
        JOptimizerConfig(name="vr_lamb", lr=j_sqrt_scaled_lr(jcifar.BASE_LR["lamb"], bs, 128),
                         schedule="cosine", warmup_steps=max(2, steps // 20), total_steps=steps,
                         k=min(32, max(4, bs // 32)), weight_decay=0.0, grad_clip=0.0),
        steps=steps,
        eval_fn=lambda p: float(jnp.mean(jnp.argmax(jcifar.logits_fn(p, xte_j), -1) == yte_j)))
    assert bench_cifar_proxy.BASE_LR == jcifar.BASE_LR
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert abs(got["eval"] - want["eval"]) <= 2 / len(yte)


def test_cifar_init_draws_from_the_generator():
    a = bench_cifar_proxy.init_mlp(torch.Generator().manual_seed(3))
    b = bench_cifar_proxy.init_mlp(torch.Generator().manual_seed(3))
    want = jcifar.init_mlp(jax.random.PRNGKey(0))
    for key, val in want.items():
        assert tuple(a[key].shape) == val.shape and torch.equal(a[key], b[key])
    std = float(a["w2"].std())
    assert abs(std - 1 / np.sqrt(128)) < 0.01 and not a["b1"].any()


def test_cifar_seed_rows_vary_the_init_only(monkeypatch, capsys):
    """seed_rows: one ``_init<seed>`` row per optimizer and seed, under
    main's protocol; the init0 row is run_point's default (init_mlp from
    seed 0), another seed's differs."""
    small = bench_cifar_proxy.data(2000, 500)
    monkeypatch.setattr(bench_cifar_proxy, "data", lambda: small)
    bench_cifar_proxy.seed_rows(("lamb",), 512, (0, 1), fast=True, device="cpu")
    rows = [line.split(",") for line in capsys.readouterr().out.splitlines()]
    assert [r[0] for r in rows] == ["cifar_proxy_lamb_b512_init0", "cifar_proxy_lamb_b512_init1"]
    main_row = bench_cifar_proxy.run_point("lamb", 512, 120 * 128 * 2, small, device="cpu")
    assert rows[0][2] == (f"test_acc={main_row['eval']:.4f};"
                          f"final_loss={main_row['final_loss']:.4f};steps=60")
    assert rows[1][2] != rows[0][2]


# ---------------------------------------------------------------------------
# dlrm proxy (Table 5)
# ---------------------------------------------------------------------------


def test_dlrm_point_matches_the_reference():
    bs, budget = 256, 8 * 256
    cfg = jdlrm_cfg.smoke()
    jp = jdlrm.init_params(cfg, jax.random.PRNGKey(0))
    got = bench_dlrm_proxy.run_point("vr_sgd", bs, budget,
                                     params=dlrm.params_from_numpy(jax.device_get(jp)),
                                     device="cpu")
    test = bench_dlrm_proxy.held_out(cfg)
    steps = max(8, budget // bs)

    def eval_auc(p):
        scores = np.asarray(jdlrm.forward(cfg, p, jnp.asarray(test["dense"]),
                                          jnp.asarray(test["sparse"])))
        return jcommon.auc(test["label"], scores)

    want = jcommon.train_optimizer(
        lambda p, b: jdlrm.bce_loss(cfg, p, b), jp,
        ({k: jnp.asarray(v) for k, v in b.items()}
         for b in j_ctr_batches(bs, cfg.table_size, cfg.n_sparse_features, seed=0)),
        JOptimizerConfig(name="vr_sgd", lr=0.15 * np.sqrt(bs / 256), schedule="poly",
                         warmup_steps=max(2, steps // 10), total_steps=steps,
                         k=min(16, max(4, bs // 64))),
        steps=steps, eval_fn=eval_auc)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert abs(got["eval"] - want["eval"]) <= 1e-4, (got["eval"], want["eval"])


# ---------------------------------------------------------------------------
# gengap (Tables 2 & 4) and bert proxy (Table 1): transformer points
# ---------------------------------------------------------------------------


def _f32(tcfg, jcfg):
    """Both configs in f32 compute, the JAX side on its reference plan."""
    tcfg = tcfg.replace(parallel=dataclasses.replace(
        tcfg.parallel, compute_dtype="float32", backend=Backend.all_reference()))
    jcfg = jcfg.replace(parallel=dataclasses.replace(
        jcfg.parallel, compute_dtype="float32", backend=JBackend.all_reference()))
    return tcfg, jcfg


def _carried(tcfg, jcfg):
    """(JAX state, port state) from the reference's init params."""
    jp = jt.init_params(jcfg.model, jax.random.PRNGKey(0))
    return (jtr.init_state(jcfg, params=jp),
            init_state(tcfg, params=params_from_numpy(jax.device_get(jp), tcfg.model),
                       device="cpu"))


def test_gengap_point_matches_the_reference():
    batch, steps, k = 32, 3, 4
    tcfg0 = bench_gengap.config(batch)
    jcfg0 = j_get_smoke("internlm2-1.8b").replace(global_batch=batch, seq_len=bench_gengap.SEQ)
    jcfg0 = jcfg0.replace(model=dataclasses.replace(
        jcfg0.model, vocab_size=bench_gengap.VOCAB, d_model=bench_gengap.D_MODEL))
    tcfg0, jcfg0 = _f32(tcfg0, jcfg0)
    pool, tests = bench_gengap.pool_and_test(32)
    tcfg = bench_gengap.point_config(tcfg0, "vr_lamb", steps, k)
    jcfg = jcfg0.replace(optimizer=dataclasses.replace(
        jcfg0.optimizer, name="vr_lamb", lr=bench_gengap.LR["vr_lamb"], warmup_steps=10,
        total_steps=steps, k=k))
    jstate, tstate = _carried(tcfg, jcfg)
    tr, te, _ = bench_gengap.run_point(tcfg0, "vr_lamb", steps, pool, tests, k=k, state=tstate,
                                       device="cpu")
    jstate, _ = jtr.train_loop(jcfg, bench_gengap.finite_pool_stream(pool, batch), steps,
                               state=jstate)
    loss_fn = j_make_loss_fn(jcfg)
    jtr_ = j_eval_loss(jcfg, loss_fn, jstate.params, [{k_: v[:128] for k_, v in pool.items()}])
    jte = j_eval_loss(jcfg, loss_fn, jstate.params, tests)
    np.testing.assert_allclose([tr, te, te - tr], [jtr_, jte, jte - jtr_], rtol=1e-4)


def test_bert_point_matches_the_reference():
    bs, steps = 32, 3
    tcfg0 = bench_bert_proxy.config()
    jcfg0 = j_get_smoke("bert-large").replace(seq_len=32)
    jcfg0 = jcfg0.replace(model=dataclasses.replace(jcfg0.model, causal=True, vocab_size=128))
    tcfg0, jcfg0 = _f32(tcfg0, jcfg0)
    tests = bench_bert_proxy.test_batches(tcfg0)
    tcfg = bench_bert_proxy.point_config(tcfg0, "vr_lamb", bs, steps)
    jcfg = jcfg0.replace(global_batch=bs, optimizer=dataclasses.replace(
        jcfg0.optimizer, name="vr_lamb", lr=j_sqrt_scaled_lr(2.5e-3, bs, 32),
        warmup_steps=max(2, steps // 10), total_steps=steps, k=min(16, max(4, bs // 16))))
    jstate, tstate = _carried(tcfg, jcfg)
    te, _ = bench_bert_proxy.run_point(tcfg0, "vr_lamb", bs, steps, tests[:1], state=tstate,
                                       device="cpu")
    jstate, _ = jtr.train_loop(jcfg, j_lm_batches(128, bs, 32, seed=0, stream_seed=1), steps,
                               state=jstate)
    jte = j_eval_loss(jcfg, j_make_loss_fn(jcfg), jstate.params, tests[:1])
    np.testing.assert_allclose(te, jte, rtol=1e-4)


def test_autoscale_ab_moves_k_and_writes_only_the_given_path(tmp_path):
    repo_record = os.path.join(ROOT, "BENCH_autoscale.json")
    before = os.stat(repo_record).st_mtime_ns
    path = tmp_path / "out" / "ab.json"
    rec = bench_bert_proxy.autoscale_ab(bench_bert_proxy.config(), True, record_path=path,
                                        device="cpu")
    assert sorted(os.listdir(tmp_path / "out")) == ["ab.json"]
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
    assert rec["autoscaled"]["k_changes"] >= 1
    assert rec["plan"] == {"attention": "reference", "optimizer": "reference",
                           "stats": "reference", "device": "cpu"}
    assert os.stat(repo_record).st_mtime_ns == before
    assert bench_bert_proxy.RECORD == \
        __import__("pathlib").Path(ROOT, "build", "bench_autoscale.json")


# ---------------------------------------------------------------------------
# common.py's guards and run.py
# ---------------------------------------------------------------------------


GUARD_RECORDS = {
    "agree": {"a": {"plan": {"x": 1}, "config": {"S": 256}}, "b": {"plan": {"x": 1}}},
    "plans_differ": {"a": {"plan": {"x": 1}}, "b": [{"plan": {"x": 2}}]},
    "configs_conflict": {"a": {"config": {"attn": {"S": 256}}},
                         "b": {"config": {"attn": {"S": 512}}}},
    "configs_disjoint": {"a": {"config": {"S": 256}}, "b": {"config": {"B": 8}}},
    "nested_list_plan": {"runs": [{"plan": {"x": 1}}, {"inner": {"plan": {"x": 1, "y": 0}}}]},
}


@pytest.mark.parametrize("case", sorted(GUARD_RECORDS))
@pytest.mark.parametrize("guard", ["check_plans_agree", "check_configs_agree",
                                   "merge_bench_records"])
def test_guards_refuse_what_the_reference_refuses(case, guard):
    rec = GUARD_RECORDS[case]

    def outcome(mod):
        fn = getattr(mod, guard)
        try:
            out = fn({}, **rec) if guard == "merge_bench_records" else fn(rec)
        except ValueError as e:
            return "refused", str(e)
        return "ok", out

    assert outcome(common) == outcome(jcommon)


def test_run_prints_the_reference_row_names(monkeypatch, capsys):
    """run.py --only linreg --fast --device cpu prints the reference's rows
    (each run cut to 3 steps here); the reference's names come from its own
    bench with its driver stubbed."""
    real = bench_linreg.train_optimizer

    def short(*args, steps, **kw):
        return real(*args, steps=min(steps, 3), **kw)

    monkeypatch.setattr(bench_linreg, "train_optimizer", short)
    assert run.main(["--only", "linreg", "--fast", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    got = [ln.split(",")[0] for ln in lines if ln.startswith("linreg_")]
    monkeypatch.setattr(jlinreg, "train_optimizer", lambda *a, **k: {
        "s_per_step": 0.0, "eval": 0.0, "steps_to_target": None})
    jlinreg.main(fast=True)
    want = [ln.split(",")[0] for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("linreg_")]
    assert got == want and len(want) == 7
    assert lines[1] == "name,us_per_call,derived"


@pytest.mark.parametrize("only", ["data", "overhead,linreg", "roofline", "serve", "nope"])
def test_run_refuses_what_has_no_port(only, capsys):
    assert run.main(["--only", only, "--device", "cpu"]) == 2
    assert "not ported yet" in capsys.readouterr().err


def test_backend_describe_names_the_resolved_plan():
    assert Backend().describe("cpu") == {"attention": "reference", "optimizer": "reference",
                                         "stats": "reference", "device": "cpu"}
    assert Backend.all_fused().describe(torch.device("cpu"))["optimizer"] == "fused"


@pytest.mark.parametrize("argv", [[], ["2e7ac75"], ["a1b2c3d", "csrc"]])
def test_norm_sums_probe_takes_a_known_parent_and_its_sources(argv):
    """``norm_sums_probe PARENT DIR``: a parent without its own table of C
    signatures, or a missing argument, stops with the usage before any
    build; each table names sources this tree still has."""
    from pathlib import Path

    from repro_torch.benchmarks import norm_sums_probe as probe

    with pytest.raises(SystemExit) as stop:
        probe.main(argv)
    assert "norm_sums_probe PARENT" in str(stop.value)
    csrc = Path(probe.__file__).parents[1] / "kernels" / "csrc"
    assert set(probe.PARENT_SIGNATURES) == {"2e7ac75", "d548add"}
    for libs in probe.PARENT_SIGNATURES.values():
        assert all((csrc / f"{name}.cu").is_file() for name in libs)
