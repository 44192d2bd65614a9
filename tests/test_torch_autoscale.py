"""Port parity of the autoscaled training loop (repro_torch.train.autoscale)
and of ``eval_loss`` against the JAX package's.

The loop runs tests/test_autoscale.py's settings (the TINY model, VR-Adam,
k0 = 2, base_batch 8 on the sqrt rule, the same policy) in f32 compute on
both sides, from the reference's init params and the same stream, with
fixed microbatches on each of the port's plans and loader-driven from an
IndexedPackedDataset on the fused plan.  It must take the reference's k
trajectory, report the LR of the sqrt rule at each step's live effective
batch (rel 1e-5), and read the same noise scale: the two squared norms,
recovered from the tr_sigma and g2 each loop hands its EMA, within rtol
1e-4 at the first step (the same params: two programs' carries,
tests/test_torch_noise_scale.py) and 2e-3 over the run, where the params
drift apart within tests/test_torch_train.py's tolerances (measured:
<= 7.1e-4 on the fused plan, 6.1e-4 on the reference plan, over 12 steps);
tr_sigma, g2 and b_simple within the bounds those give
(test_torch_noise_scale.py::check_estimate)."""
import math

import jax
import numpy as np
import pytest
import torch

import repro.core.noise_scale as jns
import repro_torch.core.noise_scale as tns
from repro.backend import Backend as JBackend
from repro.configs.base import Config as JConfig
from repro.configs.base import ModelConfig as JModel
from repro.configs.base import OptimizerConfig as JOpt
from repro.configs.base import ParallelismConfig as JPar
from repro.train import autoscale as jas
from repro.train import trainer as jtr
from repro_torch.backend import Backend
from repro_torch.configs.base import Config, ModelConfig, OptimizerConfig, ParallelismConfig
from repro_torch.train import autoscale as tas
from repro_torch.train import init_state
from repro_torch.train.checkpoint import params_from_numpy
from test_torch_noise_scale import X_RTOL, check_estimate

TRAJ_RTOL = 2e-3
MODEL = dict(name="tiny", n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
             vocab_size=64)
OPT = dict(name="vr_adam", lr=1e-3, warmup_steps=0, total_steps=60, k=2, base_batch=8,
           lr_scale_rule="sqrt", schedule="constant")
POLICY = dict(k_min=2, k_max=16, warmup_steps=3, cooldown=2, hysteresis=1.25, ema_beta=0.8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-sized work: one intra-op thread keeps this file from
    oversubscribing the cores the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(plan):
    jcfg = JConfig(model=JModel(**MODEL), optimizer=JOpt(**OPT),
                   parallel=JPar(compute_dtype="float32", backend=JBackend.all_reference()),
                   global_batch=8, seq_len=32)
    bk = Backend.all_fused() if plan == "fused" else Backend.all_reference()
    tcfg = Config(model=ModelConfig(**MODEL), optimizer=OptimizerConfig(**OPT),
                  parallel=ParallelismConfig(compute_dtype="float32", backend=bk),
                  global_batch=8, seq_len=32)
    return jcfg, tcfg


@pytest.fixture
def readings(monkeypatch):
    """The (tr_sigma, g2) each package's loop hands its EMA, step by step."""
    got = {"ref": [], "port": []}
    for key, mod in (("ref", jns), ("port", tns)):
        real = mod.update_noise_state

        def spy(st, tr, g2, beta=0.9, real=real, key=key):
            got[key].append((tr, g2))
            return real(st, tr, g2, beta=beta)

        monkeypatch.setattr(mod, "update_noise_state", spy)
    return got


def _sums(tr, g2, b_small, b_big):
    """(g2_small, g2_big) back from (tr_sigma, g2) (core/noise_scale.py)."""
    g2_big = g2 + tr / b_big
    return g2_big + tr * (1.0 / b_small - 1.0 / b_big), g2_big


def _check_run(jh, th, readings, mb_rows):
    assert [r["k"] for r in th] == [r["k"] for r in jh]
    assert len(set(r["k"] for r in th)) > 1, "k never moved"
    assert len(readings["port"]) == len(readings["ref"]) == len(th)
    for i, (jr, tr) in enumerate(zip(jh, th)):
        assert tr["effective_batch"] == jr["effective_batch"] == tr["k"] * mb_rows
        assert tr["lr"] == pytest.approx(OPT["lr"] * math.sqrt(tr["effective_batch"] / 8),
                                         rel=1e-5)
        assert tr["tokens"] == jr["tokens"]
        b_big = tr["effective_batch"]
        b_small = b_big / tr["k"]
        est = {}
        for key, (t, g) in (("port", readings["port"][i]), ("ref", readings["ref"][i])):
            s, b = _sums(t, g, b_small, b_big)
            est[key] = {"g2_small": s, "g2_big": b, "tr_sigma": t, "g2": g}
        est["port"]["b_simple"], est["ref"]["b_simple"] = tr["b_simple"], jr["b_simple"]
        check_estimate(est["port"], est["ref"], b_small, b_big,
                       X_RTOL if i == 0 else TRAJ_RTOL, f"step {i}")
        assert i == 0 or np.isfinite(tr["b_simple"])


def test_policy_matches_the_reference_over_a_grid():
    for kw in (dict(POLICY), dict(k_min=2, k_max=64, warmup_steps=5, cooldown=3,
                                  hysteresis=1.5, target_frac=0.5, max_step_factor=4)):
        tp, jp = tas.AutoscalePolicy(**kw), jas.AutoscalePolicy(**kw)
        for batch in (1, 7, 28, 48, 64, 100):
            assert tp.feasible_ks(batch) == jp.feasible_ks(batch)
        for step in (0, 4, 5, 9, 20):
            for k in (2, 3, 8, 16, 64):
                for b in (float("nan"), -3.0, 0.0, 1e-3, 8.0, 33.6, 256.0, 1e9):
                    for last in (None, 3, step - 1):
                        for feasible in (None, tp.feasible_ks(48)):
                            args = dict(step=step, current_k=k, b_simple=b, microbatch_size=4,
                                        last_change_step=last, feasible=feasible)
                            assert tp.propose(**args) == jp.propose(**args), args
    with pytest.raises(ValueError, match="positive"):
        tas.AutoscalePolicy().feasible_ks(0)


@pytest.mark.parametrize("kw, match", [
    (dict(k_min=1), "k_min"), (dict(k_min=4, k_max=2), "k_max"),
    (dict(hysteresis=1.0), "hysteresis"), (dict(max_step_factor=1), "max_step_factor"),
    (dict(ema_beta=1.0), "ema_beta"),
])
def test_policy_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        tas.AutoscalePolicy(**kw)
    with pytest.raises(ValueError, match=match):
        jas.AutoscalePolicy(**kw)


def test_loop_requires_a_stop_condition():
    with pytest.raises(ValueError, match="steps"):
        tas.autoscale_train_loop(_cfgs("fused")[1], iter([]), device="cpu")


def test_autoscale_loop_matches_the_reference(readings):
    from repro.data import lm_batches as j_lm_batches
    from repro_torch.data import lm_batches

    jcfg, _ = _cfgs("fused")
    jstate = jtr.init_state(jcfg)
    _, jh = jas.autoscale_train_loop(jcfg, j_lm_batches(64, 4, 32, seed=0), steps=12,
                                     policy=jas.AutoscalePolicy(**POLICY), state=jstate)
    ref = list(readings["ref"])
    for plan in ("fused", "reference"):
        _, tcfg = _cfgs(plan)
        readings["port"].clear()
        readings["ref"][:] = ref
        state = init_state(tcfg, params=params_from_numpy(jax.device_get(jstate.params),
                                                          tcfg.model), device="cpu")
        state, th = tas.autoscale_train_loop(tcfg, lm_batches(64, 4, 32, seed=0), steps=12,
                                             policy=tas.AutoscalePolicy(**POLICY), state=state)
        _check_run(jh, th, readings, 4)
        assert state.k == th[-1]["k"] and state.step == len(th)


def test_loader_driven_loop_and_eval_loss_match_the_reference(tmp_path, readings):
    import repro.data as jd
    from repro.train import make_loss_fn as j_make_loss_fn
    from repro_torch import data as td
    from repro_torch.train import eval_loss

    jcfg, tcfg = _cfgs("fused")
    d = str(tmp_path / "cache")
    td.write_token_cache(td.markov_documents(64, 4000, 5, 60, seed=0, stream_seed=1), d)
    jds = jd.IndexedPackedDataset(jd.TokenCache(d), seq_len=32, batch_rows=4, seed=0)
    jstate = jtr.init_state(jcfg)
    jstate, jh = jas.autoscale_train_loop(jcfg, jds, steps=10,
                                          policy=jas.AutoscalePolicy(**POLICY), state=jstate)
    tds = td.IndexedPackedDataset(td.TokenCache(d), seq_len=32, batch_rows=4, seed=0)
    requested = []
    real_next = tds.next_batch

    def spy(rows=None):
        requested.append(rows)
        return real_next(rows)

    tds.next_batch = spy
    state = init_state(tcfg, params=params_from_numpy(
        jax.device_get(jtr.init_state(jcfg).params), tcfg.model), device="cpu")
    state, th = tas.autoscale_train_loop(tcfg, tds, steps=10,
                                         policy=tas.AutoscalePolicy(**POLICY), state=state)
    _check_run(jh, th, readings, 4)
    assert requested == [r["k"] * 4 for r in th]
    for jr, tr in zip(jh, th):
        assert (tr["epoch"], tr["pack_efficiency"]) == (jr["epoch"], jr["pack_efficiency"])
    assert tds.state == jds.state
    # eval over one padded epoch of a separate cache, from each run's params
    e = str(tmp_path / "eval")
    td.write_token_cache(td.markov_documents(64, 700, 5, 60, seed=0, stream_seed=9), e)
    want = jtr.eval_loss(jcfg, j_make_loss_fn(jcfg), jstate.params,
                         jd.IndexedPackedDataset(e, 32, 4, seed=0))
    got = eval_loss(tcfg, None, state.params, td.IndexedPackedDataset(e, 32, 4, seed=0))
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-4)
    ref_params = params_from_numpy(jax.device_get(jstate.params), tcfg.model)
    assert eval_loss(tcfg, None, ref_params, td.IndexedPackedDataset(e, 32, 4, seed=0)) == \
        pytest.approx(want, rel=1e-5)
