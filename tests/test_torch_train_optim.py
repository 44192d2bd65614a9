"""Port parity of the train step with every optimizer family: each VR
optimizer's fresh steps, the stale-GSNR ``train_loop`` (``gsnr_refresh = 2``)
and one baseline (``grad_only``) step, against the JAX package's
``make_train_step`` / ``train_loop``.

The setting is tests/test_torch_train.py's (whose helpers this file uses):
both sides start from the reference's init params and take the same
``lm_batches``, f32 compute, the JAX side on its reference plan with
``scan_layers=True``, the port on each of its plans on the CPU.  Where the
reference smoke names an optimizer it is kept (internlm2-1.8b ``vr_sgd``,
granite-3-2b ``vr_momentum``); bert-large runs ``vr_adam`` and ``vr_lars``.
Each JAX run is cached in a module-scoped fixture and shared by the port's
two plans.

Tolerances are test_torch_train.py's, unchanged (loss, grad_norm,
update_norm rtol 1e-5; params ``oracle.tol_for(float32)``; gsnr/* atol
5e-4; each state leaf within 3e-3 of its norm); no new one is needed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.data import lm_batches as j_lm_batches
from repro.models import transformer as jt
from repro.train import trainer as jtr
from repro_torch.core.layout import is_flat
from repro_torch.data import lm_batches
from repro_torch.kernels import flat_stats as fs
from repro_torch.kernels import flat_update as fu
from repro_torch.train import init_state, make_train_step, train_loop
from repro_torch.train.checkpoint import params_from_numpy
from test_torch_train import _cfgs, _compare

CASES = [("bert-large", "vr_adam"), ("bert-large", "vr_lars"), ("internlm2-1.8b", "vr_sgd"),
         ("granite-3-2b", "vr_momentum"), ("bert-large", "lamb")]
STEPS = 2


def _batches(cfg, n):
    stream = lm_batches(cfg.model.vocab_size, cfg.global_batch, cfg.seq_len)
    return [next(stream) for _ in range(n)]


@pytest.fixture(scope="module")
def jax_runs():
    """{(arch, optimizer): (init params, [(state, metrics) after each step])}
    of the JAX train step, computed on first use."""
    cache = {}

    def run(arch, name):
        if (arch, name) not in cache:
            jcfg, _ = _cfgs(arch, "reference", name)
            jp = jt.init_params(jcfg.model, jax.random.PRNGKey(0))
            jstate = jtr.init_state(jcfg, params=jp)
            jstep = jax.jit(jtr.make_train_step(jcfg, log_gsnr=True)[0])
            stream = j_lm_batches(jcfg.model.vocab_size, jcfg.global_batch, jcfg.seq_len)
            hist = []
            for _ in range(STEPS):
                jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in next(stream).items()})
                hist.append(jax.device_get((jstate, jm)))
            cache[arch, name] = (jax.device_get(jp), hist)
        return cache[arch, name]

    return run


@pytest.mark.parametrize("plan", ["reference", "fused"])
@pytest.mark.parametrize("arch,name", CASES)
def test_train_step_matches_reference(arch, name, plan, jax_runs):
    """Fresh VR steps (k microbatches) and a baseline's single backward."""
    jp, hist = jax_runs(arch, name)
    _, tcfg = _cfgs(arch, plan, name)
    state = init_state(tcfg, params=params_from_numpy(jp, tcfg.model), device="cpu")
    step = make_train_step(tcfg, log_gsnr=True, device="cpu")[0]
    flat_form = plan == "fused" and name.startswith("vr_")
    assert all(is_flat(state.opt_state[k]) == flat_form for k in "mvp" if k in state.opt_state)
    for i, batch in enumerate(_batches(tcfg, STEPS)):
        state, tm = step(state, batch)
        jstate, jm = hist[i]
        _compare(jstate, jm, state, tm, i)
        assert ("gsnr/mean" in tm) == name.startswith("vr_")


def _loop_history(history):
    return [(h["loss"], h["grad_norm"], "gsnr/mean" in h) for h in history]


@pytest.fixture(scope="module")
def jax_loops():
    cache = {}

    def run(name):
        if name not in cache:
            jcfg, _ = _cfgs("bert-large", "reference", name, gsnr_refresh=2)
            # a host copy: the loop donates its state, the init params with it
            jp = jax.device_get(jt.init_params(jcfg.model, jax.random.PRNGKey(0)))
            stream = j_lm_batches(jcfg.model.vocab_size, jcfg.global_batch, jcfg.seq_len)
            jstate, hist = jtr.train_loop(jcfg, stream, 3, state=jtr.init_state(jcfg, params=jp),
                                          log_every=1, log_gsnr=True)
            cache[name] = (jp, jax.device_get(jstate), hist)
        return cache[name]

    return run


@pytest.mark.parametrize("plan", ["reference", "fused"])
@pytest.mark.parametrize("name", ["vr_adam", "vr_lamb"])
def test_stale_train_loop_matches_reference(name, plan, jax_loops, monkeypatch):
    """gsnr_refresh = 2: steps 0 and 2 fresh, step 1 stale (no Σg² carry,
    stats=None: p and pt stay).  On the fused plan the stale step's carry
    is the g-only wrapper, called once per microbatch, and the stale update
    calls no kernel wrapper."""
    jp, jstate, jhist = jax_loops(name)
    _, tcfg = _cfgs("bert-large", plan, name, gsnr_refresh=2)
    state = init_state(tcfg, params=params_from_numpy(jp, tcfg.model), device="cpu")
    calls = {}

    def counted(mod, fn_name):
        fn = getattr(mod, fn_name)

        def wrapper(*args, **kw):
            calls[fn_name] = calls.get(fn_name, 0) + 1
            return fn(*args, **kw)

        monkeypatch.setattr(mod, fn_name, wrapper)

    for mod, fn_name in ((fs, "flat_g_accum"), (fs, "flat_moments_accum"), (fu, "flat_vr_adam"),
                         (fu, "flat_vr_lamb")):
        counted(mod, fn_name)
    state, hist = train_loop(tcfg, lm_batches(tcfg.model.vocab_size, tcfg.global_batch,
                                              tcfg.seq_len), 3, state=state, log_every=1,
                             log_gsnr=True, device="cpu")
    k = tcfg.optimizer.k
    want = {"flat_g_accum": k, "flat_moments_accum": 2 * k, f"flat_{name}": 2}
    assert calls == (want if plan == "fused" else {})
    assert [h[2] for h in _loop_history(hist)] == [True, False, True]
    for (tl, tg, _), (jl, jg, _) in zip(_loop_history(hist), _loop_history(jhist)):
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_allclose(tg, jg, rtol=1e-5)
    assert state.opt_state["pt"] == int(jstate.opt_state["pt"]) == 2
    metrics = {k: hist[-1][k] for k in hist[-1] if k not in ("step", "wall")}
    jmetrics = {k: jhist[-1][k] for k in jhist[-1] if k not in ("step", "wall")}
    _compare(jstate, jmetrics, state, metrics, 2)


def test_stale_steps_only_for_vr_adam_and_vr_lamb():
    """train_loop runs every step fresh for the other optimizers, whatever
    gsnr_refresh says (as the reference does)."""
    _, tcfg = _cfgs("bert-large", "reference", "vr_sgd", gsnr_refresh=2)
    _, hist = train_loop(tcfg, lm_batches(tcfg.model.vocab_size, tcfg.global_batch,
                                          tcfg.seq_len), 2, log_every=1, log_gsnr=True,
                         device="cpu")
    assert all("gsnr/mean" in h for h in hist)


def test_stale_step_of_an_optimizer_without_one_raises():
    _, tcfg = _cfgs("bert-large", "fused", "vr_momentum")
    step = make_train_step(tcfg, device="cpu")[0]
    with pytest.raises(ValueError, match="require GradStats"):
        step(init_state(tcfg, device="cpu"), _batches(tcfg, 1)[0], with_stats=False)
