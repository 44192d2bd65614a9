"""Port parity: the whole VR-LAMB train step (repro_torch.train.trainer)
against the JAX package's ``make_train_step``.

Both sides start from the reference's init params (carried across with
``params_from_numpy``) and take the same batches: ``lm_batches`` of each
package (the port's is a copy; the test checks they agree) or a packed batch
made with numpy.  Compute is f32 on both sides; the JAX side runs its
reference plan (jnp attention, tree carry, tree optimizer math) with
``scan_layers=True``, so every stacked leaf is one GSNR / trust-ratio layer.
The port runs each of its plans on the CPU: "reference" (plain attention,
tree carry and tree math) and "fused" (the kernel wrappers: the attention
autograd Function, the flat carry and the flat VR-LAMB update, which on CPU
tensors compute their plain versions).

Tolerances, from the measured gaps (f32 math in another summation order):
loss, grad_norm and update_norm rtol 1e-5 (measured <= 2e-7 relative);
params ``oracle.tol_for(float32)`` (atol 2e-5, rtol 2e-4; measured
<= 1.3e-5).  The GSNR quantities are ill-conditioned in the reference
itself: r = g^2 / (g2 - g^2 + eps) amplifies the rounding of a variance
that cancels to near zero, a few such elements dominate their leaf's mean
of r, and every element of the leaf is normalized by that mean, so elements
within ~1e-4 of the clip floor can land on either side of it.  Hence
gsnr/* atol 5e-4 (measured <= 6e-6 on the Markov batches, 1.0e-4 on the
second packed step) and m, v, p per leaf ||port - ref|| <= 3e-3 ||ref||
(measured <= 1.8e-4 on the Markov batches, 1.0e-3 on the second packed
step, where most embedding rows are seen by a single microbatch).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import packed_positions, tol_for
from repro.backend import Backend as JBackend
from repro.configs import get_smoke as j_get_smoke
from repro.data import lm_batches as j_lm_batches
from repro.models import transformer as jt
from repro.train import trainer as jtr
from repro_torch.backend import Backend
from repro_torch.configs import get_smoke
from repro_torch.core.accumulate import split_batch
from repro_torch.core.layout import is_flat, tree_map, tree_paths
from repro_torch.data import lm_batches
from repro_torch.train import init_state, make_train_step, train_loop
from repro_torch.train.checkpoint import flat_to_numpy, params_from_numpy

TOL = tol_for(jnp.float32)
SCALARS = ("loss", "grad_norm", "update_norm")
GSNR = ("gsnr/mean", "gsnr/min", "gsnr/frac_floor")
STATE_REL = 3e-3


def _cfgs(arch, plan, name="vr_lamb", **opt):
    jcfg, tcfg = j_get_smoke(arch), get_smoke(arch)
    tb = Backend.all_fused() if plan == "fused" else Backend.all_reference()
    jcfg = jcfg.replace(
        parallel=dataclasses.replace(jcfg.parallel, compute_dtype="float32",
                                     backend=JBackend.all_reference()),
        optimizer=dataclasses.replace(jcfg.optimizer, name=name, **opt))
    tcfg = tcfg.replace(
        parallel=dataclasses.replace(tcfg.parallel, compute_dtype="float32", backend=tb),
        optimizer=dataclasses.replace(tcfg.optimizer, name=name, **opt))
    return jcfg, tcfg


def _state_tree(x):
    if is_flat(x):
        return flat_to_numpy(x.data, x.layout)
    return tree_map(lambda t: t.float().numpy(), x)


def _run_both(jcfg, tcfg, batches):
    jp = jt.init_params(jcfg.model, jax.random.PRNGKey(0))
    jstate = jtr.init_state(jcfg, params=jp)
    jstep = jax.jit(jtr.make_train_step(jcfg, log_gsnr=True)[0])
    tstate = init_state(tcfg, params=params_from_numpy(jax.device_get(jp), tcfg.model),
                        device="cpu")
    tstep = make_train_step(tcfg, log_gsnr=True, device="cpu")[0]
    # a generator: the port updates its params and flat state in place, so
    # each step is compared before the next one runs
    for batch in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        yield jstate, jm, tstate, tm


def _compare(jstate, jm, tstate, tm, step):
    """Metrics, params and every optimizer state buffer of one step (the
    GSNR metrics where the step logged them; the reference's MoE readings
    have no counterpart)."""
    assert set(tm) <= set(jm) and ("gsnr/mean" in tm) == ("gsnr/mean" in jm), \
        (sorted(tm), sorted(jm))
    for k in SCALARS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=f"{k} @ {step}")
    for k in GSNR:
        if k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=5e-4,
                                       err_msg=f"{k} @ {step}")
    tparams = flat_to_numpy(tstate.params.data, tstate.params.layout)
    jparams = jax.device_get(jstate.params)
    for (path, a), (_, b) in zip(tree_paths(tparams), tree_paths(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=f"params {path} @ {step}", **TOL)
    assert tstate.step == int(jstate.step) == step + 1
    assert set(tstate.opt_state) == set(jstate.opt_state)
    if "pt" in jstate.opt_state:
        assert tstate.opt_state["pt"] == int(jstate.opt_state["pt"])
    for name in sorted(set("mvp") & set(jstate.opt_state)):
        got = _state_tree(tstate.opt_state[name])
        want = jax.device_get(jstate.opt_state[name])
        for (path, a), (_, b) in zip(tree_paths(got), tree_paths(want)):
            b = np.asarray(b, np.float32)
            err = np.linalg.norm(a - b)
            assert err <= STATE_REL * np.linalg.norm(b) + 1e-12, (name, path, step, err)


@pytest.mark.parametrize("plan", ["reference", "fused"])
@pytest.mark.parametrize("arch", ["bert-large", "internlm2-1.8b"])
def test_train_step_matches_reference(arch, plan):
    jcfg, tcfg = _cfgs(arch, plan)
    jb = j_lm_batches(jcfg.model.vocab_size, jcfg.global_batch, jcfg.seq_len)
    tb = lm_batches(tcfg.model.vocab_size, tcfg.global_batch, tcfg.seq_len)
    batches = []
    for _ in range(3):
        a, b = next(jb), next(tb)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
        batches.append(b)
    for step, (jstate, jm, tstate, tm) in enumerate(_run_both(jcfg, tcfg, batches)):
        # the global clip is active: the mean gradient is rescaled to norm 1
        assert float(tm["grad_norm"]) > tcfg.optimizer.grad_clip
        _compare(jstate, jm, tstate, tm, step)
    fused = plan == "fused"
    assert is_flat(tstate.opt_state["m"]) == fused


def test_train_step_matches_reference_without_clip():
    jcfg, tcfg = _cfgs("bert-large", "fused", grad_clip=0.0)
    batches = [next(lm_batches(tcfg.model.vocab_size, tcfg.global_batch, tcfg.seq_len))]
    for step, (jstate, jm, tstate, tm) in enumerate(_run_both(jcfg, tcfg, batches)):
        _compare(jstate, jm, tstate, tm, step)


def _packed_batch(b, s, vocab, seed):
    rs = np.random.default_rng(seed)
    rows = [[(s // 2, 0), (s // 4, 0)], [(s - 5, 0)], [(3, 0), (s // 2, 0), (s // 3, 0)],
            [(s, 0)]]
    pos = np.stack([packed_positions(s, rows[i % len(rows)]) for i in range(b)])
    toks = rs.integers(0, vocab, size=(b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "positions": pos}


@pytest.mark.parametrize("plan", ["reference", "fused"])
def test_packed_train_step_matches_reference(plan):
    """Packed rows with padded tails: the loss masks positions < 0, the
    attention gates segments, and pad rows reach no gradient."""
    jcfg, tcfg = _cfgs("bert-large", plan)
    batches = [_packed_batch(tcfg.global_batch, tcfg.seq_len, tcfg.model.vocab_size, i)
               for i in range(2)]
    for step, (jstate, jm, tstate, tm) in enumerate(_run_both(jcfg, tcfg, batches)):
        _compare(jstate, jm, tstate, tm, step)
        np.testing.assert_allclose(float(tm["pack_efficiency"]), float(jm["pack_efficiency"]),
                                   rtol=1e-6)
        assert float(tm["pack_efficiency"]) < 1.0


def test_split_batch_raises_on_a_remainder():
    batch = {"tokens": torch.zeros((10, 4), dtype=torch.int32),
             "targets": torch.zeros((10, 4), dtype=torch.int32)}
    mb = split_batch(batch, 5)
    assert mb["tokens"].shape == (5, 2, 4)
    with pytest.raises(ValueError, match=r"batch_size=10 is not divisible by k=4.*remainder 2"):
        split_batch(batch, 4)
    with pytest.raises(ValueError, match="ragged"):
        split_batch({"a": torch.zeros((4, 1)), "b": torch.zeros((2, 1))}, 2)


def test_train_loop_runs_the_smoke_on_cpu():
    cfg = get_smoke("bert-large")
    state, hist = train_loop(cfg, lm_batches(cfg.model.vocab_size, cfg.global_batch,
                                             cfg.seq_len), steps=2, log_every=1, log_gsnr=True,
                             device="cpu")
    assert state.step == 2 and len(hist) == 2
    assert all(np.isfinite(h["loss"]) and 0.1 <= h["gsnr/mean"] <= 1.0 for h in hist)


def test_entry_points_default_to_the_card():
    cfg = get_smoke("bert-large")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(cfg)


@pytest.mark.parametrize("opt,err,match", [
    (dict(stats_method="vmap", gsnr_source="data_axis"), NotImplementedError, "vmap"),
    (dict(gsnr_source="data_axis"), NotImplementedError, "data_axis"),
    (dict(name="adagrad"), KeyError, "unknown optimizer"),
])
def test_unported_paths_and_unknown_optimizers_raise(opt, err, match):
    """The vmap stats method under a mesh raises ("stats_method='vmap' under
    a mesh is not ported") before the mesh is used: a one-rank mesh that
    joined no process group stands in for one."""
    from repro_torch.launch.mesh import DataMesh

    cfg = get_smoke("bert-large")
    cfg = cfg.replace(optimizer=dataclasses.replace(cfg.optimizer, **opt))
    batch = next(lm_batches(cfg.model.vocab_size, cfg.global_batch, cfg.seq_len))
    mesh = DataMesh(1, 0, torch.device("cpu"), "gloo") if "stats_method" in opt else None
    with pytest.raises(err, match=match):
        step = make_train_step(cfg, device="cpu", mesh=mesh)[0]
        step(init_state(cfg, device="cpu"), batch)


def test_default_optimizer_resolves_from_the_params_device():
    """make_optimizer(cfg) on the default (auto) plan keeps tree state for
    CPU params, and an update whose params lie elsewhere than the state's
    plan raises instead of running the other math."""
    from repro_torch.core.layout import FlatBuffer, FlatParams
    from repro_torch.core.vrgd import make_optimizer
    from repro_torch.models import init_params

    cfg = get_smoke("bert-large")
    flat = FlatParams(init_params(cfg.model, torch.Generator().manual_seed(0)),
                      cfg.model.n_groups(), device="cpu")
    opt = make_optimizer(cfg.optimizer)
    state = opt.init(flat)
    assert not any(is_flat(state[k]) for k in ("m", "v", "p"))
    assert set(state["m"]) == set(flat.stacked())
    fused_state = make_optimizer(cfg.optimizer, Backend.all_fused()).init(flat)
    assert all(is_flat(fused_state[k]) for k in ("m", "v", "p"))
    w = FlatBuffer(flat.data, flat.layout)
    with pytest.raises(ValueError, match="plan resolves optimizer='reference'"):
        opt.update(w, fused_state, w)


def test_mixed_stats_and_optimizer_plans_raise():
    cfg = get_smoke("bert-large")
    cfg = cfg.replace(parallel=dataclasses.replace(
        cfg.parallel, backend=Backend(stats="fused", optimizer="reference")))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        make_train_step(cfg, device="cpu")


def test_transformer_module_parameters_take_gradients():
    """The serving module's parameters require grad (its compute-dtype
    cache is detached, so serving builds no graph)."""
    from repro_torch.models import Transformer, init_params

    cfg = get_smoke("bert-large")
    module = Transformer(cfg.model, init_params(cfg.model, torch.Generator().manual_seed(0)))
    assert all(p.requires_grad for p in module.parameters())
    half = module.compute_params(torch.bfloat16)
    assert not half["groups"][0]["pos0"]["attn"]["wq"].requires_grad
