"""Port parity: the six architectures of the other block kinds (MoE,
RG-LRU, mLSTM/sLSTM, cross-attention with its encoder and image stub)
through the port's entry points, against the JAX package.

Each smoke config's JAX init params are carried across with
``params_from_numpy``; tokens and the stub inputs (frame / patch
embeddings) are drawn with numpy from a seed.  Compute is f32 on both
sides.  Tolerances:

  * logits, decode logits and parameters after a step:
    ``oracle.tol_for(float32)`` (atol 2e-5, rtol 2e-4: the same math in
    another summation order; measured <= 1.1e-5 on the logits);
  * the MoE readings (aux): atol 1e-6 (f32 means of router statistics);
  * a VR step's loss and grad_norm rtol 1e-5, gsnr/* atol 5e-4 (the GSNR
    conditioning of tests/test_torch_train.py);
  * greedy tokens identical, their logprobs atol 1e-4;
  * the port's remat (recompute) against no remat, and the vmap stats
    method against scan: rtol 1e-5 / atol 1e-6 (the same ops, rerun, or
    batched over the k groups).

Routing is discontinuous: an f32 difference could flip a top-k choice.
No flip occurs on these inputs (the logits agree to 1e-5); the tests would
show one as a logit gap far above the tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import tol_for
from torch_fast_jit import fast_jit as _jit
from repro.backend import Backend as JBackend
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.models import transformer as jt
from repro.serve import Engine as JEngine
from repro.train import checkpoint as j_ckpt
from repro.train import trainer as jtr
from repro_torch.backend import Backend
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.accumulate import grad_stats
from repro_torch.core.layout import FlatParams, tree_paths
from repro_torch.models import transformer as tt
from repro_torch.serve import ContinuousEngine, Engine
from repro_torch.train import init_state, make_train_step
from repro_torch.train.checkpoint import flat_to_numpy, load_npz, params_from_numpy, save_npz
from repro_torch.train.loss import make_loss_fn

TOL = tol_for(jnp.float32)
AUX_ATOL = 1e-6
ARCHS = ["mixtral-8x22b", "llama4-maverick-400b-a17b", "recurrentgemma-9b", "xlstm-1.3b",
         "whisper-small", "llama-3.2-vision-11b"]
PAGEABLE = {"mixtral-8x22b", "llama4-maverick-400b-a17b"}  # attention kinds only (+ MoE)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-sized work: one intra-op thread keeps this file from
    oversubscribing the cores the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Lazy(dict):
    """A dict that makes an arch's entry on first use (``make(arch)``), so
    a module fixture shares each JAX compile among the tests of that arch."""

    def __init__(self, make):
        super().__init__()
        self.make = make

    def __missing__(self, arch):
        self[arch] = self.make(arch)
        return self[arch]


@pytest.fixture(scope="module")
def carried():
    """{arch: (JAX params, port params via params_from_numpy)}."""
    def make(arch):
        m = j_get_smoke(arch).model
        jp = _jit(lambda key: jt.init_params(m, key))(jax.random.PRNGKey(0))
        return jp, params_from_numpy(jax.device_get(jp), get_smoke(arch).model)

    return _Lazy(make)


@pytest.fixture(scope="module")
def jax_forward(carried):
    """{arch: (logits at every position, aux, cache)} of the reference
    plan's jitted forward in prefill mode on ``_forward_inputs`` (one
    compile serves the forward and the prefill tests: a fresh prefill's
    logits and readings are the train-mode forward's)."""
    def make(arch):
        jcfg, _ = _cfgs(arch)
        m = jcfg.model
        toks, ex = _forward_inputs(m)
        every = jnp.broadcast_to(jnp.arange(toks.shape[1], dtype=jnp.int32), toks.shape)
        fn = _jit(lambda p, t, e: jt.forward(m, jcfg.parallel, p, t, extra=e, mode="prefill",
                                             cache_len=CACHE_LEN, gather_idx=every))
        return fn(carried[arch][0], jnp.asarray(toks), _j(ex))

    return _Lazy(make)


def _cfgs(arch, plan="reference"):
    jcfg, tcfg = j_get_smoke(arch), get_smoke(arch)
    jb = JBackend.all_fused() if plan == "fused" else JBackend.all_reference()
    tb = Backend.all_fused() if plan == "fused" else Backend.all_reference()
    jcfg = jcfg.replace(parallel=dataclasses.replace(jcfg.parallel, compute_dtype="float32",
                                                     backend=jb))
    tcfg = tcfg.replace(parallel=dataclasses.replace(tcfg.parallel, compute_dtype="float32",
                                                     backend=tb))
    return jcfg, tcfg


def _extra(m, b, seed):
    """The stub inputs a model takes (numpy f32), or None."""
    rs = np.random.default_rng(seed)
    if m.encoder is not None:
        return {"frames": rs.standard_normal((b, m.encoder.n_frames, m.d_model), dtype=np.float32)}
    if m.n_image_tokens:
        return {"image": rs.standard_normal((b, m.n_image_tokens, m.d_model), dtype=np.float32)}
    return None


def _j(ex):
    return None if ex is None else {k: jnp.asarray(v) for k, v in ex.items()}


def _t(ex):
    return None if ex is None else {k: torch.from_numpy(v) for k, v in ex.items()}


def _plain(x):
    """A config value with nested dataclasses as dicts (the two packages'
    MoEConfig / EncoderConfig are different classes with the same fields)."""
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


@pytest.mark.parametrize("which", ["config", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference_field_for_field(arch, which):
    """Every field of the port's model and optimizer configs equals the
    reference's (a field the port lacks is at its default there), and so
    do param_count and active_param_count."""
    want = (j_get_config if which == "config" else j_get_smoke)(arch)
    got = (get_config if which == "config" else get_smoke)(arch)
    for part in ("model", "optimizer"):
        g, w = getattr(got, part), getattr(want, part)
        names = {f.name for f in dataclasses.fields(g)}
        for name in names:
            assert _plain(getattr(g, name)) == _plain(getattr(w, name)), (part, name)
        for f in dataclasses.fields(w):
            if f.name not in names:
                assert getattr(w, f.name) == f.default, (part, f.name)
    for name in ("seed", "global_batch", "seq_len"):
        assert getattr(got, name) == getattr(want, name)
    assert got.model.param_count() == want.model.param_count()
    assert got.model.active_param_count() == want.model.active_param_count()


CACHE_LEN = 24


def _forward_inputs(m):
    return np.random.default_rng(1).integers(0, m.vocab_size, size=(2, 12)), _extra(m, 2, 2)


@pytest.mark.parametrize("plan", ["reference", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match(arch, plan, carried, jax_forward):
    """Both of the port's plans against the reference plan's forward (the
    fused plan's kernels compute their plain versions on the CPU)."""
    _, tcfg = _cfgs(arch, plan)
    tp = carried[arch][1]
    m = tcfg.model
    toks, ex = _forward_inputs(m)
    jl, jaux, _ = jax_forward[arch]
    tl, taux, _ = tt.forward(m, tcfg.parallel, tp, torch.from_numpy(toks), extra=_t(ex))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), atol=AUX_ATOL, err_msg=k)
    if m.moe is not None:
        assert 0.0 < float(taux["moe_util"]) <= 1.0 and float(taux["moe_lb_loss"]) > 0.0


def _compare_caches(jc, tc_, path=""):
    """Cache trees: the port's lists of groups against the reference's
    stacked or listed ones; tuples (xLSTM states) element by element."""
    if isinstance(jc, dict):
        assert set(tc_) == set(jc), (path, sorted(tc_), sorted(jc))
        for k in jc:
            _compare_caches(jc[k], tc_[k], f"{path}/{k}")
    elif isinstance(jc, (list, tuple)):
        assert len(tc_) == len(jc), path
        for i, (a, b) in enumerate(zip(jc, tc_)):
            _compare_caches(a, b, f"{path}/{i}")
    else:
        np.testing.assert_allclose(tc_.float().numpy(), np.asarray(jc, np.float32), **TOL,
                                   err_msg=path)


def _group_slice(jcache, g):
    """Group g of the reference's cache (stacked groups are indexed)."""
    groups = jcache["groups"]
    if isinstance(groups, list):
        return groups[g]
    return jax.tree_util.tree_map(lambda a: a[g], groups)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match(arch, carried, jax_forward):
    """A fresh prefill, then three greedy decode steps: logits, and every
    block's cache after the last step (the attention caches, the RG-LRU's h
    and conv window, the xLSTM states, the cross cache and the memory)."""
    jcfg, _ = _cfgs(arch)
    _, tcfg = _cfgs(arch, "fused")
    jp, tp = carried[arch]
    m = jcfg.model
    toks, ex = _forward_inputs(m)
    jdecode = _jit(lambda p, c, t, q: jt.decode_step(m, jcfg.parallel, p, c, t, q))
    jl, _, jcache = jax_forward[arch]
    jl = jl[:, -1:]
    tl, tcache = tt.prefill(tcfg.model, tcfg.parallel, tp, torch.from_numpy(toks), extra=_t(ex),
                            cache_len=CACHE_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    pos = np.full((2,), 12, np.int32)
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
    for _ in range(3):
        jl, jcache = jdecode(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tl, tcache = tt.decode_step(tcfg.model, tcfg.parallel, tp, tcache, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
        pos = pos + 1
    for g in range(m.n_groups()):
        _compare_caches(_group_slice(jcache, g), tcache["groups"][g], f"groups/{g}")
    _compare_caches(jcache["tail"], tcache["tail"], "tail")
    assert ("memory" in tcache) == ("memory" in jcache)
    if "memory" in jcache:
        _compare_caches(jcache["memory"], tcache["memory"], "memory")


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_match(arch):
    """cache_shapes (meta tensors) against the reference's abstract prefill,
    leaf for leaf (a stacked reference group's leading axis dropped)."""
    jcfg, tcfg = _cfgs(arch)
    m = jcfg.model
    ex = _extra(m, 3, 0)
    jshapes = None if ex is None else {k: jax.ShapeDtypeStruct(v.shape, jnp.float32)
                                       for k, v in ex.items()}
    js = jt.cache_shapes(m, jcfg.parallel, 3, 8, 24, extra_shapes=jshapes)
    ts = tt.cache_shapes(tcfg.model, tcfg.parallel, 3, 8, 24)
    assert len(ts["groups"]) == m.n_groups() and set(ts) == set(js)
    stacked = not isinstance(js["groups"], list)
    pairs = [(_group_slice_shapes(js, g, stacked), ts["groups"][g]) for g in range(m.n_groups())]
    pairs += [(js["tail"], ts["tail"])] + ([(js["memory"], ts["memory"])] if "memory" in js else [])
    for want_tree, got_tree in pairs:
        want, got = tree_paths(want_tree), tree_paths(got_tree)
        assert [p for p, _ in want] == [p for p, _ in got]
        for (path, w), (_, t) in zip(want, got):
            assert tuple(t.shape) == tuple(w.shape), path
            assert t.dtype == getattr(torch, str(w.dtype)) and t.device.type == "meta", path


def _group_slice_shapes(js, g, stacked):
    if not stacked:
        return js["groups"][g]
    return jax.tree_util.tree_map(lambda s: jax.ShapeDtypeStruct(s.shape[1:], s.dtype),
                                  js["groups"])


def _jax_step(jcfg, jp):
    jstate = jtr.init_state(jcfg, params=jp)
    return jstate, _jit(jtr.make_train_step(jcfg, log_gsnr=True)[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_vr_train_step_matches(arch, carried):
    """One step of the config's own VR optimizer (VR-LAMB: mixtral,
    llama4, vision; VR-Adam: recurrentgemma, xlstm, whisper) on the port's
    fused plan (the kernels' plain versions on the CPU: the attention
    Function, the flat carry and update) against the JAX step: loss (ce +
    the MoE losses), grad_norm, gsnr/*, the MoE readings and every
    parameter.  The batch carries the stub inputs, split into the k
    microbatches with the tokens."""
    jcfg, tcfg = _cfgs(arch, "fused")
    jcfg = jcfg.replace(parallel=dataclasses.replace(jcfg.parallel,
                                                     backend=JBackend.all_reference()))
    jp, _ = carried[arch]
    m = jcfg.model
    b, s = tcfg.global_batch, tcfg.seq_len
    rs = np.random.default_rng(5)
    toks = rs.integers(0, m.vocab_size, size=(b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:], **(_extra(m, b, 6) or {})}
    jstate, jstep = _jax_step(jcfg, jp)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate = init_state(tcfg, params=params_from_numpy(jax.device_get(jp), tcfg.model),
                        device="cpu")
    tstate, tm = make_train_step(tcfg, log_gsnr=True, device="cpu")[0](tstate, batch)
    assert set(tm) <= set(jm)
    for k in ("loss", "grad_norm", "update_norm", "ce"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    for k in ("gsnr/mean", "gsnr/min", "gsnr/frac_floor"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=5e-4, err_msg=k)
    for k in ("moe_lb_loss", "moe_z_loss", "moe_util"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=AUX_ATOL, err_msg=k)
    tparams = flat_to_numpy(tstate.params.data, tstate.params.layout)
    jparams = jax.device_get(jstate.params)
    got, want = tree_paths(tparams), tree_paths(jparams)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, w) in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(w), err_msg=path, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches(arch, carried):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = carried[arch]
    m = jcfg.model
    prompts = np.random.default_rng(7).integers(0, m.vocab_size, size=(2, 8))
    ex = _extra(m, 2, 8)
    jeng = JEngine(jcfg, jp, cache_len=24)
    # the engine's own functions, compiled with fast_jit's options
    jeng._prefill = _jit(jeng._prefill.__wrapped__)
    jeng._decode = _jit(jeng._decode.__wrapped__)
    want = jeng.generate(prompts, 5, extra=_j(ex))
    got = Engine(tcfg, tp, cache_len=24, device="cpu").generate(prompts, 5, extra=ex)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-4)
    assert got.steps == want.steps == 5


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_refuses_what_the_reference_refuses(arch, carried):
    """Recurrent, xLSTM and cross-attention state is per row, not a paged
    cache that packed rows share: the ContinuousEngine refuses those kinds,
    as the reference's does; the MoE configs are attention kinds and run."""
    _, tcfg = _cfgs(arch)
    tp = carried[arch][1]
    if arch in PAGEABLE:
        eng = ContinuousEngine(tcfg, tp, rows=1, lanes=2, cache_len=32, device="cpu")
        eng.submit(np.arange(5) % tcfg.model.vocab_size, 3)
        eng.run()
        assert len(eng.result(0).tokens) == 3
    else:
        with pytest.raises(NotImplementedError, match="segment-pageable"):
            ContinuousEngine(tcfg, tp, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_round_trips_both_ways(tmp_path, arch, carried):
    """The new leaves (experts stacked (n_groups, E, d, f), the RG-LRU's
    and xLSTM's, the encoder's layer list, img_proj) cross both ways:
    reference save -> port load_npz, port save_npz -> reference restore."""
    jp, tp = carried[arch]
    model = get_smoke(arch).model
    j_ckpt.save(str(tmp_path / "ref.npz"), jp)
    loaded = load_npz(str(tmp_path / "ref.npz"), model)
    got, want = tree_paths(loaded), tree_paths(tp)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert torch.equal(a, b), path
    save_npz(str(tmp_path / "port.npz"), tp, model)
    back = j_ckpt.restore(str(tmp_path / "port.npz"), jp)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _grads(tcfg, tp, batch, remat):
    pcfg = dataclasses.replace(tcfg.parallel, remat=remat)
    cfg = tcfg.replace(parallel=pcfg)
    flat = FlatParams(tp, cfg.model.n_groups())
    loss, _ = make_loss_fn(cfg)(flat.tree, batch)
    loss.backward()
    return float(loss.detach()), flat.grad.clone()


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "xlstm-1.3b", "whisper-small"])
def test_remat_gradient_is_exact(arch, carried):
    """The remat forms of the new groups: a MoE group recomputed whole with
    its readings as a second output (mixtral), a group ending in sl_down's
    product (xlstm), a group whose cross-attention reads the encoder's
    memory as an input that takes a gradient (whisper); each gradient is
    the one without remat."""
    _, tcfg = _cfgs(arch, "fused")
    tp = carried[arch][1]
    m = tcfg.model
    toks = np.random.default_rng(9).integers(0, m.vocab_size, size=(2, 17))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "targets": torch.from_numpy(toks[:, 1:]),
             **(_t(_extra(m, 2, 10)) or {})}
    l1, g1 = _grads(tcfg, tp, batch, True)
    l0, g0 = _grads(tcfg, tp, batch, False)
    assert l1 == l0
    torch.testing.assert_close(g1, g0, rtol=1e-5, atol=1e-6)
    assert float(g1.abs().sum()) > 0


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "whisper-small", "llama-3.2-vision-11b"])
def test_vmap_stats_split_the_stub_inputs_as_scan(arch, carried):
    """grad_stats with the vmap method (one vmapped backward over the k
    groups) against scan: the frames / image leaves split into the k
    microbatches along the batch axis as the tokens do, the same loss, MoE
    readings and moments (fused plan: the flat carry and K10's plain
    version)."""
    _, tcfg = _cfgs(arch, "fused")
    tp = carried[arch][1]
    m = tcfg.model
    k, b = 4, 8
    toks = np.random.default_rng(11).integers(0, m.vocab_size, size=(b, 17))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "targets": torch.from_numpy(toks[:, 1:]),
             **(_t(_extra(m, b, 12)) or {})}
    loss_fn = make_loss_fn(tcfg)
    out = {}
    for method in ("scan", "vmap"):
        flat = FlatParams(tp, m.n_groups())
        out[method] = grad_stats(loss_fn, flat, batch, k, method=method,
                                 backend=tcfg.parallel.backend)
    (ls, auxs, ss), (lv, auxv, sv) = out["scan"], out["vmap"]
    torch.testing.assert_close(lv, ls, rtol=1e-5, atol=1e-6)
    assert set(auxv) == set(auxs)
    for name in auxs:
        torch.testing.assert_close(auxv[name], auxs[name], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sv.mean.data, ss.mean.data, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sv.sq_mean.data, ss.sq_mean.data, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ["whisper-small", "llama-3.2-vision-11b", "xlstm-1.3b"])
def test_launchers_run_the_smoke_configs_on_cpu(arch, capsys):
    """Both launchers take the new archs: the trainer's batches carry the
    stub inputs drawn with the tokens, the server draws them from the seed."""
    from repro_torch.launch import serve, train

    m = get_smoke(arch).model
    assert set(serve.stub_shapes(m)) == set(_extra(m, 1, 0) or {})
    train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "1", "--batch", "4",
                "--seq", "8", "--k", "2"])
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "4",
                "--new-tokens", "2"])
    out = capsys.readouterr().out
    assert f"training {m.name}" in out and "step     0 loss" in out and f"arch={m.name}" in out
