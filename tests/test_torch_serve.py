"""Port parity: repro_torch.serve engines against the JAX package's.

The JAX smoke params are carried across with ``params_from_numpy``; both
engines run with ``compute_dtype="float32"``, where greedy tokens must be
identical and logprobs agree to ``oracle.tol_for(float32)``'s atol scaled
to log-softmax values (1e-4: f32 logits over a 512-way softmax).
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.backend import Backend as JBackend
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.models import init_params as j_init_params
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Engine as JEngine
from repro_torch.backend import Backend
from repro_torch.configs import get_config, get_smoke
from repro_torch.serve import ContinuousEngine, Engine
from repro_torch.train.checkpoint import params_from_numpy

LP_ATOL = 1e-4
ARCHS = ["internlm2-1.8b", "granite-3-2b", "phi4-mini-3.8b", "granite-20b"]


def _cfgs(arch, plan="reference"):
    jcfg, tcfg = j_get_smoke(arch), get_smoke(arch)
    jb = JBackend.all_fused() if plan == "fused" else JBackend.all_reference()
    tb = Backend.all_fused() if plan == "fused" else Backend.all_reference()
    jcfg = jcfg.replace(parallel=dataclasses.replace(jcfg.parallel, compute_dtype="float32",
                                                     backend=jb))
    tcfg = tcfg.replace(parallel=dataclasses.replace(tcfg.parallel, compute_dtype="float32",
                                                     backend=tb))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def carried():
    out = {}
    for arch in ARCHS:
        jp = j_init_params(j_get_smoke(arch).model, jax.random.PRNGKey(0))
        out[arch] = (jp, params_from_numpy(jax.device_get(jp), get_smoke(arch).model))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches(arch, carried):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = carried[arch]
    prompts = np.random.default_rng(0).integers(0, jcfg.model.vocab_size, size=(3, 8))
    want = JEngine(jcfg, jp, cache_len=32).generate(prompts, 6)
    got = Engine(tcfg, tp, cache_len=32, device="cpu").generate(prompts, 6)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=LP_ATOL)
    assert got.steps == want.steps == 6


@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_prompt_lens_match(arch, carried):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = carried[arch]
    rs = np.random.default_rng(3)
    lens = np.array([5, 9, 3])
    prompts = rs.integers(0, jcfg.model.vocab_size, size=(3, 9))
    want = JEngine(jcfg, jp, cache_len=32).generate(prompts, 5, prompt_lens=lens)
    got = Engine(tcfg, tp, cache_len=32, device="cpu").generate(prompts, 5, prompt_lens=lens)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=LP_ATOL)


def test_eos_freeze_and_empty_generation_match(carried):
    jcfg, tcfg = _cfgs("granite-3-2b")
    jp, tp = carried["granite-3-2b"]
    prompts = np.random.default_rng(2).integers(0, jcfg.model.vocab_size, size=(4, 4))
    probe = Engine(tcfg, tp, cache_len=64, device="cpu").generate(prompts, 8)
    eos = int(probe.tokens[0, 2])
    want = JEngine(jcfg, jp, cache_len=64, eos_id=eos).generate(prompts, 8)
    got = Engine(tcfg, tp, cache_len=64, eos_id=eos, device="cpu").generate(prompts, 8)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=LP_ATOL)
    first = int(np.nonzero(got.tokens[0] == eos)[0][0])
    assert np.all(got.tokens[0, first + 1:] == eos) and np.all(got.logprobs[0, first + 1:] == 0)
    empty = Engine(tcfg, tp, cache_len=32, device="cpu").generate(prompts, 0)
    assert empty.tokens.shape == (4, 0) and empty.logprobs.shape == (4, 0) and empty.steps == 0
    with pytest.raises(ValueError, match="prompt_lens"):
        Engine(tcfg, tp, cache_len=32, device="cpu").generate(prompts, 2,
                                                              prompt_lens=np.array([4, 5, 1, 1]))


def test_temperature_sampling_uses_the_generator(carried):
    _, tcfg = _cfgs("granite-3-2b")
    _, tp = carried["granite-3-2b"]
    eng = Engine(tcfg, tp, cache_len=32, device="cpu")
    prompts = np.random.default_rng(1).integers(0, tcfg.model.vocab_size, size=(2, 4))
    r1 = eng.generate(prompts, 8, temperature=1.0, generator=torch.Generator().manual_seed(1))
    r1b = eng.generate(prompts, 8, temperature=1.0, generator=torch.Generator().manual_seed(1))
    r2 = eng.generate(prompts, 8, temperature=1.0, generator=torch.Generator().manual_seed(2))
    assert r1.tokens.shape == (2, 8)
    np.testing.assert_array_equal(r1.tokens, r1b.tokens)
    assert not np.array_equal(r1.tokens, r2.tokens)


@pytest.mark.parametrize("plan", ["reference", "fused"])
def test_continuous_packed_two_docs_match(plan, carried):
    """The packed two-document case of tests/test_serve.py: both requests
    share one cache row; tokens and logprobs equal the JAX engine's."""
    jcfg, tcfg = _cfgs("internlm2-1.8b", plan)
    jp, tp = carried["internlm2-1.8b"]
    rs = np.random.RandomState(0)
    p1 = rs.randint(0, jcfg.model.vocab_size, size=(7,))
    p2 = rs.randint(0, jcfg.model.vocab_size, size=(5,))
    results = []
    for eng in (JContinuousEngine(jcfg, jp, rows=1, lanes=2, cache_len=32, chunk=16),
                ContinuousEngine(tcfg, tp, rows=1, lanes=2, cache_len=32, chunk=16, device="cpu")):
        r1, r2 = eng.submit(p1, 6), eng.submit(p2, 6)
        eng.run()
        results.append((eng.result(r1), eng.result(r2)))
    for want, got in zip(results[0], results[1]):
        np.testing.assert_array_equal(got.tokens, want.tokens)
        np.testing.assert_allclose(got.logprobs, want.logprobs, atol=LP_ATOL)


def test_continuous_scheduling_matches(carried):
    """Multi-row scheduling with overflow queueing, a mid-flight admit, a
    cancel and drained-row reuse: every request's tokens match the JAX
    engine driven through the same calls."""
    jcfg, tcfg = _cfgs("granite-3-2b")
    jp, tp = carried["granite-3-2b"]
    rs = np.random.default_rng(5)
    prompts = [rs.integers(0, jcfg.model.vocab_size, size=int(n)) for n in (5, 3, 7, 4, 6)]

    def drive(eng):
        rids = [eng.submit(p, 4) for p in prompts[:3]]
        eng.step()
        eng.step()
        eng.cancel(rids[0])
        rids += [eng.submit(p, 4) for p in prompts[3:]]
        eng.run()
        return [eng.result(r) for r in rids]

    want = drive(JContinuousEngine(jcfg, jp, rows=2, lanes=2, cache_len=24, chunk=8))
    got = drive(ContinuousEngine(tcfg, tp, rows=2, lanes=2, cache_len=24, chunk=8, device="cpu"))
    assert want[0].canceled and got[0].canceled
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=LP_ATOL)


def test_continuous_validation():
    _, tcfg = _cfgs("internlm2-1.8b")
    tp = params_from_numpy(jax.device_get(j_init_params(j_get_smoke("internlm2-1.8b").model,
                                                        jax.random.PRNGKey(0))), tcfg.model)
    ce = ContinuousEngine(tcfg, tp, rows=1, lanes=1, cache_len=16, chunk=8, device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        ce.submit(np.zeros(9, np.int32), 2)
    with pytest.raises(ValueError, match="cache_len"):
        ce.submit(np.zeros(8, np.int32), 12)


def test_engines_default_to_the_card(monkeypatch, carried):
    """device=None means CUDA; without a CUDA device the engines raise
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs("granite-3-2b")
    _, tp = carried["granite-3-2b"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(tcfg, tp, cache_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousEngine(tcfg, tp, rows=1, lanes=1, cache_len=16, chunk=8)


def test_serve_launcher_runs_the_smoke_config_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "5",
                "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "internlm2-1.8b-smoke" in out and "(2, 3)" in out


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "granite-20b"])
@pytest.mark.parametrize("which", ["config", "smoke"])
def test_dense_configs_match_the_reference_field_for_field(arch, which):
    """The port's copies of the two dense configs: every field of the
    model and optimizer configs and the top-level scalars equal the
    reference's; a field the port lacks (MoE, encoder, the xLSTM dims) is at
    its default there."""
    want = (j_get_config if which == "config" else j_get_smoke)(arch)
    got = (get_config if which == "config" else get_smoke)(arch)
    for part in ("model", "optimizer"):
        g, w = getattr(got, part), getattr(want, part)
        names = {f.name for f in dataclasses.fields(g)}
        for name in names:
            assert getattr(g, name) == getattr(w, name), (part, name)
        for f in dataclasses.fields(w):
            if f.name not in names:
                assert getattr(w, f.name) == f.default, (part, f.name)
    for name in ("seed", "global_batch", "seq_len"):
        assert getattr(got, name) == getattr(want, name)
    assert got.parallel.compute_dtype == want.parallel.compute_dtype


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "granite-20b"])
def test_bf16_held_weights_are_the_f32_draws_rounded(arch, capsys):
    """init_params(dtype=bf16) rounds each block as it is drawn: the same
    draws as the f32 tree, so every leaf is that tree's leaf in bf16; an
    engine on bf16 weights keeps them as its compute tree (no copy); the
    launcher takes both ids and holds the smoke weights in the config's
    f32."""
    from repro_torch.core.layout import tree_paths
    from repro_torch.launch import serve
    from repro_torch.models import init_params

    m = get_smoke(arch).model
    p32 = init_params(m, torch.Generator().manual_seed(0))
    p16 = init_params(m, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    for (path, a), (_, b) in zip(tree_paths(p32), tree_paths(p16)):
        assert b.dtype == torch.bfloat16 and torch.equal(a.to(torch.bfloat16), b), path
    eng = Engine(get_smoke(arch), p16, cache_len=16, device="cpu")
    ptrs = {t.data_ptr() for _, t in tree_paths(p16)}
    assert all(t.data_ptr() in ptrs for _, t in tree_paths(eng.model.params))
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "5",
                "--new-tokens", "2"])
    out = capsys.readouterr().out
    assert f"{arch}-smoke" in out and "weights=torch.float32" in out and "(2, 2)" in out


@pytest.mark.parametrize("arch, total_gb, want", [
    ("phi4-mini-3.8b", 80, torch.float32), ("granite-20b", 80, torch.bfloat16),
    ("granite-20b", 192, torch.float32)])
def test_launcher_holds_weights_in_bf16_where_the_configs_dtype_fills_half_the_card(
        arch, total_gb, want, monkeypatch):
    """weight_dtype: the config's param_dtype (f32), or bf16 on a card where
    those weights take more than half its memory (granite-20b's 81 GB of f32
    on an 80 GB card); on the CPU always the config's."""
    from repro_torch.launch.serve import weight_dtype

    cfg = get_config(arch)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(total_memory=total_gb * 10 ** 9))
    assert weight_dtype(cfg, torch.device("cuda")) == want
    assert weight_dtype(cfg, torch.device("cpu")) == torch.float32
