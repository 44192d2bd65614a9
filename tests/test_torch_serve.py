"""Port parity: repro_torch.serve engines against the JAX package's.

The JAX smoke params are carried across with ``params_from_numpy``; both
engines run with ``compute_dtype="float32"``, where greedy tokens must be
identical and logprobs agree to ``oracle.tol_for(float32)``'s atol scaled
to log-softmax values (1e-4: f32 logits over a 512-way softmax).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.backend import Backend as JBackend
from repro.configs import get_smoke as j_get_smoke
from repro.models import init_params as j_init_params
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Engine as JEngine
from repro_torch.backend import Backend
from repro_torch.configs import get_smoke
from repro_torch.serve import ContinuousEngine, Engine
from repro_torch.train.checkpoint import params_from_numpy

LP_ATOL = 1e-4
ARCHS = ["internlm2-1.8b", "granite-3-2b"]


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
