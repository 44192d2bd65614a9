"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a CUDA device, so on a CPU-only
machine they count as skipped.  This file imports neither JAX nor the JAX
package, so it also runs on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: bf16 outputs 2e-2 (one bf16 ulp at |x| < 4 — both sides do the
math in f32 from the same inputs and round the output), f32 results 1e-4
(summation order over at most a few hundred terms).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.backend import Backend
from repro_torch.configs import get_smoke
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.models import init_params
from repro_torch.serve import Engine

BF16 = dict(atol=2e-2, rtol=2e-2)
F32 = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _packed(b, s, rng):
    pos = np.full((b, s), -1, np.int32)
    for i in range(b):
        o, end = 0, s - int(rng.integers(0, s // 4))
        while o < end:
            n = int(rng.integers(1, min(90, end - o) + 1))
            pos[i, o:o + n] = np.arange(n)
            o += n
    return pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128), (torch.bfloat16, 64),
                                     (torch.float32, 128)])
def test_flash_attention_kernel_matches_plain(dev, dtype, d):
    rng = np.random.default_rng(0)
    b, s, h, kvh = 2, 160, 4, 2
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)
               for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)))
    pos = torch.from_numpy(_packed(b, s, rng)).to(dev)
    out, lse = fa.flash_attention(q, k, v, pos, pos, causal=True, window=37, with_lse=True)
    want, wlse = fa.attention_fwd_ref(q, k, v, causal=True, window=37, q_pos=pos, k_pos=pos)
    tol = BF16 if dtype == torch.bfloat16 else F32
    torch.testing.assert_close(out.float(), want.float(), **tol)
    torch.testing.assert_close(lse, wlse, **F32)
    assert bool((out[pos < 0] == 0).all())


@pytest.mark.cuda
def test_flash_attention_rejects_what_the_kernel_does_not_take(dev):
    q = torch.zeros(1, 8, 2, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q, causal=True)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q.half(), q.half(), q.half(), causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 4])
def test_flash_decode_kernels_match_plain(dev, lanes):
    rng = np.random.default_rng(lanes)
    b, c, h, kvh, d = 4, 300, 8, 2, 128
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, torch.bfloat16)
               for shape in ((b, lanes, h, d), (b, c, kvh, d), (b, c, kvh, d)))
    k_seg = np.where(np.arange(c) < 200, rng.integers(0, 2, size=(b, c)), -1).astype(np.int32)
    k_pos = np.full((b, c), -1, np.int32)
    for i in range(b):
        for seg in (0, 1):
            idx = np.nonzero(k_seg[i] == seg)[0]
            k_pos[i, idx] = np.arange(len(idx))
    q_seg = np.broadcast_to(np.arange(lanes) % 2, (b, lanes)).astype(np.int32).copy()
    q_pos = np.array([[int((k_seg[i] == q_seg[i, j]).sum()) for j in range(lanes)]
                      for i in range(b)], np.int32)
    q_pos[0, -1] = q_seg[0, -1] = -1  # an idle lane
    qp, kp, qs, ks = (torch.from_numpy(a).to(dev) for a in (q_pos, k_pos, q_seg, k_seg))
    m, l, acc = fd.flash_decode_split(q, k, v, qp, kp, qs, ks, causal=True, window=0, chunk=128)
    wm, wl, wacc = fd.decode_split_ref(q, k, v, qp, kp, qs, ks, causal=True, window=0, chunk=128)
    torch.testing.assert_close(l, wl, **F32)
    torch.testing.assert_close(acc, wacc, **F32)
    torch.testing.assert_close(m[wl > 0], wm[wl > 0], **F32)
    out = fd.flash_decode_combine(m, l, acc, torch.bfloat16)
    torch.testing.assert_close(out.float(), fd.decode_combine_ref(m, l, acc, torch.bfloat16).float(),
                               **BF16)
    full = fd.flash_decode(q, k, v, qp, kp, qs, ks)
    torch.testing.assert_close(full.float(), fd.decode_attention_ref(q, k, v, qp, kp, qs, ks).float(),
                               **BF16)
    assert bool((full[0, -1] == 0).all())


@pytest.mark.cuda
def test_engine_fused_plan_matches_reference_plan(dev):
    """granite-3-2b smoke (head_dim 64) in f32 on the card: the fused plan
    (both kernels) and the plain plan give the same greedy tokens, and the
    kernels ran on every layer."""
    cfg = get_smoke("granite-3-2b")
    cfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel, compute_dtype="float32"))
    params = init_params(cfg.model, torch.Generator(device=dev).manual_seed(0), device=dev)
    prompts = np.random.default_rng(1).integers(0, cfg.model.vocab_size, size=(3, 12))
    fa.flash_attention.launches = fd.flash_decode_split.launches = 0
    fused = Engine(cfg.replace(parallel=dataclasses.replace(cfg.parallel, backend=Backend.all_fused())),
                   params, cache_len=32, device=dev).generate(prompts, 6)
    assert fa.flash_attention.launches == cfg.model.n_layers
    assert fd.flash_decode_split.launches == cfg.model.n_layers * 6
    ref = Engine(cfg.replace(parallel=dataclasses.replace(cfg.parallel,
                                                          backend=Backend.all_reference())),
                 params, cache_len=32, device=dev).generate(prompts, 6)
    np.testing.assert_array_equal(fused.tokens, ref.tokens)
    np.testing.assert_allclose(fused.logprobs, ref.logprobs, atol=1e-4)
