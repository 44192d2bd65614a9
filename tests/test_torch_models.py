"""Port parity: repro_torch.models (pieces, attention module, paged cache,
whole transformer) and the checkpoint carry-over, against the JAX package.

Inputs and weights are made with numpy from a seed (or by the JAX init and
carried across) and handed to both sides.  Tolerances:

  * f32 math: ``oracle.tol_for(float32)`` (atol 2e-5, rtol 2e-4) — the same
    operations in a different summation order;
  * positions, segments and fill of the paged cache: exact; its k/v: exact
    where the projections are identities (so both sides scatter identical
    values), ``tol_for(float32)`` otherwise;
  * bf16 compute: a measured bound, stated at the test.
"""
import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import packed_positions, tol_for
from repro.backend import Backend as JBackend
from repro.configs import get_smoke as j_get_smoke
from repro.models import attention as j_attn
from repro.models import common as jc
from repro.models import mlp as j_mlp
from repro.models import transformer as jt
from repro.train import checkpoint as j_ckpt
from repro_torch.backend import Backend
from repro_torch.configs import get_smoke
from repro_torch.models import Transformer, attention as t_attn, common as tc, mlp as t_mlp
from repro_torch.models import transformer as tt
from repro_torch.train.checkpoint import load_npz, params_from_numpy, save_npz

TOL = tol_for(jnp.float32)
ARCHS = ["internlm2-1.8b", "granite-3-2b"]
REPO = pathlib.Path(__file__).resolve().parents[1]


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# model pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    rs = _rng(0)
    x = rs.standard_normal((2, 5, 48), dtype=np.float32) * 3
    p = {"scale": rs.standard_normal(48, dtype=np.float32), "bias": rs.standard_normal(48, dtype=np.float32)}
    if kind == "rmsnorm":
        del p["bias"]
    got = tc.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), kind)
    want = jc.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), kind)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # the result keeps the input's dtype (math in f32, cast back)
    assert tc.apply_norm({k: _t(v) for k, v in p.items()}, _t(x).bfloat16(), kind).dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(theta):
    rs = _rng(1)
    x = rs.standard_normal((2, 7, 3, 32), dtype=np.float32)
    pos = np.stack([np.arange(7), np.arange(500, 507)]).astype(np.int32)
    got = tc.apply_rope(_t(x), _t(pos), theta)
    want = jc.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    # angles up to 506 rad: sin/cos of a large f32 argument differ by ~1 ulp
    # of the argument between the two libraries, hence atol 1e-4 here
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4, rtol=2e-4)


def test_embed_tokens_exact():
    rs = _rng(2)
    table = rs.standard_normal((50, 16), dtype=np.float32)
    toks = rs.integers(0, 50, size=(3, 9))
    got = tc.embed_tokens({"embed": _t(table)}, _t(toks), torch.float32)
    want = jc.embed_tokens({"embed": jnp.asarray(table)}, jnp.asarray(toks), jnp.float32)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("softcap", [0.0, 3.0])
def test_apply_head(softcap):
    rs = _rng(3)
    x = rs.standard_normal((2, 4, 32), dtype=np.float32)
    head = rs.standard_normal((32, 70), dtype=np.float32) / np.sqrt(32)
    got = tc.apply_head({"head": _t(head)}, _t(x), softcap)
    want = jc.apply_head({"head": jnp.asarray(head)}, jnp.asarray(x), softcap)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_apply_mlp(act):
    rs = _rng(4)
    x = rs.standard_normal((2, 6, 32), dtype=np.float32)
    p = {"wi": rs.standard_normal((32, 64), dtype=np.float32) / 6,
         "wd": rs.standard_normal((64, 32), dtype=np.float32) / 8}
    if act == "swiglu":
        p["wg"] = rs.standard_normal((32, 64), dtype=np.float32) / 6
    got = t_mlp.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), act)
    want = j_mlp.apply_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), act)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# attention module and the paged cache
# ---------------------------------------------------------------------------

D, H, KVH, HD = 32, 4, 2, 16  # d_model == KVH * HD, so wk/wv may be identities


def _attn_params(seed, identity_kv):
    rs = _rng(seed)
    p = {n: rs.standard_normal(shape, dtype=np.float32) / np.sqrt(shape[0])
         for n, shape in (("wq", (D, H * HD)), ("wk", (D, KVH * HD)), ("wv", (D, KVH * HD)),
                          ("wo", (H * HD, D)))}
    if identity_kv:
        p["wk"] = p["wv"] = np.eye(D, dtype=np.float32)
    return p


def _both(p, x, q_pos, *, mode, cache_j=None, cache_t=None, plan="reference", **kw):
    jb = JBackend.all_fused() if plan == "fused" else JBackend.all_reference()
    tb = Backend.all_fused() if plan == "fused" else Backend.all_reference()
    common = dict(n_heads=H, n_kv_heads=KVH, head_dim=HD, mode=mode)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    jo, jcache = j_attn.attention({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                  q_pos=jnp.asarray(q_pos), cache=cache_j, backend=jb,
                                  **common, **jkw)
    to, tcache = t_attn.attention({k: _t(v) for k, v in p.items()}, _t(x), q_pos=_t(q_pos),
                                  cache=cache_t, backend=tb, **common, **tkw)
    return (np.asarray(jo), jcache), (_np(to), tcache)


def _check_cache(jcache, tcache, exact_kv):
    for name in ("kpos", "kseg", "fill"):
        np.testing.assert_array_equal(tcache[name].numpy(), np.asarray(jcache[name]), err_msg=name)
    for name in ("k", "v"):
        if exact_kv:
            np.testing.assert_array_equal(_np(tcache[name]), np.asarray(jcache[name]), err_msg=name)
        else:
            np.testing.assert_allclose(_np(tcache[name]), np.asarray(jcache[name]), **TOL,
                                       err_msg=name)


@pytest.mark.parametrize("device,want", [("cuda", "fused"), ("cuda:1", "fused"),
                                          ("cpu", "reference")])
def test_auto_plan_is_fused_on_every_card_and_reference_only_on_cpu(device, want):
    # The plain attention never serves a CUDA tensor under the default plan:
    # there the kernels run, or their wrappers raise on a card they refuse.
    assert Backend().resolve("attention", torch.device(device)) == want
    assert Backend().resolve("attention", device) == want
    assert Backend.all_reference().resolve("attention", device) == "reference"
    assert Backend.all_fused().resolve("attention", device) == "fused"


@pytest.mark.parametrize("path", ["sdpa", "chunked", "fused"])
def test_attention_train_packed(path):
    rs = _rng(5)
    s = 40
    x = rs.standard_normal((2, s, D), dtype=np.float32)
    pos = np.stack([packed_positions(s, [(17, 0), (15, 0)]), packed_positions(s, [(40, 3)])])
    kw = dict(rope_theta=1e4, causal=True, window=0,
              attn_chunk=8 if path == "chunked" else 1024)
    (jo, _), (to, _) = _both(_attn_params(6, False), x, pos, mode="train",
                             plan="fused" if path == "fused" else "reference", **kw)
    np.testing.assert_allclose(to, jo, **TOL)


@pytest.mark.parametrize("plan", ["reference", "fused"])
@pytest.mark.parametrize("identity_kv", [True, False], ids=["exact_kv", "rope_kv"])
def test_attention_prefill_append_decode_cache(plan, identity_kv):
    """Fresh prefill of a packed, padded chunk; an appended second chunk with
    seg_base; two decode lanes (one per document, one idle) — outputs match
    and the paged cache matches slot for slot."""
    rs = _rng(7)
    p = _attn_params(8, identity_kv)
    theta = 0.0 if identity_kv else 1e4
    c = 40
    x1 = rs.standard_normal((2, 16, D), dtype=np.float32)
    pos1 = np.stack([packed_positions(16, [(9, 0), (5, 0)]), packed_positions(16, [(12, 0)])])
    (jo, jcache), (to, tcache) = _both(p, x1, pos1, mode="prefill", plan=plan, cache_len=c,
                                       rope_theta=theta)
    np.testing.assert_allclose(to, jo, **TOL)
    _check_cache(jcache, tcache, identity_kv)
    # append a chunk continuing each row's segment numbering
    n_docs = np.array([2, 1], np.int32)
    x2 = rs.standard_normal((2, 8, D), dtype=np.float32)
    pos2 = np.stack([packed_positions(8, [(6, 0)]), packed_positions(8, [(3, 0), (4, 0)])])
    (jo, jcache), (to, tcache) = _both(p, x2, pos2, mode="prefill", plan=plan, cache_j=jcache,
                                       cache_t=tcache, rope_theta=theta, seg_base=n_docs)
    np.testing.assert_allclose(to, jo, **TOL)
    _check_cache(jcache, tcache, identity_kv)
    # decode: lane 0 continues document 0 of its row, lane 1 document 2 / idle
    for step in range(2):
        xd = rs.standard_normal((2, 2, D), dtype=np.float32)
        qpos = np.array([[9 + step, 6 + step], [12 + step, -1]], np.int32)
        qseg = np.array([[0, 2], [0, -1]], np.int32)
        (jo, jcache), (to, tcache) = _both(p, xd, qpos, mode="decode", plan=plan,
                                           cache_j=jcache, cache_t=tcache, rope_theta=theta,
                                           q_seg=qseg)
        np.testing.assert_allclose(to, jo, **TOL)
        _check_cache(jcache, tcache, identity_kv)
        assert np.all(to[1, 1] == 0.0)  # the idle lane


def test_prefill_longer_than_cache_keeps_the_tail():
    """An over-long prefill keeps only its last cache_len tokens (the ring),
    pads never scatter or advance fill."""
    rs = _rng(9)
    p = _attn_params(10, True)
    x = rs.standard_normal((2, 24, D), dtype=np.float32)
    pos = np.stack([packed_positions(24, [(20, 0)]), packed_positions(24, [(24, 0)])])
    (jo, jcache), (to, tcache) = _both(p, x, pos, mode="prefill", cache_len=16, rope_theta=0.0)
    np.testing.assert_allclose(to, jo, **TOL)
    _check_cache(jcache, tcache, True)
    assert tcache["fill"].tolist() == [12, 16]  # row 0: last 16 tokens hold 4 pads


# ---------------------------------------------------------------------------
# whole model, carried across from the JAX init
# ---------------------------------------------------------------------------


def _cfgs(arch, dtype="float32", plan="reference"):
    jcfg = j_get_smoke(arch)
    tcfg = get_smoke(arch)
    jb = JBackend.all_fused() if plan == "fused" else JBackend.all_reference()
    tb = Backend.all_fused() if plan == "fused" else Backend.all_reference()
    jcfg = jcfg.replace(parallel=dataclasses.replace(jcfg.parallel, compute_dtype=dtype, backend=jb))
    tcfg = tcfg.replace(parallel=dataclasses.replace(tcfg.parallel, compute_dtype=dtype, backend=tb))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def carried():
    """{arch: (JAX params, port params via params_from_numpy)}."""
    out = {}
    for arch in ARCHS:
        jp = jt.init_params(j_get_smoke(arch).model, jax.random.PRNGKey(0))
        out[arch] = (jp, params_from_numpy(jax.device_get(jp), get_smoke(arch).model))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(arch, carried):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = carried[arch]
    toks = _rng(11).integers(0, jcfg.model.vocab_size, size=(2, 24))
    pos = np.stack([packed_positions(24, [(10, 0), (14, 0)]), packed_positions(24, [(20, 4)])])
    for positions in (None, pos):
        jl, _, _ = jt.forward(jcfg.model, jcfg.parallel, jp, jnp.asarray(toks),
                              positions=None if positions is None else jnp.asarray(positions))
        tl, _, _ = tt.forward(tcfg.model, tcfg.parallel, tp, _t(toks),
                              positions=None if positions is None else _t(positions))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)


@pytest.mark.parametrize("plan", ["reference", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match(arch, plan, carried):
    jcfg, tcfg = _cfgs(arch, plan=plan)
    jp, tp = carried[arch]
    m = jcfg.model
    rs = _rng(12)
    toks = rs.integers(0, m.vocab_size, size=(2, 12))
    lens = np.array([12, 7])
    positions = np.where(np.arange(12)[None] < lens[:, None], np.arange(12)[None], -1).astype(np.int32)
    gidx = (lens - 1)[:, None].astype(np.int32)
    jl, jcache = jt.prefill(m, jcfg.parallel, jp, jnp.asarray(toks), cache_len=20,
                            positions=jnp.asarray(positions), gather_idx=jnp.asarray(gidx))
    tl, tcache = tt.prefill(tcfg.model, tcfg.parallel, tp, _t(toks), cache_len=20,
                            positions=_t(positions), gather_idx=_t(gidx))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    pos = lens.astype(np.int32)
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
    for _ in range(3):
        jl, jcache = jt.decode_step(m, jcfg.parallel, jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tl, tcache = tt.decode_step(tcfg.model, tcfg.parallel, tp, tcache, _t(tok), _t(pos))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
        pos = pos + 1
    for g in range(m.n_groups()):
        jc_ = jax.tree_util.tree_map(lambda a: a[g], jcache["groups"])["pos0"]["self"]
        _check_cache(jc_, tcache["groups"][g]["pos0"]["self"], exact_kv=False)


def test_variant_branches_match():
    """The config branches the two serving archs leave unused — a
    sliding-window ("swa") layer and a tail layer, a ring cache shorter than
    the prompt, tied embeddings, logit soft-cap, LayerNorm and GELU — against
    the reference through forward, prefill and decode."""
    over = dict(block_pattern=("attn", "swa"), n_layers=3, sliding_window=6,
                tie_embeddings=True, logit_softcap=30.0, norm="layernorm", act="gelu")
    jcfg, tcfg = _cfgs("granite-3-2b")
    jm = dataclasses.replace(jcfg.model, **over)
    tm = dataclasses.replace(tcfg.model, **over)
    jp = jt.init_params(jm, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.device_get(jp), tm)
    assert len(tp["groups"]) == 1 and len(tp["tail"]) == 1
    toks = _rng(15).integers(0, jm.vocab_size, size=(2, 12))
    jl, _, _ = jt.forward(jm, jcfg.parallel, jp, jnp.asarray(toks))
    tl, _, _ = tt.forward(tm, tcfg.parallel, tp, _t(toks))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    jl, jcache = jt.prefill(jm, jcfg.parallel, jp, jnp.asarray(toks), cache_len=20)
    tl, tcache = tt.prefill(tm, tcfg.parallel, tp, _t(toks), cache_len=20)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
    pos = np.full((2,), 12, np.int32)
    jl, jcache = jt.decode_step(jm, jcfg.parallel, jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
    tl, tcache = tt.decode_step(tm, tcfg.parallel, tp, tcache, _t(tok), _t(pos))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    swa = tcache["groups"][0]["pos1"]["self"]
    assert tuple(swa["k"].shape[:2]) == (2, 6)  # the sliding-window ring
    # one group: the reference keeps a list, not a stacked (scanned) tree
    _check_cache(jcache["groups"][0]["pos1"]["self"], swa, exact_kv=False)
    _check_cache(jcache["tail"][0]["self"], tcache["tail"][0]["self"], exact_kv=False)


def test_forward_bf16_measured_tolerance(carried):
    """compute_dtype bf16 on both sides: the projections round to bf16 at
    different points in XLA and PyTorch.  Measured on the CPU over five
    input seeds, both smoke configs: max |diff| 0.038-0.058, mean ~0.007,
    on logits of std ~1.  Bounds: max 0.15, mean 0.02."""
    jcfg, tcfg = _cfgs("internlm2-1.8b", dtype="bfloat16")
    jp, tp = carried["internlm2-1.8b"]
    toks = _rng(13).integers(0, jcfg.model.vocab_size, size=(2, 32))
    jl, _, _ = jt.forward(jcfg.model, jcfg.parallel, jp, jnp.asarray(toks))
    tl, _, _ = tt.forward(tcfg.model, tcfg.parallel, tp, _t(toks))
    diff = np.abs(_np(tl) - np.asarray(jl, np.float32))
    assert diff.max() < 0.15 and diff.mean() < 0.02, (diff.max(), diff.mean())


def test_cache_shapes_match():
    jcfg, tcfg = _cfgs("granite-3-2b")
    js = jt.cache_shapes(jcfg.model, jcfg.parallel, 3, 8, 24)
    ts = tt.cache_shapes(tcfg.model, tcfg.parallel, 3, 8, 24)
    assert len(ts["groups"]) == jcfg.model.n_groups() and ts["tail"] == []
    for name, sd in js["groups"]["pos0"]["self"].items():
        got = ts["groups"][0]["pos0"]["self"][name]
        assert tuple(got.shape) == tuple(sd.shape[1:]) and got.device.type == "meta"
        assert got.dtype == getattr(torch, str(sd.dtype))


def test_checkpoint_round_trips_both_ways(tmp_path, carried):
    """Reference save -> port load_npz; port save_npz -> reference restore."""
    arch = "internlm2-1.8b"
    jp, tp = carried[arch]
    model = get_smoke(arch).model
    j_ckpt.save(str(tmp_path / "ref.npz"), jp)
    loaded = load_npz(str(tmp_path / "ref.npz"), model)
    for (ka, a), (kb, b) in zip(_flat(loaded), _flat(tp)):
        assert ka == kb
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    save_npz(str(tmp_path / "port.npz"), tp, model)
    back = j_ckpt.restore(str(tmp_path / "port.npz"), jp)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def test_transformer_module_names_mirror_checkpoint_paths(carried):
    """Module parameter names are the reference checkpoint paths with the
    stacked group axis split out; the module's forward is the functional
    forward on the compute-dtype copy."""
    jp, tp = carried["granite-3-2b"]
    jcfg, tcfg = _cfgs("granite-3-2b")
    model = Transformer(tcfg.model, tp)
    names = {n for n, _ in model.named_parameters()}
    want = set()
    for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if keys[0] == "groups":
            want |= {".".join(["groups", str(g)] + keys[1:]) for g in range(jcfg.model.n_groups())}
        else:
            want.add(".".join(keys))
    assert names == want
    toks = _t(_rng(14).integers(0, tcfg.model.vocab_size, size=(1, 10)))
    got = model(tcfg.parallel, toks)[0]
    ref = tt.forward(tcfg.model, tcfg.parallel, tp, toks)[0]
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    half = model.compute_params(torch.bfloat16)
    assert half["groups"][0]["pos0"]["attn"]["wq"].dtype == torch.bfloat16
    assert half["head"].dtype == torch.float32  # the head stays f32 (f32 logits)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


def _port_files():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax", "optax", "benchmarks"), \
                f"{path}: imports {n}"
