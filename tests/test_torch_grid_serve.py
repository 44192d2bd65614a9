"""Port parity of sharded serving on a (data, model) grid of spawned gloo
ranks (models/transformer.py::prefill_grid / decode_step_grid,
serve/engine.py::Engine on a rank's GridParams, models/transformer.py::
cache_specs, sharding/placement.py's serving collectives, the decode
kernel's log-sum-exp).

Without ranks:

* ``cache_specs`` against the reference's ``launch/specs.py::batch_pspec``
  on the reference's cache shapes (stacked groups, the group dim dropped),
  leaf for leaf, on a (2, 2) grid, for the three smokes; and the rule's
  by-size search of the batch pinned: a batch of the size of a leaf's dim 1
  takes that dim in both packages, and the serving grid refuses that
  placement (its rows would not be the data axis's).
* K12's plain version with ``with_lse``: out and lse (B, L, H) against
  ``decode_attention_ref`` and a direct log-sum-exp of the masked scores,
  with idle lanes, a half-empty cache and an all-empty row (out exactly 0,
  lse -1e30), in f32 and bf16; the merge of the two slot halves' partials
  (``placement.py::lse_merge``) against the whole cache, a row whose valid
  slots all lie in one half among them, and the mean of the partials (the
  merge without its weights) off by far more.
* The paged write of a block of the ring (``attention.py::_paged_write``
  with ``slots``): each half of the slots written alone equals its slice of
  the whole ring's write, for ragged prefills whose pads' spare slot lies
  in the other half, a prefill that fills a whole half, an over-long
  prefill and decode steps that wrap across the halves' boundary.

One group of four CPU ranks as a (2, 2) grid (one torch thread each, a
rendezvous file under the test's tmp dir) serves the internlm2 (GQA, its
heads split over the model axis), recurrentgemma (RG-LRU channels split,
MQA attention replicated over a split local cache) and mixtral (experts
over the model axis, sliding window; capacity factor 0.5, so that choices
drop and the decode step's capacity and slots must be the whole batch's)
smokes in f32 from the reference's init params, batch 4 (two rows a data
rank), ragged prompts of 32, 7, 30 and 19 tokens into a 34-slot ring (17
slots a model rank: the 7-token row leaves model rank 1's slots empty in
the first decode steps, the 32-token row's decode wraps from model rank 1's
block into model rank 0's):

* the one-card greedy chain's tokens fed to a chain, prefill and four
  decode steps, on the ranks (the
  embedding and the logits from the rank's vocab blocks, without gathering
  the table or the head: ``Placement.vocab_blocks``); its
  logits against the JAX ``prefill``/``decode_step`` chain on one device
  fed the same tokens (``oracle.tol_for(float32)``) and against the port's
  one-card chain (the same tolerance); the grid's greedy choice at every
  step is the one-card token;
* ``Engine.generate`` on the grid: rank 0's gathered tokens equal the
  one-card engine's, logprobs within 1e-4; the other ranks return None;
* each rank's cache blocks after the chain: k, v, h and conv within the
  tolerance, kpos, kseg and fill equal, to their slices of the one-card
  cache by the reference's cache rule;
* the MoE capacity in decode: every call's capacity and token count are
  the whole batch's (``moe._grid_counts`` recorded);
* sampled ``generate`` (a generator seeded by each data index): tokens in
  the vocabulary, finite logprobs;
* the grid-wide stop: an EOS that both rows of data rank 0 emit first,
  which data rank 1's rows never emit, ends data rank 0's rows while the
  grid decodes on; the tokens equal the one-card engine's with that EOS;
* planted faults, each of which must fail: the merge without the LSE
  weights (the mean of the partials: the decode logits move past the
  tolerance), every model rank holding and writing the whole cache (its
  blocks are not the rule's slices) and a per-rank early stop (each rank
  ending on its own rows: the grid deadlocks in its collectives and the
  group fails its deadline).

The rank function lives in this module and the ranks import it; JAX is
imported inside the test functions and the fixture only.  The ranks start
first and wait for their inputs, then the parent runs the JAX chains.
"""
import dataclasses
import os
import pickle
import time

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import start_ranks, wait_ranks

GRID = (2, 2)
WORLD = GRID[0] * GRID[1]
DEADLINE_S = 240.0
STOP_DEADLINE_S = 6.0  # the planted per-rank stop, once the group's results are in
ARCHS = ("internlm2-1.8b", "recurrentgemma-9b", "mixtral-8x22b")
MOE_CF = 0.5
CACHE_LEN = 34
PROMPT = 32
LENS = np.array([32, 7, 30, 19], np.int32)
EOS_LENS = np.array([7, 7, 30, 19], np.int32)
NEW = 4
TOL = dict(atol=2e-5, rtol=2e-4)  # tests/oracle.py::tol_for(float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(arch, dtype="float32"):
    from repro_torch.backend import Backend
    from repro_torch.configs import get_smoke

    cfg = get_smoke(arch)
    m = cfg.model
    if m.moe is not None:
        m = dataclasses.replace(m, moe=dataclasses.replace(m.moe, capacity_factor=MOE_CF))
    return cfg.replace(model=m, parallel=dataclasses.replace(
        cfg.parallel, compute_dtype=dtype, backend=Backend.all_fused()))


def _jax_cfg(arch):
    from repro.backend import Backend as JBackend
    from repro.configs import get_smoke as j_get_smoke

    cfg = j_get_smoke(arch)
    m = cfg.model
    if m.moe is not None:
        m = dataclasses.replace(m, moe=dataclasses.replace(m.moe, capacity_factor=MOE_CF))
    return cfg.replace(model=m, parallel=dataclasses.replace(
        cfg.parallel, compute_dtype="float32", backend=JBackend.all_reference()))


def _layout(prompts, lens):
    ar = np.arange(prompts.shape[1], dtype=np.int32)[None, :]
    return np.where(ar < lens[:, None], ar, -1).astype(np.int32), (lens - 1)[:, None]


def _chain(eng, prompts, lens, force=None, steps=NEW):
    """The engine's prefill and ``steps`` decode steps on its rows: greedy,
    or fed ``force`` (B, steps) -> logits (rows, steps + 1, V), each step's
    argmax (rows, steps), the tokens fed (rows, steps) and the cache after
    the last step."""
    rows = eng.rows(len(prompts))
    positions, gidx = _layout(prompts[rows], lens[rows])
    logits, cache = eng._prefill(torch.as_tensor(prompts[rows]),
                                 positions=torch.as_tensor(positions),
                                 gather_idx=torch.as_tensor(gidx))
    out, fed = [logits[:, -1]], []
    pos = torch.as_tensor(lens[rows])
    for t in range(steps):
        tok = logits[:, -1].argmax(-1) if force is None else torch.as_tensor(force[rows, t])
        fed.append(tok)
        logits, cache = eng._decode(cache, tok[:, None], pos)
        out.append(logits[:, -1])
        pos = pos + 1
    logits = torch.stack(out, 1)
    return {"logits": logits, "greedy": logits[:, :steps].argmax(-1).numpy(),
            "tokens": torch.stack(fed, 1).numpy() if fed else None, "cache": cache}


def _mean_merge(outs, lses):
    """The planted merge: the partial outputs' mean, without their LSE
    weights."""
    return sum(o.float() for o in outs) / len(outs)


def _rank(rank, init, out):
    from repro_torch.launch.mesh import init_grid_mesh
    from repro_torch.models import moe
    from repro_torch.serve import Engine
    from repro_torch.sharding import placement
    from repro_torch.train.trainer import grid_params

    torch.set_num_threads(1)  # smoke-sized work on a shared machine
    mesh = init_grid_mesh("gloo", *GRID, "cpu", init_method=init, rank=rank)
    end = time.monotonic() + DEADLINE_S
    while not os.path.exists(f"{out}/inputs.pkl") and time.monotonic() < end:
        time.sleep(0.1)
    with open(f"{out}/inputs.pkl", "rb") as f:
        jparams, prompts, eos_prompts, eos, forced = pickle.load(f)
    res = {"coords": dict(mesh.coords)}
    grid_counts = moe._grid_counts
    calls = []

    def recorded(pl, counts, n, cfg):
        got = grid_counts(pl, counts, n, cfg)
        calls.append((int(got[1]), int(got[3])))
        return got

    with torch.no_grad():
        for arch in ARCHS:
            cfg = _port_cfg(arch)
            gp = grid_params(cfg, jparams[arch], mesh, "cpu")[0]
            eng = Engine(cfg, gp, cache_len=CACHE_LEN, device="cpu")
            moe._grid_counts = recorded
            try:
                res[arch] = _chain(eng, prompts, LENS, force=forced[arch])
                res[arch]["vocab blocks"] = eng.placement.vocab_blocks
            finally:
                moe._grid_counts = grid_counts
            res[arch]["moe calls"], calls[:] = list(calls), []
            res[arch]["generate"] = eng.generate(prompts, NEW, prompt_lens=LENS)
            if arch != ARCHS[0]:
                continue
            first = cfg, gp
            bf16 = Engine(_port_cfg(arch, "bfloat16"), gp, cache_len=CACHE_LEN)
            res["bf16 prefill"] = _chain(bf16, prompts, LENS, steps=0)["logits"]
            res["sampled"] = eng.generate(prompts, 2, temperature=1.0, prompt_lens=LENS)
            res["eos"] = Engine(cfg, gp, cache_len=CACHE_LEN, eos_id=eos).generate(
                eos_prompts, NEW, prompt_lens=EOS_LENS)
            lse_merge = placement.lse_merge
            placement.lse_merge = _mean_merge
            try:
                res["mean merge"] = _chain(eng, prompts, LENS, forced[arch], 1)["logits"]
            finally:
                placement.lse_merge = lse_merge
            slots = placement.Placement.cache_slots
            placement.Placement.cache_slots = lambda self, spec, n: None
            try:
                res["whole cache"] = _chain(eng, prompts, LENS, forced[arch], 1)["cache"]
            finally:
                placement.Placement.cache_slots = slots
    torch.save(res, f"{out}/rank{rank}.pt")
    open(f"{out}/done{rank}", "w").close()
    # the planted per-rank early stop, last: data rank 0's rows end at the
    # first step, and its ranks leave the decode loop while data rank 1's
    # go on gathering weights with them
    Engine._all_done = lambda self, done: bool(done.all())
    with torch.no_grad():
        Engine(*first, cache_len=CACHE_LEN, eos_id=eos).generate(eos_prompts, NEW,
                                                                 prompt_lens=EOS_LENS)
    mesh.close()


def _one_card(arch, jp, prompts, dtype="float32"):
    from repro_torch.serve import Engine
    from repro_torch.train.checkpoint import params_from_numpy

    cfg = _port_cfg(arch, dtype)
    return Engine(cfg, params_from_numpy(jp, cfg.model), cache_len=CACHE_LEN, device="cpu")


def _jax_chain(arch, jp, prompts, tokens):
    """The reference's prefill and decode steps on one device, fed
    ``tokens`` -> logits (B, NEW + 1, V)."""
    import jax.numpy as jnp

    from repro.models import transformer as jt
    from torch_fast_jit import fast_jit

    jcfg = _jax_cfg(arch)
    m, pc = jcfg.model, jcfg.parallel
    jprefill = fast_jit(lambda p, t, q, g: jt.prefill(m, pc, p, t, cache_len=CACHE_LEN,
                                                      positions=q, gather_idx=g))
    jdecode = fast_jit(lambda p, c, t, q: jt.decode_step(m, pc, p, c, t, q))
    positions, gidx = _layout(prompts, LENS)
    jl, jc = jprefill(jp, jnp.asarray(prompts, jnp.int32), jnp.asarray(positions),
                      jnp.asarray(gidx, jnp.int32))
    out = [np.asarray(jl[:, -1])]
    pos = LENS.copy()
    for t in range(NEW):
        jl, jc = jdecode(jp, jc, jnp.asarray(tokens[:, t:t + 1], jnp.int32), jnp.asarray(pos))
        out.append(np.asarray(jl[:, -1]))
        pos = pos + 1
    return np.stack(out, 1)


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    """(every rank's results, the one-card greedy chains, the one-card
    engines' results, the JAX chains fed their tokens, how the planted
    per-rank stop ended): the ranks serve, fed the one-card chains' tokens,
    while the parent runs the JAX chains."""
    import jax

    from repro.models import transformer as jt
    from torch_fast_jit import fast_jit

    tmp = tmp_path_factory.mktemp("grid_serve")
    ctx = start_ranks(_rank, WORLD, args=(f"file://{tmp}/rdzv", str(tmp)))
    jps = {arch: jax.device_get(fast_jit(lambda k, m=_jax_cfg(arch).model: jt.init_params(m, k))(
        jax.random.PRNGKey(0))) for arch in ARCHS}
    rs = np.random.default_rng(0)
    prompts = rs.integers(0, 512, size=(4, PROMPT)).astype(np.int32)
    eos_prompts = prompts.copy()
    eos_prompts[0] = prompts[1]
    with torch.no_grad():
        first = _chain(_one_card(ARCHS[0], jps[ARCHS[0]], prompts), eos_prompts, EOS_LENS,
                       steps=0)["logits"][:, 0].argmax(-1).numpy()
        ones, gens = {}, {}
        for arch in ARCHS:  # the one-card greedy chains, whose tokens every chain is fed
            eng = _one_card(arch, jps[arch], prompts)
            ones[arch] = _chain(eng, prompts, LENS)
            if arch == ARCHS[0]:  # what the planted whole-cache run wrote
                ones["step 1 cache"] = _chain(eng, prompts, LENS, steps=1)["cache"]
            gens[arch] = eng.generate(prompts, NEW, prompt_lens=LENS)
    forced = {arch: ones[arch]["tokens"] for arch in ARCHS}
    with open(tmp / "inputs.tmp", "wb") as f:
        pickle.dump((jps, prompts, eos_prompts, int(first[0]), forced), f)
    os.replace(tmp / "inputs.tmp", tmp / "inputs.pkl")
    jax_chains = {arch: _jax_chain(arch, jps[arch], prompts, forced[arch]) for arch in ARCHS}
    with torch.no_grad():
        eng = _one_card(ARCHS[0], jps[ARCHS[0]], prompts, "bfloat16")
        ones["bf16 prefill"] = _chain(eng, prompts, LENS, steps=0)["logits"]
        eng = _one_card(ARCHS[0], jps[ARCHS[0]], prompts)
        eng.eos_id = int(first[0])
        gens["eos"] = eng.generate(eos_prompts, NEW, prompt_lens=EOS_LENS)

    end = time.monotonic() + DEADLINE_S
    while not all(os.path.exists(tmp / f"done{r}") for r in range(WORLD)):
        if time.monotonic() > end or not all(p.is_alive() for p in ctx.processes):
            wait_ranks(ctx, 1.0)  # a rank failed: raise its error
            raise TimeoutError("the serving ranks did not finish")
        time.sleep(0.2)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    try:
        wait_ranks(ctx, STOP_DEADLINE_S)
        stop = None
    except Exception as e:  # the planted per-rank stop must not complete
        stop = e
    return ranks, ones, gens, jax_chains, stop


def _rows_of(coords):
    n = 4 // GRID[0]
    return slice(coords["data"] * n, (coords["data"] + 1) * n)


def _check_blocks(arch, block, whole, coords):
    """Each leaf of a rank's cache ``block`` against its slice of the one-card
    cache ``whole`` by the reference's cache rule."""
    from repro_torch.core.layout import tree_paths
    from repro_torch.models.transformer import cache_specs
    from repro_torch.sharding.placement import block_slices, shard_shape
    from repro_torch.sharding.rules import Rules

    cfg = _port_cfg(arch)
    rules = Rules(mesh=types_mesh())
    specs = dict(_spec_paths(cache_specs(cfg.model, cfg.parallel, rules, 4, CACHE_LEN)))
    got, want = dict(tree_paths(block)), dict(tree_paths(whole))
    assert set(got) == set(want) == set(specs)
    sizes = dict(zip(("data", "model"), GRID))
    for path, w in want.items():
        sl = block_slices(shard_shape(w.shape, specs[path], sizes), specs[path], coords, sizes)
        g, w = got[path], w[sl]
        assert g.shape == w.shape, (path, tuple(g.shape), tuple(w.shape))
        if g.dtype.is_floating_point:
            np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=path, **TOL)
        else:
            assert torch.equal(g, w), path


def _spec_paths(tree, prefix=""):
    """[(path, Spec)] of a tree of cache specs (a Spec is a tuple: a leaf)."""
    from repro_torch.sharding.rules import Spec

    if isinstance(tree, Spec):
        return [(prefix[:-1], tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [pair for k, v in items for pair in _spec_paths(v, f"{prefix}{k}/")]


def types_mesh():
    from repro_torch.sharding.rules import MeshShape

    return MeshShape(GRID, ("data", "model"))


@pytest.mark.parametrize("arch", ARCHS)
def test_grid_chain_matches_the_reference_and_one_card(serve_runs, arch):
    ranks, ones, _, jax_chains, _ = serve_runs
    for res in ranks:
        assert res[arch]["vocab blocks"]  # the embedding and logits from the rank's blocks
        rows = _rows_of(res["coords"])
        got = res[arch]["logits"].numpy()
        np.testing.assert_allclose(got, jax_chains[arch][rows], err_msg=f"{arch} vs JAX", **TOL)
        np.testing.assert_allclose(got, ones[arch]["logits"][rows].numpy(),
                                   err_msg=f"{arch} vs one card", **TOL)
        np.testing.assert_array_equal(res[arch]["greedy"], ones[arch]["tokens"][rows])


@pytest.mark.parametrize("arch", ARCHS)
def test_grid_generate_matches_one_card(serve_runs, arch):
    ranks, _, gens, _, _ = serve_runs
    got = ranks[0][arch]["generate"]
    np.testing.assert_array_equal(got.tokens, gens[arch].tokens)
    np.testing.assert_allclose(got.logprobs, gens[arch].logprobs, atol=1e-4)
    assert got.steps == gens[arch].steps == NEW
    assert all(res[arch]["generate"] is None for res in ranks[1:])


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_blocks_are_the_rule_slices(serve_runs, arch):
    """Each rank's cache blocks against their slices of the one-card cache,
    and their shapes ``cache_shapes(placement=)``'s."""
    from repro_torch.core.layout import tree_paths
    from repro_torch.models.transformer import cache_shapes
    from test_torch_sharding import _placement

    ranks, ones, _, _, _ = serve_runs
    cfg = _port_cfg(arch)
    shapes = dict(tree_paths(cache_shapes(cfg.model, cfg.parallel, 4, 0, CACHE_LEN,
                                          placement=_placement(cfg.model)[0]())))
    for res in ranks:
        _check_blocks(arch, res[arch]["cache"], ones[arch]["cache"], res["coords"])
        got = dict(tree_paths(res[arch]["cache"]))
        assert {p: tuple(t.shape) for p, t in got.items()} == {
            p: tuple(t.shape) for p, t in shapes.items()}
        assert all(got[p].dtype == t.dtype for p, t in shapes.items())


def test_moe_capacity_in_decode_is_the_whole_batch(serve_runs):
    from repro_torch.models.moe import capacity

    ranks, _, _, _, _ = serve_runs
    moe_cfg = _port_cfg("mixtral-8x22b").model.moe
    n_moe = _port_cfg("mixtral-8x22b").model.n_layers
    want = [(capacity(4 * PROMPT, moe_cfg), 4 * PROMPT)] * n_moe
    want += [(capacity(4, moe_cfg), 4)] * (n_moe * NEW)
    for res in ranks:
        assert res["mixtral-8x22b"]["moe calls"] == want


def test_grid_bf16_prefill_matches_one_card(serve_runs):
    """In bf16 the grid gathers the weights cast to bf16 (the cast
    commutes with the gather) and rounds the model axis's sums once: its
    prefill logits within ``tol_for(bfloat16)`` of one card's."""
    ranks, ones, _, _, _ = serve_runs
    for res in ranks:
        rows = _rows_of(res["coords"])
        np.testing.assert_allclose(res["bf16 prefill"].numpy(),
                                   ones["bf16 prefill"][rows].numpy(), atol=3e-2, rtol=3e-2)


def test_grid_sampled_generate_is_in_vocabulary(serve_runs):
    """Sampling on the grid: each data rank draws from a generator seeded
    by its data index; the gathered tokens lie in the vocabulary, their
    logprobs are finite and at most 0."""
    ranks, _, _, _, _ = serve_runs
    got = ranks[0]["sampled"]
    vocab = _port_cfg(ARCHS[0]).model.vocab_size
    assert got.tokens.shape == (4, 2) and ((got.tokens >= 0) & (got.tokens < vocab)).all()
    assert np.isfinite(got.logprobs).all() and (got.logprobs <= 0).all()
    assert all(res["sampled"] is None for res in ranks[1:])


def test_grid_wide_stop_on_eos(serve_runs):
    ranks, _, gens, _, _ = serve_runs
    got, want = ranks[0]["eos"], gens["eos"]
    np.testing.assert_array_equal(got.tokens, want.tokens)
    eos = want.tokens[0, 0]
    assert (want.tokens[:2] == eos).all() and (want.tokens[2:] != eos).all()
    assert got.steps == NEW  # the grid decoded on after data rank 0's rows ended


def test_planted_merge_without_lse_weights_fails(serve_runs):
    ranks, ones, _, _, _ = serve_runs
    with pytest.raises(AssertionError):
        for res in ranks:
            rows = _rows_of(res["coords"])
            np.testing.assert_allclose(res["mean merge"].numpy(),
                                       ones[ARCHS[0]]["logits"][rows, :2].numpy(), **TOL)


def test_planted_whole_cache_on_every_model_rank_fails(serve_runs):
    ranks, ones, _, _, _ = serve_runs
    with pytest.raises(AssertionError):
        for res in ranks:
            _check_blocks(ARCHS[0], res["whole cache"], ones["step 1 cache"], res["coords"])


def test_planted_per_rank_stop_fails_by_deadline(serve_runs):
    *_, stop = serve_runs
    assert isinstance(stop, TimeoutError), f"a per-rank early stop ended with {stop!r}"


# ---------------------------------------------------------------------------
# without ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,batch", [(a, 4) for a in ARCHS] + [("recurrentgemma-9b", 34),
                                                                   ("recurrentgemma-9b", 256)])
def test_cache_specs_follow_the_reference_rule(arch, batch):
    """The port's cache specs are the reference's ``batch_pspec(kind=
    "cache")`` of its cache shapes, leaf for leaf.  The batch is found by
    size: at batch 34 (the 34-slot ring of the one-group recurrentgemma
    smoke's local layer, unstacked) and 256 (its d_model, the RG-LRU's h
    (B, D)) a leaf's dim 1 takes the batch's axis in both packages, and
    the serving grid refuses those caches."""
    import jax

    from repro.launch.specs import batch_pspec
    from repro.models import transformer as jt
    from repro.sharding.rules import Rules as JRules
    from repro_torch.models.transformer import cache_specs
    from repro_torch.sharding.rules import Rules
    from test_torch_sharding import _amesh, _placement

    jcfg, cfg = _jax_cfg(arch), _port_cfg(arch)
    jrules = JRules(mesh=_amesh(GRID, ("data", "model")))
    js = jt.cache_shapes(jcfg.model, jcfg.parallel, batch, 8, CACHE_LEN)
    stacked = not isinstance(js["groups"], list)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(js)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        spec = tuple(batch_pspec(leaf, jrules, batch, kind="cache"))
        spec += (None,) * (leaf.ndim - len(spec))
        if keys[0] == "groups" and stacked:
            want.update({"/".join(["groups", str(g), *keys[1:]]): spec[1:]
                         for g in range(jcfg.model.n_groups())})
        else:
            want["/".join(keys)] = spec
    specs = cache_specs(cfg.model, cfg.parallel, Rules(mesh=types_mesh()), batch, CACHE_LEN)
    assert {p: tuple(s) for p, s in _spec_paths(specs)} == want
    pl = _placement(cfg.model)[0]()

    def serve_checks():
        for blk in [*(b for g in specs["groups"] for b in g.values()), *specs["tail"]]:
            if "self" in blk:
                assert pl.cache_slots(blk["self"]["k"], CACHE_LEN) == (0, CACHE_LEN)
            else:
                pl.check_rec_cache(blk)

    if batch == 4:
        serve_checks()
    else:
        assert any(spec[0] != "data" for _, spec in _spec_paths(specs))
        with pytest.raises(ValueError, match="another dim 1"):
            serve_checks()


def _decode_case(dtype, rs):
    """(q, k, v, q_pos, k_pos, q_seg, k_seg): B 4, L 2, H 4 over KV 2, D 16,
    C 24 slots; row 0 half empty, row 1 all empty, row 2 full with an idle
    lane, row 3 two documents."""
    b, lanes, h, kvh, d, c = 4, 2, 4, 2, 16, 24
    q, k, v = (torch.from_numpy(rs.standard_normal(s, dtype=np.float32)).to(dtype)
               for s in ((b, lanes, h, d), (b, c, kvh, d), (b, c, kvh, d)))
    k_pos = np.full((b, c), -1, np.int32)
    k_pos[0, ::2] = np.arange(12)
    k_pos[2] = np.arange(c)
    k_pos[3] = np.arange(c)
    k_seg = np.where(k_pos >= 0, 0, -1).astype(np.int32)
    k_seg[3, 10:] = 1
    q_pos = np.array([[12, 13], [0, 1], [24, -1], [24, 25]], np.int32)
    q_seg = np.array([[0, 0], [0, 0], [0, -1], [1, 0]], np.int32)
    return q, k, v, *(torch.from_numpy(a) for a in (q_pos, k_pos, q_seg, k_seg))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decode_lse_matches_a_direct_log_sum_exp(dtype):
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.flash_attention import attention_mask

    q, k, v, qp, kp, qs, ks = _decode_case(dtype, np.random.default_rng(1))
    out, lse = fd.flash_decode(q, k, v, qp, kp, qs, ks, with_lse=True)
    want = fd.decode_attention_ref(q, k, v, qp, kp, qs, ks)
    torch.testing.assert_close(out, want)
    b, lanes, h, d = q.shape
    g = h // k.shape[2]
    s = torch.einsum("blhd,bchd->blhc", q.float(),
                     k.float().repeat_interleave(g, dim=2)) * d**-0.5
    mask = attention_mask(qp, kp, qs, ks, causal=True)[:, :, None, :]
    direct = torch.logsumexp(torch.where(mask, s, -float("inf")), dim=-1)
    live = mask.any(-1).expand(b, lanes, h)
    torch.testing.assert_close(lse[live], direct[live], rtol=1e-6, atol=1e-6)
    assert lse.shape == (b, lanes, h) and lse.dtype == torch.float32
    assert bool((lse[~live] == fd.NEG_INF).all()) and bool((out[~live] == 0).all())
    assert not bool(live[1].any())  # the all-empty row


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_merge_of_slot_halves_is_the_whole_cache(dtype):
    """Each half of the slots through K12's plain version with its lse,
    merged by ``lse_merge``, against the whole cache: row 0's valid slots
    lie in both halves, row 2's... every case of ``_decode_case``, plus a
    row whose valid slots all lie in the first half.  The mean of the
    partials misses by far more."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.sharding.placement import lse_merge

    q, k, v, qp, kp, qs, ks = _decode_case(dtype, np.random.default_rng(2))
    kp[0, 12:] = -1  # row 0: every valid slot in the first half
    ks[0, 12:] = -1
    half = k.shape[1] // 2
    parts = [fd.flash_decode(q, k[:, sl], v[:, sl], qp, kp[:, sl], qs, ks[:, sl], with_lse=True)
             for sl in (slice(0, half), slice(half, None))]
    merged = lse_merge([o for o, _ in parts], [l for _, l in parts])
    whole = fd.flash_decode(q, k, v, qp, kp, qs, ks).float()
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(merged, whole, **tol)
    assert bool((merged[1] == 0).all()) and bool((merged[2, 1] == 0).all())
    assert not torch.isnan(merged).any()
    mean = sum(o.float() for o, _ in parts) / 2
    assert float((mean - whole).abs().max()) > 10 * tol["atol"]


def _write_case(c, steps):
    """The whole ring's cache after ``steps`` (a list of (k, pos) writes)
    and each half of it written alone, as (whole, [half 0, half 1])."""
    from repro_torch.models.attention import _paged_write, empty_cache

    b = 3
    whole = empty_cache(b, c, 2, 4, torch.float32, "cpu")
    halves = [empty_cache(b, c // 2, 2, 4, torch.float32, "cpu") for _ in range(2)]
    for kin, pos in steps:
        seg = torch.where(pos >= 0, 0, -1).int()
        _paged_write(whole, kin, -kin, pos, seg)
        for j, h in enumerate(halves):
            _paged_write(h, kin, -kin, pos, seg, slots=(j * (c // 2), c))
    return whole, halves


@pytest.mark.parametrize("case", ["ragged prefill", "a half filled", "over-long", "decode wrap"])
def test_paged_write_of_a_block_is_the_ring_slice(case):
    c = 16
    rs = np.random.default_rng(3)

    def prefill(lens, s):
        ar = np.arange(s)[None, :]
        pos = torch.from_numpy(np.where(ar < np.asarray(lens)[:, None], ar, -1).astype(np.int32))
        return torch.from_numpy(rs.standard_normal((3, s, 2, 4), dtype=np.float32)), pos

    def decode(at):
        return (torch.from_numpy(rs.standard_normal((3, 1, 2, 4), dtype=np.float32)),
                torch.tensor(at, dtype=torch.int32)[:, None])

    steps = {
        "ragged prefill": [prefill([12, 3, 9], 12)],  # spares at 12, 3, 9: both halves
        "a half filled": [prefill([8, 10, 5], 10)],  # row 0 fills half 0; row 1 crosses
        # the attention keeps an over-long prefill's last C tokens
        "over-long": [tuple(t[:, -c:] for t in prefill([20, 18, 16], 20))],
        "decode wrap": [prefill([14, 7, 15], 15)] + [decode([14 + t, 7 + t, 15 + t])
                                                     for t in range(4)],
    }[case]
    whole, halves = _write_case(c, steps)
    for j, h in enumerate(halves):
        sl = slice(j * (c // 2), (j + 1) * (c // 2))
        for name in ("k", "v", "kpos", "kseg"):
            assert torch.equal(h[name], whole[name][:, sl]), (case, j, name)
        assert torch.equal(h["fill"], whole["fill"])
