"""Port parity of whole-train-state checkpoints (repro_torch.train.checkpoint
``save``/``restore``) against the JAX package's ``repro.train.checkpoint``.

On the bert-large smoke (f32 compute), one VR-LAMB step is taken by the JAX
``make_train_step`` (reference plan: tree state) and by the port from the
same init params and batch, on the port's fused plan (flat m/v/p) and its
reference plan (tree m/v/p), with f32 and with bf16 state.  Each package
saves its state; the files have the same key set and dtypes; each file
restores into the other package's template (built from other init values)
and gives back exactly the saved numbers; and the next step from each
restored state matches the other package's next step at
tests/test_torch_train.py's tolerances (its ``_compare``).  Flat- and
tree-state checkpoints interchange within the port too, the data cursor
(``DataState``) round-trips through either package and serves the same
next batch, and under a 2-rank gloo mesh the row-sharded flat state is
gathered, saved and restored into shards equal (``torch.equal``) to the
saved ones.  Flat buffers are compared on the elements that hold a
parameter: the checkpoint does not store a buffer's padding (see
train/checkpoint.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jt
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtr
from repro_torch.core.layout import FlatBuffer, is_flat, pad_mask, tree_leaves, tree_paths
from repro_torch.data import lm_batches
from repro_torch.launch.mesh import make_host_mesh, run_ranks
from repro_torch.train import init_state, make_train_step
from repro_torch.train.checkpoint import flat_to_numpy, params_from_numpy, restore, save
from test_torch_train import _cfgs, _compare


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-sized work: one intra-op thread keeps this file from
    oversubscribing the cores the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_leaves(state) -> dict:
    """The port's state as {tree path: f32 numpy} in the checkpoint's terms."""
    out = {"params": flat_to_numpy(state.params.data, state.params.layout), "step": state.step}
    for key, val in state.opt_state.items():
        out[f"opt_state/{key}"] = flat_to_numpy(val.data, val.layout) if is_flat(val) else \
            (val if isinstance(val, int) else
             {p: x.float().numpy() for p, x in tree_paths(val)})
    flat = {}
    for key, val in out.items():
        if isinstance(val, dict):
            for p, x in tree_paths(val):
                flat[f"{key}/{p}"] = np.asarray(x, np.float32)
        else:
            flat[key] = np.asarray(val)
    return flat


def _jax_leaves(state) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]
    return {jckpt._path_str(p): np.asarray(x, np.float32) if np.asarray(x).dtype.kind == "f"
            else np.asarray(x) for p, x in flat}


def _assert_same_numbers(a: dict, b: dict, what):
    assert set(a) == set(b), (what, sorted(set(a) ^ set(b)))
    for key in a:
        assert np.array_equal(np.asarray(a[key]), np.asarray(b[key])), (what, key)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_between_the_packages(tmp_path, state_dtype):
    plans = ("fused", "reference") if state_dtype == "float32" else ("fused",)
    jcfg, _ = _cfgs("bert-large", "reference", state_dtype=state_dtype)
    jp = jt.init_params(jcfg.model, jax.random.PRNGKey(0))
    stream = lm_batches(jcfg.model.vocab_size, jcfg.global_batch, jcfg.seq_len)
    b0, b1 = next(stream), next(stream)
    jstep = jax.jit(jtr.make_train_step(jcfg)[0])
    jstate1, _ = jstep(jtr.init_state(jcfg, params=jp), {k: jnp.asarray(v) for k, v in b0.items()})
    ref_path = str(tmp_path / "ref.npz")
    jckpt.save(ref_path, jstate1)
    jtemplate = jtr.init_state(jcfg, key=jax.random.PRNGKey(99))
    for plan in plans:
        _, tcfg = _cfgs("bert-large", plan, state_dtype=state_dtype)
        tstep = make_train_step(tcfg, device="cpu")[0]
        tstate1, _ = tstep(init_state(tcfg, params=params_from_numpy(jax.device_get(jp),
                                                                     tcfg.model),
                                      device="cpu"), b0)
        port_path = str(tmp_path / f"port_{plan}.npz")
        save(port_path, tstate1)
        with np.load(port_path) as fp, np.load(ref_path) as fr:
            assert set(fp.files) == set(fr.files)
            assert {k: fp[k].dtype for k in fp.files} == {k: fr[k].dtype for k in fr.files}
            assert fp["step"].dtype == np.int32 and fp["step"].shape == ()
        # the reference's file into a port template of other values, and back
        template = init_state(tcfg, device="cpu")
        port_from_ref = restore(ref_path, template)
        m = port_from_ref.opt_state["m"]
        assert is_flat(m) == (plan == "fused")
        assert tree_leaves(m)[0].dtype == tree_leaves(template.opt_state["m"])[0].dtype
        _assert_same_numbers(_port_leaves(port_from_ref), _jax_leaves(jstate1),
                             f"{plan}: reference file -> port")
        ref_from_port = jckpt.restore(port_path, jtemplate)
        _assert_same_numbers(_jax_leaves(ref_from_port), _port_leaves(tstate1),
                             f"{plan}: port file -> reference")
        # the next step of each package from the other's checkpoint
        jstate2, jm2 = jstep(ref_from_port, {k: jnp.asarray(v) for k, v in b1.items()})
        tstate2, tm2 = tstep(port_from_ref, b1)
        _compare(jstate2, jm2, tstate2, tm2, 1)


def test_flat_and_tree_state_and_k_interchange_within_the_port(tmp_path):
    """A fused (flat m/v/p) state restores into a reference-plan (tree)
    template and back, bit for bit; TrainState.k adds its leaf only when
    set."""
    _, fcfg = _cfgs("bert-large", "fused")
    _, rcfg = _cfgs("bert-large", "reference")
    batch = next(lm_batches(fcfg.model.vocab_size, fcfg.global_batch, fcfg.seq_len))
    state, _ = make_train_step(fcfg, device="cpu")[0](init_state(fcfg, device="cpu"), batch)
    unpacked = state.with_unpacked_opt_state().opt_state
    assert not is_flat(unpacked["m"]) and unpacked["step"] == 1
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(unpacked["v"]),
                                                 tree_leaves(state.opt_state["v"].unpack())))
    save(str(tmp_path / "flat.npz"), state._replace(k=4))
    tree = restore(str(tmp_path / "flat.npz"), init_state(rcfg, device="cpu")._replace(k=0))
    assert tree.k == 4 and isinstance(tree.k, int) and tree.step == state.step == 1
    assert not is_flat(tree.opt_state["m"])
    save(str(tmp_path / "tree.npz"), tree._replace(k=None))
    with np.load(tmp_path / "tree.npz") as f:
        assert "k" not in f.files and f["opt_state/pt"].dtype == np.int32
    back = restore(str(tmp_path / "tree.npz"), init_state(fcfg, device="cpu"))
    assert back.k is None and back.opt_state["pt"] == state.opt_state["pt"]
    assert torch.equal(back.params.data, state.params.data)
    for name in "mvp":  # every element of every leaf (the padding is not stored)
        for a, b in zip(tree_leaves(back.opt_state[name].unpack()),
                        tree_leaves(state.opt_state[name].unpack())):
            assert torch.equal(a, b), name
    # the restored FlatParams are trainable: leaves are views with grads
    leaf = tree_leaves(back.params.tree)[0]
    assert leaf.requires_grad and leaf.grad is not None
    with pytest.raises(KeyError, match="missing"):
        restore(str(tmp_path / "tree.npz"), {"other": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore(str(tmp_path / "tree.npz"), {"step": torch.zeros(3)})


def test_datastate_round_trips_through_both_packages(tmp_path):
    import repro.data as jd
    from repro_torch import data as td

    d = str(tmp_path / "cache")
    td.write_token_cache(td.markov_documents(64, 800, 3, 70, seed=0, stream_seed=1), d, vocab=64)
    ds = td.IndexedPackedDataset(d, 32, 4, seed=9)
    for _ in range(3):
        ds.next_batch()
    st = ds.state
    save(str(tmp_path / "port.npz"), {"data": st, "step": 3})
    back = restore(str(tmp_path / "port.npz"), {"data": td.DataState.make(), "step": 0})
    assert back["step"] == 3 and all(np.asarray(x).dtype == np.int64 for x in back["data"])
    assert tuple(map(int, back["data"])) == tuple(map(int, st))
    jback = jckpt.restore(str(tmp_path / "port.npz"), {"data": jd.DataState.make(),
                                                       "step": jnp.zeros((), jnp.int32)})
    assert tuple(map(int, jback["data"])) == tuple(map(int, st))
    jckpt.save(str(tmp_path / "ref.npz"), jback["data"])
    from_ref = restore(str(tmp_path / "ref.npz"), td.DataState.make())
    want = td.IndexedPackedDataset(d, 32, 4, state=st).next_batch()
    for cursor in (back["data"], from_ref):
        got = td.IndexedPackedDataset(d, 32, 4, state=cursor).next_batch()
        assert all(np.array_equal(got[k], want[k]) for k in want)


def _mesh_rank(rank, world, init, out):
    torch.set_num_threads(1)
    mesh = make_host_mesh(world, rank, init)
    _, cfg = _cfgs("bert-large", "fused", gsnr_source="data_axis")
    params = torch.load(f"{out}/params.pt", weights_only=False)
    batch = next(lm_batches(cfg.model.vocab_size, cfg.global_batch, cfg.seq_len))
    state = init_state(cfg, params=params, device="cpu", mesh=mesh)
    state, metrics = make_train_step(cfg, device="cpu", mesh=mesh, noise_scale=True)[0](
        state, batch)
    path = f"{out}/sharded.npz"
    save(path, {"state": state}, mesh=mesh)
    template = init_state(cfg.replace(seed=7), device="cpu", mesh=mesh)
    back = restore(path, {"state": template})["state"]
    res = {"noise": {k: float(v) for k, v in metrics.items() if k.startswith("noise/")},
           "params": torch.equal(back.params.data, state.params.data),
           "step": (back.step, state.step, back.opt_state["pt"], state.opt_state["pt"]),
           "shards": {}}
    for name in "mvp":  # every element of the rank's rows that holds a parameter
        a, b = back.opt_state[name], state.opt_state[name]
        live = a.shard.local(pad_mask(a.layout))
        res["shards"][name] = (a.shard == b.shard and torch.equal(a.data[live], b.data[live]),
                               tuple(a.data.shape))
    res["whole"] = {name: FlatBuffer(state.opt_state[name].shard.gather(
        state.opt_state[name].data, mesh), state.params.layout) for name in "mvp"}
    res["params_data"] = state.params.data
    torch.save(res, f"{out}/rank{rank}.pt")
    mesh.close()


def test_sharded_state_checkpoint_under_a_two_rank_mesh(tmp_path):
    from test_torch_noise_scale import SUM_RTOL, check_estimate

    from repro_torch.configs import get_smoke
    from repro_torch.models import init_params

    world = 2
    cfg = get_smoke("bert-large")
    params = init_params(cfg.model, torch.Generator().manual_seed(0))
    torch.save(params, tmp_path / "params.pt")
    run_ranks(_mesh_rank, world, args=(world, f"file://{tmp_path}/rdzv", str(tmp_path)),
              deadline_s=180.0)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]
    for r, res in enumerate(ranks):
        assert res["params"] and res["step"] == (1, 1, 1, 1), r
        for name, (equal, shape) in res["shards"].items():
            assert equal and shape[0] < ranks[0]["whole"][name].data.shape[0], (r, name)
        assert res["noise"] == ranks[0]["noise"], r  # the same readings on every rank
    # the file holds the whole state: it restores on one card, unsharded
    _, one = _cfgs("bert-large", "fused", k=world)
    single = restore(str(tmp_path / "sharded.npz"), {"state": init_state(one, device="cpu")})
    assert torch.equal(single["state"].params.data, ranks[0]["params_data"])
    for name in "mvp":
        for a, b in zip(tree_leaves(single["state"].opt_state[name].unpack()),
                        tree_leaves(ranks[0]["whole"][name].unpack())):
            assert torch.equal(a, b), name
    # the readings against the single-card k = 2 step from the same params
    batch = next(lm_batches(one.model.vocab_size, one.global_batch, one.seq_len))
    _, m = make_train_step(one, device="cpu", noise_scale=True)[0](
        init_state(one, params=params, device="cpu"), batch)
    keys = ("g2_small", "g2_big", "tr_sigma", "g2", "b_simple")
    check_estimate({k: ranks[0]["noise"][f"noise/{k}"] for k in keys},
                   {k: float(m[f"noise/{k}"]) for k in keys},
                   one.global_batch / world, one.global_batch, SUM_RTOL, "W=2 vs k=2")
