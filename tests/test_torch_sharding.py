"""Port parity of the weights' sharding rules and their placement, without
ranks (sharding/rules.py, sharding/placement.py, core/layout.py::
GridShard).

* Rules parity: for each of the 11 transformer configs of ``ARCH_MODULES``
  at full width, every leaf of the reference's ``params_shapes`` (scanned
  layout) gets the reference's ``Rules.leaf_pspec`` from the port's rules,
  entry by entry, on the meshes (16, 16), the pod mesh (2, 16, 16), (2, 2),
  (4, 2) and (1, 4), with ``fsdp`` on and off and with ``fsdp_over_pod``;
  ``batch_axes`` and ``resolve`` agree for every logical name over a range
  of sizes, and ``flat_buffer_pspec`` over a range of row counts.  The
  port's own stacked layout (``models/transformer.py::model_layout``, drawn
  on the meta device) has the reference's paths and shapes.  Only shapes:
  nothing is allocated.  DLRM's tables wait for their own slice.
* Every case of tests/test_sharding.py replayed against the port.
* Round trip: ``shard_params`` on each simulated rank, then
  ``assemble_params``, is ``torch.equal`` to the tree, on the bert-large
  and internlm2 smokes over (2, 2), (1, 2), (2, 1) and (4, 1); each rank's
  GridShard local buffer holds exactly its blocks (``GridShard.local`` of
  the whole buffer against the packed ``shard_params``), its held element
  count is its spec block sizes, and the owners of each leaf cover the grid
  once.
* What a rank of bert-large holds at published width on (2, 2): every leaf
  but the 1-D final norm splits 4 ways, 91.2 M of 364.6 M params.
* The placement's refusals without ranks: each unported block kind (MoE,
  RG-LRU, mLSTM/sLSTM, cross-attention with its encoder or image stub)
  raises NotImplementedError naming ROADMAP A9.

The spawned-rank checks of the grid step are in tests/test_torch_grid.py.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_MODULES, get_config, get_smoke
from repro_torch.core.layout import GridShard, pad_mask
from repro_torch.models.transformer import init_params, model_layout
from repro_torch.sharding import placement as plm
from repro_torch.sharding.rules import MeshShape, Rules, Spec, batch_spec, constrain

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "pod 2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
}
KNOBS = {"fsdp": {}, "no fsdp": {"fsdp": False}, "fsdp over pod": {"fsdp_over_pod": True}}
LOGICAL = ("batch", "tp", "ff", "heads", "vocab", "experts", "fsdp", "expert_cap",
           "cache_seq", "unknown", None)
SIZES = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64, 100, 128, 256, 512, 30522, 51865)
SMOKES = ("bert-large", "internlm2-1.8b")
GRIDS = ((2, 2), (1, 2), (2, 1), (4, 1))


def _amesh(sizes, names):
    from jax.sharding import AbstractMesh

    try:
        return AbstractMesh(sizes, names)
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))


def _ref_leaves(arch):
    import jax

    from repro.configs import get_config as j_get_config
    from repro.models.transformer import params_shapes

    cfg = j_get_config(arch)
    leaves = jax.tree_util.tree_flatten_with_path(params_shapes(cfg.model, cfg.parallel))[0]
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path), leaf.shape)
            for path, leaf in leaves]


def _both(mesh, **kw):
    from repro.sharding.rules import Rules as JRules

    sizes, names = MESHES[mesh]
    return Rules(mesh=MeshShape(sizes, names), **kw), JRules(mesh=_amesh(sizes, names), **kw)


@pytest.mark.parametrize("arch", sorted(ARCH_MODULES))
def test_leaf_specs_match_the_reference(arch):
    leaves = _ref_leaves(arch)
    layout = model_layout(get_config(arch).model)
    assert layout.paths == tuple(p for p, _ in leaves)
    assert layout.shapes == tuple(tuple(s) for _, s in leaves)
    for mesh in MESHES:
        for knob, kw in KNOBS.items():
            port, ref = _both(mesh, **kw)
            for path, shape in leaves:
                got, want = port.leaf_pspec(path, shape), ref.leaf_pspec(path, shape)
                assert isinstance(got, Spec)
                assert tuple(got) == tuple(want), (arch, mesh, knob, path, shape, got, want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_axes_resolve_and_flat_rows_match_the_reference(mesh):
    for kw in KNOBS.values():
        for extra in ({}, {"shard_cache_seq": False}):
            port, ref = _both(mesh, **kw, **extra)
            for n in SIZES:
                assert port.batch_axes(n) == ref.batch_axes(n), (mesh, n)
                for name in LOGICAL:
                    assert port.resolve(name, n) == ref.resolve(name, n), (mesh, name, n)
                for rows in (n, 64 * n):
                    assert tuple(port.flat_buffer_pspec((rows, 128))) == \
                        tuple(ref.flat_buffer_pspec((rows, 128))), (mesh, rows)


# -- tests/test_sharding.py, replayed against the port ----------------------

SINGLE = MeshShape((16, 16), ("data", "model"))
POD = MeshShape((2, 16, 16), ("pod", "data", "model"))


def test_generic_weight_fsdp_tp():
    r = Rules(mesh=SINGLE)
    assert r.leaf_pspec("groups/pos0/mlp/wi", (6144, 16384)) == Spec("data", "model")
    assert r.leaf_pspec("x/w", (6144, 100)) == Spec("data", None)
    assert r.leaf_pspec("x/w", (100, 16384)) == Spec(None, "model")


def test_stacked_scan_leaves_keep_leading_dim_replicated():
    r = Rules(mesh=SINGLE)
    assert r.leaf_pspec("groups/pos0/attn/wq", (7, 4096, 4096)) == Spec(None, "data", "model")


def test_expert_parallel_when_divisible():
    r = Rules(mesh=SINGLE)
    assert r.leaf_pspec("moe/expert_wi", (128, 5120, 8192)) == Spec("model", "data", None)
    assert r.leaf_pspec("moe/expert_wi", (8, 6144, 16384)) == Spec(None, "data", "model")


def test_embedding_vocab_sharding():
    r = Rules(mesh=SINGLE)
    assert r.leaf_pspec("embed/embed", (32768, 4096)) == Spec("model", "data")
    assert r.leaf_pspec("embed/embed", (51865, 768)) == Spec(None, "data")


def test_small_vectors_replicated():
    assert Rules(mesh=SINGLE).leaf_pspec("final_norm/scale", (4096,)) == Spec(None)


def test_batch_axes_adaptive():
    r1 = Rules(mesh=SINGLE)
    assert r1.batch_axes(256) == "data"
    assert r1.batch_axes(1) is None
    r2 = Rules(mesh=POD)
    assert r2.batch_axes(256) == ("pod", "data")
    assert r2.batch_axes(2) == "pod"
    assert r2.batch_axes(3) is None


def test_fsdp_off():
    assert Rules(mesh=SINGLE, fsdp=False).leaf_pspec("mlp/wi", (4096, 16384)) == \
        Spec(None, "model")


def test_cache_seq_fallback_spec():
    r_off = Rules(mesh=SINGLE, cache_seq_tp=False)
    assert batch_spec((1, 524288, 1, 128), r_off, 1, kind="cache") == \
        Spec(None, "data", None, None)
    assert batch_spec((128, 32768, 8, 128), r_off, 128, kind="cache") == \
        Spec("data", None, None, None)
    leaf3 = (24, 128, 32768, 8, 128)
    assert batch_spec(leaf3, r_off, 128, kind="cache") == Spec(None, "data", None, None, None)
    r_tp = Rules(mesh=SINGLE)
    assert r_tp.cache_seq_tp
    assert batch_spec(leaf3, r_tp, 128, kind="cache") == Spec(None, "data", "model", None, None)
    assert batch_spec((128, 32768, 8, 128), r_tp, 128, kind="cache") == \
        Spec("data", "model", None, None)
    assert batch_spec((1, 524288, 1, 128), r_tp, 1, kind="cache") == \
        Spec(None, ("data", "model"), None, None)


def test_cache_and_batch_specs_match_the_reference():
    from repro.launch.specs import batch_pspec

    import jax

    for mesh in MESHES:
        for extra in ({}, {"cache_seq_tp": False}, {"cache_seq_tp": False,
                                                    "shard_cache_seq": False}):
            port, ref = _both(mesh, **extra)
            for shape, batch in (((1, 524288, 1, 128), 1), ((128, 32768, 8, 128), 128),
                                 ((24, 128, 32768, 8, 128), 128), ((6, 2, 64), 2),
                                 ((3, 4), 5), ((2, 3, 7), 3)):
                for kind in ("batch", "cache"):
                    leaf = jax.ShapeDtypeStruct(shape, "float32")
                    assert tuple(batch_spec(shape, port, batch, kind)) == \
                        tuple(batch_pspec(leaf, ref, batch, kind)), (mesh, shape, kind)


def test_flat_buffer_rows_fsdp():
    from repro_torch.core.layout import FlatBuffer, ParamLayout, is_flat
    from repro_torch.sharding.rules import param_specs

    r = Rules(mesh=SINGLE)
    assert r.flat_buffer_pspec((512, 128)) == Spec("data", None)
    assert r.leaf_pspec("m/data", (512, 128)) == Spec("data", "model")
    assert Rules(mesh=SINGLE, fsdp=False).flat_buffer_pspec((512, 128)) == Spec(None, None)
    assert r.flat_buffer_pspec((7, 128)) == Spec(None, None)
    assert Rules(mesh=POD, fsdp_over_pod=True).flat_buffer_pspec((512, 128)) == \
        Spec(("pod", "data"), None)
    tree = {"w": torch.ones((40, 7))}
    layout = ParamLayout.for_tree(tree)
    fb = FlatBuffer(layout.pack(tree), layout)
    specs = param_specs({"m": fb, "step": torch.zeros((), dtype=torch.int32)}, r)
    assert is_flat(specs["m"])
    assert specs["m"].data == Spec("data", None)
    assert specs["step"] == Spec()


def test_constrain_noop_without_mesh():
    from repro_torch.sharding.rules import activate, constrain_like_param

    x = torch.ones((4, 4))
    assert constrain(x, ("batch", None)) is x
    with activate(SINGLE):
        assert constrain(x, ("batch", None)) is x
        assert constrain_like_param(x, "x/w") is x
        with pytest.raises(ValueError, match="logical axes"):
            constrain(x, ("batch", None, None))


# -- placement geometry, ranks simulated in one process ----------------------


def _grid(d, m, i=0, j=0):
    return types.SimpleNamespace(shape={"data": d, "model": m}, coords={"data": i, "model": j},
                                 axis_names=("data", "model"), size=d * m, rank=i * m + j)


def _stacked(arch):
    from repro_torch.core.layout import stack_groups

    cfg = get_smoke(arch)
    return cfg, stack_groups(init_params(cfg.model, torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("arch", SMOKES)
def test_shard_then_assemble_is_the_tree(arch):
    from repro_torch.core.layout import ParamLayout, tree_paths

    cfg, tree = _stacked(arch)
    layout = ParamLayout.for_tree(tree)
    for d, m in GRIDS:
        rules = Rules(mesh=MeshShape((d, m), ("data", "model")))
        specs = {p: rules.leaf_pspec(p, tuple(x.shape)) for p, x in tree_paths(tree)}
        spec_tree = _spec_tree(tree, specs)
        ranks = [_grid(d, m, *divmod(r, m)) for r in range(d * m)]
        blocks = [plm.shard_params(tree, spec_tree, g) for g in ranks]
        back = plm.assemble_params(blocks, spec_tree, ranks[0].shape,
                                   [g.coords for g in ranks])
        for (path, a), (_, b) in zip(tree_paths(back), tree_paths(tree)):
            assert torch.equal(a, b), (arch, d, m, path)
        whole = layout.pack(tree)
        owners = np.zeros(layout.n_leaves, int)
        for g, blk in zip(ranks, blocks):
            sh = GridShard(layout, [specs[p] for p in layout.paths], g)
            local = sh.local(whole)
            assert torch.equal(local, sh.local_layout.pack(blk)), (arch, d, m)
            assert sh.local(local) is local
            assert sh.held == plm.held_elements(dict(zip(layout.paths, layout.shapes)), specs,
                                                g.shape)
            assert sh.held == sum(x.numel() for _, x in tree_paths(blk))
            owners += sh.owner
            live = sh.live("cpu")
            assert torch.equal(live & ~pad_mask(sh.local_layout), torch.zeros_like(live))
        # every leaf is owned once per distinct block: its replicas count once
        for p, n in zip(layout.paths, owners):
            split = int(np.prod([g for a, g in ranks[0].shape.items()
                                 if a in specs[p].axes()]))
            assert n == split, (arch, d, m, p, n)


def _spec_tree(tree, specs, prefix=""):
    if isinstance(tree, dict):
        return {k: _spec_tree(v, specs, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_tree(v, specs, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return specs[prefix[:-1]]


def test_bert_large_rank_holds_a_quarter_on_two_by_two():
    layout = model_layout(get_config("bert-large").model)
    rules = Rules(mesh=MeshShape((2, 2), ("data", "model")))
    specs = {p: rules.leaf_pspec(p, s) for p, s in zip(layout.paths, layout.shapes)}
    for p, spec in specs.items():
        assert (spec.axes() == ()) == p.startswith("final_norm/"), (p, spec)
    assert specs["groups/pos0/ln1/scale"] == Spec("data", "model")
    held = plm.held_elements(dict(zip(layout.paths, layout.shapes)), specs, rules.mesh.shape)
    total = sum(layout.sizes)
    assert round(total / 1e6, 1) == 364.6 and round(held / 1e6, 1) == 91.2
    assert held == (total - 2 * 1024) // 4 + 2 * 1024


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "recurrentgemma-9b", "xlstm-1.3b",
                                  "whisper-small", "llama-3.2-vision-11b"])
def test_unported_block_kinds_raise_on_a_grid(arch):
    cfg = get_smoke(arch)
    layout = model_layout(cfg.model)
    rules = Rules(mesh=MeshShape((2, 2), ("data", "model")))
    specs = {p: rules.leaf_pspec(p, s) for p, s in zip(layout.paths, layout.shapes)}
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        plm.Placement(cfg.model, rules, _grid(2, 2), specs, dict(zip(layout.paths,
                                                                     layout.shapes)))
