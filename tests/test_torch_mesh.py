"""Serving on a device mesh: the port's ``torch.distributed`` ranks against
the JAX package, on the CPU.

The reference's mesh tests need a multi-device XLA host, which this host
is not; the port is held against the reference's own single-device
functions instead:

  * Specs: ``sharding.partition``'s tables against
    ``repro.sharding.partition``'s on every config's smoke tree and on
    Llama's and DeepSeek's served trees, on (2, 8), (16, 16) and
    (2, 16, 16) stand-in meshes (the rules read only a mesh's shape and
    axis names); on the port's per-layer trees, the reference's spec of
    the stacked leaf without its layer dim.
  * Tiles and planes: ``choose_fused_tiles(shards=)`` over a grid of
    shapes and shard counts, and ``build_serve_params(model_shards=2, 4)``
    byte for byte (also with column groups).
  * Spawned gloo ranks (``launch.mesh.spawn``, one spawn per mesh shape:
    (1, 2) and (2, 2)), each on its share of the weights
    (``place_params``): column-parallel K1 and K5 and expert-parallel K3
    (plain versions) bitwise equal to one process; column groups
    (``TiledPackedLinear``) and the local-routing MoE within a stated
    tolerance of the reference's unsharded ``decode_dequant_matmul`` and
    ``apply_moe`` (dropless); ``generate`` tokens bitwise equal to one
    process and to the reference's ``generate`` under the exact-tie rule
    of ``test_torch_moe.py``; the ``Engine`` on a mesh bitwise equal to
    ``generate`` on it; the dispatch probes as the reference's gates
    predict.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.configs import all_archs as jall_archs
from repro.configs import get_config
from repro.core import CompressionPolicy as JPolicy
from repro.core import blocked_codec as jbc
from repro.core import integrity as JI
from repro.kernels import ops as jops
from repro.models import encdec as JED
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.serve import engine as JE
from repro.serve.context import ServeContext as JContext
from repro.sharding import partition as JPT

from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.core import blocked_codec as tbc
from repro_torch.core import integrity as TI
from repro_torch.core.compressed import PackedLinear, TiledPackedLinear
from repro_torch.core.policy import CompressionPolicy
from repro_torch.kernels import _build, ops
from repro_torch.launch import mesh as M
from repro_torch.models import lm as TLM
from repro_torch.serve import engine as TE
from repro_torch.serve.resilience import ResilientEngine
from repro_torch.sharding import partition as PT

import torch_mesh_worker
from test_torch_moe import _reference_greedy
from test_torch_serve import _prompts
from test_torch_tiled import _u16

torch.set_num_threads(2)
STAND_IN = [((2, 8), ("data", "model")), ((16, 16), ("data", "model")),
            ((2, 16, 16), ("pod", "data", "model"))]
SHAPES = [(1, 2), (2, 2)]
LLAMA, DEEPSEEK = "llama3.2-1b", "deepseek-v2-lite-16b"
MODEL_SHARDS = 2            # both spawned meshes have two model ranks
MAX_NEW = 6
# the local-routing MoE against the reference's global one: bf16 outputs
# (its router runs in f32 where the global one runs in bf16, and the
# partial outputs add over model in bf16), within this many bf16 ulps of
# the reference's largest magnitude
MOE_ULPS = 4
# column groups with the f32 partial sums added over data: within this
# share of the output's largest magnitude (test_torch_tiled.py's bound)
TILED_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _clear_counts():
    ops.DISPATCH_COUNTS.clear()
    _build.LAUNCH_COUNTS.clear()
    yield
    assert not _build.LAUNCH_COUNTS, "a CPU call launched a kernel"


# -- specs -----------------------------------------------------------------

def _ref_flat(specs) -> dict:
    """{path: spec as a tuple}; an axis tuple of one name as the bare name
    (which a PartitionSpec holds it as, in the JAX versions that
    normalize it)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {JPT._leaf_path_str(p): tuple(
        a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in s)
        for p, s in flat}


def _port_flat(specs, prefix="") -> dict:
    if isinstance(specs, dict):
        out = {}
        for k, v in specs.items():
            out.update(_port_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(specs, list):
        out = {}
        for i, v in enumerate(specs):
            out.update(_port_flat(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {prefix: specs}


def _stand_ins(tree) -> dict:
    """The reference's tree as nested dicts of shapes, keyed by its paths
    (what the port's rules read)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    root: dict = {}
    for path, leaf in flat:
        parts = JPT._leaf_path_str(path).split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = types.SimpleNamespace(shape=tuple(leaf.shape))
    return root


@functools.lru_cache(maxsize=None)
def _dense_shapes(arch):
    cfg = get_config(arch).smoke
    init = JED.init_encdec if cfg.family == "encdec" else JLM.init_lm
    return jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg,
                                       jnp.float32))


@pytest.mark.parametrize("shape,axes", STAND_IN)
@pytest.mark.parametrize("arch", jall_archs())
def test_param_specs_equal_reference_on_every_config(arch, shape, axes):
    tree = _dense_shapes(arch)
    mesh = M.AbstractMesh(shape, axes)
    for mode in ("train", "serve"):
        want = _ref_flat(JPT.make_param_specs(
            tree, mesh, JPT.ShardingConfig(mode=mode)))
        got = _port_flat(PT.make_param_specs(
            _stand_ins(tree), mesh, PT.ShardingConfig(mode=mode)))
        assert got == want, (arch, mode)
    assert any(any(a is not None for a in s) for s in want.values())


@pytest.mark.parametrize("shape,axes", STAND_IN)
@pytest.mark.parametrize("kind", ["compressed", "tiled", "quant"])
@pytest.mark.parametrize("arch", [LLAMA, DEEPSEEK])
def test_served_specs_equal_reference(arch, kind, shape, axes):
    """Plane rules on the served trees: the reference's tree through both
    packages' rules, then the port's own per-layer tree (its layer's leaf
    takes the reference's spec of the stacked leaf without the layer
    dim)."""
    b = _built(arch, MODEL_SHARDS, 2 if kind == "tiled" else 0,
               "quant" if kind == "quant" else "compressed")
    mesh = M.AbstractMesh(shape, axes)
    scfg = JPT.ShardingConfig(mode="serve")
    want = _ref_flat(JPT.make_param_specs(b.jst.params, mesh, scfg))
    got = _port_flat(PT.make_param_specs(_stand_ins(b.jst.params), mesh,
                                         PT.ShardingConfig(mode="serve")))
    assert got == want
    own = _port_flat(PT.make_param_specs(b.tst.params, mesh,
                                         PT.ShardingConfig(mode="serve")))
    for path, spec in own.items():
        parts = path.split("/")
        if parts[0] == "blocks":
            ref = want["/".join(["blocks"] + parts[2:])]
            assert spec == ref[1:], path
        else:
            assert spec == want[path], path
    planes = {"compressed": "/codes", "tiled": "/codes_t",
              "quant": "/values"}[kind]
    assert any(p.endswith(planes) for p in own)


def test_cache_and_data_specs_equal_reference():
    cfg = get_config(LLAMA).smoke
    tcfg = tget_config(LLAMA).smoke
    caches = jax.eval_shape(lambda: JLM.init_caches(cfg, 4, 16))
    tcaches = TLM.init_caches(tcfg, 4, 16, device="cpu")
    for shape, axes in STAND_IN:
        mesh = M.AbstractMesh(shape, axes)
        want = _ref_flat(JPT.make_cache_specs(caches, mesh))
        assert _port_flat(PT.make_cache_specs(_stand_ins(caches),
                                              mesh)) == want
        for path, spec in _port_flat(PT.make_cache_specs(tcaches,
                                                         mesh)).items():
            parts = path.split("/")
            assert spec == want["/".join(["blocks"] + parts[2:])][1:]
        batch = {"tokens": np.zeros((32, 8), np.int32)}
        assert _port_flat(PT.make_data_specs(batch, mesh)) == _ref_flat(
            JPT.make_data_specs(batch, mesh))


def test_rule_helpers_equal_reference():
    for path in ("blocks/attn/wq", "blocks/attn/wo", "blocks/mlp/w_down",
                 "blocks/0/mlp/w_up", "embed", "blocks/moe/experts/w_down",
                 "blocks/mamba/out_proj"):
        assert PT.is_row_parallel(path) == JPT.is_row_parallel(path)
    key = "['blocks']['mlp']['w_down']"
    assert PT.clean_keystr(key) == JPT.clean_keystr(key)
    x = torch.zeros(8, 4)
    assert PT.constrain(x, ("pod", "data"), "model") is x
    assert PT.current_mesh() == ({}, None)


# -- tiles and planes ------------------------------------------------------

TILE_SHAPES = [(64, 64), (128, 64), (192, 64), (48, 96), (211, 64),
               (8192, 2048), (512, 2048), (10944, 2048), (2048, 10944),
               (1408, 2048), (4096, 512), (16, 16), (24, 40)]


@pytest.mark.parametrize("shards", [(1, 1), (2, 1), (4, 1), (8, 1),
                                    (16, 1), (2, 2), (3, 1), (1, 4)])
def test_choose_fused_tiles_shards(shards):
    for shape in TILE_SHAPES:
        for bw in (4096, 1024, 256):
            assert tbc.choose_fused_tiles(shape, bw, shards=shards) == \
                jbc.choose_fused_tiles(shape, bw, shards=shards), \
                (shape, bw)


@dataclasses.dataclass
class _Built:
    cfg: object
    tcfg: object
    jparams: object
    jst: object
    tst: object


@functools.lru_cache(maxsize=None)
def _built(arch, model_shards, tiles, mode="compressed"):
    """Both packages' serve states of the arch's smoke model (the
    reference's PRNGKey(0) weights, dropless MoE capacity)."""
    cfg = get_config(arch).smoke
    tcfg = tget_config(arch).smoke
    if cfg.n_experts:
        factor = cfg.n_experts / cfg.top_k
        cfg = dataclasses.replace(cfg, capacity_factor=factor)
        tcfg = dataclasses.replace(tcfg, capacity_factor=factor)
    params = JLM.init_lm(jax.random.PRNGKey(0), cfg, jnp.float32)
    jst = JE.build_serve_params(params, JPolicy(
        mode=mode, min_weight_size=1024, tiles=tiles),
        model_shards=model_shards)
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    tst = TE.build_serve_params(tparams, CompressionPolicy(
        mode=mode, min_weight_size=1024, tiles=tiles),
        model_shards=model_shards, device="cpu")
    return _Built(cfg, tcfg, params, jst, tst)


@pytest.mark.parametrize("arch,model_shards,tiles", [
    (LLAMA, 2, 0), (LLAMA, 4, 0), (DEEPSEEK, 2, 0), (DEEPSEEK, 4, 0),
    (LLAMA, 2, 2)])
def test_build_serve_params_model_shards_byte_equal(arch, model_shards,
                                                    tiles):
    b = _built(arch, model_shards, tiles)
    want = dict(JI._iter_plane_leaves(b.jst.params))
    got = {leaf.name: leaf for leaf in TI.plane_leaves(b.tst.params)}
    assert list(got) == list(want)
    for name, leaf in got.items():
        ref = np.asarray(want[name])
        parts = [_u16(p) for p in leaf.parts]
        arr = np.stack(parts) if leaf.stacked else parts[0]
        assert arr.dtype == ref.dtype and arr.shape == ref.shape, name
        np.testing.assert_array_equal(arr, ref, err_msg=name)
    np.testing.assert_array_equal(b.tst.lut.numpy(), np.asarray(b.jst.lut))
    assert b.tst.stats == b.jst.stats
    # the shard-aware tiles split every tile-major weight's out tiles
    # evenly over the model shards
    for _, holders in TI.leaf_groups(b.tst.params):
        w = holders[0][0][holders[0][1]]
        if isinstance(w, (PackedLinear, TiledPackedLinear)) and w.tile_n:
            assert (w.shape[0] // w.tile_n) % model_shards == 0 \
                or w.shape[0] % model_shards


# -- meshes of spawned ranks -----------------------------------------------

def test_mesh_of_more_ranks_than_started_is_refused():
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        M.make_mesh((1, 2), ("data", "model"))
    host = M.make_host_mesh()
    assert host.shape == {"data": 1, "model": 1} and host.size == 1
    assert M.data_axes(host) == ("data",)
    assert M.axis_size(host, "pod") == 1 and M.axis_size(host, "model") == 1
    stand_in = M.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert M.data_axes(stand_in) == ("pod", "data")
    assert M.axis_size(stand_in, "model") == 16 and stand_in.size == 512
    with pytest.raises(ValueError, match="needs 256 devices"):
        M.make_production_mesh()
    assert M.backend_for("cpu", 4) == "gloo"


def test_decode_graph_and_tiered_residency_refuse_a_mesh():
    b = _built(LLAMA, MODEL_SHARDS, 0)
    with pytest.raises(ValueError, match="cannot capture"):
        TE.decode_graph(b.tst.params, b.tcfg, b.tst.lut, 2, 16,
                        device="cpu", mesh=object())
    with pytest.raises(ValueError, match="mesh must be None"):
        ResilientEngine(b.tcfg, b.tst, device="cpu", residency=object(),
                        mesh=object())


def _x(shape, seed, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


def _cases():
    """What every rank runs, and the one-process outputs to hold them to:
    → (cases, {key: one-process output})."""
    lm = _built(LLAMA, MODEL_SHARDS, 0)
    lq = _built(LLAMA, MODEL_SHARDS, 0, "quant")
    lt = _built(LLAMA, MODEL_SHARDS, 2)
    ds = _built(DEEPSEEK, MODEL_SHARDS, 0)
    blk, qblk, tblk = (lm.tst.params["blocks"][0], lq.tst.params["blocks"][0],
                       lt.tst.params["blocks"][0])
    matmul, k5, k3, moe = {}, {}, {}, {}
    for name, grp in (("wq", "attn"), ("wk", "attn"), ("wo", "attn"),
                      ("w_gate", "mlp"), ("w_down", "mlp")):
        w = blk[grp][name]
        matmul[f"k1 {name} decode"] = (w, lm.tst.lut,
                                       _x((4, 1, w.shape[1]), 1), True)
        matmul[f"k1 {name} prefill"] = (w, lm.tst.lut,
                                        _x((3, 11, w.shape[1]), 2), False)
        q = qblk[grp][name]
        k5[f"k5 {name}"] = (q, _x((4, q.values.shape[1]), 3))
    for name, grp in (("wq", "attn"), ("w_down", "mlp")):
        w = tblk[grp][name]
        matmul[f"tiled {name}"] = (w, lt.tst.lut, _x((3, 11, w.shape[1]), 4),
                                   False)
    # the gates: M above max(N, 512) rows (the reference's, which the port
    # does not take), and a weight whose out tiles do not split over two
    # model ranks (one 16-row tile)
    w = blk["attn"]["wq"]
    matmul["gate rows"] = (w, lm.tst.lut, _x((600, w.shape[1]), 5), False)
    small = TE.build_serve_params({"w": torch.randn(16, 64, generator=(
        torch.Generator().manual_seed(6)))}, CompressionPolicy(
            mode="compressed", min_weight_size=1024), device="cpu")
    matmul["gate tiles"] = (small.params["w"], small.lut,
                            _x((3, 64), 7), False)
    stack = ds.tst.params["blocks"][1]["moe"]["experts"]["w_gate"]
    k3["k3 w_gate"] = (stack, ds.tst.lut, _x((8, 5, stack.shape[1]), 8))
    local_cfg = dataclasses.replace(ds.tcfg, moe_local_dispatch=True)
    moe["moe local"] = (ds.tst.params["blocks"][1]["moe"], ds.tst.lut,
                        _x((4, 3, ds.tcfg.d_model), 9), local_cfg)
    prompts = torch.from_numpy(_prompts(lm.tcfg.vocab_size).astype(np.int64))
    generate = {f"generate {arch}": (b.tcfg, b.tst.params, b.tst.lut,
                                     prompts, MAX_NEW)
                for arch, b in ((LLAMA, lm), (DEEPSEEK, ds))}
    reqs = [np.asarray(r[r != 0]) for r in _prompts(lm.tcfg.vocab_size)]
    engine = {"engine": (lm.tcfg, lm.tst.params, lm.tst.lut, reqs, MAX_NEW)}
    cases = {"matmul": matmul, "k5": k5, "k3": k3, "moe": moe,
             "generate": generate, "engine": engine}

    one = {}
    for key, (w, lut, x, decode) in matmul.items():
        if key == "gate tiles":     # the reference's fallback: two steps
            ops.set_default_impl("unfused")
        try:
            one[key] = ops.decode_dequant_matmul(
                x, w, lut, out_dtype=torch.float32, decode=decode)
        finally:
            ops.set_default_impl("auto")
    for key, (q, x) in k5.items():
        one[key] = ops.dequant_matmul(x, q.values, q.scale, q.zero,
                                      out_dtype=torch.float32)
    for key, (w, lut, xe) in k3.items():
        one[key] = ops.grouped_decode_dequant_matmul(
            xe, w, lut, out_dtype=torch.float32)
    for key, (cfg, params, lut, toks, n) in generate.items():
        one[key] = TE.generate(params, cfg, toks, lut=lut, device="cpu",
                               max_new=n)
        # the cached states outlive this test: free their decode graphs,
        # which would otherwise stay among engine._GRAPHS for later tests
        TE.drop_graphs(cfg)
    return cases, one


@functools.lru_cache(maxsize=None)
def _run(shape):
    cases, one = _cases()
    outs = M.spawn(torch_mesh_worker.run, shape[0] * shape[1], shape, cases,
                   device="cpu")
    return cases, one, outs


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"mesh{s}")
def ran(request):
    return (request.param,) + _run(request.param)


def test_ranks_hold_their_coordinates(ran):
    shape, _, _, outs = ran
    assert [tuple(o["coords"].values()) for o in outs] == [
        (d, m) for d in range(shape[0]) for m in range(shape[1])]


def test_k1_column_parallel_bitwise(ran):
    """Every rank's K1 on its out band, gathered, is one process's output
    bit for bit, at decode and prefill M; each rank held N/2 rows."""
    _, cases, one, outs = ran
    keys = [k for k in cases["matmul"] if k.startswith("k1")]
    for out in outs:
        for key in keys:
            y, probe, axes, codes = out[key]
            w = cases["matmul"][key][0]
            assert torch.equal(y, one[key]), key
            assert probe == {"fused_shard_map": 1}, (key, probe)
            assert axes == ("model",) and codes[0] * 2 == w.codes.shape[0]


def test_k5_column_parallel_bitwise(ran):
    _, cases, one, outs = ran
    for out in outs:
        for key in cases["k5"]:
            y, probe = out[key]
            assert torch.equal(y, one[key]), key
            assert probe == {"dequant_shard_map": 1}


def test_k3_expert_parallel_bitwise(ran):
    _, cases, one, outs = ran
    for out in outs:
        for key, (w, _, _) in cases["k3"].items():
            y, probe, axes, codes = out[key]
            assert torch.equal(y, one[key]), key
            assert probe == {"grouped_fused_shard_map": 1}
            assert axes == ("model",) and codes[0] * 2 == w.codes.shape[0]


def test_tiled_within_tolerance_of_reference(ran):
    """Column groups on data, out bands on model, the f32 sums added over
    data: within TILED_RTOL of the reference's unsharded product; with
    one data rank (no sum over ranks) bitwise one process's."""
    shape, cases, one, outs = ran
    lt = _built(LLAMA, MODEL_SHARDS, 2)
    jblk = jax.tree_util.tree_map(lambda a: a[0], lt.jst.params["blocks"])
    for key in (k for k in cases["matmul"] if k.startswith("tiled")):
        w, _, x, _ = cases["matmul"][key]
        grp = "attn" if key.endswith("wq") else "mlp"
        want = np.asarray(jax.jit(
            lambda x, w, lut: jops.tiled_decode_dequant_matmul(
                x, w, lut, out_dtype=jnp.float32, impl="ref"))(
            jnp.asarray(x.float().numpy(), jnp.bfloat16),
            jblk[grp][key.split()[1]], lt.jst.lut))
        for out in outs:
            y, probe, axes, codes = out[key]
            assert probe == {"tiled_fused_shard_map": 1}
            assert axes == ("data", "model")
            assert codes[:2] == (w.codes.shape[0] // shape[0],
                                 w.codes.shape[1] // 2)
            np.testing.assert_allclose(
                y.numpy(), want, rtol=0,
                atol=TILED_RTOL * float(np.abs(want).max()))
            if shape[0] == 1:
                assert torch.equal(y, one[key]), key


def test_moe_local_within_tolerance_of_reference(ran):
    """Local routing (tokens on their data shard, experts on their model
    shard, K3 over the rank's experts, the bf16 sum over model) against
    the reference's global ``apply_moe``, dropless."""
    shape, cases, _, outs = ran
    ds = _built(DEEPSEEK, MODEL_SHARDS, 0)
    moe, _, x, _ = cases["moe"]["moe local"]
    jbp = jax.tree_util.tree_map(lambda a: a[1],
                                 ds.jst.params["blocks"])["moe"]
    moe_fn = jax.jit(lambda p, x, lut: JL.apply_moe(p, x, ds.cfg, lut=lut))
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    jy, _ = moe_fn(jbp, jx, ds.jst.lut)
    want = np.asarray(jy, np.float32)
    # the reference's local aux: each data shard's own, averaged
    rows = x.shape[0] // shape[0]
    jaux = np.mean([float(moe_fn(jbp, jx[d * rows:(d + 1) * rows],
                                 ds.jst.lut)[1]) for d in range(shape[0])])
    for out in outs:
        (y, aux), probe = out["moe local"]
        # one count a call for the routed experts (as the reference counts
        # it), the shared experts' three projections beside them
        assert probe == {"grouped_fused_shard_map": 1,
                         "fused_shard_map": 3}, probe
        assert y.dtype == torch.bfloat16 and y.shape == x.shape
        np.testing.assert_allclose(
            y.float().numpy(), want, rtol=0,
            atol=MOE_ULPS * 2.0 ** -8 * float(np.abs(want).max()))
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-2)
        assert torch.equal(y, outs[0]["moe local"][0][0])


@pytest.mark.parametrize("arch", [LLAMA, DEEPSEEK])
def test_generate_tokens_on_mesh(ran, arch):
    """Every rank's tokens are one process's bit for bit, and the
    reference's greedy tokens under the exact-tie rule."""
    _, cases, one, outs = ran
    key = f"generate {arch}"
    for out in outs:
        toks, probe = out[key]
        assert torch.equal(toks, one[key])
        assert probe.get("fused_shard_map", 0) > 0
        assert not probe.get("unfused") and not probe.get("fused")
        if arch == DEEPSEEK:
            assert probe["grouped_fused_shard_map"] > 0
    b = _built(arch, MODEL_SHARDS, 0)
    prompts = _prompts(b.cfg.vocab_size)
    t0 = prompts.shape[1]
    got = one[key].numpy()
    ref = np.asarray(JE.generate(b.jst.params, b.cfg, jnp.asarray(prompts),
                                 ctx=JContext(cfg=b.cfg, lut=b.jst.lut),
                                 max_new=MAX_NEW))
    if np.array_equal(got, ref):
        return
    _, steps = _reference_greedy(b.jst.params, b.cfg, b.jst.lut, prompts,
                                 MAX_NEW)
    for r in np.nonzero((got != ref).any(axis=1))[0]:
        s = int(np.argmax(got[r, t0:] != ref[r, t0:]))
        logits = steps[s][r]
        assert logits[got[r, t0 + s]] == logits[ref[r, t0 + s]], (r, s)


def test_engine_on_mesh_matches_generate(ran):
    _, _, _, outs = ran
    for out in outs:
        got, alone = out["engine"]
        assert got == alone
        assert got == outs[0]["engine"][0]


def test_dispatch_probes_follow_the_reference_gates(ran):
    """A weight whose out tiles do not split over the weight axes stays
    whole and takes the two-step path on every rank, as the reference's
    gate sends it ('unfused', bitwise one process's two-step output).
    The reference's second gate, M ≤ max(N, 512) rows, prices the x
    gather of its shard_map; the port's activations are replicated, so
    it does not take that gate (``kernels/ops.py``): 600 rows of a 64-row
    weight stay on the sharded fused branch, bitwise one process's fused
    output, where the reference would take the two-step path."""
    _, cases, one, outs = ran
    w, _, x, _ = cases["matmul"]["gate rows"]
    assert x.shape[0] > max(w.shape[0], jops.FUSED_SHARD_MAP_MAX_M)
    small = cases["matmul"]["gate tiles"][0]
    assert (small.shape[0] // small.tile_n) % MODEL_SHARDS != 0
    for out in outs:
        y, probe, axes, _ = out["gate rows"]
        assert probe == {"fused_shard_map": 1} and axes == ("model",)
        assert torch.equal(y, one["gate rows"])
        y, probe, axes, _ = out["gate tiles"]
        assert probe == {"unfused": 1} and axes is None
        assert torch.equal(y, one["gate tiles"])
