"""The dry run's planned trees (``repro_torch.launch.specs`` and the
planners of ``repro_torch.core.compressed``) against the reference's
(``repro.launch.specs``, ``repro.core.compressed``) on the CPU.

  * The planners: containers of the reference's shapes and dtypes (the
    port's codes are int16 holding the uint16 bits), over 2-D and stacked
    shapes, the linear and the tile-major layouts, and 16 column groups.
  * The inputs: ``input_specs`` and ``shape_applicable`` for all 40 cells
    (10 archs × 4 shapes).
  * Full-size trees, leaf by leaf (the reference's path, shape and dtype;
    the port's per-layer leaves stacked as the reference stacks them):
    ``serve_param_specs`` in quant and compressed mode on 16 model shards
    (the giants also with 16 column groups, as their decode cells take),
    with each container's layout and ``row_parallel`` flag;
    ``train_state_specs`` with the dry run's moments and qblock; and the
    caches (within ``input_specs``).
  * Nothing allocated: Kimi-K2's full tree is ``meta`` tensors and costs
    the process less than 200 MB.
  * Against the packer at smoke size: ``serve_param_specs`` has
    ``build_serve_params``' containers in quant mode; in compressed mode
    every plane but the literal planes' capacity (a planned escape rate,
    where packing measures the weights'); ``train_state_specs`` has
    ``init_train_state``'s shapes.
"""
import dataclasses

import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ASSIGNED_ARCHS as J_ARCHS
from repro.configs import get_config as jget_config
from repro.core import CompressionPolicy as JPolicy
from repro.core import compressed as JC
from repro.launch import specs as JS
from repro.train.optimizer import AdamWConfig as JAdamW

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.core import compressed as TC
from repro_torch.core.blocked_codec import choose_fused_tiles
from repro_torch.core.policy import CompressionPolicy
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as TS
from repro_torch.models import lm as TLM
from repro_torch.serve.engine import build_serve_params
from repro_torch.sharding import partition as PT
from repro_torch.train.steps import init_train_state

torch.set_num_threads(2)
# the lists the reference stacks on a leading layer axis, at any depth of
# a tree (parameters, moments, caches)
STACKED = ("blocks", "encoder", "decoder", "self", "enc_k", "enc_v")
_CONTAINERS = (TC.QuantLinear, TC.PackedLinear, TC.TiledPackedLinear)
_JCONTAINERS = (JC.QuantLinear, JC.PackedLinear, JC.TiledPackedLinear)


def _dtype(t, name="") -> str:
    dt = str(t.dtype).replace("torch.", "")
    # the port keeps codes as int16 holding the reference's uint16 bits
    return "uint16" if dt == "int16" and name.endswith(("codes", "codes_t")) \
        else dt


def port_flat(tree) -> dict:
    """{the reference's keyed path: (shape, dtype)} of a port tree, each
    list in STACKED stacked on a leading axis as the reference's is."""
    out = {}

    def walk(node, name, lead):
        if isinstance(node, dict):
            for k in sorted(node):
                v = node[k]
                if isinstance(v, list) and k in STACKED:
                    assert all(_shapes(x) == _shapes(v[0]) for x in v)
                    walk(v[0], f"{name}['{k}']", lead + (len(v),))
                else:
                    walk(v, f"{name}['{k}']", lead)
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for f in node._fields:
                walk(getattr(node, f), f"{name}.{f}", lead)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{name}[{i}]", lead)
        elif isinstance(node, _CONTAINERS):
            keys = getattr(node, "PLANE_KEYS", {})
            for f in dataclasses.fields(node):
                v = getattr(node, f.name)
                if isinstance(v, torch.Tensor):
                    plane = f"{name}.{keys.get(f.name, f.name)}"
                    out[plane] = (lead + tuple(v.shape), _dtype(v, plane))
        elif isinstance(node, torch.Tensor):
            out[name] = (lead + tuple(node.shape), _dtype(node))

    walk(tree, "", ())
    return out


def _shapes(tree):
    return sorted((k, v[0]) for k, v in port_flat(tree).items())


def ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): (tuple(l.shape), str(l.dtype))
            for p, l in flat}


def port_layouts(tree) -> dict:
    """{path of a compressed container: (kind, shape, tile_n, tile_k,
    row_parallel)}, one entry per stacked leaf (every layer alike)."""
    out = {}

    def walk(node, name):
        if isinstance(node, dict):
            for k in sorted(node):
                v = node[k]
                if isinstance(v, list) and k in STACKED:
                    layouts = {_layout(x) for x in v}
                    assert len(layouts) <= 1
                    walk(v[0], f"{name}['{k}']")
                else:
                    walk(v, f"{name}['{k}']")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{name}[{i}]")
        elif isinstance(node, (TC.PackedLinear, TC.TiledPackedLinear)):
            out[name] = _layout(node)

    walk(tree, "")
    return out


def _layout(w):
    if not isinstance(w, (TC.PackedLinear, TC.TiledPackedLinear)):
        return None
    return (type(w).__name__, tuple(w.shape), w.tile_n, w.tile_k,
            bool(w.row_parallel))


def ref_layouts(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, _JCONTAINERS))
    return {jax.tree_util.keystr(p): (
        type(w).__name__, tuple(w.shape), w.tile_n, w.tile_k,
        bool(getattr(w, "row_parallel", False)))
        for p, w in flat
        if isinstance(w, (JC.PackedLinear, JC.TiledPackedLinear))}


# -- the planners -----------------------------------------------------------

PLANNED = [((2048, 2048), ()), ((512, 2048), ()), ((8192, 2048), (7,)),
           ((2048, 8192), ()), ((1408, 2048), (64,)), ((102400, 2048), ()),
           ((211, 64), ()), ((2048, 1408), (2, 4))]


def _planes_equal(got, want):
    for f in ("codes", "literals", "nlit", "scale", "zero", "values"):
        if hasattr(want, f):
            g, w = getattr(got, f), getattr(want, f)
            assert (tuple(g.shape), _dtype(g, f)) == (tuple(w.shape),
                                                      str(w.dtype)), f
            assert g.device.type == "meta"


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("shape,stacked", PLANNED)
def test_planned_packed_specs_equal_reference(shape, stacked, tiled):
    picked = choose_fused_tiles(shape, 4096, shards=(16, 1)) if tiled \
        else None
    tn, tk = picked[:2] if picked else (0, 0)
    got = TC.planned_packed_specs(shape, stacked=stacked, tile_n=tn,
                                  tile_k=tk)
    want = JC.planned_packed_specs(shape, stacked=stacked, tile_n=tn,
                                   tile_k=tk)
    _planes_equal(got, want)
    assert (got.shape, got.tile_n, got.tile_k) == (want.shape, want.tile_n,
                                                   want.tile_k)


@pytest.mark.parametrize("tiles", [2, 16])
@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("shape,stacked", [
    ((16384, 16384), ()), ((53248, 16384), ()), ((16384, 53248), (3,)),
    ((1024, 16384), ())])
def test_planned_tiled_specs_equal_reference(shape, stacked, tiled, tiles):
    sub = (shape[0], shape[1] // tiles)
    picked = choose_fused_tiles(sub, 4096, shards=(16, 1)) if tiled \
        else None
    tn, tk = picked[:2] if picked else (0, 0)
    got = TC.planned_tiled_specs(shape, tiles, stacked=stacked, tile_n=tn,
                                 tile_k=tk)
    want = JC.planned_tiled_specs(shape, tiles, stacked=stacked, tile_n=tn,
                                  tile_k=tk)
    _planes_equal(got, want)
    assert got.tiles == tiles


@pytest.mark.parametrize("shape,stacked", PLANNED[:3])
def test_planned_quant_and_lut_specs_equal_reference(shape, stacked):
    _planes_equal(TC.planned_quant_specs(shape, stacked=stacked),
                  JC.planned_quant_specs(shape, stacked=stacked))
    got, want = TC.lut_spec(), JC.lut_spec()
    assert (tuple(got.shape), _dtype(got)) == (tuple(want.shape),
                                               str(want.dtype))


# -- the inputs -------------------------------------------------------------

def test_assigned_archs_equal_reference():
    assert ASSIGNED_ARCHS == J_ARCHS
    assert TS.SHAPES == JS.SHAPES


@pytest.mark.parametrize("shape_name", list(JS.SHAPES))
@pytest.mark.parametrize("arch", J_ARCHS)
def test_input_specs_equal_reference(arch, shape_name):
    """Batch, caches (``cache_specs_for``), prefill's out caches and
    decode's position, for every cell; the reference's skip rule."""
    assert TS.shape_applicable(get_config(arch).full, shape_name) == \
        JS.shape_applicable(jget_config(arch).full, shape_name)
    got = TS.input_specs(arch, shape_name)
    want = JS.input_specs(arch, shape_name)
    assert set(got) == set(want)
    assert got["kind"] == want["kind"]
    for key in set(want) - {"kind"}:
        assert port_flat(got[key]) == ref_flat(want[key]), key


# -- full-size trees ----------------------------------------------------------

@pytest.mark.parametrize("arch,mode,tiles", [
    (arch, mode, tiles) for arch in J_ARCHS
    for mode, tiles in (("quant", 0), ("compressed", 0), ("compressed", 16))
    if not tiles or arch in D.FSDP_SERVE])     # the giants' decode cells
def test_serve_param_specs_equal_reference(arch, mode, tiles):
    policy = dict(mode=mode, tiles=tiles)
    want, wlut = JS.serve_param_specs(jget_config(arch).full,
                                      JPolicy(**policy), jnp.bfloat16,
                                      model_shards=16)
    got, glut = TS.serve_param_specs(get_config(arch).full,
                                     CompressionPolicy(**policy),
                                     torch.bfloat16, model_shards=16)
    assert port_flat(got) == ref_flat(want)
    assert port_layouts(got) == ref_layouts(want)
    assert (glut is None) == (wlut is None)
    if glut is not None:
        assert (tuple(glut.shape), _dtype(glut)) == (tuple(wlut.shape),
                                                     str(wlut.dtype))


@pytest.mark.parametrize("arch", J_ARCHS)
def test_train_state_specs_equal_reference(arch):
    opt = D._train_cfgs(arch).optimizer
    want = JS.train_state_specs(jget_config(arch).full, JAdamW(
        quantized_state=opt.quantized_state, qblock=opt.qblock),
        jnp.bfloat16)
    got = TS.train_state_specs(get_config(arch).full, opt, torch.bfloat16)
    assert port_flat(got) == ref_flat(want)


def _rss() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * 4096


def test_full_kimi_tree_allocates_nothing():
    TS.serve_param_specs(get_config("deepseek-v2-lite-16b").smoke,
                         CompressionPolicy())           # warm the imports
    before = _rss()
    params, lut = TS.serve_param_specs(get_config("kimi-k2-1t-a32b").full,
                                       CompressionPolicy(),
                                       torch.bfloat16, model_shards=16)
    state = TS.train_state_specs(get_config("kimi-k2-1t-a32b").full,
                                 D._train_cfgs("kimi-k2-1t-a32b").optimizer)
    grown = _rss() - before
    leaves = [l for tree in (params, state) for l in _tensors(tree)]
    assert leaves and all(t.device.type == "meta" for t in leaves)
    assert lut.device.type == "meta"
    # a terabyte of weights and moments planned in less than 200 MB
    assert sum(t.numel() * t.element_size() for t in leaves) > 10 ** 12
    assert grown < 200 * 2 ** 20, grown


def _tensors(tree):
    from repro_torch.launch.op_stats import tensors
    return tensors(tree)


# -- against the packer at smoke size ---------------------------------------

def _built(arch, mode):
    cfg = get_config(arch).smoke
    params = TLM.init_lm(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    policy = CompressionPolicy(mode=mode, min_weight_size=1024)
    built = build_serve_params(params, policy, model_shards=2,
                               device="cpu", manifest=False)
    planned, lut = TS.serve_param_specs(cfg, policy, torch.bfloat16,
                                        model_shards=2)
    return built, planned, lut


@pytest.mark.parametrize("mode", ["quant", "compressed"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-lite-16b"])
def test_serve_param_specs_equal_packer(arch, mode):
    built, planned, lut = _built(arch, mode)
    got, want = port_flat(planned), port_flat(built.params)
    assert set(got) == set(want)
    lits = [k for k in want if k.endswith(".literals")]
    assert bool(lits) == (mode == "compressed")
    for k in want:
        if k in lits:     # (..., nb, cap, 4): all but the planned cap
            assert got[k][0][:-2] == want[k][0][:-2] and \
                got[k][0][-1] == want[k][0][-1] and got[k][1] == want[k][1]
        else:
            assert got[k] == want[k], k
    # the packer leaves the reference's row_parallel flag unset (no kernel
    # path reads it); the planner sets it, as the reference's specs do
    assert {k: v[:4] for k, v in port_layouts(planned).items()} == \
        {k: v[:4] for k, v in port_layouts(built.params).items()}
    flags = {k: v[4] for k, v in port_layouts(planned).items()}
    assert flags == {k: PT.is_row_parallel(PT.clean_keystr(k))
                     for k in flags}
    assert any(flags.values()) == (mode == "compressed")
    assert (lut is None) == (built.lut is None)


def test_train_state_specs_equal_init_train_state():
    cfg = get_config("deepseek-v2-lite-16b").smoke
    for opt in (D._train_cfgs("deepseek-v2-lite-16b").optimizer,
                D._train_cfgs("kimi-k2-1t-a32b").optimizer):
        tcfg = D.TrainConfig(optimizer=opt)
        real = init_train_state(TLM.init_lm(cfg, seed=0, device="cpu",
                                            dtype=torch.bfloat16), tcfg)
        assert port_flat(TS.train_state_specs(cfg, opt)) == port_flat(real)
