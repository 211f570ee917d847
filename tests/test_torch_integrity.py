"""The port's artifact integrity against the JAX package's, on the CPU.

Both packages pack the same smoke weights (Llama-3.2 and DeepSeek-V2-Lite,
``min_weight_size=1024``, weights from PRNGKey 0); the planes are
byte-equal, so:

  * the port's manifest equals ``repro.core.integrity.build_manifest``
    leaf for leaf: names, shape, ``nbytes``, ``crc32``, ``crc32_fast``
    (dtypes equal but for the codes, which the port stores as int16
    holding the uint16 bits), the LUT's entry and ``table_crc32``;
  * a seeded bit flip in any plane or in the LUT is named by the port's
    ``verify_serve_state`` exactly as by the reference's for the same
    seed, at 'full' and at 'fast' (the same bytes are sampled);
  * an out-of-range code is caught by ``check_invariants`` in both, and
    the gate of ``ResilientEngine`` refuses with ``IntegrityError``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.core import CompressionPolicy as JPolicy
from repro.core import integrity as JI
from repro.models import lm as JLM
from repro.serve import engine as JE
from repro.serve import resilience as JR
from repro.testing import FaultInjector as JInjector

from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.core import integrity as TI
from repro_torch.core.policy import CompressionPolicy
from repro_torch.kernels import ops
from repro_torch.serve import engine as TE
from repro_torch.serve.resilience import (FALLBACK_COUNTS, ResiliencePolicy,
                                          ResilientEngine)
from repro_torch.testing import FaultInjector

torch.set_num_threads(2)
ARCHS = ["llama3.2-1b", "deepseek-v2-lite-16b"]


@pytest.fixture(autouse=True)
def _clear_counts():
    FALLBACK_COUNTS.clear()
    ops.DISPATCH_COUNTS.clear()
    yield
    assert ops._DEFAULT_IMPL == "auto"


@pytest.fixture(scope="module", params=ARCHS)
def packed(request):
    """(port cfg, reference state, port state): both packages pack the
    same dense weights, each with its own manifest."""
    cfg = get_config(request.param).smoke
    tcfg = tget_config(request.param).smoke
    params = JLM.init_lm(jax.random.PRNGKey(0), cfg, jnp.float32)
    jst = JE.build_serve_params(params, JPolicy(mode="compressed",
                                                min_weight_size=1024))
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    tst = TE.build_serve_params(tparams, CompressionPolicy(
        mode="compressed", min_weight_size=1024), device="cpu")
    return tcfg, jst, tst


def _same_dtype(port: str, ref: str) -> bool:
    return port == ref or (port, ref) == ("int16", "uint16")


def test_manifest_equals_reference(packed):
    _, jst, tst = packed
    jm, tm = jst.manifest, tst.manifest
    assert tm["version"] == jm["version"] == TI.MANIFEST_VERSION
    assert sorted(tm["leaves"]) == sorted(jm["leaves"])
    assert any(n.endswith(".codes") for n in tm["leaves"])
    for name, want in jm["leaves"].items():
        got = tm["leaves"][name]
        assert _same_dtype(got["dtype"], want["dtype"]), (name, got, want)
        for key in ("shape", "nbytes", "crc32", "crc32_fast"):
            assert got[key] == want[key], (name, key, got[key], want[key])
    assert tm["lut"] == jm["lut"]
    assert tm["table_crc32"] == jm["table_crc32"] is not None
    assert tm["total_bytes"] == jm["total_bytes"]
    assert tm["build_s"] >= 0
    # a large plane takes the sampled digest, which differs from the full
    big = [e for e in tm["leaves"].values()
           if e["nbytes"] > TI.FAST_FULL_MAX]
    assert all(e["crc32_fast"] != e["crc32"] for e in big)


@pytest.mark.parametrize("n,cuts", [
    (TI.FAST_FULL_MAX, (1000,)), (TI.FAST_FULL_MAX + 1, (7, 300_000)),
    (3 << 20, (1, 65_537, 1_000_000, 3_000_000)), (5 << 20, ())])
def test_digests_of_split_planes(n, cuts):
    """A stacked leaf's digests, chained over its layers' parts (and the
    sample gathered part by part), are the reference's over the
    concatenated bytes, whatever the cuts."""
    u8 = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    parts = [torch.from_numpy(p) for p in np.split(u8, list(cuts))]
    assert TI._crc_full(parts) == JI._crc_full(u8)
    assert TI._crc_fast(parts) == JI._crc_fast(u8)


def test_manifest_verifies(packed):
    _, jst, tst = packed
    for level in ("fast", "full"):
        got = TI.verify_serve_state(tst, level=level)
        want = JI.verify_serve_state(jst, level=level)
        assert got.ok and want.ok, got.corrupt
        assert got.checked == want.checked > 0
    assert TI.verify_serve_state(tst, level="off").ok
    # the same bytes on another device: the manifest still holds
    assert TI.verify_serve_state(tst.to("cpu"), level="full").ok
    with pytest.raises(ValueError, match="off\\|fast\\|full"):
        TI.verify_serve_state(tst, level="paranoid")
    with pytest.raises(ValueError, match="manifest"):
        TI.verify_serve_state(dataclasses.replace(tst, manifest=None))


@pytest.mark.parametrize("plane,leaf", [
    ("codes", ""), ("literals", ""), ("nlit", ""), ("scale", ""),
    ("zero", ""), ("codes", "w_down"), ("literals", "mlp"),
    ("scale", "wo")])
@pytest.mark.parametrize("seed", [0, 3])
def test_bitflip_named_as_reference(packed, plane, leaf, seed):
    """The same seeded flip in both packages: the same leaf, and the same
    report (leaf, plane, reason with both CRCs) at 'full' and 'fast'."""
    _, jst, tst = packed
    try:
        jbad, jname = JInjector(seed).flip_bit(jst, leaf, plane=plane)
    except KeyError:
        with pytest.raises(KeyError):
            FaultInjector(seed).flip_bit(tst, leaf, plane=plane)
        return
    tbad, tname = FaultInjector(seed).flip_bit(tst, leaf, plane=plane)
    assert tname == jname
    for level in ("full", "fast"):
        got = TI.verify_serve_state(tbad, level=level)
        want = JI.verify_serve_state(jbad, level=level)
        assert got.corrupt == want.corrupt, level
    full = TI.verify_serve_state(tbad, level="full")
    assert not full.ok and full.quarantined == [tname]
    assert TI.verify_serve_state(tst, level="full").ok    # flip_bit copied


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lut_bitflip_named_as_reference(packed, seed):
    _, jst, tst = packed
    got = TI.verify_serve_state(FaultInjector(seed).flip_lut_bit(tst))
    want = JI.verify_serve_state(JInjector(seed).flip_lut_bit(jst))
    assert got.corrupt == want.corrupt
    assert not got.ok and [p for _, p, _ in got.corrupt] == ["lut"]


def _first_codes(st):
    """(name, holder, key) of the first compressed leaf's first layer."""
    for name, holders in TI.leaf_groups(st.params):
        h, k = holders[0]
        if hasattr(h[k], "codes"):
            return name, h, k
    raise AssertionError("no compressed leaf")


def test_invariants_catch_out_of_range_code(packed):
    """A code past the LUT (not ESCAPE) in the first compressed leaf:
    both packages' device-side checks name it, and the gate refuses it
    even when the manifest was rebuilt over the damage (so that only the
    invariants can see it)."""
    _, jst, tst = packed
    n_rows = tst.lut.shape[0]
    assert n_rows < (1 << 15)
    params = TE._copy_tree(tst.params)
    name, h, k = _first_codes(dataclasses.replace(tst, params=params))
    codes = h[k].codes.clone()
    codes.reshape(-1)[0] = n_rows
    h[k] = dataclasses.replace(h[k], codes=codes)
    bad = dataclasses.replace(tst, params=params)
    rep = TI.check_invariants(bad)
    assert not rep.ok and rep.quarantined == [name]
    assert TI.check_invariants(tst).ok

    flat, treedef = jax.tree_util.tree_flatten_with_path(jst.params)
    leaves = [leaf for _, leaf in flat]
    i = next(i for i, (p, _) in enumerate(flat)
             if jax.tree_util.keystr(p) == name + ".codes")
    arr = np.asarray(leaves[i]).copy()
    arr.reshape(-1)[0] = n_rows
    leaves[i] = jnp.asarray(arr)
    jrep = JI.check_invariants(dataclasses.replace(
        jst, params=treedef.unflatten(leaves)))
    assert jrep.quarantined == rep.quarantined

    bad = dataclasses.replace(bad, manifest=TI.build_manifest(
        bad.params, bad.lut, bad.table))
    assert TI.verify_serve_state(bad).ok
    with pytest.raises(TI.IntegrityError) as ei:
        ResilientEngine(None, bad, policy=ResiliencePolicy(verify="fast"),
                        device="cpu")
    assert ei.value.report.level == "invariant"
    assert ei.value.report.quarantined == [name]
    assert FALLBACK_COUNTS["integrity_refused"] == 1


def test_gate_refuses_corrupt_artifact(packed):
    """ResilientEngine(verify='full') refuses a flipped code plane and
    names the leaf, as the reference's does; a clean artifact passes the
    gate with both reports kept for health()."""
    tcfg, jst, tst = packed
    tbad, name = FaultInjector().flip_bit(tst, "", plane="codes")
    with pytest.raises(TI.IntegrityError) as ei:
        ResilientEngine(tcfg, tbad, policy=ResiliencePolicy(verify="full"),
                        device="cpu")
    jbad, jname = JInjector().flip_bit(jst, "", plane="codes")
    with pytest.raises(JI.IntegrityError) as jei:
        JR.ResilientEngine(get_config("llama3.2-1b").smoke, jbad,
                           policy=JR.ResiliencePolicy(verify="full"))
    assert name == jname
    assert ei.value.report.quarantined == jei.value.report.quarantined \
        == [name]
    assert FALLBACK_COUNTS["integrity_refused"] == 1
    eng = ResilientEngine(tcfg, tst, policy=ResiliencePolicy(verify="full"),
                          device="cpu")
    h = eng.health()
    assert h["verify"].startswith("verify[full]: ok")
    assert h["invariants"].startswith("verify[invariant]: ok")
    assert h["last_rung"] is None and h["requests"] == 0
