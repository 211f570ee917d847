"""The decoder-only families the port gained in one slice — Qwen3 (qk-norm),
Qwen2 (QKV bias), InternLM2, Llama-3-405B, Kimi-K2 (MoE with GQA), Mamba2
(``ssm``), Zamba2 (``hybrid``) and InternVL2 (``vlm``) — against the JAX
package on their smoke configs, weights from PRNGKey 0 crossing as numpy.

Tolerances and rules:
  * forward logits: ``ATOL`` of ``tests/test_torch_model.py`` (dense f32
    1e-4; quant and compressed 3e-2: bf16 activations, rounded by the
    reference's XLA program at other places than the port's op by op);
  * packed planes, tables, LUTs and stats: byte-equal;
  * greedy tokens: equal; in the bf16 modes a row may part from the
    reference's only at a step where the reference's own logits tie the
    two tokens exactly (the rule of ``tests/test_torch_moe.py``).  One
    near tie, one bf16 ulp apart, is recorded in ROADMAP.md §3 and pinned
    by ``test_zamba2_recorded_near_tie`` (f32 roundoff: XLA's approximate
    rsqrt and its reduction order in ``rms_norm`` move a logit by an ulp;
    the reference's eager and jitted forwards differ by as much).
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.core import CompressionPolicy as JPolicy
from repro.launch import serve as JLaunch
from repro.models import lm as JLM
from repro.serve import engine as JE
from repro.serve.context import ServeContext as JContext
from repro.serve.kv_cache import PagedKVPool as JPool

from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.core.policy import CompressionPolicy
from repro_torch.launch import serve as TLaunch
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.serve import engine as TE
from repro_torch.serve.context import ServeContext
from repro_torch.serve.kv_cache import PagedKVPool
from repro_torch.serve.scheduler import Engine, Request

from test_torch_model import ATOL, state_to_numpy
from test_torch_serve import _prompts

torch.set_num_threads(2)

ARCHS = ["qwen3-4b", "qwen2-7b", "internlm2-1.8b", "llama3-405b",
         "kimi-k2-1t-a32b", "mamba2-2.7b", "zamba2-1.2b", "internvl2-2b"]
MODES = ["dense", "quant", "compressed"]
# leaves that init leaves at 0 or 1: moved off it, so that they matter
_MOVED = ("bq", "bk", "bv", "q_norm", "k_norm", "conv_b", "dt_bias",
          "d_skip", "gate_norm")


def _params(cfg):
    """The reference's init with its biases and norms moved off their
    init values by seeded noise (numpy), so each of them is exercised."""
    params = JLM.init_lm(jax.random.PRNGKey(0), cfg, jnp.float32)
    rng = np.random.default_rng(11)

    def move(path, a):
        key = getattr(path[-1], "key", None)
        if key not in _MOVED:
            return a
        return a + jnp.asarray(rng.standard_normal(a.shape).astype(
            np.float32) * 0.1)
    return jax.tree_util.tree_map_with_path(move, params)


_CACHE: dict = {}


def _served(arch, mode, **over):
    """(cfg, tcfg, jax params, jax lut, port params, port lut, jax state)
    for ``arch``'s smoke config (``over`` replaces config fields) in
    ``mode``; kept for the module."""
    key = (arch, mode, tuple(sorted(over.items())))
    if key not in _CACHE:
        cfg = dataclasses.replace(get_config(arch).smoke, **over)
        tcfg = dataclasses.replace(tget_config(arch).smoke, **over)
        params = _params(cfg)
        if mode == "dense":
            _CACHE[key] = (cfg, tcfg, params, None, convert.params_from_numpy(
                jax.tree_util.tree_map(np.asarray, params), tcfg,
                device="cpu"), None, None)
        else:
            st = JE.build_serve_params(params, JPolicy(
                mode=mode, min_weight_size=1024), manifest=False)
            ts = convert.serve_state_from_numpy(
                state_to_numpy(st), np.asarray(st.lut)
                if st.lut is not None else None, tcfg, mode=mode,
                device="cpu")
            _CACHE[key] = (cfg, tcfg, st.params, st.lut, ts.params, ts.lut,
                           st)
    return _CACHE[key]


def _embeds(cfg, batch, seed=5):
    """Seeded stand-in patch embeddings (B, n_patches, d), numpy f32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, cfg.n_patches, cfg.d_model))
            * 0.02).astype(np.float32)


def _reference_steps(jp, cfg, jlut, toks, n, embeds=None):
    """The reference's greedy tokens and each step's logits, from its
    jitted prefill and decode step (what its ``generate`` runs)."""
    prefill, decode_step = JE.make_serve_fns(cfg)
    b, t0 = toks.shape
    extra = 0 if embeds is None else embeds.shape[1]
    caches = JLM.init_caches(cfg, b, extra + t0 + n)
    batch = {"tokens": jnp.asarray(toks)}
    if embeds is not None:
        batch["embeds"] = jnp.asarray(embeds)
    logits, caches = prefill(jp, jlut, batch, caches)
    tokens, steps = [], []
    for i in range(n):
        steps.append(np.asarray(logits, np.float32))
        tokens.append(steps[-1].argmax(-1))
        if i < n - 1:
            logits, caches = decode_step(
                jp, jlut, jnp.asarray(tokens[-1][:, None], jnp.int32),
                caches, extra + t0 + i)
    return np.stack(tokens, axis=1), steps


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(abs(v))) - 7) if v else 2.0 ** -133


def _equal_or_tied(got, ref, steps, t0, rule: str):
    """``got`` equals ``ref``, or each differing row parts from it first
    at a step where the reference's logits give the port's token the same
    value as its own choice (``rule`` 'tie': an exact bf16 tie) or one
    within a bf16 ulp of it ('ulp'); ``rule`` 'equal' allows nothing."""
    if np.array_equal(got, ref):
        return
    assert rule != "equal", f"tokens differ at {np.argwhere(got != ref)[:4]}"
    for r in np.nonzero((got != ref).any(axis=1))[0]:
        s = int(np.argmax(got[r, t0:] != ref[r, t0:]))
        logits = steps[s][r]
        mine, theirs = logits[got[r, t0 + s]], logits[ref[r, t0 + s]]
        room = _bf16_ulp(theirs) if rule == "ulp" else 0.0
        assert theirs - mine <= room, (
            f"row {r} step {s}: port token {got[r, t0 + s]} ({mine}) is "
            f"not tied ({rule}) with the reference's {ref[r, t0 + s]} "
            f"({theirs})")


# -- forward and packing ------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(arch, mode):
    cfg, tcfg, jp, jlut, tp, tlut, _ = _served(arch, mode)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 11))
    jl = JLM.forward(jp, cfg, jnp.asarray(toks, jnp.int32), lut=jlut)[0]
    tl = TLM.forward(tp, tcfg, torch.from_numpy(toks), lut=tlut)[0]
    assert tuple(tl.shape) == (3, 11, cfg.vocab_size)
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               rtol=0, atol=ATOL[mode])


def _same_tree(got, want, path=""):
    """Two port trees (dicts, lists, tensors, weight containers) equal,
    byte for byte."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{path}[{i}]")
    elif dataclasses.is_dataclass(want):
        assert type(got) is type(want), path
        for f in dataclasses.fields(want):
            _same_tree(getattr(got, f.name), getattr(want, f.name),
                       f"{path}.{f.name}")
    elif torch.is_tensor(want):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path
    else:
        assert got == want, path


@pytest.mark.parametrize("mode", ["quant", "compressed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_packed_planes_byte_equal(arch, mode):
    """The port's build_serve_params on the same dense weights gives the
    reference's state: every plane, scale and zero (stacked Mamba2
    blocks, the hybrid's shared block, QKV biases and qk-norms dense),
    the table, the LUT and the byte counts."""
    cfg, tcfg, jp, jlut, want, wlut, st = _served(arch, mode)
    dense = _served(arch, "dense")[4]
    got = TE.build_serve_params(dense, CompressionPolicy(
        mode=mode, min_weight_size=1024), manifest=False, device="cpu")
    assert got.stats == st.stats
    assert got.table == st.table
    if mode == "compressed":
        assert torch.equal(got.lut, wlut)
    _same_tree(got.params, want)
    if cfg.family in ("ssm", "hybrid"):
        mamba = got.params["blocks"][0]["mamba"]
        assert type(mamba["in_proj"]).__name__ == (
            "PackedLinear" if mode == "compressed" else "QuantLinear")
        assert all(torch.is_tensor(mamba[k]) for k in (
            "a_log", "dt_bias", "conv_w", "conv_b", "d_skip", "gate_norm"))
    if cfg.qkv_bias or cfg.qk_norm:
        attn = got.params["blocks"][0]["attn"]
        assert all(torch.is_tensor(v) for k, v in attn.items()
                   if k in _MOVED)


# -- caches ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-4b", "internlm2-1.8b",
                                  "deepseek-v2-lite-16b", "mamba2-2.7b",
                                  "zamba2-1.2b", "kimi-k2-1t-a32b"])
def test_decode_matches_full_forward(arch):
    """Prefill of 11 tokens into caches + one decode step ≡ the full
    forward at position 11 (the reference's test and its arch list, with
    Kimi-K2: GQA, MLA, SSD and hybrid caches; the MoEs dropless), and the
    step's logits equal the reference's step on the same caches' path."""
    over = {}
    if get_config(arch).smoke.is_moe:
        over = {"capacity_factor": 64.0}
    cfg, tcfg, jp, _, tp, _, _ = _served(arch, "dense", **over)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 12))
    full = TLM.forward(tp, tcfg, torch.from_numpy(toks))[0]
    caches = TLM.init_caches(tcfg, 2, 12, dtype=torch.float32, device="cpu")
    TLM.forward(tp, tcfg, torch.from_numpy(toks[:, :11]), caches=caches,
                pos=0)
    step = TLM.forward(tp, tcfg, torch.from_numpy(toks[:, 11:]),
                       caches=caches, pos=11)[0]
    torch.testing.assert_close(step[:, 0], full[:, 11], rtol=2e-2,
                               atol=2e-3)
    jc = JLM.init_caches(cfg, 2, 12, dtype=jnp.float32)
    _, jc, _ = JLM.forward(jp, cfg, jnp.asarray(toks[:, :11]), caches=jc,
                           pos=0)
    jstep = JLM.forward(jp, cfg, jnp.asarray(toks[:, 11:]), caches=jc,
                        pos=11)[0]
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), rtol=0,
                               atol=ATOL["dense"])


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_recurrent_caches_and_pool_refusal(arch):
    """Mamba2 caches: an f32 conv ring and SSM state per block (the
    hybrid: a KV cache per shared-attention application); no time axis to
    page, so cache_batch_time_axes and the pool raise ValueError, as the
    reference's do."""
    cfg, tcfg = get_config(arch).smoke, tget_config(arch).smoke
    c = TLM.init_caches(tcfg, 2, 9, device="cpu")
    jc = JLM.init_caches(cfg, 2, 9)
    assert len(c["blocks"]) == cfg.n_layers
    for k in ("conv", "ssm"):
        assert c["blocks"][0][k].dtype == torch.float32
        assert tuple(c["blocks"][0][k].shape) == jc["blocks"][k].shape[1:]
    if cfg.family == "hybrid":
        assert len(c["attn"]) == len(jc["attn"]) == 2
        assert tuple(c["attn"][0]["k"].shape) == jc["attn"][0]["k"].shape
    for fn in (lambda: TLM.cache_batch_time_axes(tcfg),
               lambda: PagedKVPool(tcfg, 2, 16, device="cpu")):
        with pytest.raises(ValueError, match="cannot back a paged KV pool"):
            fn()
    with pytest.raises(ValueError, match="cannot back a paged KV pool"):
        JPool(cfg, 2, 16)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_launcher_refuses_recurrent_families(arch, monkeypatch, capsys):
    """Both launchers serve through the Engine, whose pool refuses the
    Mamba2 caches: the same ValueError."""
    argv = ["--arch", arch, "--batch", "2", "--max-new", "2"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(ValueError) as ref:
        JLaunch.main()
    with pytest.raises(ValueError) as got:
        TLaunch.main(argv + ["--device", "cpu"])
    assert "cannot back a paged KV pool" in str(ref.value)
    assert "cannot back a paged KV pool" in str(got.value)


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2-7b", "internlm2-1.8b",
                                  "internvl2-2b", "llama3-405b",
                                  "kimi-k2-1t-a32b"])
def test_launcher_serves_each_arch(arch, capsys):
    out = TLaunch.main(["--device", "cpu", "--arch", arch, "--batch", "3",
                        "--max-new", "4"])
    assert out["reasons"] == {"max_new": 3}
    assert out["tokens"] == 12


# -- generate -----------------------------------------------------------

@pytest.mark.parametrize("arch,mode", [(a, "compressed") for a in ARCHS]
                         + [(a, m) for a in ("mamba2-2.7b", "zamba2-1.2b")
                            for m in ("dense", "quant")])
def test_generate_tokens_match_reference(arch, mode):
    """Greedy tokens for 3 left-padded prompts (pad id 0, which enters an
    SSM's state as in the reference) × 8 new tokens."""
    cfg, tcfg, jp, jlut, tp, tlut, _ = _served(arch, mode)
    toks = _prompts(cfg.vocab_size)
    t0 = toks.shape[1]
    ref = np.asarray(JE.generate(jp, cfg, jnp.asarray(toks),
                                 ctx=JContext(cfg=cfg, lut=jlut), max_new=8))
    TL.MATERIALIZE_COUNTS.clear()
    got = TE.generate(tp, tcfg, torch.from_numpy(toks),
                      ctx=ServeContext(tcfg, lut=tlut, device="cpu"),
                      max_new=8).numpy()
    np.testing.assert_array_equal(got[:, :t0], toks)
    if mode == "compressed" and not cfg.is_moe:
        assert sum(TL.MATERIALIZE_COUNTS.values()) == 0
    if not np.array_equal(got, ref):
        _, steps = _reference_steps(jp, cfg, jlut, toks, 8)
        _equal_or_tied(got, ref, steps, t0,
                       "equal" if mode == "dense" else "tie")


@pytest.mark.parametrize("mode", ["quant", "compressed"])
def test_zamba2_recorded_near_tie(mode):
    """The one row recorded in ROADMAP.md §3: Zamba2's smoke model at the
    reference's own init (biases and norms not moved), the same prompts.
    Row 1's first token is a near tie in the reference (0.39648 for token
    103 against 0.39453 for 44, one bf16 ulp apart); the port's logits,
    f32 roundoff away (XLA's approximate rsqrt and reduction order in
    rms_norm), tie them at 0.40039 and its argmax takes 44.  Every other
    row is equal."""
    cfg = get_config("zamba2-1.2b").smoke
    tcfg = tget_config("zamba2-1.2b").smoke
    params = JLM.init_lm(jax.random.PRNGKey(0), cfg, jnp.float32)
    st = JE.build_serve_params(params, JPolicy(mode=mode,
                                               min_weight_size=1024),
                               manifest=False)
    ts = convert.serve_state_from_numpy(
        state_to_numpy(st), np.asarray(st.lut) if st.lut is not None
        else None, tcfg, mode=mode, device="cpu")
    toks = _prompts(cfg.vocab_size)
    t0 = toks.shape[1]
    ref = np.asarray(JE.generate(st.params, cfg, jnp.asarray(toks),
                                 ctx=JContext(cfg=cfg, lut=st.lut),
                                 max_new=8))
    got = TE.generate(ts.params, tcfg, torch.from_numpy(toks),
                      ctx=ServeContext(tcfg, lut=ts.lut, device="cpu"),
                      max_new=8).numpy()
    np.testing.assert_array_equal(got[[0, 2]], ref[[0, 2]])
    assert (got[1, t0], ref[1, t0]) == (44, 103)
    _, steps = _reference_steps(st.params, cfg, st.lut, toks, 8)
    _equal_or_tied(got, ref, steps, t0, "ulp")


@pytest.mark.parametrize("mode", MODES)
def test_generate_with_embeds_matches_reference(mode):
    """InternVL2: the patch embeddings prepended at the prefill, decode
    from T' + T0; tokens against the reference's generate(embeds=)."""
    cfg, tcfg, jp, jlut, tp, tlut, _ = _served("internvl2-2b", mode)
    toks = _prompts(cfg.vocab_size)
    emb = _embeds(cfg, toks.shape[0])
    t0 = toks.shape[1]
    ref = np.asarray(JE.generate(jp, cfg, jnp.asarray(toks),
                                 ctx=JContext(cfg=cfg, lut=jlut), max_new=6,
                                 embeds=jnp.asarray(emb)))
    got = TE.generate(tp, tcfg, torch.from_numpy(toks),
                      ctx=ServeContext(tcfg, lut=tlut, device="cpu"),
                      max_new=6, embeds=torch.from_numpy(emb)).numpy()
    assert got.shape == ref.shape == (3, t0 + 6)
    if not np.array_equal(got, ref):
        _, steps = _reference_steps(jp, cfg, jlut, toks, 6, emb)
        _equal_or_tied(got, ref, steps, t0,
                       "equal" if mode == "dense" else "tie")
    # the prefix matters: without it the continuation is another
    plain = TE.generate(tp, tcfg, torch.from_numpy(toks),
                        ctx=ServeContext(tcfg, lut=tlut, device="cpu"),
                        max_new=6).numpy()
    assert not np.array_equal(plain, got)


def test_forward_with_embeds_matches_reference():
    cfg, tcfg, jp, jlut, tp, tlut, _ = _served("internvl2-2b", "compressed")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 5))
    emb = _embeds(cfg, 2, seed=6)
    jl = JLM.forward(jp, cfg, jnp.asarray(toks, jnp.int32), lut=jlut,
                     embeds=jnp.asarray(emb))[0]
    tl = TLM.forward(tp, tcfg, torch.from_numpy(toks), lut=tlut,
                     embeds=torch.from_numpy(emb))[0]
    assert tuple(tl.shape) == (2, cfg.n_patches + 5, cfg.vocab_size)
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               rtol=0, atol=ATOL["compressed"])


# -- the int8 KV cache ------------------------------------------------------

def test_int8_kv_cache_matches_reference():
    """Qwen3 with kv_cache_bits=8: the prefill's int8 codes and scales
    equal to the reference's (its jitted prefill, which scales by the f32
    reciprocal of 127), and the greedy tokens."""
    cfg, tcfg, jp, jlut, tp, tlut, _ = _served("qwen3-4b", "compressed",
                                               kv_cache_bits=8)
    toks = _prompts(cfg.vocab_size)
    b, t0 = toks.shape
    jpre, _ = JE.make_serve_fns(cfg)
    _, jc = jpre(jp, jlut, {"tokens": jnp.asarray(toks)},
                 JLM.init_caches(cfg, b, t0 + 8))
    tpre, _ = TE.make_serve_fns(tcfg, device="cpu")
    _, tc = tpre(tp, tlut, {"tokens": torch.from_numpy(toks)},
                 TLM.init_caches(tcfg, b, t0 + 8, device="cpu"))
    for i in range(cfg.n_layers):
        layer = tc["blocks"][i]
        assert layer["k"].dtype == torch.int8
        for k in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(layer[k].numpy(),
                                          np.asarray(jc["blocks"][k][i]))
    ref = np.asarray(JE.generate(jp, cfg, jnp.asarray(toks),
                                 ctx=JContext(cfg=cfg, lut=jlut), max_new=8))
    got = TE.generate(tp, tcfg, torch.from_numpy(toks),
                      ctx=ServeContext(tcfg, lut=tlut, device="cpu"),
                      max_new=8).numpy()
    if not np.array_equal(got, ref):
        _, steps = _reference_steps(jp, cfg, jlut, toks, 8)
        _equal_or_tied(got, ref, steps, t0, "tie")


def test_int8_kv_cache_halves_bytes():
    tcfg = tget_config("qwen3-4b").smoke
    c16 = TLM.init_caches(tcfg, 2, 32, device="cpu")
    c8 = TLM.init_caches(dataclasses.replace(tcfg, kv_cache_bits=8), 2, 32,
                         device="cpu")
    b16, b8 = (sum(t.numel() * t.element_size() for t in TE._tensors(c))
               for c in (c16, c8))
    assert b8 < 0.7 * b16, (b8, b16)
    axes = TLM.cache_batch_time_axes(dataclasses.replace(tcfg,
                                                         kv_cache_bits=8))
    assert axes["blocks"][0] == {"k": (0, 1), "v": (0, 1),
                                 "k_scale": (0, 1), "v_scale": (0, 1)}


def test_int8_kv_engine_matches_generate():
    """The Engine pages the int8 codes and their scales: its completions
    (staggered, 2 slots) bitwise equal generate's of each prompt alone."""
    cfg, tcfg, _, _, tp, tlut, _ = _served("qwen3-4b", "compressed",
                                           kv_cache_bits=8)
    ctx = ServeContext(tcfg, lut=tlut, device="cpu")
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, cfg.vocab_size, int(rng.randint(4, 10)))
               for _ in range(4)]
    eng = Engine(ctx, tp, n_slots=2, max_len=20, page_size=4)
    for i, p in enumerate(prompts):
        eng.submit(Request(tokens=p, max_new=5, rid=i))
    eng.drain()
    assert eng.health()["occupancy_max"] == 2
    for c in eng.completions:
        want = TE.generate(tp, None, torch.from_numpy(prompts[c.rid])[None],
                           ctx=ctx, max_new=5, max_len=eng.pool.max_len)
        np.testing.assert_array_equal(c.tokens, want[0].numpy())
