"""The encoder–decoder (seamless-m4t-medium) against the JAX package on its
smoke config, weights from PRNGKey 0 crossing as numpy, frames and tokens
from numpy seeds.

Tolerances and rules:
  * dense mode in f32: 1e-4 (``ATOL["dense"]`` of
    ``tests/test_torch_model.py``); quant and compressed: ``ATOL`` (3e-2,
    bf16 activations);
  * packed planes, tables, LUTs and stats: byte-equal;
  * greedy tokens: equal; in the bf16 modes a row may part from the
    reference's only at a step where the reference's own logits tie the
    two tokens exactly (``test_torch_families._equal_or_tied``).
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
from repro.launch import train as JTrain
from repro.models import encdec as JED
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.serve import engine as JE

from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.core.policy import CompressionPolicy
from repro_torch.launch import serve as TLaunch
from repro_torch.launch import train as TTrain
from repro_torch.models import encdec as TED
from repro_torch.models import frontends
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.serve import engine as TE
from repro_torch.serve.context import ServeContext
from repro_torch.serve.kv_cache import PagedKVPool
from repro_torch.serve.scheduler import Engine

from test_torch_families import _equal_or_tied, _same_tree
from test_torch_model import ATOL, state_to_numpy
from test_torch_serve import _prompts

torch.set_num_threads(2)

ARCH = "seamless-m4t-medium"
MODES = ["dense", "quant", "compressed"]
FRAMES = 9
# norms init at 1: moved off it, so that each of them matters
_MOVED = ("attn_norm", "cross_norm", "mlp_norm", "enc_final_norm",
          "dec_final_norm")


def _params(cfg):
    params = JED.init_encdec(jax.random.PRNGKey(0), cfg, jnp.float32)
    rng = np.random.default_rng(11)

    def move(path, a):
        if getattr(path[-1], "key", None) not in _MOVED:
            return a
        return a + jnp.asarray(rng.standard_normal(a.shape).astype(
            np.float32) * 0.1)
    return jax.tree_util.tree_map_with_path(move, params)


_CACHE: dict = {}


def _served(mode):
    """(cfg, tcfg, jax params, jax lut, port params, port lut, jax state)
    in ``mode``; kept for the module."""
    if mode not in _CACHE:
        cfg, tcfg = get_config(ARCH).smoke, tget_config(ARCH).smoke
        params = _params(cfg)
        if mode == "dense":
            _CACHE[mode] = (cfg, tcfg, params, None, convert.params_from_numpy(
                jax.tree_util.tree_map(np.asarray, params), tcfg,
                device="cpu"), None, None)
        else:
            st = JE.build_serve_params(params, JPolicy(
                mode=mode, min_weight_size=1024), manifest=False)
            ts = convert.serve_state_from_numpy(
                state_to_numpy(st), np.asarray(st.lut)
                if st.lut is not None else None, tcfg, mode=mode,
                device="cpu")
            _CACHE[mode] = (cfg, tcfg, st.params, st.lut, ts.params, ts.lut,
                            st)
    return _CACHE[mode]


def _frames(cfg, batch, seed=5, n=FRAMES):
    """Seeded stand-in frame embeddings (B, S, d), numpy f32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n, cfg.d_model)) * 0.02).astype(
        np.float32)


def _both(frames, dtype):
    """The frames as (jax, torch) arrays of ``dtype`` ('f32' | 'bf16')."""
    j, t = jnp.asarray(frames), torch.from_numpy(frames)
    if dtype == "bf16":
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _close(got, want, mode):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=ATOL[mode])


def _dtype(mode):
    return "f32" if mode == "dense" else "bf16"


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


# -- function by function ----------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_encode_matches(mode):
    cfg, tcfg, jp, jlut, tp, tlut, _ = _served(mode)
    jf, tf = _both(_frames(cfg, 3), _dtype(mode))
    want = jax.jit(lambda p, f: JED.encode(p, cfg, f, lut=jlut))(jp, jf)
    got = TED.encode(tp, tcfg, tf, lut=tlut)
    assert got.dtype == tf.dtype and tuple(got.shape) == want.shape
    _close(got, want, mode)


@pytest.mark.parametrize("mode", MODES)
def test_project_enc_kv_all_matches(mode):
    """Every decoder layer's cross K/V of the same encoder output."""
    cfg, tcfg, jp, jlut, tp, tlut, _ = _served(mode)
    enc, tenc = _both(_frames(cfg, 2, seed=6) * 40, _dtype(mode))
    jk, jv = JED.project_enc_kv_all(jp, cfg, enc, lut=jlut)
    tk, tv = TED.project_enc_kv_all(tp, tcfg, tenc, lut=tlut)
    assert len(tk) == len(tv) == cfg.decoder_layers
    for i in range(cfg.decoder_layers):
        assert tuple(tk[i].shape) == jk.shape[1:] == (
            2, FRAMES, cfg.n_kv_heads, cfg.resolved_head_dim)
        _close(tk[i], jk[i], mode)
        _close(tv[i], jv[i], mode)


@pytest.mark.parametrize("t", [5, 1])
@pytest.mark.parametrize("mode", MODES)
def test_cross_attention_matches(mode, t):
    """One decoder layer's cross-attention over seeded K/V, at a prefill's
    T and at a decode step's T = 1 (K2 without the mask at one row)."""
    cfg, tcfg, jp, jlut, tp, tlut, _ = _served(mode)
    rng = np.random.default_rng(7)
    hd = cfg.resolved_head_dim
    x, k, v = (rng.standard_normal(s).astype(np.float32) for s in (
        (2, t, cfg.d_model), (2, FRAMES, cfg.n_kv_heads, hd),
        (2, FRAMES, cfg.n_kv_heads, hd)))
    (jx, tx), (jk, tk), (jv, tv) = (_both(a, _dtype(mode)) for a in (x, k, v))
    bp = _layer(jp["decoder"], 1)["cross"]
    want = JL.apply_cross_attention(bp, jx, jk, jv, cfg, lut=jlut)
    got = TL.apply_cross_attention(tp["decoder"][1]["cross"], tx, tk, tv,
                                   tcfg, lut=tlut)
    assert tuple(got.shape) == (2, t, cfg.d_model)
    _close(got, want, mode)


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_decode_stack_matches(mode, cached):
    """The decoder stack over the same cross K/V, without caches (full
    attention) and into caches longer than the prompt (causal flash over
    the cache), whose K/V match too.  The caches are in the activations'
    dtype (f32 in dense mode, as the reference's own teacher-forcing test
    has them): f32 roundoff in a bf16 cache would round some K to the
    neighbouring bf16 value."""
    cfg, tcfg, jp, jlut, tp, tlut, _ = _served(mode)
    enc, tenc = _both(_frames(cfg, 2, seed=8) * 40, _dtype(mode))
    jk, jv = JED.project_enc_kv_all(jp, cfg, enc, lut=jlut)
    tk, tv = TED.project_enc_kv_all(tp, tcfg, tenc, lut=tlut)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 6))
    jx = JL.embed(jp["dec_embed"], jnp.asarray(toks), jlut)
    tx = TL.embed(tp["dec_embed"], torch.from_numpy(toks), tlut)
    jc = tc = None
    if cached:
        dense = mode == "dense"
        jc = JED.init_dec_caches(cfg, 2, 10, jnp.float32 if dense
                                 else jnp.bfloat16)
        tc = TED.init_dec_caches(tcfg, 2, 10, torch.float32 if dense
                                 else torch.bfloat16, device="cpu")
    jy, jc = jax.jit(lambda p, x, k, v, c: JED.decode_stack(
        p, cfg, x, k, v, caches=c, pos=0 if c is not None else None,
        lut=jlut))(jp, jx, jk, jv, jc)
    ty, tc = TED.decode_stack(tp, tcfg, tx, tk, tv, caches=tc,
                              pos=0 if cached else None, lut=tlut)
    # hidden states, as test_torch_model.test_hidden_states_match holds
    # them: in bf16 two ulps (2^-6) relative on top of the logit atol
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                               rtol=0 if mode == "dense" else 2.0 ** -6,
                               atol=ATOL[mode])
    if cached:
        for i in range(cfg.decoder_layers):
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    tc[i][name].float().numpy(),
                    np.asarray(jc[name][i], np.float32), rtol=0, atol=3e-2)


@pytest.mark.parametrize("frames", ["f32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
def test_forward_matches(mode, frames):
    """Logits of the whole model and, with ``return_hidden``, the final
    normed hidden states; f32 frames run the encoder in f32 (K1 rounds
    its x to bf16 in both packages and writes f32), bf16 frames in bf16."""
    cfg, tcfg, jp, jlut, tp, tlut, _ = _served(mode)
    jf, tf = _both(_frames(cfg, 3), frames)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 7))
    fwd = jax.jit(lambda p, f, t, h: JED.forward(p, cfg, f, t, lut=jlut,
                                                 return_hidden=h),
                  static_argnums=3)
    jl, jc = fwd(jp, jf, jnp.asarray(toks), False)
    tl, tc = TED.forward(tp, tcfg, tf, torch.from_numpy(toks), lut=tlut)
    assert tuple(tl.shape) == (3, 7, cfg.vocab_size)
    atol = ATOL[mode] if (mode, frames) != ("dense", "bf16") else 3e-2
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               rtol=0, atol=atol)
    assert tc["self"] is None and len(tc["enc_k"]) == cfg.decoder_layers
    assert tc["enc_k"][0].dtype == tf.dtype
    jh, _ = fwd(jp, jf, jnp.asarray(toks), True)
    th, _ = TED.forward(tp, tcfg, tf, torch.from_numpy(toks), lut=tlut,
                        return_hidden=True)
    assert tuple(th.shape) == (3, 7, cfg.d_model)
    np.testing.assert_allclose(th.float().numpy(), np.asarray(jh, np.float32),
                               rtol=0 if mode == "dense" else 2.0 ** -6,
                               atol=atol)


@pytest.mark.parametrize("mode", MODES)
def test_decode_step_matches_teacher_forcing(mode):
    """The reference's test_encdec_decode_matches_teacher_forcing on the
    port: prefill 5 tokens into f32 caches, one decode step ≡ the full
    forward at position 5; and the step's logits against the reference's
    step on its own caches."""
    cfg, tcfg, jp, jlut, tp, tlut, _ = _served(mode)
    rng = np.random.default_rng(3)
    enc = (rng.standard_normal((2, 8, cfg.d_model)) * 0.3).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 6))
    jf, tf = _both(enc, _dtype(mode))
    full, _ = TED.forward(tp, tcfg, tf, torch.from_numpy(toks), lut=tlut)
    caches = {"self": TED.init_dec_caches(tcfg, 2, 6, torch.float32,
                                          device="cpu")}
    _, c = TED.forward(tp, tcfg, tf, torch.from_numpy(toks[:, :5]),
                       caches=caches, pos=0, lut=tlut)
    step, _ = TED.decode_step(tp, tcfg, torch.from_numpy(toks[:, 5:6]), c, 5,
                              lut=tlut)
    torch.testing.assert_close(step[:, -1].float(), full[:, 5].float(),
                               rtol=2e-2, atol=2e-3 if mode == "dense"
                               else ATOL[mode])
    jc = {"self": JED.init_dec_caches(cfg, 2, 6, jnp.float32)}
    _, jc = JED.forward(jp, cfg, jf, jnp.asarray(toks[:, :5]), caches=jc,
                        pos=0, lut=jlut)
    jstep, _ = JED.decode_step(jp, cfg, jnp.asarray(toks[:, 5:6]), jc, 5,
                               lut=jlut)
    _close(step, jstep, mode)


def test_caches_match_reference_layout():
    cfg, tcfg = get_config(ARCH).smoke, tget_config(ARCH).smoke
    jc = JED.init_dec_caches(cfg, 2, 9)
    tc = TED.init_dec_caches(tcfg, 2, 9, device="cpu")
    assert len(tc) == cfg.decoder_layers
    assert tuple(tc[0]["k"].shape) == jc["k"].shape[1:]
    assert tc[0]["k"].dtype == torch.bfloat16
    sc = TED.init_caches(tcfg, 2, 9, FRAMES, enc_dtype=torch.float32,
                         device="cpu")
    assert tuple(sc["enc_k"][1].shape) == (2, FRAMES, cfg.n_kv_heads,
                                           cfg.resolved_head_dim)
    assert sc["enc_v"][0].dtype == torch.float32


def test_forward_refuses_cross_buffers_of_another_dtype():
    cfg, tcfg, _, _, tp, _, _ = _served("dense")
    caches = TED.init_caches(tcfg, 1, 8, FRAMES, device="cpu")   # bf16
    with pytest.raises(ValueError, match="do not fit"):
        TED.forward(tp, tcfg, torch.from_numpy(_frames(cfg, 1)),
                    torch.zeros((1, 4), dtype=torch.long), caches=caches,
                    pos=0)


def test_audio_frame_embeddings():
    g = torch.Generator().manual_seed(0)
    a = frontends.audio_frame_embeddings(g, 2, 5, 16, torch.bfloat16)
    assert a.shape == (2, 5, 16) and a.dtype == torch.bfloat16
    assert 0.005 < float(a.float().std()) < 0.05


# -- packing ------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["quant", "compressed"])
def test_packed_planes_byte_equal(mode):
    """build_serve_params on the same dense weights gives the reference's
    state: the stacked encoder and decoder leaves (compressed or quant),
    dec_embed and lm_head quant, the norms dense; the table, the LUT and
    the byte counts."""
    cfg, tcfg, jp, jlut, want, wlut, st = _served(mode)
    dense = _served("dense")[4]
    got = TE.build_serve_params(dense, CompressionPolicy(
        mode=mode, min_weight_size=1024), manifest=False, device="cpu")
    assert got.stats == st.stats
    assert got.table == st.table
    if mode == "compressed":
        assert torch.equal(got.lut, wlut)
    _same_tree(got.params, want)
    kind = "PackedLinear" if mode == "compressed" else "QuantLinear"
    for stack in ("encoder", "decoder"):
        assert type(got.params[stack][0]["mlp"]["w_gate"]).__name__ == kind
    assert type(got.params["decoder"][1]["cross"]["wq"]).__name__ == kind
    for head in ("dec_embed", "lm_head"):
        assert type(got.params[head]).__name__ == "QuantLinear"
    assert torch.is_tensor(got.params["decoder"][0]["cross_norm"])


def test_manifest_names_the_reference_leaves():
    """The integrity manifest of a compressed state names the reference's
    stacked leaves (``['encoder']['attn']['wq'].codes``) and matches its
    entries leaf for leaf."""
    dense = _served("dense")[4]
    got = TE.build_serve_params(dense, CompressionPolicy(
        mode="compressed", min_weight_size=1024), device="cpu")
    ref = JE.build_serve_params(_params(get_config(ARCH).smoke), JPolicy(
        mode="compressed", min_weight_size=1024))
    names = set(got.manifest["leaves"])
    assert "['encoder']['attn']['wq'].codes" in names
    assert names == set(ref.manifest["leaves"])
    for name, entry in ref.manifest["leaves"].items():
        assert got.manifest["leaves"][name]["crc32"] == entry["crc32"], name


# -- greedy serving -----------------------------------------------------------

def _reference_greedy(cfg, jp, jlut, toks, frames, n):
    """The reference's jitted prefill and ``_decode_loop`` (its decode
    phase), and each step's logits from its jitted decode step."""
    prefill, decode_step = JE.make_serve_fns(cfg)
    b, t0 = toks.shape
    caches = {"self": JED.init_dec_caches(cfg, b, t0 + n)}
    logits, caches = prefill(jp, jlut, {"tokens": jnp.asarray(toks),
                                        "enc_embeds": frames}, caches)
    tok0 = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    rest = JE._decode_loop(cfg, n - 1, 0.0, None, jp, jlut, tok0, caches,
                           t0, None)
    tokens = np.concatenate([np.asarray(tok0), np.asarray(rest)], axis=1)
    steps, c, lg = [], caches, logits
    for i in range(n):
        steps.append(np.asarray(lg, np.float32))
        if i < n - 1:
            lg, c = decode_step(jp, jlut, jnp.asarray(tokens[:, i:i + 1]),
                                c, t0 + i)
    return tokens, steps


def _eager(tcfg, tp, tlut, ids, frames, n, enc_dtype):
    """The port's greedy decode as an eager loop over make_serve_fns."""
    prefill, decode_step = TE.make_serve_fns(tcfg, device="cpu")
    b, t0 = ids.shape
    caches = TED.init_caches(tcfg, b, t0 + n, frames.shape[1],
                             enc_dtype=enc_dtype, device="cpu")
    logits, caches = prefill(tp, tlut, {"tokens": ids, "enc_embeds": frames},
                             caches)
    toks = [torch.argmax(logits, -1)[:, None]]
    for i in range(n - 1):
        logits, caches = decode_step(tp, tlut, toks[-1], caches, t0 + i)
        toks.append(torch.argmax(logits, -1)[:, None])
    return torch.cat(toks, dim=1)


@pytest.mark.parametrize("mode", MODES)
def test_greedy_tokens_match_reference(mode):
    """3 left-padded prompts × 8 new tokens over seeded frames: the port's
    decode graph (eager steps on the CPU) and its eager loop against the
    reference's prefill + _decode_loop."""
    cfg, tcfg, jp, jlut, tp, tlut, _ = _served(mode)
    toks = _prompts(cfg.vocab_size)
    jf, tf = _both(_frames(cfg, toks.shape[0]), _dtype(mode))
    ref, steps = _reference_greedy(cfg, jp, jlut, toks, jf, 8)
    ids = torch.from_numpy(toks).long()
    graph = TE.decode_graph(tp, tcfg, tlut, 3, toks.shape[1] + 8,
                            enc_len=FRAMES, enc_dtype=tf.dtype, device="cpu")
    TL.MATERIALIZE_COUNTS.clear()
    got = graph.run(tp, tlut, ids, 8, enc_embeds=tf).numpy()
    if mode == "compressed":
        assert sum(TL.MATERIALIZE_COUNTS.values()) == 0
    eager = _eager(tcfg, tp, tlut, ids, tf, 8, tf.dtype).numpy()
    np.testing.assert_array_equal(got, eager)
    _equal_or_tied(got, ref, steps, 0, "equal" if mode == "dense" else "tie")


def test_decode_graph_over_two_batches_of_frames():
    """One DecodeGraph, two batches of other frames and prompts: each
    prefill copies its cross K/V into the graph's buffers, so each
    batch's tokens are an eager loop's over fresh caches."""
    cfg, tcfg, _, _, tp, tlut, _ = _served("compressed")
    graph = TE.decode_graph(tp, tcfg, tlut, 3, 9 + 6, enc_len=FRAMES,
                            device="cpu")
    outs = []
    for seed in (4, 12):
        toks = torch.from_numpy(_prompts(cfg.vocab_size, seed=seed)).long()
        f = torch.from_numpy(_frames(cfg, 3, seed=seed)).to(torch.bfloat16)
        got = graph.run(tp, tlut, toks, 6, enc_embeds=f)
        assert TE.decode_graph(tp, tcfg, tlut, 3, 15, enc_len=FRAMES,
                               device="cpu") is graph
        torch.testing.assert_close(got, _eager(tcfg, tp, tlut, toks, f, 6,
                                               torch.bfloat16), rtol=0,
                                   atol=0)
        outs.append(got)
    assert not torch.equal(outs[0], outs[1])


def test_decode_rows_do_not_depend_on_the_batch():
    """A decode step's rows, each against itself alone (the same caches
    row by row), bitwise — on the CPU the plain versions; the card test
    holds the kernels."""
    cfg, tcfg, _, _, tp, tlut, _ = _served("compressed")
    toks = torch.from_numpy(_prompts(cfg.vocab_size)).long()
    f = torch.from_numpy(_frames(cfg, 3)).to(torch.bfloat16)
    prefill, step = TE.make_serve_fns(tcfg, device="cpu")
    c = TED.init_caches(tcfg, 3, 12, FRAMES, device="cpu")
    logits, c = prefill(tp, tlut, {"tokens": toks, "enc_embeds": f}, c)
    nxt = torch.argmax(logits, -1)[:, None]
    both = step(tp, tlut, nxt, c, 9)[0]
    for r in range(3):
        one = {k: [{n: t[r:r + 1].clone() for n, t in layer.items()}
                   for layer in v] if k == "self"
               else [t[r:r + 1].clone() for t in v] for k, v in c.items()}
        alone = step(tp, tlut, nxt[r:r + 1], one, 9)[0]
        assert torch.equal(alone[0], both[r]), r


# -- what refuses the family, as the reference does ---------------------------

def test_generate_engine_and_pool_refuse_encdec():
    cfg, tcfg, jp, jlut, tp, tlut, _ = _served("compressed")
    toks = _prompts(cfg.vocab_size)
    with pytest.raises(ValueError):
        JE.generate(jp, cfg, jnp.asarray(toks), lut=jlut, max_new=2)
    with pytest.raises(ValueError, match="encdec"):
        TE.generate(tp, tcfg, torch.from_numpy(toks), lut=tlut, max_new=2,
                    device="cpu")
    for fn in (lambda: JLM.init_caches(cfg, 2, 8),
               lambda: JLM.cache_batch_time_axes(cfg)):
        with pytest.raises(ValueError):
            fn()
    ctx = ServeContext(tcfg, lut=tlut, device="cpu")
    for fn in (lambda: TLM.init_caches(tcfg, 2, 8, device="cpu"),
               lambda: TLM.init_lm(tcfg, device="cpu"),
               lambda: TLM.cache_batch_time_axes(tcfg),
               lambda: PagedKVPool(tcfg, 2, 16, device="cpu"),
               lambda: Engine(ctx, tp, n_slots=2, max_len=16, page_size=4),
               lambda: TE.serve_fns(tcfg, torch.device("cpu"), routing=True)):
        with pytest.raises(ValueError, match="encdec"):
            fn()


def test_tiered_generate_refuses_encdec():
    from repro_torch.serve import residency as TR
    cfg, tcfg, _, _, tp, tlut, _ = _served("compressed")
    ctx = ServeContext(tcfg, lut=tlut, device="cpu")
    with pytest.raises(ValueError, match="encdec"):
        TR.tiered_generate(tp, tcfg, torch.from_numpy(_prompts(
            cfg.vocab_size)), ctx=ctx, max_new=2)


def test_serving_launcher_refuses_encdec(monkeypatch, capsys):
    argv = ["--arch", ARCH, "--batch", "2", "--max-new", "2"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(ValueError) as ref:
        JLaunch.main()
    with pytest.raises(ValueError) as got:
        TLaunch.main(argv + ["--device", "cpu"])
    assert str(ref.value) == "encdec"
    assert "encdec" in str(got.value)


def test_training_launcher_refuses_encdec(monkeypatch, tmp_path):
    argv = ["--arch", ARCH, "--steps", "1"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with pytest.raises(SystemExit) as ref:
        JTrain.main()
    with pytest.raises(SystemExit) as got:
        TTrain.main(argv + ["--device", "cpu", "--ckpt-dir",
                            str(tmp_path)])
    assert str(got.value) == str(ref.value) == \
        "use examples/ for enc-dec; LM families here"


def test_full_config_matches_reference():
    full, tfull = get_config(ARCH).full, tget_config(ARCH).full
    assert dataclasses.asdict(full) == dataclasses.asdict(tfull)
    assert tfull.n_params() == full.n_params() == 977_744_896
