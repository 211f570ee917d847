"""The port's train step (``repro_torch.train``) against the JAX package's,
on the same converted init and the same batches, for the smoke configs of
every family the port serves: Llama (dense), DeepSeek-V2-Lite (MoE + MLA),
seamless-m4t-medium (encoder–decoder: batches carry ``enc_embeds``),
Mamba2 (``ssm``), Zamba2 (``hybrid``), InternVL2 (``vlm``: batches carry
``embeds``, the logits past them are scored) and Qwen3 (qk-norm).  The
frames and patch embeddings are drawn from a numpy seed a step.

Tolerances (both run in f32 on the CPU):
  * plain, ``accum_steps=2`` and ``logits_chunk``: 5 steps end to end,
    each step's loss within 1e-5 relative, and after them the parameters,
    as one vector, within 1e-5 relative (L2).  Gradients differ by f32
    roundoff (sums in another order); AdamW divides each update by the
    gradient's own scale, so a tiny gradient's relative error shows in its
    update, and 1e-5 of the parameters leaves room for that.
  * ``grad_compression='int8_ef'`` and ``quantized_state=True``: their
    uint8 codes round per element, and a value a gradient's roundoff moves
    across a rounding boundary changes by a whole step; the error feedback
    of a gradient's zeros is a cancellation (q·scale + min) whose sign
    roundoff decides, and AdamW turns that sign into ±lr.  So end to end
    the two packages part (measured: up to 4 % of a leaf after 5 steps).
    These variants are held step by step for 5 steps: from the
    reference's state, the loss and the gradients within 1e-5 relative
    (as one vector), and the port's compression and optimizer given the
    reference's gradients give its new parameters within 1e-5 relative,
    its error feedback bitwise and its int8 moments within one code.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.models import encdec as JED
from repro.models import lm as JLM
from repro.train import steps as JS
from repro.train.data import DataConfig as JDC, DataPipeline as JDP
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.optimizer import QMoment as JQMoment

from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.train import tree as T
from repro_torch.train.data import DataConfig, DataPipeline
from repro_torch.train.optimizer import AdamWConfig, QMoment, adamw_update
from repro_torch.train.steps import (TrainConfig, compress_grads_int8,
                                     init_train_state, loss_and_grads,
                                     make_train_step)

torch.set_num_threads(2)

ARCHS = ["llama3.2-1b", "deepseek-v2-lite-16b", "seamless-m4t-medium",
         "mamba2-2.7b", "zamba2-1.2b", "internvl2-2b", "qwen3-4b"]
VARIANTS = {"plain": {}, "accum2": dict(accum_steps=2),
            "int8_ef": dict(grad_compression="int8_ef"),
            "quantized_state": {}, "logits_chunk": dict(logits_chunk=5)}
STEPS, BATCH, SEQ = 5, 4, 16


def _configs(variant):
    opt = dict(lr=5e-3, warmup_steps=2, total_steps=10, qblock=64,
               quantized_state=variant == "quantized_state")
    return (JS.TrainConfig(optimizer=JAdamW(**opt), **VARIANTS[variant]),
            TrainConfig(optimizer=AdamWConfig(**opt), **VARIANTS[variant]))


def _to_numpy(tree):
    """A JAX tree as numpy, a QMoment as a {"q", "scale", "zero"} dict."""
    if isinstance(tree, JQMoment):
        return {f: np.asarray(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return np.asarray(tree)


def _qmoments(tree):
    """{"q", "scale", "zero"} dicts of a converted tree → QMoments."""
    if isinstance(tree, dict) and set(tree) == {"q", "scale", "zero"}:
        return QMoment(tree["q"], tree["scale"], tree["zero"])
    if isinstance(tree, dict):
        return {k: _qmoments(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_qmoments(v) for v in tree]
    return tree


def port_tree(jtree, tcfg):
    """A JAX tree of the params' layout (stacked blocks) in the port's
    layout (a list of layers), on the CPU."""
    return _qmoments(convert.params_from_numpy(_to_numpy(jtree), tcfg,
                                               device="cpu"))


def port_state(jstate, tcfg):
    state = {"params": port_tree(jstate["params"], tcfg),
             "opt": {"mu": port_tree(jstate["opt"]["mu"], tcfg),
                     "step": torch.tensor(int(jstate["opt"]["step"]),
                                          dtype=torch.int32)}}
    if "grad_error" in jstate:
        state["grad_error"] = port_tree(jstate["grad_error"], tcfg)
    return state


def rel(a_tree, b_tree) -> float:
    """‖a − b‖ / ‖b‖ over all leaves as one vector."""
    a, b = T.leaves(a_tree), T.leaves(b_tree)
    assert len(a) == len(b)
    num = sum(float(((x.float() - y.float()) ** 2).sum())
              for x, y in zip(a, b))
    den = sum(float((y.float() ** 2).sum()) for y in b)
    return (num / den) ** 0.5


# the encoder–decoder's frames a row
FRAMES = 12


class WithEmbeds:
    """A data pipeline whose batches also carry a frontend's output,
    drawn from a numpy seed a step: an encoder–decoder's ``enc_embeds``
    (B, FRAMES, d) or a VLM's ``embeds`` (B, n_patches, d), f32, as jnp
    (``jax=True``) or torch arrays."""

    def __init__(self, base, cfg, jax_arrays: bool):
        self.base, self.cfg, self.jax = base, cfg, jax_arrays

    def batch_at(self, i):
        batch = dict(self.base.batch_at(i))
        key = "enc_embeds" if self.cfg.family == "encdec" else "embeds"
        n = FRAMES if key == "enc_embeds" else self.cfg.n_patches
        rng = np.random.default_rng(1000 + i)
        e = (rng.standard_normal((BATCH, n, self.cfg.d_model)) * 0.02
             ).astype(np.float32)
        batch[key] = jnp.asarray(e) if self.jax else torch.from_numpy(e)
        return batch


def init_params(cfg):
    """The reference's init of ``cfg`` from PRNGKey 0."""
    if cfg.family == "encdec":
        return JED.init_encdec(jax.random.PRNGKey(0), cfg, jnp.float32)
    return JLM.init_lm(jax.random.PRNGKey(0), cfg, jnp.float32)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    cfg, tcfg = get_config(arch).smoke, tget_config(arch).smoke
    params = init_params(cfg)
    jdata = JDP(JDC(vocab_size=cfg.vocab_size, batch=BATCH, seq_len=SEQ,
                    seed=1))
    tdata = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, batch=BATCH,
                                    seq_len=SEQ, seed=1))
    if cfg.family in ("encdec", "vlm"):
        jdata, tdata = WithEmbeds(jdata, cfg, True), WithEmbeds(tdata, cfg,
                                                                False)
    return cfg, tcfg, params, jdata, tdata


# (smoke config, variant) pairs whose trajectory amplifies f32 roundoff
# step over step, so that 5 steps end to end part by more than 1e-5 in
# both packages' own runs; they are held one train step at a time from
# the reference's state instead (every step's loss, and its parameters
# and moments after the step, under the same bounds).  Measured on the
# CPU: Qwen3's smoke parameters after 5 steps, the port against the
# jitted reference, 1.15e-5 with accum_steps=2 (3.8e-6 plain); the
# reference's own eager against its jitted run 7.7e-6 plain, 3.0e-6 with
# accum_steps=2; each single step from the reference's state within
# 8.7e-7, its gradients within 9.2e-7 (Llama's: 9.1e-7).
STEPWISE = {("qwen3-smoke", "accum2")}


@pytest.mark.parametrize("variant", ["plain", "accum2", "logits_chunk"])
def test_train_steps_match_end_to_end(setup, variant):
    cfg, tcfg, params, jdata, tdata = setup
    jt, tt = _configs(variant)
    js = JS.init_train_state(params, jt)
    ts = init_train_state(port_tree(params, tcfg), tt)
    jstep, tstep = jax.jit(JS.make_train_step(cfg, jt)), \
        make_train_step(tcfg, tt)
    if (cfg.name, variant) in STEPWISE:
        for i in range(STEPS):
            ts = port_state(js, tcfg)
            js, jm = jstep(js, jdata.batch_at(i))
            ts, tm = tstep(ts, tdata.batch_at(i))
            assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                      rel=1e-5), i
            assert rel(ts["params"], port_tree(js["params"], tcfg)) <= 1e-5
            assert rel(ts["opt"]["mu"],
                       port_tree(js["opt"]["mu"], tcfg)) <= 1e-4
        return
    for i in range(STEPS):
        js, jm = jstep(js, jdata.batch_at(i))
        ts, tm = tstep(ts, tdata.batch_at(i))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5), i
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert rel(ts["params"], port_tree(js["params"], tcfg)) <= 1e-5
    assert rel(ts["opt"]["mu"], port_tree(js["opt"]["mu"], tcfg)) <= 1e-4


@pytest.mark.parametrize("variant", ["int8_ef", "quantized_state"])
def test_train_steps_match_step_by_step(setup, variant):
    cfg, tcfg, params, jdata, tdata = setup
    jt, tt = _configs(variant)
    js = JS.init_train_state(params, jt)
    jgrad = jax.jit(jax.value_and_grad(
        lambda p, b: JS._loss_fn(p, cfg, jt, b)[0]))

    @jax.jit
    def jupdate(state, grads):
        new = {}
        if "grad_error" in state:
            grads, new["grad_error"] = JS.compress_grads_int8(
                grads, state["grad_error"])
        new["params"], new["opt"], _ = JS.adamw_update(
            state["params"], grads, state["opt"], jt.optimizer)
        return new

    for i in range(STEPS):
        batch = jdata.batch_at(i)
        jl, jg = jgrad(js["params"], batch)
        ts = port_state(js, tcfg)
        tl, tg = loss_and_grads(ts["params"], tcfg, tt, tdata.batch_at(i))
        assert float(tl) == pytest.approx(float(jl), rel=1e-5), i
        jg_port = port_tree(jg, tcfg)
        assert rel(T.unflatten(ts["params"], tg), jg_port) <= 1e-5, i
        js = jupdate(js, jg)
        grads = jg_port
        if "grad_error" in ts:
            grads, err = compress_grads_int8(grads, ts["grad_error"])
            for a, b in zip(T.leaves(err),
                            T.leaves(port_tree(js["grad_error"], tcfg))):
                assert torch.equal(a, b), i
        new_p, new_opt, _ = adamw_update(ts["params"], grads, ts["opt"],
                                         tt.optimizer)
        assert rel(new_p, port_tree(js["params"], tcfg)) <= 1e-5, i
        want = port_tree(js["opt"]["mu"], tcfg)
        for (path, a), b in zip(T.flatten(new_opt["mu"]), T.leaves(want)):
            if path.endswith(".q"):
                diff = (a.to(torch.int16) - b.to(torch.int16)).abs()
                assert int(diff.max()) <= 1, (i, path)
            elif not path.endswith(".scale") and not path.endswith(".zero"):
                assert rel(a, b) <= 1e-5, (i, path)
        assert int(new_opt["step"]) == int(js["opt"]["step"])
    if variant == "quantized_state":          # int8 moments were held
        assert any(p.endswith(".q") for p, _ in T.flatten(new_opt["mu"]))


def test_moe_aux_loss_enters_the_loss():
    """The DeepSeek smoke model's loss is its CE plus moe_aux_weight times
    the routers' aux loss, in both packages (the aux weight's share of the
    loss difference between weights 0 and 1)."""
    arch = "deepseek-v2-lite-16b"
    cfg, tcfg = get_config(arch).smoke, tget_config(arch).smoke
    params = JLM.init_lm(jax.random.PRNGKey(0), cfg, jnp.float32)
    tp = port_tree(params, tcfg)
    batch = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, batch=2,
                                    seq_len=8)).batch_at(0)
    out = {}
    for w in (0.0, 1.0):
        jl = float(JS._loss_fn(params, cfg, JS.TrainConfig(moe_aux_weight=w),
                               {k: jnp.asarray(v.numpy())
                                for k, v in batch.items()})[0])
        tl = float(loss_and_grads(tp, tcfg, TrainConfig(moe_aux_weight=w),
                                  batch)[0])
        out[w] = (jl, tl)
        assert tl == pytest.approx(jl, rel=1e-5)
    assert out[1.0][1] - out[0.0][1] == pytest.approx(
        out[1.0][0] - out[0.0][0], rel=1e-4)
    assert out[1.0][1] > out[0.0][1]


# ---------------------------------------------------------------------------
# The reference's training-substrate tests (tests/test_train.py), on the
# port: loss descent, chunked CE, accumulation, int8 optimizer state,
# gradient compression, the data pipeline.  Same inputs and bounds.
# ---------------------------------------------------------------------------

from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.train.optimizer import (adamw_init, lr_schedule,  # noqa
                                         moment_block)
from repro_torch.train.steps import (chunked_cross_entropy,  # noqa: E402
                                     cross_entropy)


def _tiny():
    tcfg = tget_config("llama3.2-1b").smoke
    return tcfg, TLM.init_lm(tcfg, seed=0, device="cpu")


def test_loss_decreases_on_learnable_data():
    cfg, params = _tiny()
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, batch=16,
                                   seq_len=32, seed=3))
    tt = TrainConfig(optimizer=AdamWConfig(lr=1e-2, warmup_steps=10,
                                           total_steps=2000))
    state = init_train_state(params, tt)
    step = make_train_step(cfg, tt)
    losses = []
    for i in range(80):
        state, m = step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 1.0, losses


def _ce_inputs(b, t, d, v, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(b, t, d)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, v, size=(b, t))))


@pytest.mark.parametrize("chunk", [4, 8, 16, 5])
def test_chunked_ce_matches_full(chunk):
    hidden, head, labels = _ce_inputs(2, 16, 8, 32)
    full = cross_entropy(torch.einsum("btd,vd->btv", hidden, head), labels,
                         z_loss=1e-4)
    ch = chunked_cross_entropy(hidden, head, labels, chunk=chunk,
                               z_loss=1e-4)
    assert float(ch) == pytest.approx(float(full), rel=1e-5)


def test_chunked_ce_gradients_match():
    hidden, head, labels = _ce_inputs(2, 8, 4, 16)
    h1 = hidden.clone().requires_grad_(True)
    cross_entropy(torch.einsum("btd,vd->btv", h1, head), labels).backward()
    h2 = hidden.clone().requires_grad_(True)
    chunked_cross_entropy(h2, head, labels, chunk=4).backward()
    np.testing.assert_allclose(h2.grad.numpy(), h1.grad.numpy(), rtol=1e-4,
                               atol=1e-6)


def test_accumulation_matches_single_batch():
    """accum_steps=k over a batch == one step over the same batch."""
    cfg, params = _tiny()
    batch = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, batch=8,
                                    seq_len=8, seed=1)).batch_at(0)
    outs = {}
    for accum in (1, 4):
        tt = TrainConfig(accum_steps=accum)
        new, m = make_train_step(cfg, tt)(init_train_state(params, tt),
                                          batch)
        outs[accum] = (float(m["loss"]), T.leaves(new["params"])[0])
    assert outs[1][0] == pytest.approx(outs[4][0], rel=1e-4)
    np.testing.assert_allclose(outs[1][1].numpy(), outs[4][1].numpy(),
                               rtol=1e-3, atol=1e-5)


def test_adamw_quantized_state_tracks_fp32():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(16, 256)).astype(np.float32))
    cfg_q = AdamWConfig(lr=1e-2, quantized_state=True, qblock=64,
                        warmup_steps=0)
    cfg_f = AdamWConfig(lr=1e-2, quantized_state=False, warmup_steps=0)
    pq, pf = {"w": w}, {"w": w}
    sq, sf = adamw_init(pq, cfg_q), adamw_init(pf, cfg_f)
    assert isinstance(sq["mu"]["w"]["m"], QMoment)
    for _ in range(20):
        g = {"w": torch.from_numpy(rng.normal(size=w.shape).astype(
            np.float32))}
        pq, sq, _ = adamw_update(pq, g, sq, cfg_q)
        pf, sf, _ = adamw_update(pf, g, sf, cfg_f)
    drift = float((pq["w"] - pf["w"]).norm() / (pf["w"] - w).norm())
    assert drift < 0.15, drift


@pytest.mark.parametrize("last,block,want", [(16384, 256, 256),
                                             (448, 256, 64), (7, 256, 7)])
def test_moment_block_divides(last, block, want):
    assert moment_block(last, block) == want
    assert last % moment_block(last, block) == 0


def test_qmoment_shapes_mirror_param():
    st = adamw_init({"w": torch.zeros((4, 6, 512))},
                    AdamWConfig(quantized_state=True, qblock=128))
    qm = st["mu"]["w"]["m"]
    assert qm.q.shape == (4, 6, 4, 128) and qm.scale.shape == (4, 6, 4, 1)


@pytest.mark.parametrize("step,want", [(0, 0.0), (10, 1e-3), (100, 1e-4)])
def test_lr_schedule_shape(step, want):
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    assert float(lr_schedule(step, cfg)) == pytest.approx(want, rel=1e-2,
                                                          abs=1e-12)


def test_grad_clip_applies():
    cfg = AdamWConfig(lr=0.0, grad_clip=1.0)
    p = {"w": torch.zeros((8, 8))}
    _, _, m = adamw_update(p, {"w": torch.full((8, 8), 100.0)},
                           adamw_init(p, cfg), cfg)
    assert float(m["grad_norm"]) == pytest.approx(800.0)


def test_grad_compression_error_feedback_unbiased():
    """Summed over steps, the feedback compensates: Σ dq ≈ Σ g."""
    rng = np.random.default_rng(0)
    g_sum = torch.zeros((32, 32))
    dq_sum = torch.zeros((32, 32))
    err = {"w": torch.zeros((32, 32))}
    for _ in range(50):
        g = {"w": torch.from_numpy(rng.normal(size=(32, 32)).astype(
            np.float32))}
        dq, err = compress_grads_int8(g, err)
        g_sum += g["w"]
        dq_sum += dq["w"]
    resid = float((dq_sum - g_sum).norm() / g_sum.norm())
    assert resid < 0.01, resid


def test_grad_compression_single_step_quantization_error_small():
    rng = np.random.default_rng(1)
    g = {"w": torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))}
    dq, _ = compress_grads_int8(g, {"w": torch.zeros((64, 64))})
    assert float((dq["w"] - g["w"]).norm() / g["w"].norm()) < 0.01


def test_train_step_with_grad_compression_runs():
    cfg, params = _tiny()
    tt = TrainConfig(grad_compression="int8_ef")
    state = init_train_state(params, tt)
    assert "grad_error" in state
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, batch=4,
                                   seq_len=8))
    state, m = make_train_step(cfg, tt)(state, data.batch_at(0))
    assert np.isfinite(float(m["loss"]))


def test_data_random_access_deterministic():
    cfg = DataConfig(vocab_size=100, batch=4, seq_len=16, seed=9)
    b1, b2 = DataPipeline(cfg).batch_at(17), DataPipeline(cfg).batch_at(17)
    assert torch.equal(b1["tokens"], b2["tokens"])


def test_data_labels_shifted():
    b = DataPipeline(DataConfig(vocab_size=50, batch=2, seq_len=8,
                                seed=0)).batch_at(0)
    assert b["tokens"].shape == (2, 8) and b["labels"].shape == (2, 8)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_data_markov_learnable_structure():
    """The markov stream is predictable: few distinct successors."""
    b = DataPipeline(DataConfig(vocab_size=64, batch=64, seq_len=32,
                                seed=1)).batch_at(0)
    succ: dict = {}
    for row in b["tokens"].numpy():
        for a, c in zip(row[:-1], row[1:]):
            succ.setdefault(int(a), set()).add(int(c))
    assert np.mean([len(v) for v in succ.values()]) < 40


# -- K2 under autograd ---------------------------------------------------------

from repro.kernels import ops as JOPS  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402


@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,dv,off", [
    (2, 4, 2, 16, 16, 16, 16, 0),      # Llama smoke, GQA
    (2, 4, 4, 12, 12, 24, 16, 0),      # DeepSeek smoke MLA (24/16)
    (1, 4, 1, 5, 20, 16, 16, 15),      # q_offset over a longer k/v
    (2, 4, 4, 9, 9, 16, 16, None),     # the encoder's self-attention
    (2, 4, 4, 6, 12, 16, 16, None),    # cross-attention over 12 frames
    (3, 4, 2, 1, 12, 16, 16, None),    # cross-attention at one row, GQA
])
def test_flash_attention_function_gradients(b, hq, hkv, tq, tk, d, dv, off):
    """K2's ``autograd.Function`` on the CPU (forward: the plain version;
    backward: the plain version's gradient) equals plain autograd
    bitwise, and the JAX package's gradient of its attention within 1e-5
    of each gradient's largest magnitude (f32 sums in another order).
    ``off``: a causal case's q_offset; None: no mask (the
    encoder–decoder's encoder and cross-attention)."""
    causal = off is not None
    off = off or 0
    rng = np.random.default_rng(b * 100 + d)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, dv)))
    w = rng.normal(size=(b, hq, tq, dv)).astype(np.float32)

    def grads(fn):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        (fn(*ts, causal=causal, q_offset=off) * torch.from_numpy(w)).sum() \
            .backward()
        return [t.grad for t in ts]

    got = grads(lambda q, k, v, **kw: FA.FlashAttentionFn.apply(
        q, k, v, kw["causal"], None, kw["q_offset"]))
    plain = grads(FA.flash_attention_plain)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    ref = jax.grad(lambda *a: jnp.sum(JOPS.flash_attention(
        *a, causal=causal, q_offset=off) * w), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-5 * float(np.abs(r).max()))


def test_training_attention_goes_through_the_function():
    """With gradients on, every layer's prefill attention is a node of K2's
    autograd wrapper in the logits' graph (its backward: the plain
    version's), one a layer."""
    cfg, params = _tiny()
    batch = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, batch=2,
                                    seq_len=8)).batch_at(0)
    live = [p.detach().requires_grad_(True) for p in T.leaves(params)]
    logits, _, _ = TLM.forward(T.unflatten(params, live), cfg,
                               batch["tokens"])
    names, seen, todo = [], set(), [logits.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(node.name())
        todo.extend(f for f, _ in node.next_functions)
    assert sum("FlashAttentionFn" in n for n in names) == cfg.n_layers

