"""The port's continuous-batching engine on the MoE family, on the CPU.

DeepSeek-V2-Lite's smoke config pages MLA latent planes and an MoE
model's ``"first"`` dense layer.  Expert capacity depends on the batch,
so parity needs the dropless regime (capacity_factor ≥ n_experts /
top_k).  A file of its own: the reference's Engine runs eagerly here,
which takes two minutes on the CPU.
"""
import jax
import numpy as np

from repro.configs import get_config
from repro.serve.context import ServeContext as JContext
from repro.serve.scheduler import Engine as JEngine
from repro.serve.scheduler import Request as JRequest

from repro_torch.serve.scheduler import Engine, Request

from test_torch_scheduler import (_by_rid, _equal_or_tied, _prompts, _ref,
                                  _served)


def test_moe_dropless_parity():
    """DeepSeek-V2-Lite smoke (MLA latents, an MoE model's "first" dense
    layer) in the dropless regime: bitwise-equal to the port's generate,
    and the reference Engine's tokens under the exact-tie rule.

    The reference Engine runs eagerly here: the reference's MoE differs
    between its eager and jitted runs (XLA's fusion rounds bf16 elsewhere
    and reroutes near-tied tokens; ROADMAP.md queue 3), and the port's
    layers round where its eager run does.  On these prompts its jitted
    Engine reroutes one token of request 0 (logits 0.119 apart at its
    second step) and breaks a bf16 tie of request 1 the other way."""
    arch = "deepseek-v2-lite-16b"
    smoke = get_config(arch).smoke
    cfg, tcfg, st, tp, ctx = _served(
        arch, name=smoke.name + "-sched-dropless",
        capacity_factor=float(smoke.n_experts) / smoke.top_k)
    prompts = _prompts(cfg.vocab_size, 3, seed=9)
    eng = Engine(ctx, tp, n_slots=2, max_len=16)
    for i, p in enumerate(prompts):
        eng.submit(Request(tokens=p, max_new=3, rid=i))
    eng.drain()
    assert eng.health()["occupancy_max"] == 2
    by_rid = _by_rid(eng)
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(by_rid[i].tokens,
                                      _ref(tp, ctx, p, 3, eng.pool.max_len))
    with jax.disable_jit():
        jeng = JEngine(JContext.from_state(cfg, st), st.params, n_slots=2,
                       max_len=16)
        for i, p in enumerate(prompts):
            jeng.submit(JRequest(tokens=p, max_new=3, rid=i))
        jeng.drain()
        for i, p in enumerate(prompts):
            _equal_or_tied(st, cfg, p, by_rid[i].tokens,
                           np.asarray(_by_rid(jeng)[i].tokens), 16)
