"""The port's serving launcher (``repro_torch.launch.serve``), its training
launcher (``repro_torch.launch.train``) and the data pipeline both draw
from (``repro_torch.train.data``), on the CPU.

  * ``DataPipeline.batch_at`` gives the reference's tokens and labels for
    several steps, from a Markov table and from a byte corpus.
  * ``main`` runs with every flag set the launcher documents (the three
    weight modes, ``--tiles 2``, ``--verify full``, DeepSeek's
    ``--residency tiered``, ``--pressure-trace oscillate``), accounts for
    every request and dispatches what the flags ask for; ``--mesh 1,2``
    serves on two spawned ranks with the one-device completions, and a
    mesh of more ranks than torchrun started is refused.
  * With the reference's ``init_lm(PRNGKey(0))`` weights carried across
    (``repro_torch.convert``), the Llama run's ``sample:`` tokens and its
    completions by reason equal the reference launcher's, run in-process.
  * The training launcher: each flag set trains on the CPU (the loss
    falls); ``--mesh single|multi`` is refused without its ranks; a run
    stopped by SIGINT and started again resumes from its checkpoint with
    the uninterrupted run's losses, bit for bit (the same eager ops on the
    same CPU); on the reference's init its losses are the reference's
    train step's under the launcher's TrainConfig, within 1e-5 relative
    (f32 sums in another order; tests/test_torch_train.py).
"""
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.launch import serve as JS
from repro.models import lm as JLM
from repro.train.data import DataConfig as JDataConfig
from repro.train.data import DataPipeline as JDataPipeline

from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import serve as TS
from repro_torch.launch import train as TT
from repro_torch.train.data import DataConfig, DataPipeline

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _reset_fallback_counts():
    """The launcher's health line reports the resilience ladder's global
    ``FALLBACK_COUNTS``: clear it, so that a run reads its own fallbacks
    and not those an earlier test in this process left."""
    from repro_torch.serve.resilience import FALLBACK_COUNTS
    FALLBACK_COUNTS.clear()


@pytest.mark.parametrize("kind", ["markov", "bytes"])
def test_batch_at_matches_reference(kind, tmp_path):
    path = None
    if kind == "bytes":
        path = tmp_path / "corpus.bin"
        path.write_bytes(np.random.default_rng(7).integers(
            0, 256, 5000, dtype=np.uint8).tobytes())
        path = str(path)
    kw = dict(vocab_size=256 if kind == "bytes" else 300, batch=3,
              seq_len=17, seed=5, kind=kind, corpus_path=path)
    ref = JDataPipeline(JDataConfig(**kw))
    got = DataPipeline(DataConfig(**kw))
    for step in (0, 1, 7, 1000):
        want, have = ref.batch_at(step), got.batch_at(step)
        for key in ("tokens", "labels"):
            assert have[key].dtype == torch.int32
            np.testing.assert_array_equal(have[key].numpy(),
                                          np.asarray(want[key]))
    first = next(iter(got))
    assert torch.equal(first["tokens"], got.batch_at(0)["tokens"])


FLAG_SETS = {
    "dense": ["--mode", "dense"],
    "quant": ["--mode", "quant"],
    "compressed": [],
    "tiles": ["--tiles", "2"],
    "verify": ["--tiles", "2", "--verify", "full"],
    "pressure": ["--tiles", "2", "--pressure-trace", "oscillate"],
    "tiered": ["--arch", "deepseek-v2-lite-16b", "--residency", "tiered",
               "--tiles", "2"],
}


@pytest.mark.parametrize("flags", list(FLAG_SETS))
def test_main_runs_each_flag_set_on_cpu(flags, capsys):
    argv = ["--device", "cpu", "--batch", "3", "--max-new", "6"] \
        + FLAG_SETS[flags]
    out = TS.main(argv)
    text = capsys.readouterr().out
    assert out["reasons"] == {"max_new": 3}
    assert out["engine"]["completed"] == 3 and out["tokens"] == 18
    assert "completions by reason: {'max_new': 3}" in text
    assert re.search(r"^sample: \[(\d+, ){5}\d+\]$", text, re.M)
    dispatch = out["dispatch"]
    if flags in ("dense", "quant"):
        assert not dispatch and "matmul dispatch" not in text
    elif flags == "compressed":
        assert set(dispatch) == {"fused"}
    else:
        assert "tiled_fused" in dispatch and "tiled_unfused" not in dispatch
        assert "fused" not in dispatch
    if flags == "tiered":
        assert set(dispatch) == {"tiled_fused", "grouped_fused"}
        assert out["residency"]["miss"] > 0
        assert re.search(r"^residency: hits \d+", text, re.M)
        assert "expert cache:" in text
    if flags == "verify":
        assert "verify[full]: ok" in text
        assert "verify[invariant]: ok" in text
    if flags == "pressure":
        assert re.search(r"^pressure: plan_changes \d+", text, re.M)
        assert "pressure trace: oscillate" in text
    if flags != "dense" and flags != "quant":
        assert out["health"]["last_rung"] == "fused"
        assert not out["health"]["fallbacks"]


def test_pressure_trace_low_watermark_forces_a_reclaim(capsys):
    """Oscillating down to a 1 MiB low watermark under the 4 GiB boot
    budget: the governor retires KV pages and regrows them, refuses what
    arrives below its floor, and every request is accounted for."""
    out = TS.main(["--device", "cpu", "--batch", "4", "--max-new", "4",
                   "--tiles", "2", "--pressure-trace", "oscillate",
                   "--pressure-low-mib", "1"])
    text = capsys.readouterr().out
    assert sum(out["reasons"].values()) == 4
    assert set(out["reasons"]) <= {"max_new", "pressure"}
    assert out["pressure"]["plan_changes"] > 0
    assert "retire_kv" in out["pressure"]["rung_latency_s"]
    assert re.search(r"^pressure: plan_changes [1-9]", text, re.M)


def test_mesh_serves_as_one_device():
    """``--mesh 1,2`` starts two ranks (gloo, on the CPU), each serving its
    share of the packed weights through the sharded kernels' plain
    versions: the completions are the one-device launcher's, token for
    token, and every compressed matmul took the sharded fused branch."""
    one = TS.main(["--device", "cpu"])
    got = TS.main(["--device", "cpu", "--mesh", "1,2"])
    assert got["mesh"] == {"data": 1, "model": 2} and one["mesh"] is None
    assert got["sample"] == one["sample"]
    assert got["reasons"] == one["reasons"]
    assert [list(c.tokens) for c in got["completions"]] == \
        [list(c.tokens) for c in one["completions"]]
    assert set(got["dispatch"]) == {"fused_shard_map"}
    assert got["dispatch"]["fused_shard_map"] == one["dispatch"]["fused"]


def test_mesh_of_more_ranks_than_started_is_refused(monkeypatch, capsys):
    """Under torchrun's variables, a mesh of more ranks than it started is
    refused with the reference launcher's message."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(SystemExit) as e:
        TS.main(["--device", "cpu", "--mesh", "1,2"])
    assert e.value.code != 0
    assert "--mesh 1,2 needs 2 devices, have 1" in capsys.readouterr().err


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.main(["--batch", "1", "--max-new", "2"])


def _summary(text: str):
    sample = re.search(r"^sample: (\[.*\])$", text, re.M).group(1)
    reasons = re.search(r"^completions by reason: (\{.*\})$", text,
                        re.M).group(1)
    return sample, reasons


@pytest.mark.parametrize("tiles", [0, 2])
def test_llama_run_matches_reference_launcher(tiles, capsys, monkeypatch):
    """The reference's launcher and the port's, on the reference's weights:
    the same sample tokens and completions by reason (the Engine's greedy
    tokens are the port's generate, held to the reference's there)."""
    argv = ["--batch", "3", "--max-new", "8", "--tiles", str(tiles)]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    JS.main()
    ref = _summary(capsys.readouterr().out)
    cfg = get_config("llama3.2-1b").smoke
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, JLM.init_lm(
            jax.random.PRNGKey(0), cfg, jnp.float32)),
        tget_config("llama3.2-1b").smoke, device="cpu")
    TS.main(argv + ["--device", "cpu"], params=params)
    got = _summary(capsys.readouterr().out)
    assert got == ref


# -- the training launcher ---------------------------------------------------

TRAIN_FLAGS = {
    "plain": [],
    "accum": ["--accum", "2"],
    "int8_ef": ["--grad-compression", "int8_ef"],
    "quantized_opt": ["--quantized-opt"],
    "logits_chunk": ["--logits-chunk", "8"],
    "deepseek": ["--arch", "deepseek-v2-lite-16b"],
}


@pytest.mark.parametrize("flags", list(TRAIN_FLAGS))
def test_train_main_runs_each_flag_set_on_cpu(flags, capsys, tmp_path):
    """20 steps at the default batch (8 × 32) and lr 1e-2: the last
    three steps' mean loss below the first step's."""
    out = TT.main(["--device", "cpu", "--steps", "20", "--lr", "1e-2",
                   "--ckpt-dir", str(tmp_path / "ck")] + TRAIN_FLAGS[flags])
    text = capsys.readouterr().out
    assert out["start_step"] == 0 and out["end_step"] == 20
    assert sorted(out["losses"]) == list(range(1, 21))
    assert all(np.isfinite(v) for v in out["losses"].values())
    assert np.mean([out["losses"][s] for s in (18, 19, 20)]) < \
        out["losses"][1]
    assert re.search(r"^step +10 loss \d+\.\d{4} gnorm", text, re.M)
    assert "done at step 20." in text
    assert (tmp_path / "ck" / "step_00000020" / "COMMIT").exists()


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_train_mesh_is_refused(mesh, capsys):
    """Without the production mesh's ranks started (torchrun), the mesh is
    refused, naming the ranks it needs."""
    with pytest.raises(SystemExit) as e:
        TT.main(["--device", "cpu", "--mesh", mesh])
    assert e.value.code != 0
    need = 256 if mesh == "single" else 512
    assert f"needs {need} devices, have 1" in capsys.readouterr().err


def test_train_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.main(["--steps", "1"])


def test_train_preempted_and_resumed_equals_uninterrupted(tmp_path, capsys):
    """SIGINT at step 7 (checkpoints every 3): the loop commits step 7 and
    stops; started again with the same --ckpt-dir it resumes at 7 and its
    losses for steps 8–16 are the uninterrupted run's."""
    import signal
    argv = ["--device", "cpu", "--steps", "16", "--batch", "4", "--seq",
            "16", "--ckpt-every", "3"]
    ref = TT.main(argv + ["--ckpt-dir", str(tmp_path / "ref")])

    def stop_at_7(s, m):
        if s == 7:
            signal.raise_signal(signal.SIGINT)

    d = ["--ckpt-dir", str(tmp_path / "run")]
    first = TT.main(argv + d, on_metrics=stop_at_7)
    assert first["end_step"] == 7
    assert "stopped at step 7" in capsys.readouterr().out
    second = TT.main(argv + d)
    assert second["start_step"] == 7 and second["end_step"] == 16
    assert "resumed from committed step 7" in capsys.readouterr().out
    assert {**first["losses"], **second["losses"]} == ref["losses"]


def test_train_losses_match_the_reference_step(tmp_path):
    """On the reference's init (``init_lm(PRNGKey(0))``, converted), the
    launcher's losses are those of the reference's jitted train step under
    the same TrainConfig (the reference launcher's: lr 5e-3, warmup
    steps/10) and the same batches."""
    from repro.train.data import DataConfig as JDC, DataPipeline as JDP
    from repro.train.optimizer import AdamWConfig as JAdamW
    from repro.train.steps import TrainConfig as JTC
    from repro.train.steps import init_train_state, make_train_step
    cfg = get_config("llama3.2-1b").smoke
    params = JLM.init_lm(jax.random.PRNGKey(0), cfg, jnp.float32)
    steps = 8
    jt = JTC(optimizer=JAdamW(lr=5e-3, warmup_steps=max(steps // 10, 1),
                              total_steps=steps))
    state = init_train_state(params, jt)
    step = jax.jit(make_train_step(cfg, jt))
    data = JDP(JDC(vocab_size=cfg.vocab_size, batch=4, seq_len=16))
    want = {}
    for i in range(steps):
        state, m = step(state, data.batch_at(i))
        want[i + 1] = float(m["loss"])
    got = TT.main(["--device", "cpu", "--steps", str(steps), "--batch", "4",
                   "--seq", "16", "--ckpt-dir", str(tmp_path / "ck")],
                  params=convert.params_from_numpy(
                      jax.tree_util.tree_map(np.asarray, params),
                      tget_config("llama3.2-1b").smoke, device="cpu"))
    for s in want:
        assert got["losses"][s] == pytest.approx(want[s], rel=1e-5), s
