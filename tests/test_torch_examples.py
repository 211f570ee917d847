"""The port's examples, each run once on the CPU at its smallest settings
(``examples/torch_gptq_calibration.py``,
``examples/torch_fault_tolerant_train.py``), and the quickstart and the
batched-serving example as they are (``examples/torch_quickstart.py``,
``examples/torch_serve_batched.py``)."""
import importlib.util
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gptq_calibration_example_runs(capsys):
    """A 30-step trained smoke model at 4 bits: every scheme's loss is
    printed and finite, within 0.1 of the f32 loss.  (Which scheme wins
    is not asserted: the example calibrates on the final hidden states,
    the reference example's stand-in for each projection's inputs.)"""
    out = _example("torch_gptq_calibration").main(
        ["--device", "cpu", "--steps", "30"])
    text = capsys.readouterr().out
    for scheme in ("naive-per-tensor", "naive-per-channel", "gptq"):
        assert f"{scheme}" in text
        assert abs(out[scheme] - out["fp32"]) < 0.1, out


def test_fault_tolerant_train_example_runs(tmp_path, capsys):
    out = _example("torch_fault_tolerant_train").main(
        ["--device", "cpu", "--steps", "20", "--ckpt-dir",
         str(tmp_path / "ck")])
    text = capsys.readouterr().out
    assert out["resumed_at"] == 10 and out["restored_at"] == 20
    assert "resumed from committed step 10" in text


def test_quickstart_example_runs(capsys):
    """The reference quickstart's recipe (100 steps, both packing modes,
    12 tokens for 2 prompts): on the CPU the compressed and quant tokens
    agree token for token (the example's own assertion), and every
    compressed weight decodes to the quant state's int8 values."""
    out = _example("torch_quickstart").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert out["exact"] and not out["codec_mismatch"]
    assert out["codec_weights"] > 0
    assert out["compressed"].shape == (2, 16 + 12)
    assert "matches quantized model exactly: True" in text
    assert "trained 100 steps" in text


@pytest.mark.parametrize("mode", ["compressed", "quant", "dense"])
def test_serve_batched_example_runs(mode, capsys):
    """8 requests of 8–24 tokens left-padded into one batch: prefill ms,
    eager and graph-step tokens/s reported, and the graph-step tokens
    equal to the eager loop's (on the CPU both run eagerly)."""
    out = _example("torch_serve_batched").main(
        ["--device", "cpu", "--mode", mode])
    text = capsys.readouterr().out
    assert out["batch"] == 8 and 8 <= out["prompt_len"] <= 24
    assert out["tokens"].shape == (8, 16)
    assert out["prefill_ms"] > 0 and out["tok_s"] > 0
    assert "graphed tokens equal the eager loop's: True" in text
