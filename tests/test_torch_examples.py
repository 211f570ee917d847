"""The port's examples, each run once on the CPU at its smallest settings
(``examples/torch_gptq_calibration.py``,
``examples/torch_fault_tolerant_train.py``)."""
import importlib.util
from pathlib import Path

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
