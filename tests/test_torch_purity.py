"""The port imports torch and never jax or the JAX package ``repro``; so does
``chip_smoke.py``.  Checked in fresh interpreters, since this test process
has imported both."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _run(code: str, cwd=ROOT) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


_CHECK = """
import sys
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in {forbidden!r})
assert not bad, bad
print('clean', len([m for m in sys.modules if m.startswith('repro_torch')]))
"""


# modules of the MoE slice, of request-level serving, of integrity and
# resilience, of tiered residency and the governor, of the serving
# launcher and its data pipeline, of training and calibration, of the
# other decoder-only families, of the encoder–decoder, of serving on a
# mesh and of training on one, and of the dry run (with the compressed
# planners of core.compressed), which the walk below must reach
MOE_MODULES = ("repro_torch.configs.deepseek_v2_lite_16b",
               "repro_torch.kernels.dict_decode",
               "repro_torch.serve.kv_cache", "repro_torch.serve.resilience",
               "repro_torch.serve.scheduler", "repro_torch.core.integrity",
               "repro_torch.testing.faults", "repro_torch.serve.residency",
               "repro_torch.serve.governor", "repro_torch.core.policy",
               "repro_torch.launch.serve", "repro_torch.train.data",
               "repro_torch.core.quant", "repro_torch.core.gptq",
               "repro_torch.core.lzw", "repro_torch.core.codec",
               "repro_torch.train.optimizer", "repro_torch.train.steps",
               "repro_torch.train.tree", "repro_torch.train.checkpoint",
               "repro_torch.train.fault", "repro_torch.train.trained",
               "repro_torch.launch.train", "repro_torch.models.ssm",
               "repro_torch.models.frontends",
               "repro_torch.configs.mamba2_2_7b",
               "repro_torch.configs.zamba2_1_2b",
               "repro_torch.configs.qwen3_4b",
               "repro_torch.configs.qwen2_7b",
               "repro_torch.configs.internlm2_1_8b",
               "repro_torch.configs.internvl2_2b",
               "repro_torch.configs.llama3_405b",
               "repro_torch.configs.kimi_k2_1t_a32b",
               "repro_torch.models.encdec",
               "repro_torch.configs.seamless_m4t_medium",
               "repro_torch.launch.mesh", "repro_torch.sharding.partition",
               "repro_torch.testing.routes", "repro_torch.launch.specs",
               "repro_torch.launch.dryrun", "repro_torch.launch.op_stats",
               "repro_torch.core.compressed")


def test_port_imports_no_jax_and_no_reference():
    code = """
import pkgutil, importlib, sys, repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):
    importlib.import_module(m.name)
missing = [m for m in {moe!r} if m not in sys.modules]
assert not missing, missing
""".format(moe=MOE_MODULES) + _CHECK.format(forbidden=FORBIDDEN)
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 39   # every submodule was loaded


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("name", sorted(
    p.name for p in (ROOT / "examples").glob("torch_*.py")))
def test_example_imports_no_jax_and_no_reference(name):
    """The port's examples (the quickstart and the batched-serving example
    among them) import the port alone, in a fresh process."""
    names = _imports(ROOT / "examples" / name)
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN], names
    assert any(n.startswith("repro_torch") for n in names)
    code = "\n".join(f"import {n}" for n in sorted(names)) + \
        _CHECK.format(forbidden=FORBIDDEN)
    out = _run(code)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("name", ["torch_mesh_worker",
                                  "torch_mesh_train_worker"])
def test_mesh_worker_imports_no_jax_and_no_reference(name):
    """What the spawned ranks of the mesh tests import by name."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
            f"import {name}" + _CHECK.format(forbidden=FORBIDDEN))
    out = _run(code)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_imports_no_jax_and_no_reference():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN], names
    assert any(n.startswith("repro_torch") for n in names)
    # everything chip_smoke imports, in one fresh process
    code = "\n".join(f"import {n}" for n in sorted(names)) + \
        _CHECK.format(forbidden=FORBIDDEN)
    out = _run(code)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """Without CUDA (this host), or alone in a directory, it exits non-zero
    and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env=dict(os.environ, PYTHONPATH=""))
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
