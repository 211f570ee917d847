"""The port's dry run at full size on the CPU: ``decode_32k`` on the 16×16
mesh for every assigned arch (one fake decode step each, planned in this
process by ``run_cell``), and the CLI on one cell.

  * Each arch's record is ok, with the reference's keys, the planned card
    and the kernels' launches; its memory adds up as the reference's
    ``total_hbm_bytes`` does; the rank's caches are its share under the
    reference's ``make_cache_specs`` (the Mamba2 state and conv window
    included: none is kept whole on model) and it serves its 8 of the
    batch's 128 rows.
  * ``python -m repro_torch.launch.dryrun`` on internlm2-1.8b writes that
    record; a second run skips it as cached; the CLI never imports JAX.
"""
import json
import os
import subprocess
import sys
import tempfile

import pytest

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.kernels import _build
from repro_torch.launch import dryrun as D
from repro_torch.sharding import partition as PT

RECORD_KEYS = {"arch", "shape", "mesh", "mode", "ok", "memory", "cost",
               "collectives", "wall_s", "kernels", "planned"}
PLANNED = {"device": "cuda:0", "card": "H100 SXM", "sms": 132,
           "hbm_bytes": 80 * 10 ** 9}
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _check_record(rec):
    assert rec["ok"], (rec.get("error"), rec.get("traceback"))
    assert RECORD_KEYS <= set(rec)
    assert rec["planned"] == PLANNED
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] > 0
    assert mem["total_hbm_bytes"] == (
        mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
        + mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"])
    assert rec["cost"]["flops"] > 0
    assert rec["kernels"]
    assert sum(v["launches"] for v in rec["kernels"].values()) == \
        sum(rec["launches"].values())


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_full_size_decode_plan(arch):
    """decode_32k on the 16×16 mesh at full size: one fake decode step of
    rank 0, every kernel launch planned."""
    rec = D.run_cell(arch, "decode_32k", multi_pod=False)
    _check_record(rec)
    assert rec["collectives"]["total_bytes"] > 0
    assert _build.PLAN is None
    # the rank's caches are its share under the reference's
    # make_cache_specs: the Mamba2 state by heads and its conv window by
    # channels too, since the 16 model ranks divide both SSM configs'
    # heads and B/C width (partition.ssm_split), so no leaf is named as
    # kept whole on model
    cfg = get_config(arch).full
    if cfg.family in ("ssm", "hybrid"):
        assert PT.ssm_split(cfg, 16)
    assert rec["cache_whole_on_model"] == {}
    assert rec["cache_bytes"] == rec["reference_cache_bytes"]
    assert rec["batch_rows"] == 128 // 16


_CLI = ("import runpy, sys; sys.argv = ['dryrun'] + sys.argv[1:]; "
        "runpy.run_module('repro_torch.launch.dryrun', run_name='__main__');"
        " assert 'jax' not in sys.modules, 'the dry run imported jax'")


def _cli(out):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-c", _CLI, "--arch", "internlm2-1.8b", "--shape",
         "decode_32k", "--mesh", "single", "--out", out], env=env,
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    return run.stdout


def test_cli_writes_the_record_then_skips_it_cached():
    """The CLI writes internlm2-1.8b's decode_32k record; run again, it
    skips the cached ok record."""
    with tempfile.TemporaryDirectory() as out:
        text = _cli(out)
        assert "[OK] internlm2-1.8b decode_32k single" in text, text
        with open(os.path.join(
                out, "internlm2-1.8b__decode_32k__single__compressed.json")) \
                as f:
            _check_record(json.load(f))
        assert "[skip cached]" in _cli(out)
