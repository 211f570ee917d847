"""The decode-row plans of K1/K3 and K5 above 16 rows, as pure functions.

A decode step's rows (one token a request) must have the bits each has
alone at any batch, so above 16 rows ``launch_plan`` and ``dequant_plan``
give the decode kernels' plan in groups of at most 16 (K1/K3: ⌈M/16⌉
launches of the 16-row plan) or 4 (K5: ⌈M/4⌉ launches) rows; a prefill of
the same M (one request's tokens) keeps the tensor-core kernel.  Exact
equalities: these are integers and plans.
"""
import pytest

from repro_torch.kernels import dequant_matmul as dqm
from repro_torch.kernels import fused_decode_matmul as fdm

SMS = 132                                    # H100 SXM

# (N, K, tile_k, E, slots): Llama-3.2-1B's q_proj and down_proj, DeepSeek-
# V2-Lite's expert stacks (E = 64) and a smoke width
K1_SHAPES = [(2048, 2048, 64, 1, 1024), (2048, 8192, 128, 1, 1024),
             (1408, 2048, 32, 64, 512), (2048, 1408, 64, 64, 1024),
             (64, 64, 16, 1, 256)]


@pytest.mark.parametrize("m", [17, 20, 24, 32, 33, 48, 64])
@pytest.mark.parametrize("n,k,tile_k,e,slots", K1_SHAPES)
def test_launch_plan_decode_rows_above_16(m, n, k, tile_k, e, slots):
    """At decode M = 17–64 the plan is the 16-row decode plan with
    ⌈M/16⌉ row groups; at prefill the same M runs the tensor-core
    kernel."""
    plan = fdm.launch_plan(m, n, k, tile_k, e, SMS, slots, decode=True)
    sixteen = fdm.launch_plan(16, n, k, tile_k, e, SMS, slots)
    assert sixteen.kernel == "decode" and sixteen.row_groups == 1
    assert plan == sixteen._replace(row_groups=-(-m // 16))
    # its warps, and so every row's order of sums, are M = 1's
    assert plan.warps == fdm.launch_plan(1, n, k, tile_k, e, SMS,
                                         slots).warps
    prefill = fdm.launch_plan(m, n, k, tile_k, e, SMS, slots)
    assert prefill.kernel == "mma" and prefill.row_groups == 1


@pytest.mark.parametrize("m", [1, 4, 5, 16])
def test_launch_plan_decode_flag_changes_nothing_up_to_16(m):
    for n, k, tile_k, e, slots in K1_SHAPES:
        assert fdm.launch_plan(m, n, k, tile_k, e, SMS, slots,
                               decode=True) == fdm.launch_plan(
            m, n, k, tile_k, e, SMS, slots)


@pytest.mark.parametrize("m", [17, 24, 32, 64])
@pytest.mark.parametrize("n,k", [(128256, 2048), (102400, 2048),
                                 (512, 2048), (8192, 2048), (256, 64)])
def test_dequant_plan_decode_rows_above_16(m, n, k):
    """K5 at decode M = 17–64: the decode kernel, ⌈M/4⌉ launches of 4
    rows, the grid of M = 1; at prefill the tensor-core kernel."""
    plan = dqm.dequant_plan(m, n, k, SMS, decode=True)
    one = dqm.dequant_plan(1, n, k, SMS)
    assert plan.kernel == "decode"
    assert plan == one._replace(row_groups=-(-m // 4))
    assert dqm.dequant_plan(m, n, k, SMS) == dqm.mma_plan(m, n, k, SMS)


@pytest.mark.parametrize("m", [1, 3, 8, 16])
def test_dequant_plan_decode_flag_changes_nothing_up_to_16(m):
    for n, k in [(128256, 2048), (512, 2048), (256, 64), (300, 100)]:
        assert dqm.dequant_plan(m, n, k, SMS, decode=True) == \
            dqm.dequant_plan(m, n, k, SMS)
