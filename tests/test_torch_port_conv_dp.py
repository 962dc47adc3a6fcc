"""The fused conv tower over several data ranks (``-pallas_conv
-data_parallel N``: DP-13-14, DP-13-14-bf16) on the CPU.

  * the tower's plain versions on 2 gloo ranks, each its samples' rows,
    the BatchNorm statistics summed over the data ranks (``plan``), against
    the single-process tower on every row: the output by rows, mus and vars,
    and every gradient (x0's by rows, the weights' summed over the ranks),
    within 1e-5 relative in f32; in bf16 the output within 8e-3 of its max
    and the gradients within 1e-2 (tensors below 1e-2 on both sides, a conv
    bias before its BatchNorm, whose true gradient is 0, held to 1e-2
    absolutely: ROADMAP C7). An internal first conv and an external one,
    each in f32 and bf16;
  * the MOD_TINY DeepSense ``-pallas_conv`` pretrain step at dp 2 against
    the single-process step (every drop rate 0, SGD), f32: the loss within
    rtol 1e-4, the state within rtol 3e-3 and atol 1e-5, the ranks' states
    identical.
One spawn runs every check.
"""

import numpy as np
import pytest

import torch_port_dist_workers as workers
from focal_tpu_torch.parallel import distributed
from torch_port_threads import one_torch_thread  # noqa: F401

CASES = [workers.tower_case(seed, 6, 7, 16, 3, 3, external, dtype)
         for seed, (external, dtype) in enumerate([(False, "float32"), (True, "float32"),
                                                   (False, "bfloat16"), (True, "bfloat16")])]
STEP = dict(model_name="DeepSense", flags=["-pallas_conv"])


@pytest.fixture(scope="module")
def ranks():
    return distributed.run_local(workers.rank_conv_dp, 2, CASES, [STEP])


def _check(got, want, bf16, name, zero=False):
    """Within the tolerance of max|want|; ``zero`` (a conv bias before its
    BatchNorm: a true gradient of 0, noise on both sides, C7) and in bf16
    tensors below 1e-2 on both sides absolutely: 1e-4 in f32, 1e-2 in
    bf16."""
    err = float(np.abs(got - want).max())
    top = max(float(np.abs(want).max()), float(np.abs(got).max()))
    if zero or (bf16 and top < 1e-2):
        assert err <= (1e-2 if bf16 else 1e-4), (name, err)
        return
    tol = (8e-3 if name == "a" else 1e-2) if bf16 else 1e-5
    assert err <= tol * float(np.abs(want).max()), (name, err / float(np.abs(want).max()))


@pytest.mark.parametrize("c_index", range(len(CASES)))
def test_tower_over_data_ranks_matches_one_process(ranks, c_index):
    case = CASES[c_index]
    bf16 = case["dtype"] == "bfloat16"
    single = workers.tower_result(case)
    parts = [r[0][c_index] for r in ranks]
    a = np.concatenate([p["a"] for p in parts])
    _check(a, single["a"], bf16, "a")
    for p in parts:
        for k in ("mus", "vars"):
            for i, (g, w) in enumerate(zip(p[k], single[k])):
                _check(g, w, bf16, f"{k}{i}")
    _check(np.concatenate([p["grads"][0] for p in parts]), single["grads"][0], bf16, "dx0")
    L = len(case["cfgs"])
    for i, w in enumerate(single["grads"][1:], start=1):
        if w is None:  # an external first conv's placeholder weight
            continue
        _check(sum(p["grads"][i] for p in parts), w, bf16, f"grad{i}",
               zero=L < i <= 2 * L)  # the conv biases


def test_pallas_conv_step_at_dp2_matches_single_process(ranks):
    single = workers.step_result(**STEP)
    results = [r[1][0] for r in ranks]
    for r in results:
        assert np.isclose(r["loss"], single["loss"], rtol=1e-4), (r["loss"], single["loss"])
    for name, want in single["state"].items():
        np.testing.assert_allclose(results[0]["state"][name], want, rtol=3e-3, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_array_equal(results[1]["state"][name], results[0]["state"][name],
                                      err_msg=name)
