"""Data parallelism of the port on the CPU: a step on two gloo processes
(``-data_parallel 2``) against the port's single-process step.

MOD_TINY, every drop rate 0, SGD at lr 0.05 (the update is then linear in
the gradient, so the two are comparable; one Adam step from zero moments is
about lr sign(g), which flips on reduction-order noise), the same seeded
init and the same views (every rank draws the global batch's views from the
step's host generator and keeps its rows). One spawn of two ranks runs every
case; the single-process steps run here.

Tolerances (both f32; the order of the sums only): the loss within rtol
1e-4; the updated parameters within rtol 1e-3 (DeepSense) or 3e-3
(SW_Transformer), atol 1e-5; DeepSense's BatchNorm running statistics, the
global batch's, within 1e-5; the two ranks' parameters identical.
"""

import numpy as np
import pytest
import torch

import torch_port_dist_workers as workers
from focal_tpu_torch.parallel import distributed
from focal_tpu_torch.parallel.mesh import SEED_STRIDE, make_mesh_plan
from focal_tpu_torch.train.state import TrainState
from torch_port_threads import one_torch_thread  # noqa: F401

CASES = {
    "sw_pretrain": dict(model_name="SW_Transformer"),
    "sw_pretrain_two_forwards": dict(model_name="SW_Transformer", fused=False),
    "sw_pretrain_no_pallas_block": dict(model_name="SW_Transformer", pallas_block=False),
    "ds_pretrain": dict(model_name="DeepSense"),
    "ds_supervised": dict(model_name="DeepSense", supervised=True),
    "sw_supervised": dict(model_name="SW_Transformer", supervised=True),
}
RTOL = {"SW_Transformer": 3e-3, "DeepSense": 1e-3}


@pytest.fixture(scope="module")
def dp2():
    """{case: (single-process result, [rank 0's, rank 1's])}."""
    configs = list(CASES.values())
    ranks = distributed.run_local(workers.rank_steps, 2, 1, configs)
    return {name: (workers.step_result(**cfg), [r[i] for r in ranks])
            for i, (name, cfg) in enumerate(CASES.items())}


@pytest.mark.parametrize("case", list(CASES))
def test_dp2_step_matches_single_process(dp2, case):
    single, ranks = dp2[case]
    rtol = RTOL[CASES[case]["model_name"]]
    for r in ranks:
        assert np.isclose(r["loss"], single["loss"], rtol=1e-4), (r["loss"], single["loss"])
    moved = 0
    for name, want in single["state"].items():
        got = ranks[0]["state"][name]
        if name.endswith(("mean", "var")):  # BatchNorm: the global batch's statistics
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5, err_msg=name)
        np.testing.assert_array_equal(ranks[1]["state"][name], got, err_msg=name)
        moved += 1
    assert moved == len(ranks[0]["state"])


def test_mesh_plan_raises_where_the_jax_one_does():
    """make_mesh_plan over a world of processes: None for one, the data axis
    filled by data_parallel=0, and the JAX package's refusals (plus a layout
    that leaves processes out)."""
    assert make_mesh_plan(0, 1, world=1, rank=0) is None
    plan = make_mesh_plan(0, 2, world=8, rank=5)
    assert (plan.dp, plan.mp, plan.d, plan.m) == (4, 2, 2, 1)
    assert plan.rows(16) == (8, 12)
    for dp, mp in ((0, 3), (8, 2), (2, 2)):
        with pytest.raises(ValueError):
            make_mesh_plan(dp, mp, world=8, rank=0)


def test_step_generators_of_a_shard():
    """TrainState's StepRngs on rank (2, 1) of a 4 x 2 layout: kernel seeds
    the single process's draw plus the data shard's (2) or, split, the
    (data, model) shard's (5) SEED_STRIDE; the device generator shared with
    the other model rank of the data rank, the split generator its own and
    unlike every device generator."""
    model = torch.nn.Linear(2, 2)
    plans = [make_mesh_plan(0, 2, world=8, rank=r) for r in (4, 5)]
    single = TrainState(model, None, seed=3, step=7).generators()
    rngs = lambda: [TrainState(model, None, seed=3, step=7, plan=p).generators()  # noqa: E731
                    for p in plans]
    draw = single.seed()
    assert [r.seed() for r in rngs()] == [draw + 2 * SEED_STRIDE] * 2
    assert [r.seed(split=True) for r in rngs()] == [draw + 4 * SEED_STRIDE,
                                                   draw + 5 * SEED_STRIDE]
    rngs = rngs()
    device = {r.device.initial_seed() for r in rngs}
    split = {r.split.initial_seed() for r in rngs}
    assert len(device) == 1 and len(split) == 2 and not device & split
    assert single.split is single.device
    one_model_rank = TrainState(model, None, seed=3, step=7,
                                plan=make_mesh_plan(0, 1, world=2, rank=1)).generators()
    assert one_model_rank.split is one_model_rank.device

