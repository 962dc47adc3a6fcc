"""The sharded train layout (-data_layout sharded) on the CPU.

  * over two gloo ranks, each holding only its rows of the global batch,
    the sharded step equals the single-process step fed the whole global
    batch: the loss within 1e-5 relative, the gradient of every parameter
    (summed over the ranks) within 1e-5 of its tensor's largest; one below
    1e-6 of the model's largest gradient on both sides, zero but for
    rounding (a conv bias before a BatchNorm, the fusion attention's key
    bias), within 1e-6 of the model's largest absolutely, as chip_smoke.py
    holds such gradients (C7); BatchNorm's running statistics within 1e-5,
    the ranks' parameters identical.
    The augmenters' draws are the global batch's on every rank: jitter's
    noise (forced, its draw the size of the batch) in pretraining, mixup's
    partners and soft targets across the ranks in supervised training; a
    GradCache step of two micro-batches on the layout too;
  * ``ShardedEvalPlan`` takes every row of every rank once (weight 1) and
    pads with weight 0, its labels the ranks' rows in rank order;
  * the layout's row assignment takes whole subsequences, the same on
    every rank, and a rank's permutation differs between ranks and epochs;
  * the training CLI pretrains at ``-data_parallel 2 -data_layout
    sharded`` on two processes, as a user starts them.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_port_dist_workers as workers
from focal_tpu_torch.data import load_split
from focal_tpu_torch.parallel import distributed
from focal_tpu_torch.parallel.mesh import MeshPlan
from focal_tpu_torch.params import parse_train_params
from focal_tpu_torch.train import loops
from focal_tpu_torch.train.evaluate import ShardedEvalPlan
from test_torch_port_distributed import COMMON, _folders, _run
from torch_port_threads import one_torch_thread  # noqa: F401

CASES = {
    "sw_pretrain_jitter": dict(model_name="SW_Transformer"),
    "ds_pretrain_jitter": dict(model_name="DeepSense"),
    "ds_supervised_mixup": dict(model_name="DeepSense", supervised=True),
    "sw_supervised_mixup": dict(model_name="SW_Transformer", supervised=True),
    "sw_gradcache": dict(model_name="SW_Transformer", accum=2),
}


@pytest.fixture(scope="module")
def sharded():
    """{case: (single-process result, [rank 0's, rank 1's])}."""
    configs = list(CASES.values())
    ranks = distributed.run_local(workers.rank_sharded, 2, configs)
    return {name: (workers.sharded_step(**cfg), [r[i] for r in ranks])
            for i, (name, cfg) in enumerate(CASES.items())}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_equals_the_single_process_step(sharded, case):
    single, ranks = sharded[case]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], single["loss"], rtol=1e-5)
    grads = single["grads"]
    largest = max(float(np.abs(g).max()) for g in grads.values())
    assert set(ranks[0]["grads"]) == set(grads)
    for name, want in grads.items():
        got = ranks[0]["grads"][name]
        err = float(np.abs(got - want).max())
        if max(float(np.abs(got).max()), float(np.abs(want).max())) < 1e-6 * largest:
            assert err <= 1e-6 * largest, (name, err)  # zero but for rounding
        else:
            assert err <= 1e-5 * float(np.abs(want).max()), (name, err)
    for name, want in single["state"].items():
        got = ranks[0]["state"][name]
        np.testing.assert_array_equal(ranks[1]["state"][name], got, err_msg=name)
        if name.endswith(("mean", "var")):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)


def test_sharded_eval_plan_takes_every_row_once():
    dp, n_local, batch = 2, 11, 8
    labels = np.arange(dp * n_local).reshape(dp, n_local)
    plan = ShardedEvalPlan(labels, batch, None, "cpu")
    L = batch // dp
    assert plan.idx.shape == (3, L) and plan.weight.shape == plan.labels.shape == (3, dp * L)
    taken = plan.labels[plan.weight > 0]
    assert sorted(taken.tolist()) == list(range(dp * n_local))
    assert plan.weight.sum() == dp * n_local and plan.local


def test_rows_go_to_the_ranks_in_whole_subsequences():
    """Run._shard on each of two data ranks: every sample of the kept
    subsequences on one rank only, a rank's subsequences stored whole and
    one after another, ``labels_grouped`` the same on both; each rank's
    epoch permutation keyed by its rank and the epoch."""
    args = parse_train_params(COMMON + ["-data_layout", "sharded"])
    split = load_split("train", args)
    seq_len = split.subseq_idx.shape[1]
    names, grouped = [], []
    for d in range(2):
        rank = SimpleNamespace(plan=MeshPlan(dp=2, mp=1, d=d, m=0), args=args)
        local = loops.Run._shard(rank, split)
        for sub in local.subseq_idx:
            seqs = {local.names[i].rsplit("_", 1)[0] for i in sub}
            assert len(seqs) == 1 and list(sub) == list(range(sub[0], sub[0] + seq_len))
        names += local.names
        grouped.append(rank.labels_grouped)
    assert len(names) == len(set(names)) == split.num_subseqs // 2 * 2 * seq_len
    np.testing.assert_array_equal(grouped[0], grouped[1])
    perm = lambda *keys: torch.randperm(8, generator=loops._generator(0, 1, *keys))  # noqa: E731
    assert not torch.equal(perm(0, 0), perm(0, 1)) and not torch.equal(perm(0, 0), perm(1, 0))


def test_cli_pretrains_at_dp2_on_the_sharded_layout(tmp_path):
    _run("focal_tpu_torch.train", COMMON + ["-epochs", "1", "-data_parallel", "2", "-data_layout",
                                            "sharded", "-output_dir", str(tmp_path)], world=2)
    names, base = _folders(tmp_path, "SW_Transformer")
    assert names == ["exp0_contrastive_FOCAL"], names
    exp = tmp_path / "weights" / "MOD_TINY_SW_Transformer" / names[0]
    log = (exp / "pretrain_log.txt").read_text()
    assert "(sharded)" in log and "val loss" in log
    latest = torch.load(exp / "MOD_TINY_SW_Transformer_pretrain_latest.pt", weights_only=True)
    assert all(torch.isfinite(v).all() for v in latest.values() if v.is_floating_point())
