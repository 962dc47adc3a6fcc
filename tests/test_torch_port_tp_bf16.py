"""#4-TP-bf16/#5-TP-bf16 and the bf16 SW_Transformer step under tensor
parallelism (``-compute_dtype bfloat16 -model_parallel N``) on the CPU.

  * the block: ``sharded_window_block_tp`` fed bf16 x and dy (the plain
    versions of #4-TP-bf16/#5-TP-bf16 on each rank, the f32 weights rounded
    inside, y and dx summed in f32 over the model ranks and rounded once) on
    2 ranks (mp 2) and on 4 (dp 2 x mp 2), against the JAX
    ``sharded_window_block_tp`` fed bf16 (x, wqkv and wproj bf16) on a
    (1, 2) and a (2, 2) mesh of the virtual CPU devices, its kernels in
    interpret mode, at rate 0, N 9, H 4, a shift mask of nW 4, C 64 and 128.
    y within 8e-3 of max|y|, each gradient within 1e-2 of its max;
  * the MOD_TINY bf16 SW_Transformer pretrain step at mp 2 (every drop rate
    0, SGD) against the single-process bf16 step, with C11's gates (PERF.md
    §2): the loss within 1e-2 relative, every parameter's gradient (the
    update over the learning rate) at cosine >= 0.9 to the single process's
    and the median over the tensors of ||g - g_single|| / ||g_single|| at
    most 5e-2; every rank's whole state identical.
One spawn a layout runs every check of it.
"""

import statistics

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dist_workers as workers
from focal_tpu.ops.pallas_kernels import expand_bias_lanes, sharded_window_block_tp
from focal_tpu.parallel.mesh import make_mesh_plan as jax_mesh_plan
from focal_tpu_torch.models import build_backbone, init_params
from focal_tpu_torch.parallel import distributed
from test_torch_port_tensor_parallel import CASES, H, LAYOUTS, _assemble
from torch_port_threads import one_torch_thread  # noqa: F401

STEP = dict(model_name="SW_Transformer", flags=["-compute_dtype", "bfloat16"])


@pytest.fixture(scope="module")
def ranks():
    """{layout: per rank (block results, step results)}."""
    return {name: distributed.run_local(workers.rank_tp_bf16, world, mp, CASES,
                                        [STEP] if name == "mp2" else [])
            for name, (world, mp) in LAYOUTS.items()}


def _jax_block_bf16(case, dp, mp):
    """(y, dx, dwqkv [C, 3C], dbqkv, dwproj, dbproj, d rel_bias) of the JAX
    sharded_window_block_tp fed bf16 x, wqkv, wproj and dy on a (dp, mp)
    mesh, as f32 numpy arrays."""
    C = case["x"].shape[-1]
    hd = C // H
    plan = jax_mesh_plan(dp, mp)
    mask = jnp.asarray(case["mask"])
    bf16 = jnp.bfloat16

    def f(x, wqkv, bqkv, wproj, bproj, rel_bias):
        bias_l = expand_bias_lanes(rel_bias, mask)
        return sharded_window_block_tp(plan.mesh, x, wqkv.reshape(C, 3, H, hd),
                                       bqkv.reshape(3, H, hd), wproj, bproj, bias_l)

    args = [jnp.asarray(case[k]).astype(bf16 if k in ("x", "wqkv", "wproj") else jnp.float32)
            for k in ("x", "wqkv", "bqkv", "wproj", "bproj", "rel_bias")]
    y, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(case["dy"]).astype(y.dtype))
    return [np.asarray(t.astype(jnp.float32)) for t in (y, *grads)]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("c_index", range(len(CASES)))
def test_tp_bf16_block_plain_matches_jax(ranks, layout, c_index):
    world, mp = LAYOUTS[layout]
    case = CASES[c_index]
    got = _assemble([r[0][c_index] for r in ranks[layout]], case, world // mp)
    want = _jax_block_bf16(case, world // mp, mp)
    names = ("y", "dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "drel_bias")
    for name, g, w in zip(names, got, want):
        err = float(np.abs(g - w).max() / np.abs(w).max())
        assert err <= (8e-3 if name == "y" else 1e-2), (name, err)


def test_tp_bf16_step_matches_single_process(ranks):
    single = workers.step_result(**STEP)
    results = [r[1][0] for r in ranks["mp2"]]
    args = workers._args("SW_Transformer", False, flags=STEP["flags"])
    model = init_params(build_backbone(args.dataset_config, "SW_Transformer", args.task,
                                       args.learn_framework), seed=0)
    init = {k: v.numpy() for k, v in model.state_dict().items()}
    for r in results:
        assert abs(r["loss"] - single["loss"]) <= 1e-2 * abs(single["loss"]), (r["loss"],
                                                                                single["loss"])
    rels, trained = [], 0
    for name, p in model.named_parameters():
        want = (init[name] - single["state"][name]).astype(np.float64)
        got = (init[name] - results[0]["state"][name]).astype(np.float64)
        for r in results[1:]:
            np.testing.assert_array_equal(r["state"][name], results[0]["state"][name],
                                          err_msg=name)
        if not np.any(want) and not np.any(got):
            continue  # frozen or untouched
        trained += 1
        cos = float((got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want)))
        assert cos >= 0.9, (name, cos)
        rels.append(float(np.linalg.norm(got - want) / np.linalg.norm(want)))
    assert trained > 50 and statistics.median(rels) <= 5e-2, (trained, statistics.median(rels))
