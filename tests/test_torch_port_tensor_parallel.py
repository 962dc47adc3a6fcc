"""Tensor parallelism of the port on the CPU (``-model_parallel``): the
rules against the JAX package's, #4-TP/#5-TP's plain versions across gloo
processes against the JAX ``sharded_window_block_tp``, and the
SW_Transformer step across processes against the single-process one.

  * the rules: ``parallel.tp.sharded_leaf_count`` equals the JAX
    ``tp.sharded_leaf_count`` over the same model's params (drawn by
    ``jax.eval_shape``) wherever the heads divide by mp;
  * #4-TP/#5-TP: ``sharded_window_block_tp`` on 2 ranks (mp 2) and on 4
    (dp 2 x mp 2), each with its windows and heads of whole inputs, against
    the JAX wrapper on a (1, 2) and a (2, 2) mesh of the virtual CPU
    devices, its kernels in interpret mode (rate 0, N 9, H 4, a shift mask
    of nW 4). y and dx come back whole from the ranks' rows; each weight
    gradient is the data ranks' sum of the rank's slice. Tolerance,
    max|port - ref| / max|ref| per tensor: 1e-5 against the JAX wrapper at
    C 64. At C 128 the JAX kernel computes in bf16 (ROADMAP C13) and is
    itself up to 1.7e-2 off the exact (float64) block on these inputs (dx;
    y 9.4e-3): there the port is held within 1e-5 of the exact block, as
    the plain whole-block function in float64 gives it, and within 2e-2 of
    the JAX wrapper;
  * the MOD_TINY SW_Transformer pretrain and supervised steps at mp 2, and
    the pretrain step at dp 2 x mp 2, against the single-process step, with
    the DP tolerances (tests/test_torch_port_parallel.py): the loss within
    rtol 1e-4, the parameters within rtol 3e-3, atol 1e-5, every rank's
    whole parameters identical;
  * dropout at mp 2 (and dp 2 x mp 2): one step at the recipe's rates on
    the plain attention route. The masks of what the model ranks split
    (the attention weights of their heads, their columns of each Swin MLP's
    hidden layer: the calls whose input is smaller than one process's) differ
    between the two model ranks, and together keep 205/256 of the entries
    (remat_dropout's realised keep rate) within 0.01; the masks of what they
    hold whole agree.
One spawn a layout runs every check of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dist_workers as workers
from focal_tpu.models.sw_transformer import SWTransformer as JaxSWTransformer
from focal_tpu.models.swin import shifted_window_mask
from focal_tpu.ops.pallas_kernels import expand_bias_lanes, sharded_window_block_tp
from focal_tpu.parallel import tp as jax_tp
from focal_tpu.parallel.mesh import make_mesh_plan as jax_mesh_plan
from focal_tpu_torch.models import build_backbone
from focal_tpu_torch.ops import pallas_kernels as pk
from focal_tpu_torch.parallel import distributed, tp
from focal_tpu_torch.params import load_dataset_config
from torch_port_threads import one_torch_thread  # noqa: F401

H, N, NW, SAMPLES = 4, 9, 4, 4
WIDTHS = (64, 128)
STEPS = {"pretrain": dict(model_name="SW_Transformer"),
         "supervised": dict(model_name="SW_Transformer", supervised=True)}
LAYOUTS = {"mp2": (2, 2), "dp2xmp2": (4, 2)}  # (world, mp)


def _case(C, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: (s * rng.normal(size=shape)).astype(np.float32)  # noqa: E731
    return {"x": f(SAMPLES * NW, N, C), "wqkv": f(C, 3 * C, s=C**-0.5), "bqkv": f(3 * C, s=0.1),
            "wproj": f(C, C, s=C**-0.5), "bproj": f(C, s=0.1), "rel_bias": f(H, N, N, s=0.1),
            "mask": shifted_window_mask(6, 6, 3, 3, 1, 1).astype(np.float32),
            "dy": f(SAMPLES * NW, N, C)}


CASES = [_case(C, i) for i, C in enumerate(WIDTHS)]


@pytest.fixture(scope="module")
def ranks():
    """{layout: (block results per rank, step results per rank)}."""
    out = {}
    for name, (world, mp) in LAYOUTS.items():
        steps = list(STEPS.values()) if name == "mp2" else [STEPS["pretrain"]]
        out[name] = distributed.run_local(workers.rank_tp, world, mp, CASES, steps)
    return out


def _jax_block(case, dp, mp):
    """(y, dx, dwqkv [C, 3C], dbqkv, dwproj, dbproj, d rel_bias) of the JAX
    sharded_window_block_tp on a (dp, mp) mesh."""
    C = case["x"].shape[-1]
    hd = C // H
    plan = jax_mesh_plan(dp, mp)
    mask = jnp.asarray(case["mask"])

    def f(x, wqkv, bqkv, wproj, bproj, rel_bias):
        bias_l = expand_bias_lanes(rel_bias, mask)
        return sharded_window_block_tp(plan.mesh, x, wqkv.reshape(C, 3, H, hd),
                                       bqkv.reshape(3, H, hd), wproj, bproj, bias_l)

    args = [jnp.asarray(case[k]) for k in ("x", "wqkv", "bqkv", "wproj", "bproj", "rel_bias")]
    y, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(case["dy"]))
    return [np.asarray(t) for t in (y, *grads)]


def _assemble(results, case, dp):
    """The ranks' shards put back whole: y and dx by rows, the weight
    gradients summed over the data ranks into their heads' places."""
    C = case["x"].shape[-1]
    y, dx = np.zeros_like(case["x"]), np.zeros_like(case["x"])
    dw = {"wqkv": np.zeros((C, 3 * C), np.float32), "bqkv": np.zeros(3 * C, np.float32),
          "wproj": np.zeros((C, C), np.float32), "bproj": np.zeros(C, np.float32),
          "rel_bias": np.zeros((H, N, N), np.float32)}
    for r in results:
        y[r["lo"]:r["hi"]] = r["y"]
        dx[r["lo"]:r["hi"]] = r["dx"]
        dw["wqkv"][:, r["cols"]] += r["dwqkv"]
        dw["bqkv"][r["cols"]] += r["dbqkv"]
        dw["wproj"][r["rows"]] += r["dwproj"]
        dw["rel_bias"][r["heads"]] += r["drel_bias"]
    # dbproj: the same on every model rank; sum the data ranks' of model rank 0
    mp = len(results) // dp
    dw["bproj"] = sum(r["dbproj"] for r in results[::mp])
    return [y, dx, dw["wqkv"], dw["bqkv"], dw["wproj"], dw["bproj"], dw["rel_bias"]]


def _exact_block(case):
    """The same outputs of the whole block in float64 (the plain versions of
    #1/#3 on every head at once)."""
    t = {k: torch.from_numpy(case[k]).double() for k in case}
    args = [t[k] for k in ("x", "wqkv", "bqkv", "wproj", "bproj", "rel_bias", "mask")]
    y = pk.fused_window_block_reference(*args)
    grads = pk.fused_window_block_backward_reference(*args, t["dy"])
    return [v.numpy() for v in (y, *grads)]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("c_index", range(len(WIDTHS)))
def test_tp_block_plain_matches_jax(ranks, layout, c_index):
    world, mp = LAYOUTS[layout]
    case = CASES[c_index]
    got = _assemble([r[0][c_index] for r in ranks[layout]], case, world // mp)
    refs = [(_jax_block(case, world // mp, mp), 1e-5 if WIDTHS[c_index] < 128 else 2e-2)]
    if WIDTHS[c_index] >= 128:
        refs.append((_exact_block(case), 1e-5))
    names = ("y", "dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "drel_bias")
    for want, tol in refs:
        for name, g, w in zip(names, got, want):
            err = float(np.abs(g - w).max() / np.abs(w).max())
            assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("layout,step", [("mp2", "pretrain"), ("mp2", "supervised"),
                                         ("dp2xmp2", "pretrain")])
def test_tp_step_matches_single_process(ranks, layout, step):
    single = workers.step_result(**STEPS[step])
    results = [r[1][list(STEPS).index(step) if layout == "mp2" else 0] for r in ranks[layout]]
    for r in results:
        assert np.isclose(r["loss"], single["loss"], rtol=1e-4), (r["loss"], single["loss"])
    for name, want in single["state"].items():
        np.testing.assert_allclose(results[0]["state"][name], want, rtol=3e-3, atol=1e-5,
                                   err_msg=name)
        for r in results[1:]:
            np.testing.assert_array_equal(r["state"][name], results[0]["state"][name],
                                          err_msg=name)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_dropout_masks_split_with_the_tensor(ranks, layout):
    world, mp = LAYOUTS[layout]
    # one process's calls on [rows, N, width] tensors, in order (its attention drops in
    # the kernel); a data rank's have fewer rows, a model rank's split ones less width
    single = [call[0] for call in workers.dropout_masks() if len(call[0]) == 3]
    for d in range(world // mp):
        a, b = (ranks[layout][d * mp + m][2] for m in range(2))
        assert [c[0] for c in a] == [c[0] for c in b]
        assert len(single) == sum(len(c[0]) == 3 for c in a)
        split, flat = 0, iter(single)
        for i, (ca, cb) in enumerate(zip(a, b)):
            (shape, seed_a, valid_a, keep_a), (_, seed_b, valid_b, keep_b) = ca, cb
            if len(shape) == 3 and shape[-1] == next(flat)[-1]:  # held whole: one mask
                assert seed_a == seed_b and np.array_equal(keep_a, keep_b), (i, shape)
                continue
            split += 1
            assert seed_a != seed_b, (i, shape)
            both = valid_a & valid_b
            assert not np.array_equal(keep_a[both], keep_b[both]), (i, shape)
            kept = (keep_a[valid_a].sum() + keep_b[valid_b].sum()) / (valid_a.sum() + valid_b.sum())
            assert abs(kept - 205 / 256) <= 0.01, (i, shape, kept)
        assert split >= 2 * 4, split  # a rank's heads and hidden columns in each Swin block


@pytest.mark.parametrize("dataset,mp", [("MOD_TINY", 2), ("MOD", 2), ("MOD", 4)])
def test_sharded_leaf_count_matches_jax(dataset, mp):
    cfg = load_dataset_config(dataset)
    with torch.device("meta"):
        model = build_backbone(cfg, "SW_Transformer", "vehicle_classification", "FOCAL")
    x = {loc: {mod: jnp.zeros((2, cfg["loc_mod_in_freq_channels"][loc][mod],
                               cfg["num_segments"], cfg["loc_mod_spectrum_len"][loc][mod]))
               for mod in cfg["loc_modalities"][loc]} for loc in cfg["location_names"]}
    jmodel = JaxSWTransformer(dataset_config=cfg, task="vehicle_classification")
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.key(0)}, x, train=False, head="both"))
    want = jax_tp.sharded_leaf_count({"params": shapes["params"]}, jax_mesh_plan(1, mp))
    got = tp.sharded_leaf_count(model, mp)
    assert got == want > 0, (got, want)
