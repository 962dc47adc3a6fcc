"""The attention-only route (``-no_pallas_block``) and the plain XLA route at
``-compute_dtype bfloat16``: the bf16 forms of #6-#9 against the JAX
package fed bf16, on the CPU, the route through SW_Transformer and
WindowAttention, and the entry points.

  * (a) #6-bf16 and #8-bf16: ``fused_window_attention_bf16`` and
    ``fused_window_attention_backward_bf16`` (their plain versions here)
    against ``focal_tpu.ops.pallas_kernels.fused_window_attention`` fed bf16
    q, k, v in interpret mode, and its ``jax.vjp``. q is scaled as the JAX
    caller scales it (``qkv[0] * scale`` on bf16, op by op), the port's side
    given the unscaled q and ``q_scale``. Forward within 1e-2 of max|y|
    (measured <= 2.7e-4: both upcast, compute in f32 and round once, and an
    element whose f32 sums, in another order, straddle a bf16 rounding
    point lands one bf16 step apart), gradients within 2e-2 relative
    (measured <= 7.5e-4 for dq, dk, dv in bf16, <= 1.8e-7 for drel_bias).
  * (b) #7-bf16 and #9-bf16: their dropout draws the TPU's bits, so the
    plain versions with a stored keep mask are held against the TPU
    kernels' own math (``_scores_softmax``, ``_weighted_sum``,
    ``_bwd_math``) on the upcast inputs with that mask, rounded to bf16 at
    the outputs as the kernels store them (1e-2 of max|y|, 2e-2 relative;
    measured <= 1.1e-3).
  * (c) ``window_attention_qkv`` on a bf16 qkv against the JAX chain
    ``qkv[0] * scale`` -> kernel -> head layout, with its VJP: the output
    and d(qkv) elementwise within one bf16 step (the f32 sums in another
    order can round either way; measured in <= 0.03 % of the elements), in
    at most 1 % of them. d(qkv)'s q columns are bf16(bf16(dq) bf16(scale)), the VJP of
    the bf16 multiply; rounding the f32 dq * scale once instead moves more
    of them than that.
  * (d) A MOD_TINY bf16 SW_Transformer built with ``pallas_block=False``
    against the flax bf16 model with ``use_pallas`` and without
    ``use_pallas_block`` applied op by op (no ``jit``), the port's
    parameters from ``params_from_flax``: logits within 1e-2 relative
    (measured 4.5e-3: (a)'s one-step flips carried through 8 bf16 blocks;
    the XLA route of (e), whose sums run in the same order on both sides,
    gives the same bits); spies show every block on the bf16 entries
    (``fused_window_attention_bf16`` in eval, ``window_attention_qkv`` on a
    bf16 qkv in training) and none on a whole-block one.
  * (e) ROADMAP C12: a bf16 ``WindowAttention`` at widths no bf16 kernel
    takes (C 12 H 2, C 20 H 4, C 12 H 1 and C 24 H 2 on the attention-only
    route: hd 12, which the f32 kernels take and the bf16 ones do not)
    against flax's ``WindowAttention(use_pallas=False, dtype=bfloat16)``,
    its XLA route, op by op: within 1e-2 of max|y| (measured 0); a
    backward in training gives finite f32 gradients.
  * (f) The entry points on ``-device cpu`` with ``-no_pallas_block
    -compute_dtype bfloat16``: pretrain and finetune 1 epoch each, ``test``
    and ``predict``, the sweep (supervised) and ``Predictor``.

The CUDA kernels are held against these plain versions on the card
(``tests/test_torch_port_gpu.py``, ``chip_smoke.py`` phase 33).
"""

import importlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.models.sw_transformer import SWTransformer as JaxSWTransformer
from focal_tpu.models.swin import WindowAttention as JaxWindowAttention
from focal_tpu.models.swin import shifted_window_mask
from focal_tpu.ops.pallas_kernels import (_bwd_math, _scores_softmax, _weighted_sum,
                                          expand_bias_lanes, fused_window_attention)
from focal_tpu_torch import predict as predict_cli
from focal_tpu_torch import sweep as sweep_cli
from focal_tpu_torch import test as test_cli
from focal_tpu_torch.data import synthetic_arrays
from focal_tpu_torch.models import build_backbone
from focal_tpu_torch.models import swin as tswin
from focal_tpu_torch.ops import pallas_kernels as pk
from focal_tpu_torch.ops.dropout import StepRngs
from focal_tpu_torch.params import load_dataset_config
from focal_tpu_torch.serve import Predictor
from focal_tpu_torch.weights import params_from_flax
from torch_port_threads import one_torch_thread  # noqa: F401

train_cli = importlib.import_module("focal_tpu_torch.train.__main__")

TASK = "vehicle_classification"
FWD_TOL = 1e-2
GRAD_TOL = 2e-2
BF = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def _root_logger_restored():
    """The training CLI points the root logger at its run folder; give the
    next test file the logger it had."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    for h in root.handlers[:]:
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    for h in handlers:
        if h not in root.handlers:
            root.addHandler(h)
    root.setLevel(level)


def _f32(a):
    """A JAX array or torch tensor as an f32 numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16(a):
    """A JAX bf16 array as a torch bf16 tensor with the same values."""
    return torch.from_numpy(_f32(a)).to(BF)


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(seed, B, H, N, hd, shifted):
    """bf16 q (unscaled), k, v and g as JAX arrays, f32 rel_bias at a
    trained model's scale, the shift mask of a 6x6 grid of 3x3 windows or
    None."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (jnp.asarray(rng.normal(size=(B, H, N, hd)), jnp.float32).astype(jnp.bfloat16)
                  for _ in range(4))
    rel_bias = (0.02 * rng.normal(size=(H, N, N))).astype(np.float32)
    mask = shifted_window_mask(6, 6, 3, 3, 1, 1) if shifted else None
    return q, k, v, g, rel_bias, mask, rng


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_plain_bf16_forward_and_backward_match_jax_kernel_fed_bf16(hd, shifted):
    H, N, B = 4, 9, 32
    q, k, v, g, rel_bias, mask, _ = _inputs(hd + shifted, B, H, N, hd, shifted)
    scale = hd**-0.5
    qs = q * scale  # the JAX caller's bf16 multiply, op by op
    bias_l = expand_bias_lanes(jnp.asarray(rel_bias), mask)
    want, vjp = jax.vjp(jax.jit(fused_window_attention), qs, k, v, bias_l)
    assert want.dtype == jnp.bfloat16
    dq, dk, dv, dbias_l = vjp(g)
    tq, tk, tv, tg = (_bf16(a) for a in (q, k, v, g))
    out = pk.fused_window_attention_bf16(tq, tk, tv, _t(rel_bias), _t(mask), q_scale=scale)
    assert out.dtype == BF and _rel(out, want) <= FWD_TOL
    grads = pk.fused_window_attention_backward_bf16(tq, tk, tv, _t(rel_bias), _t(mask), tg,
                                                    q_scale=scale)
    assert [t.dtype for t in grads] == [BF, BF, BF, torch.float32]
    for name, got, w in zip(["dq", "dk", "dv", "drel_bias"], grads,
                            [dq, dk, dv, np.asarray(dbias_l).sum(-1)]):
        assert got.shape == w.shape, name
        assert _rel(got, w) <= GRAD_TOL, (name, _rel(got, w))


def _jax_dropout(q, k, v, g, rel_bias, mask, keep, rate):
    """#7's output and #9's (dq, dk, dv, drel_bias) in the TPU kernels' jnp
    on f32 q, k, v, g, head by head on the [N, hd, B_] lane layout, with
    ``keep`` as their mask; out, dq, dk, dv rounded to bf16 as the kernels
    fed bf16 store them."""
    B, H, N, _ = q.shape
    bias_w = np.zeros((N, N, B), np.float32)
    if mask is not None:
        bias_w = mask[np.arange(B) % mask.shape[0]].transpose(1, 2, 0)
    out, dq, dk, dv, drel = [], [], [], [], []
    for h in range(H):
        ql, kl, vl, gl = (jnp.asarray(a[:, h].transpose(1, 2, 0)) for a in (q, k, v, g))
        bias = jnp.asarray(rel_bias[h][:, :, None] + bias_w)
        kp = jnp.asarray(keep[:, h].transpose(1, 2, 0).astype(bool))
        attn = jnp.where(kp, _scores_softmax(ql, kl, bias) / (1.0 - rate), 0.0)
        out.append(_weighted_sum(attn, vl))
        d = _bwd_math(ql, kl, vl, gl, bias, kp, 1.0 / (1.0 - rate))
        for acc, a in zip((dq, dk, dv), d[:3]):
            acc.append(a)
        drel.append(np.asarray(d[3]).sum(-1))

    def back(parts):  # H x [N, hd, B_] -> [B_, H, N, hd], rounded to bf16
        return np.stack([_f32(jnp.asarray(a).astype(jnp.bfloat16)).transpose(2, 0, 1)
                         for a in parts], axis=1)

    return back(out), (back(dq), back(dk), back(dv), np.stack(drel))


@pytest.mark.parametrize("hd,shifted", [(16, True), (32, False), (64, True)])
def test_plain_bf16_dropout_pair_matches_the_tpu_kernels_math(hd, shifted):
    H, N, B, rate = 4, 9, 16, 0.2
    q, k, v, g, rel_bias, mask, rng = _inputs(7 * hd, B, H, N, hd, shifted)
    scale = hd**-0.5
    keep = (rng.random((B, H, N, N)) >= rate).astype(np.uint8)
    tq, tk, tv, tg = (_bf16(a) for a in (q, k, v, g))
    args = (tq, tk, tv, _t(rel_bias), _t(mask))
    out = pk.fused_window_attention_bf16_reference(*args, _t(keep), rate, q_scale=scale)
    grads = pk.fused_window_attention_backward_bf16_reference(*args, tg, _t(keep), rate,
                                                              q_scale=scale)
    want_out, want_grads = _jax_dropout(_f32(q * scale), _f32(k), _f32(v), _f32(g), rel_bias,
                                        mask, keep, rate)
    assert out.dtype == BF and _rel(out, want_out) <= FWD_TOL
    for name, got, w in zip(["dq", "dk", "dv", "drel_bias"], grads, want_grads):
        assert got.shape == w.shape, name
        assert _rel(got, w) <= GRAD_TOL, (name, _rel(got, w))
    # the CPU wrappers: the plain versions with draw_keep_mask's mask, no launch
    kernels = (pk.fused_window_attention_bf16, pk.fused_window_attention_dropout_bf16,
               pk.fused_window_attention_backward_bf16,
               pk.fused_window_attention_dropout_backward_bf16)
    before = [f.launches for f in kernels]
    drawn = pk.draw_keep_mask(5, (B, H, N, N), rate, "cpu")
    assert torch.equal(pk.fused_window_attention_dropout_bf16(*args, 5, rate, q_scale=scale),
                       pk.fused_window_attention_bf16_reference(*args, drawn, rate, scale))
    for a, b in zip(pk.fused_window_attention_backward_bf16(*args, tg, 5, rate, q_scale=scale),
                    pk.fused_window_attention_backward_bf16_reference(*args, tg, drawn, rate,
                                                                      scale)):
        assert torch.equal(a, b)
    assert [f.launches for f in kernels] == before


def _within_a_bf16_step(got, want):
    """The share of elements that differ, each within one bf16 step: the
    spacing of bf16 values (2^-7 of the power of two) at the larger of the
    two, or at 2^-14 of max|want| where both are smaller (sums that cancel
    to near 0, whose rounding the summation order sets)."""
    got, want = _f32(got), _f32(want)
    diff = np.abs(got - want)
    top = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0**-14 * np.abs(want).max())
    assert (diff <= np.exp2(np.floor(np.log2(top)) - 7)).all()
    return float((diff > 0).mean())


@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
def test_qkv_route_in_bf16_rounds_dqkv_as_the_jax_chain(shifted):
    B, N, H, hd = 32, 9, 4, 32
    C = H * hd
    rng = np.random.default_rng(5 + shifted)
    qkv = jnp.asarray(rng.normal(size=(B, N, 3 * C)), jnp.float32).astype(jnp.bfloat16)
    gy = jnp.asarray(rng.normal(size=(B, N, C)), jnp.float32).astype(jnp.bfloat16)
    rel_bias = (0.02 * rng.normal(size=(H, N, N))).astype(np.float32)
    mask = shifted_window_mask(6, 6, 3, 3, 1, 1) if shifted else None
    bias_l = expand_bias_lanes(jnp.asarray(rel_bias), mask)
    scale = hd**-0.5

    def chain(qkv, bias_l):  # focal_tpu/models/swin.py:269-294 after the qkv Dense
        t = qkv.reshape(B, N, 3, H, hd).transpose(2, 0, 3, 1, 4)
        out = fused_window_attention(t[0] * scale, t[1], t[2], bias_l)
        return out.transpose(0, 2, 1, 3).reshape(B, N, C)

    want, vjp = jax.vjp(chain, qkv, bias_l)
    dqkv, dbias_l = vjp(gy)
    tqkv = _bf16(qkv).requires_grad_(True)
    trb = torch.from_numpy(rel_bias).requires_grad_(True)
    out = pk.window_attention_qkv(tqkv, H, trb, _t(mask))
    y = out.transpose(1, 2).reshape(B, N, C)
    assert y.dtype == BF
    y.backward(_bf16(gy))
    assert tqkv.grad.dtype == BF and trb.grad.dtype == torch.float32
    assert _within_a_bf16_step(y, want) <= 1e-2
    assert _within_a_bf16_step(tqkv.grad, dqkv) <= 1e-2
    got_q, want_q = _f32(tqkv.grad)[..., :C], _f32(dqkv)[..., :C]
    assert _within_a_bf16_step(got_q, want_q) <= 1e-2
    # rounding the f32 dq * scale once gives other bits in more of the q columns
    q, k, v = pk._head_views(tqkv.detach(), H)
    dq32 = pk.fused_window_attention_backward_reference(
        pk.scale_bf16(q, scale).float(), k.float(), v.float(), trb.detach(), _t(mask),
        pk._heads(_bf16(gy), H).float())[0]
    once = (dq32 * scale).to(BF).transpose(1, 2).reshape(B, N, C)
    assert float((_f32(once) != want_q).mean()) > 1e-2
    assert _rel(trb.grad, np.asarray(dbias_l).sum(-1)) <= GRAD_TOL


def _tiny_input(cfg, batch, seed):
    loc = cfg["location_names"][0]
    rng = np.random.default_rng(seed)
    return {loc: {m: rng.normal(size=(batch, 2 * cfg["loc_mod_in_time_channels"][loc][m],
                                      cfg["num_segments"],
                                      cfg["loc_mod_spectrum_len"][loc][m])).astype(np.float32)
                  for m in cfg["modality_names"]}}


def _spy(monkeypatch, module, names, calls):
    for name in names:
        real = getattr(module, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append((_name, args[0].dtype))
            return _real(*args, **kw)

        monkeypatch.setattr(module, name, spy)


def test_tiny_bf16_attention_only_model_matches_flax_op_by_op(monkeypatch):
    cfg = load_dataset_config("MOD_TINY")
    x = _tiny_input(cfg, 3, 2)
    jmodel = JaxSWTransformer(dataset_config=cfg, task=TASK, dtype=jnp.bfloat16, use_pallas=True,
                              use_pallas_block=False)
    jx = jax.tree_util.tree_map(jnp.asarray, x)
    v = jax.jit(lambda xx: jmodel.init({"params": jax.random.key(3)}, xx, train=False,
                                       head="both"))(jx)
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=np.shape(a))).astype(np.float32),
        v["params"])
    logits = jmodel.apply({"params": params}, jx, train=False, head="class")
    port = build_backbone(cfg, "SW_Transformer", TASK, pallas_block=False,
                          compute_dtype="bfloat16").eval()
    port.load_state_dict(params_from_flax(params, {}, cfg), strict=True)
    tx = {loc: {m: torch.from_numpy(a) for m, a in mods.items()} for loc, mods in x.items()}
    calls = []
    _spy(monkeypatch, tswin, ("fused_window_attention_bf16", "fused_window_attention",
                              "window_attention_qkv", "window_block", "window_block_forward"),
         calls)
    with torch.no_grad():
        got = port(tx, head="class")
    assert got.dtype == torch.float32 and got.shape == (3, 7)
    assert _rel(got, logits) <= FWD_TOL
    blocks = [m for m in port.modules() if isinstance(m, tswin.WindowAttention)]
    assert len(blocks) == 8 and calls == [("fused_window_attention_bf16", BF)] * 8
    calls.clear()
    rngs = StepRngs(torch.Generator().manual_seed(0), torch.Generator().manual_seed(1))
    logits_t, proj = port.train()(tx, head="both", rng=rngs)
    (logits_t.float().sum() + sum(p.float().sum() for p in proj.values())).backward()
    assert calls == [("window_attention_qkv", BF)] * 8
    assert all(p.grad is None or p.grad.dtype == torch.float32 for p in port.parameters())
    assert all(b.qkv.weight.grad is not None and bool(torch.isfinite(b.qkv.weight.grad).all())
               for b in blocks)


@pytest.mark.parametrize("dim,heads,pallas_block", [(12, 2, True), (20, 4, True), (12, 1, True),
                                                    (24, 2, False)],
                         ids=["C12H2", "C20H4", "C12H1", "C24H2-no-pallas-block"])
@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
def test_bf16_plain_route_at_widths_no_bf16_kernel_takes(dim, heads, pallas_block, shifted,
                                                         monkeypatch):
    """C12: every width runs in bf16, as in f32; hd 12 (C12H1, C24H2) is a
    width the f32 attention-only kernels take and the bf16 ones do not."""
    N, B = 9, 8
    hd = dim // heads
    assert not pk.attention_takes(N, hd, BF)
    assert not (pallas_block and pk.wblock_takes(N, dim, heads, BF))
    assert pk.attention_takes(N, hd) == (hd % 4 == 0)
    rng = np.random.default_rng(dim + heads + shifted)
    mask = shifted_window_mask(6, 6, 3, 3, 1, 1) if shifted else None
    jm = None if mask is None else jnp.asarray(mask)
    x = jnp.asarray(rng.normal(size=(B, N, dim)), jnp.float32).astype(jnp.bfloat16)
    jattn = JaxWindowAttention(dim=dim, window_size=(3, 3), num_heads=heads, use_pallas=False,
                               dtype=jnp.bfloat16)
    params = jax.jit(lambda xx: jattn.init({"params": jax.random.key(0)}, xx, jm,
                                           train=False))(x)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=np.shape(a))).astype(np.float32),
        params["params"])
    want = jattn.apply({"params": params}, x, jm, train=False)
    assert want.dtype == jnp.bfloat16
    attn = tswin.WindowAttention(dim, (3, 3), heads, attn_drop=0.2, pallas_block=pallas_block,
                                 compute_dtype=BF)
    attn.load_state_dict(params_from_flax(params, {}, {"location_names": ["l"]}), strict=True)
    calls = []
    _spy(monkeypatch, tswin, ("fused_window_attention_bf16", "fused_window_attention",
                              "window_attention_qkv", "window_block", "window_block_forward"),
         calls)
    tx = _bf16(x)
    tmask = _t(mask)
    with torch.no_grad():
        y = attn.eval()(tx, tmask)
    assert y.dtype == BF and _rel(y, want) <= FWD_TOL
    xt = tx.clone().requires_grad_(True)
    rngs = StepRngs(torch.Generator().manual_seed(0), torch.Generator().manual_seed(1))
    y = attn.train()(xt, tmask, rngs)
    y.float().square().sum().backward()
    assert calls == []  # no kernel entry point
    assert xt.grad.dtype == BF and bool(torch.isfinite(xt.grad.float()).all())
    for name, p in attn.named_parameters():
        assert p.grad.dtype == torch.float32 and bool(torch.isfinite(p.grad).all()), name
        assert float(p.grad.abs().max()) > 0, name


def test_entry_points_run_the_bf16_attention_only_route(tmp_path, monkeypatch):
    """Pretrain 1 epoch, finetune 1 epoch, ``test`` and ``predict`` on the
    pretrained _best, the sweep (supervised, one ratio) and ``Predictor``,
    all with -no_pallas_block -compute_dtype bfloat16: finite numbers, f32
    checkpoints, every window attention on the bf16 attention-only route
    (a whole-block call fails the test)."""

    def whole_block(*args, **kw):
        raise AssertionError("a whole-block kernel entry was called")

    monkeypatch.setattr(tswin, "window_block", whole_block)
    monkeypatch.setattr(tswin, "window_block_forward", whole_block)
    dtypes = set()
    real = tswin.window_attention_qkv
    monkeypatch.setattr(tswin, "window_attention_qkv",
                        lambda qkv, *a: dtypes.add(qkv.dtype) or real(qkv, *a))
    tiny = ["-dataset", "MOD_TINY", "-model", "SW_Transformer", "-no_pallas_block",
            "-compute_dtype", "bfloat16", "-synthetic", "-synthetic_samples", "32",
            "-batch_size", "8", "-val_epochs", "1", "-device", "cpu", "-output_dir", str(tmp_path)]
    pre = tiny + ["-learn_framework", "FOCAL", "-epochs", "1"]
    state, _, points = train_cli.main(pre)
    assert [p["epoch"] for p in points] == [0]
    assert all(np.isfinite(p[k]) for p in points for k in ("train_loss", "val_loss"))
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    exp = tmp_path / "weights" / "MOD_TINY_SW_Transformer" / "exp0_contrastive_FOCAL"
    best = exp / "MOD_TINY_SW_Transformer_pretrain_best.pt"
    saved = torch.load(best, map_location="cpu", weights_only=True)
    assert saved and all(t.dtype == torch.float32 for t in saved.values())
    assert all(np.isfinite(test_cli.main(pre)))
    probs = predict_cli.main(["-dataset", "MOD_TINY", "-learn_framework", "FOCAL", "-synthetic",
                              "-synthetic_samples", "6", "-batch_size", "4", "-no_pallas_block",
                              "-compute_dtype", "bfloat16", "-model_weight", str(best),
                              "-device", "cpu"])["probs"]
    assert probs.shape[1:] == (7,) and len(probs) and probs.dtype == np.float32
    assert np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    _, _, points = train_cli.main(tiny + ["-learn_framework", "FOCAL", "-stage", "finetune",
                                          "-epochs", "1"])
    assert len(points) == 1 and np.isfinite(points[0]["test_loss"])
    rows = sweep_cli.main(tiny + ["-learn_framework", "no", "-epochs", "1", "-ratios", "1.0",
                                  "-out", str(tmp_path / "sweep.json")])
    assert len(rows) == 1 and 0.0 <= rows[0]["best_val_acc"] <= 1.0
    cfg = load_dataset_config("MOD_TINY")
    data, labels, _ = synthetic_arrays(cfg, TASK, 6, seed=0)
    served = Predictor(cfg, "SW_Transformer", TASK, None, batch_size=4, device="cpu",
                       pallas_block=False, compute_dtype="bfloat16").predict(data)["probs"]
    assert served.shape == (len(labels), 7) and np.isfinite(served).all()
    assert dtypes == {torch.bfloat16}
