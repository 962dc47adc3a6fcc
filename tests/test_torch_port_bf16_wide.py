"""The per-head kernels' bf16 forms (#4-bf16, #5-bf16): their plain
versions against the JAX package's per-head kernels fed bf16, on the CPU,
and the route of MOD_WIDE's bf16 blocks to their wrappers.

``_wblock_ph_fwd_impl`` and ``_wblock_ph_bwd_impl`` (``focal_tpu/ops/
pallas_kernels.py``) run in interpret mode here with bf16 x, wqkv, wproj
and dy (f32 biases and bias table): they give a bf16 y and dx, summing y
and dx over the heads in f32 and rounding once, and round qkv's attention
output and dq, dk, dv to bf16 before their products, as the whole-block
kernel does. So #4-bf16 and #5-bf16 take the bf16 plain versions of
#1-#3 (``fused_window_block_bf16_reference``,
``fused_window_block_backward_bf16_reference``) unchanged, and this file
holds those against the per-head kernels: at C 64 and MOD_WIDE stage 1's
C 512 (4 heads), nW 1 and 4, the backward with a keep mask and without.
#4-bf16's dropout draws the TPU's bits, so it is held at rate -> 0 (every
weight kept) against the rate-0 forward.

Tolerances, as ``tests/test_torch_port_bf16_kernel.py``'s, max|port - jax|
/ max|jax|: the forward 1e-2 (one bf16 step is 2^-8 of an element), each
gradient 2e-2.

The CUDA kernels are held against these plain versions on the card
(``tests/test_torch_port_gpu.py``, ``chip_smoke.py`` phase 31).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import focal_tpu.ops.pallas_kernels as jpk
from focal_tpu.models.swin import WindowAttention as JaxWindowAttention
from focal_tpu.models.swin import shifted_window_mask
from focal_tpu.ops.pallas_kernels import (_block_tile_perhead, _wblock_ph_bwd_impl,
                                          _wblock_ph_fwd_impl, expand_bias_lanes)
from focal_tpu_torch.models import build_backbone, swin
from focal_tpu_torch.ops import pallas_kernels as pk
from focal_tpu_torch.ops.dropout import StepRngs
from focal_tpu_torch.params import load_dataset_config
from focal_tpu_torch.weights import params_from_flax

FWD_TOL = 1e-2
GRAD_TOL = 2e-2
NAMES = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "drel_bias")
B, N, H = 8, 9, 4


def _inputs(C, nW, seed):
    """Numpy-seeded inputs at a trained model's scale: the JAX package's
    (bf16 x, wqkv, wproj, dy; f32 biases and lane-expanded bias table) and
    the port's (the same values as torch tensors), and the numpy rng."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, C))
    wqkv = rng.normal(size=(C, 3 * C)) * C**-0.5
    bqkv = rng.normal(size=3 * C) * 0.1
    wproj = rng.normal(size=(C, C)) * C**-0.5
    bproj = rng.normal(size=C) * 0.1
    rel_bias = rng.normal(size=(H, N, N)) * 0.02
    dy = rng.normal(size=(B, N, C))
    mask = shifted_window_mask(6, 6, 3, 3, 1, 1) if nW == 4 else None
    bf = jnp.bfloat16
    j_x, j_wq, j_wp, j_dy = (jnp.asarray(a, jnp.float32).astype(bf) for a in (x, wqkv, wproj, dy))
    jax_args = (j_x, j_wq, jnp.asarray(bqkv, jnp.float32), j_wp, jnp.asarray(bproj, jnp.float32),
                expand_bias_lanes(jnp.asarray(rel_bias, jnp.float32), mask))

    def to_bf16(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)

    def to_f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    port_args = (to_bf16(j_x), to_bf16(j_wq), to_f32(bqkv), to_bf16(j_wp), to_f32(bproj),
                 to_f32(rel_bias), None if mask is None else torch.from_numpy(mask))
    return jax_args, j_dy, port_args, to_bf16(j_dy), rng


def _jax_keep(keep, C):
    """uint8 [B, H, N, N] -> bf16 [H, N, N, Bp] in the per-head kernel's
    lanes (its bf16 tile), zero-padded."""
    tile = _block_tile_perhead(N, C, C // H, B, 2)
    lanes = np.zeros(keep.shape[1:] + (-(-B // tile) * tile,), np.float32)
    lanes[..., :B] = keep.transpose(1, 2, 3, 0)
    return jnp.asarray(lanes, jnp.bfloat16)


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


CASES = [(64, 1), (64, 4), (512, 1), (512, 4)]


@pytest.mark.parametrize("C,nW", CASES)
def test_bf16_plain_forward_matches_jax_perhead_kernel(C, nW):
    """#4-bf16's plain version (and at rate -> 0 with every weight kept, its
    dropout form) against ``_wblock_ph_fwd_impl`` fed bf16; the CPU wrapper
    gives the plain version and no mask at rate 0."""
    jax_args, _, port_args, _, _ = _inputs(C, nW, C + nW)
    want = _wblock_ph_fwd_impl(*jax_args)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    y, keep = pk.fused_window_block_perhead_bf16(*port_args)
    assert keep is None and y.dtype == torch.bfloat16 and tuple(y.shape) == want.shape
    assert torch.equal(y, pk.fused_window_block_bf16_reference(*port_args))
    assert _rel(y, want) <= FWD_TOL
    ones = torch.ones(B, H, N, N, dtype=torch.uint8)
    assert _rel(pk.fused_window_block_bf16_reference(*port_args, ones, 1e-7), want) <= FWD_TOL
    # the exact plain version (float64 sums), the card's floor reference (C14)
    y64 = pk.fused_window_block_bf16_reference(*port_args, acc=torch.float64)
    assert y64.dtype == torch.bfloat16 and _rel(y64, want) <= FWD_TOL


@pytest.mark.parametrize("C,nW", CASES)
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_bf16_plain_backward_matches_jax_perhead_kernel(C, nW, rate):
    """#5-bf16's plain version against ``_wblock_ph_bwd_impl`` fed bf16,
    with a stored keep mask where rate > 0: dx in bf16, the weight, bias and
    bias-table gradients in f32."""
    jax_args, j_dy, port_args, dy, rng = _inputs(C, nW, C + nW + int(rate * 10))
    keep = (rng.random((B, H, N, N)) >= rate).astype(np.uint8) if rate else None
    want = _wblock_ph_bwd_impl(*jax_args, j_dy, mask=None if keep is None else _jax_keep(keep, C),
                               rate=rate)
    assert want[0].dtype == jnp.bfloat16
    want = [np.asarray(w.astype(jnp.float32)) for w in want]
    want[5] = want[5].sum(-1)  # d bias_l [H, N, N, 128] -> d rel_bias
    tkeep = None if keep is None else torch.from_numpy(keep)
    got = pk.fused_window_block_perhead_backward_bf16(*port_args, dy, tkeep, rate)
    assert got[0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in got[1:])
    exact = pk.fused_window_block_backward_bf16_reference(*port_args, dy, tkeep, rate,
                                                          acc=torch.float64)
    assert [g.dtype for g in exact] == [g.dtype for g in got]
    for name, g, e, w in zip(NAMES, got, exact, want):
        assert tuple(g.shape) == w.shape, name
        assert _rel(g, w) <= GRAD_TOL, (name, _rel(g, w))
        assert _rel(e, w) <= GRAD_TOL, (name, _rel(e, w))


@pytest.mark.parametrize("shifted", [False, True])
def test_bf16_wide_window_attention_matches_jax_module(shifted, monkeypatch):
    """A bf16 WindowAttention at C 512 (MOD_WIDE stage 1) against the JAX
    module with ``use_pallas_block`` and ``dtype=bfloat16``, whose
    whole-block kernel dispatches to the per-head Pallas kernels (interpret
    mode): the output in eval and in training (#4-bf16), dx in bf16 and
    every f32 parameter's gradient (#5-bf16), rate 0."""
    ran = []
    for name in ("_wblock_ph_fwd_impl", "_wblock_ph_bwd_impl"):
        real = getattr(jpk, name)
        monkeypatch.setattr(jpk, name, lambda *a, _r=real, _n=name, **k: ran.append(_n) or _r(*a, **k))
    C = 512
    rng = np.random.default_rng(11 + shifted)
    x = jnp.asarray(rng.normal(size=(B, N, C)), jnp.float32).astype(jnp.bfloat16)
    dy = jnp.asarray(rng.normal(size=(B, N, C)), jnp.float32).astype(jnp.bfloat16)
    mask = shifted_window_mask(6, 6, 3, 3, 1, 1) if shifted else None
    jm = None if mask is None else jnp.asarray(mask)
    jattn = JaxWindowAttention(dim=C, window_size=(3, 3), num_heads=H, use_pallas=True,
                               use_pallas_block=True, dtype=jnp.bfloat16)
    params = jax.jit(lambda xx: jattn.init({"params": jax.random.key(0)}, xx, jm, train=False))(x)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.float32(0.05) * rng.normal(size=np.shape(a)).astype(np.float32),
        params["params"])
    y, vjp = jax.vjp(lambda p, xx: jattn.apply({"params": p}, xx, jm, train=False), params, x)
    jgrads, jdx = vjp(dy)
    assert y.dtype == jnp.bfloat16 and jdx.dtype == jnp.bfloat16
    assert "_wblock_ph_fwd_impl" in ran and "_wblock_ph_bwd_impl" in ran  # the per-head kernels
    y = np.asarray(y.astype(jnp.float32))

    attn = swin.WindowAttention(C, (3, 3), H, compute_dtype=torch.bfloat16)
    attn.load_state_dict(params_from_flax(params, {}, {"location_names": ["l"]}), strict=True)
    tx = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    tmask = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        y_eval = attn.eval()(tx, tmask)
    assert y_eval.dtype == torch.bfloat16 and _rel(y_eval, y) <= FWD_TOL
    tx = tx.clone().requires_grad_(True)
    y_train = attn.train()(tx, tmask)
    y_train.backward(torch.from_numpy(np.asarray(dy.astype(jnp.float32))).to(torch.bfloat16))
    assert _rel(y_train.detach(), y) <= FWD_TOL
    assert tx.grad.dtype == torch.bfloat16
    assert _rel(tx.grad, np.asarray(jdx.astype(jnp.float32))) <= GRAD_TOL
    want = params_from_flax(jax.device_get(jgrads), {}, {"location_names": ["l"]})
    got = dict(attn.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        assert got[name].grad.dtype == torch.float32, name
        assert _rel(got[name].grad, w.numpy()) <= GRAD_TOL, name


def test_mod_wide_bf16_blocks_reach_the_perhead_bf16_wrappers(monkeypatch):
    """MOD_WIDE's bf16 SW_Transformer builds (on the meta device: its 184M
    parameters are not allocated here). Each of its window attentions, built
    again at its geometry with a few windows, runs in eval and in training
    (rate 0.2) through spies on the bf16 wrappers: the blocks that
    ``wblock_fits`` refuses (stages 1 and 2, C 512 and 1024) reach #4-bf16
    and #5-bf16 and nothing else, the others #1-bf16, #2-bf16 and #3-bf16."""
    cfg = load_dataset_config("MOD_WIDE")
    with torch.device("meta"):
        net = build_backbone(cfg, "SW_Transformer", "vehicle_classification",
                             compute_dtype="bfloat16")
    geos = {(m.dim, m.window_size, m.num_heads) for m in net.modules()
            if isinstance(m, swin.WindowAttention)}
    assert {C for C, _, _ in geos} == {256, 512, 1024}
    names = ("fused_window_block_bf16", "fused_window_block_dropout_bf16",
             "fused_window_block_backward_bf16", "fused_window_block_perhead_bf16",
             "fused_window_block_perhead_backward_bf16")
    calls = []
    for name in names:
        real = getattr(pk, name)
        monkeypatch.setattr(pk, name, lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    rng = np.random.default_rng(3)
    for C, window, heads in sorted(geos):
        attn = swin.WindowAttention(C, window, heads, attn_drop=0.2, compute_dtype=torch.bfloat16)
        n = window[0] * window[1]
        x = torch.from_numpy(rng.normal(size=(2, n, C)).astype(np.float32)).to(torch.bfloat16)
        calls.clear()
        with torch.no_grad():
            attn.eval()(x)
        rngs = StepRngs(torch.Generator().manual_seed(0), torch.Generator().manual_seed(1))
        y = attn.train()(x.clone().requires_grad_(True), None, rngs)
        y.float().sum().backward()
        if pk.wblock_fits(n, C, heads):
            assert C == 256 and calls == list(names[:3]), (C, calls)
        else:
            assert C in (512, 1024) and calls == ["fused_window_block_perhead_bf16"] * 2 + [
                "fused_window_block_perhead_backward_bf16"], (C, calls)
