"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests import neither JAX nor the JAX package, so they run on a machine
with a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

Without a card each test skips. Tolerance 1e-4: kernel and plain version are
both full f32 (TF32 off), so they differ only in summation order.
"""

import numpy as np
import pytest
import torch

from focal_tpu_torch.ops.pallas_kernels import fused_window_block, fused_window_block_reference


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _args(rng, B, N, C, H, nW, dev):
    """Inputs at a trained model's scale: unit activations, weights of
    std C**-0.5, small biases, so outputs are O(1) and 1e-4 is ~1e3 ulps."""
    shapes = [(B, N, C), (C, 3 * C), (3 * C,), (C, C), (C,), (H, N, N)]
    scales = [1.0, C**-0.5, 0.1, C**-0.5, 0.1, 0.02]
    args = [torch.from_numpy((rng.normal(size=s) * k).astype(np.float32)).to(dev)
            for s, k in zip(shapes, scales)]
    mask = None
    if nW:
        mask = torch.from_numpy(
            np.where(rng.random((nW, N, N)) < 0.3, -100.0, 0.0).astype(np.float32)).to(dev)
    return args + [mask]


# (windows, tokens per window, channels, heads, shift-mask windows or 0):
# the MOD stage widths, a window batch that is not a multiple of the
# windows per block or of nW, and the smallest and largest window.
@pytest.mark.gpu
@pytest.mark.parametrize("B,N,C,H,nW", [
    (512, 9, 64, 4, 64), (509, 9, 128, 4, 16), (511, 9, 256, 4, 0),
    (37, 4, 32, 2, 3), (64, 16, 64, 4, 8),
    # RealWorld_HAR's shifted stages: 48 (stage 0) and 12 (stage 1) windows a sample
    (528, 9, 64, 4, 48), (516, 9, 128, 4, 12),
])
def test_kernel_matches_plain_on_card(B, N, C, H, nW):
    dev = _card()
    args = _args(np.random.default_rng(B + C), B, N, C, H, nW, dev)
    before = fused_window_block.launches
    y = fused_window_block(*args)
    torch.cuda.synchronize()
    assert fused_window_block.launches == before + 1
    ref = fused_window_block_reference(*args)
    assert y.shape == ref.shape and float((y - ref).abs().max()) <= 1e-4


def _mod_block_geometries(batch):
    """(windows, N, C, H, shift mask or None) of every distinct block of a
    MOD SW_Transformer forward at ``batch`` samples: ten geometries."""
    import os

    from focal_tpu_torch.models.sw_transformer import mod_geometry
    from focal_tpu_torch.models.swin import block_geometry, shifted_window_mask
    from focal_tpu_torch.params import load_yaml

    cfg = load_yaml(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                 "focal_tpu_torch", "configs", "MOD.yaml"))
    heads = cfg["SW_Transformer"]["time_freq_head_num"]
    out = set()
    for mod in cfg["modality_names"]:
        geo = mod_geometry(cfg, cfg["location_names"][0], mod)
        for stage, ((H, W), C) in enumerate(geo["stages"]):
            for i in range(geo["block_num"][stage]):
                shift = [0, 0] if i % 2 == 0 else [w // 2 for w in geo["window"]]
                wh, ww, sh, sw, shifted = block_geometry((H, W), geo["window"], shift)
                nW = (H // wh) * (W // ww)
                out.add((batch * nW, wh * ww, C, heads, (H, W, wh, ww, sh, sw) if shifted else None))
    return [(B, N, C, Hh, None if m is None else shifted_window_mask(*m))
            for B, N, C, Hh, m in sorted(out, key=str)]


@pytest.mark.gpu
def test_kernel_at_every_served_mod_geometry_repeats_bitwise():
    """#1 (the row-tiled forward at rate 0) at the ten block geometries of a
    served MOD batch of 128: within 1e-4 of plain, one launch counted a
    call, the same bits on a second call."""
    dev = _card()
    geos = _mod_block_geometries(128)
    assert len(geos) == 10
    for B, N, C, H, mask in geos:
        args = _args(np.random.default_rng(B + C), B, N, C, H, 0, dev)
        args[-1] = None if mask is None else torch.from_numpy(mask).to(dev)
        before = fused_window_block.launches
        y = fused_window_block(*args)
        again = fused_window_block(*args)
        torch.cuda.synchronize()
        assert fused_window_block.launches == before + 2
        assert torch.equal(y, again), (B, N, C)
        assert float((y - fused_window_block_reference(*args)).abs().max()) <= 1e-4, (B, N, C)


@pytest.mark.gpu
def test_kernel_wrapper_raises_on_cuda_input_it_cannot_take():
    dev = _card()
    args = _args(np.random.default_rng(0), 8, 9, 64, 4, 0, dev)
    with pytest.raises(TypeError):
        fused_window_block(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        fused_window_block(args[0].transpose(0, 1).contiguous().transpose(0, 1), *args[1:])
    with pytest.raises(ValueError):
        fused_window_block(args[0], args[1][:, :96].contiguous(), *args[2:])
    with pytest.raises(ValueError):  # N above the kernel's register tile
        fused_window_block(*_args(np.random.default_rng(1), 2, 17, 64, 4, 0, dev))


# ---------------------------------------------------------------------------
# training kernels: #2 (forward with attention dropout) and #3 (backward),
# row-tiled 3xTF32 products around the attention per (window, head). #2
# against the plain forward fed #2's own keep mask (1e-4 absolute, as #1);
# #3 against autograd of the plain version with the same mask as
# max|kernel - plain| / max|plain| <= 1e-4 per gradient (long f32 sums over
# every window, so the bound is relative).

def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,C,H,nW", [
    (512, 9, 64, 4, 64), (509, 9, 128, 4, 16), (511, 9, 256, 4, 0), (37, 4, 32, 2, 3),
    (528, 9, 64, 4, 48), (516, 9, 128, 4, 12),
])
def test_dropout_forward_matches_plain_given_its_mask(B, N, C, H, nW):
    from focal_tpu_torch.ops.pallas_kernels import (
        fused_window_block_dropout, fused_window_block_dropout_reference)

    dev = _card()
    args = _args(np.random.default_rng(B + C), B, N, C, H, nW, dev)
    rate = 0.2
    before = fused_window_block_dropout.launches
    y, keep = fused_window_block_dropout(*args, seed=1234, rate=rate)
    torch.cuda.synchronize()
    assert fused_window_block_dropout.launches == before + 1
    assert keep.dtype == torch.uint8 and keep.shape == (B, H, N, N)
    assert int(keep.max()) <= 1
    ref = fused_window_block_dropout_reference(*args, keep, rate)
    assert float((y - ref).abs().max()) <= 1e-4
    # keep rate within 5 sigma of the binomial mean 1 - rate
    n = keep.numel()
    kept = float(keep.double().mean())
    assert abs(kept - (1 - rate)) <= 5 * (rate * (1 - rate) / n) ** 0.5, kept


@pytest.mark.gpu
def test_dropout_mask_is_a_function_of_the_seed():
    from focal_tpu_torch.ops.pallas_kernels import fused_window_block_dropout

    dev = _card()
    args = _args(np.random.default_rng(5), 300, 9, 64, 4, 4, dev)
    y1, k1 = fused_window_block_dropout(*args, seed=7, rate=0.2)
    y2, k2 = fused_window_block_dropout(*args, seed=7, rate=0.2)
    _, k3 = fused_window_block_dropout(*args, seed=8, rate=0.2)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2) and torch.equal(y1, y2)
    assert not torch.equal(k1, k3)


# C = 64, 128, 256 (the MOD stage widths), nW 1 (no mask) and 4, a window
# batch whose rows (9 B_) are not a multiple of the 128-row projection tile
# and B_ not a multiple of nW, with and without dropout
@pytest.mark.gpu
@pytest.mark.parametrize("C", [64, 128, 256])
@pytest.mark.parametrize("nW", [0, 4])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_backward_matches_autograd_of_plain(C, nW, rate):
    _backward_case(C, nW, rate)


# RealWorld_HAR's shifted stages (ROADMAP C8): 48 windows a sample at C 64,
# 12 at C 128, where the JAX package's fused gate refuses (128 % nW)
@pytest.mark.gpu
@pytest.mark.parametrize("C,nW", [(64, 48), (128, 12)])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_backward_at_realworld_har_window_counts(C, nW, rate):
    _backward_case(C, nW, rate)


def _backward_case(C, nW, rate):
    from focal_tpu_torch.ops.pallas_kernels import (
        fused_window_block_backward, fused_window_block_backward_reference,
        fused_window_block_dropout)

    dev = _card()
    B, N, H = 1003, 9, 4
    rng = np.random.default_rng(C + nW)
    args = _args(rng, B, N, C, H, nW, dev)
    dy = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32)).to(dev)
    keep = None
    if rate:
        _, keep = fused_window_block_dropout(*args, seed=3, rate=rate)
    before = fused_window_block_backward.launches
    got = fused_window_block_backward(*args, dy, keep, rate)
    torch.cuda.synchronize()
    assert fused_window_block_backward.launches == before + 1
    want = fused_window_block_backward_reference(*args, dy, keep, rate)
    for name, g, w in zip(["dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "drel_bias"], got, want):
        assert g.shape == w.shape, name
        assert _rel(g, w) <= 1e-4, (name, _rel(g, w))
    again = fused_window_block_backward(*args, dy, keep, rate)
    for g, h in zip(got, again):  # fixed-order sums: bitwise repeatable
        assert torch.equal(g, h)


def _training_pair(args, dy, rate, seed):
    """#2 (or no mask at rate 0) and #3 given the weights' [out, in] copies
    (args[7:9], as the Swin block passes them): (y, keep, the six
    gradients)."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    y, keep = (pk.fused_window_block_dropout(*args[:7], seed=seed, rate=rate) if rate
               else (None, None))
    return y, keep, pk.fused_window_block_backward(*args[:7], dy, keep, rate, *args[7:])


def _with_transposes(args):
    return args + [args[1].t().contiguous(), args[3].t().contiguous()]


# (windows, tokens, channels, heads, shift-mask windows or 0): MOD_TINY's
# stage 0 (hd 8) with a ragged window count, head widths that are not a
# multiple of 4 (hd 6, hd 3: scalar staging), and one head of 1024 floats
# (fewer (window, head) pairs a block than the attention's default). Held
# against the plain version in float64: at hd 1024 these inputs (q not
# scaled by hd**-0.5) give logits of std ~32, and there the f32 plain
# version is itself ~5e-5 from the exact output, as far as the kernel is.
@pytest.mark.gpu
@pytest.mark.parametrize("B,N,C,H,nW", [
    (37, 9, 16, 2, 4), (131, 9, 24, 4, 4), (53, 4, 12, 4, 3), (19, 9, 1024, 1, 0),
])
def test_training_kernels_at_other_head_widths(B, N, C, H, nW):
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    rng = np.random.default_rng(B + C + H)
    args = _args(rng, B, N, C, H, nW, dev)
    dy = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32)).to(dev)
    rate = 0.2
    y, keep, got = _training_pair(_with_transposes(args), dy, rate, 21)
    torch.cuda.synchronize()
    assert keep.shape == (B, H, N, N)
    exact = [None if a is None else a.double() for a in args]
    ref = pk.fused_window_block_reference(*exact, keep, rate)
    assert float((y.double() - ref).abs().max()) <= 1e-4
    want = pk.fused_window_block_backward_reference(*exact, dy.double(), keep, rate)
    for name, g, w in zip(["dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "drel_bias"], got, want):
        assert _rel(g.double(), w) <= 1e-4, (name, _rel(g.double(), w))


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_backward_repeats_bitwise_at_a_full_launch(rate):
    """#3 at MOD's audio stage-0 width and a quarter of its window count
    (73,728 rows: the weight gradients in ~130 row splits, the attention on
    a full grid): the same bits on a second call, with #2's mask and
    without one."""
    dev = _card()
    rng = np.random.default_rng(8)
    args = _with_transposes(_args(rng, 8192, 9, 64, 4, 64, dev))
    dy = torch.from_numpy(rng.normal(size=(8192, 9, 64)).astype(np.float32)).to(dev)
    _, keep, got = _training_pair(args, dy, rate, 5)
    _, _, again = _training_pair(args, dy, rate, 5)
    torch.cuda.synchronize()
    for g, h in zip(got, again):
        assert torch.equal(g, h)


@pytest.mark.gpu
def test_training_kernels_launch_only_window_block_kernels():
    """A profiled call of #2 and of #3 (given the transposed weights, as the
    Swin block passes them) runs only csrc/window_block.cu's kernels: the
    projections, the attention, the weight gradients and the reductions,
    and no cuBLAS or cuDNN kernel."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    rng = np.random.default_rng(9)
    args = _with_transposes(_args(rng, 512, 9, 64, 4, 64, dev))
    dy = torch.from_numpy(rng.normal(size=(512, 9, 64)).astype(np.float32)).to(dev)
    _training_pair(args, dy, 0.2, 3)  # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _training_pair(args, dy, 0.2, 3)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    kernels = {m.group(1) if m else n for n in names
               for m in [re.search(r"::(\w+)(?:<[^()]*>)?\(", n)]}
    assert kernels == {"proj_gemm_kernel", "attn_fwd_kernel", "attn_bwd_kernel",
                       "wgrad_gemm_kernel", "reduce_partials_kernel"}, names


@pytest.mark.gpu
@pytest.mark.parametrize("transposed", [False, True])
def test_window_block_function_gradients_on_card(transposed):
    """The autograd pair (#2 forward, #3 backward) against autograd of the
    plain version with #2's keep mask; with ``transposed`` #3 reads the
    weights' [out, in] copies that the caller passes, as the Swin block
    does."""
    from focal_tpu_torch.ops.pallas_kernels import (
        fused_window_block_dropout, fused_window_block_reference, window_block)

    dev = _card()
    B, N, C, H, nW = 130, 9, 64, 4, 4
    rng = np.random.default_rng(11)
    args = _args(rng, B, N, C, H, nW, dev)
    leaves = [a.clone().requires_grad_(True) for a in args[:6]]
    extra = {}
    if transposed:
        extra = {"wqkv_t": args[1].t().contiguous(), "wproj_t": args[3].t().contiguous()}
    y = window_block(*leaves, args[6], seed=99, rate=0.2, **extra)
    dy = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32)).to(dev)
    got = torch.autograd.grad(y, leaves, dy)
    _, keep = fused_window_block_dropout(*args, seed=99, rate=0.2)
    ref_leaves = [a.clone().requires_grad_(True) for a in args[:6]]
    ref = fused_window_block_reference(*ref_leaves, args[6], keep, 0.2)
    assert float((y - ref).detach().abs().max()) <= 1e-4
    want = torch.autograd.grad(ref, ref_leaves, dy)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-4


# ---------------------------------------------------------------------------
# per-head kernels: #4 (forward, with and without dropout) and #5 (backward)
# at the MOD_WIDE widths C = 512 (hd 128) and 1024 (hd 256), 4 heads; row
# counts R = 9 B_ that are not a multiple of the 128-row projection tile
# (B_ = 3, 37, 131). Same tolerances as #1-#3; the projections' tensor-core
# product (3xTF32) also against its plain emulation.

@pytest.mark.gpu
@pytest.mark.parametrize("B", [37, 131])
@pytest.mark.parametrize("C", [512, 1024])
@pytest.mark.parametrize("nW", [0, 4])
def test_perhead_forward_matches_plain(B, C, nW):
    from focal_tpu_torch.ops.pallas_kernels import (
        fused_window_block_perhead, fused_window_block_reference)

    dev = _card()
    N, H = 9, 4
    args = _args(np.random.default_rng(C + nW + B), B, N, C, H, nW, dev)
    before = fused_window_block_perhead.launches
    y, keep = fused_window_block_perhead(*args)
    torch.cuda.synchronize()
    assert keep is None and fused_window_block_perhead.launches == before + 1
    assert float((y - fused_window_block_reference(*args)).abs().max()) <= 1e-4
    rate = 0.2
    y, keep = fused_window_block_perhead(*args, seed=77, rate=rate)
    torch.cuda.synchronize()
    assert keep.dtype == torch.uint8 and keep.shape == (B, H, N, N) and int(keep.max()) <= 1
    assert float((y - fused_window_block_reference(*args, keep, rate)).abs().max()) <= 1e-4
    kept = float(keep.double().mean())
    assert abs(kept - (1 - rate)) <= 5 * (rate * (1 - rate) / keep.numel()) ** 0.5, kept
    y2, keep2 = fused_window_block_perhead(*args, seed=77, rate=rate)
    assert torch.equal(y, y2) and torch.equal(keep, keep2)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [512, 1024])
def test_perhead_mask_equals_dropout_kernels_mask(C):
    """#4 draws from #2's Philox counters: the same seed and geometry give
    the same keep mask bit for bit (#2 launches at both widths)."""
    from focal_tpu_torch.ops.pallas_kernels import (
        fused_window_block_dropout, fused_window_block_perhead)

    dev = _card()
    args = _args(np.random.default_rng(3), 70, 9, C, 4, 4, dev)
    _, k2 = fused_window_block_dropout(*args, seed=2024, rate=0.2)
    _, k4 = fused_window_block_perhead(*args, seed=2024, rate=0.2)
    torch.cuda.synchronize()
    assert torch.equal(k2, k4)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [3, 131])
@pytest.mark.parametrize("C", [512, 1024])
@pytest.mark.parametrize("nW,rate", [(0, 0.0), (4, 0.0), (4, 0.2)])
def test_perhead_backward_matches_autograd_of_plain(B, C, nW, rate):
    from focal_tpu_torch.ops.pallas_kernels import (
        fused_window_block_backward_reference, fused_window_block_perhead,
        fused_window_block_perhead_backward)

    dev = _card()
    N, H = 9, 4
    rng = np.random.default_rng(C + nW + B + 1)
    args = _args(rng, B, N, C, H, nW, dev)
    dy = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32)).to(dev)
    keep = fused_window_block_perhead(*args, seed=5, rate=rate)[1] if rate else None
    before = fused_window_block_perhead_backward.launches
    got = fused_window_block_perhead_backward(*args, dy, keep, rate)
    torch.cuda.synchronize()
    assert fused_window_block_perhead_backward.launches == before + 1
    want = fused_window_block_backward_reference(*args, dy, keep, rate)
    for name, g, w in zip(["dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "drel_bias"], got, want):
        assert g.shape == w.shape, name
        assert _rel(g, w) <= 1e-4, (name, _rel(g, w))
    again = fused_window_block_perhead_backward(*args, dy, keep, rate)
    for g, h in zip(got, again):  # fixed-order sums: bitwise repeatable
        assert torch.equal(g, h)


# (M, N, K, a transposed): the projections at MOD_WIDE shapes with ragged
# rows (qkv at C 512, dx at C 1024: K = 3C) and the weight gradients with a
# ragged row count K; at MOD's C = 64 (128 x 64 tiles: N = 192, 64) qkv with
# ragged rows and dWqkv over a ragged row count
@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K,trans", [
    (333, 1536, 512, False), (4608, 1024, 3072, False), (512, 1536, 333, True),
    (1024, 1024, 4608, True), (4617, 192, 64, False), (4617, 64, 192, False),
    (64, 192, 4617, True),
    # #10-#12's products: z = x W1 and dh = g2 W2^T (K = C), y = h W2 and
    # dx = dz W1^T (K = H) at MOD_WIDE stage 0 (C 256) and MOD stage 0 (C
    # 64); x^T dz and h^T g2 over a split's rows (1,472 at MOD_WIDE audio
    # stage 0, 448 at MOD seismic stage 0)
    (4617, 1024, 256, False), (4617, 256, 1024, False), (4617, 256, 64, False),
    (4617, 64, 256, False), (256, 1024, 1472, True), (1024, 256, 1472, True),
    (64, 256, 448, True), (256, 64, 448, True),
])
def test_gemm_3xtf32_matches_its_emulation(M, N, K, trans):
    """The tensor-core core of #2-#5 and #10-#12 against its plain emulation
    (gemm_3xtf32_reference) and the exact product: within 1e-5 of both,
    relative; one TF32 product is ~4x outside the f32 gates."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    rng = np.random.default_rng(M + N + K)
    a = rng.normal(size=(K, M) if trans else (M, K)).astype(np.float32)
    b = (rng.normal(size=(K, N)) * K**-0.5).astype(np.float32)
    before = pk.gemm_3xtf32.launches
    got = pk.gemm_3xtf32(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev), trans)
    torch.cuda.synchronize()
    assert pk.gemm_3xtf32.launches == before + 1 and got.shape == (M, N)
    at = torch.from_numpy(a.T.copy() if trans else a)
    emulated = pk.gemm_3xtf32_reference(at, torch.from_numpy(b))
    exact = torch.from_numpy((at.double().numpy() @ b.astype(np.float64)))
    assert _rel(got.cpu(), emulated) <= 1e-5
    assert _rel(got.cpu().double(), exact) <= 1e-5


@pytest.mark.gpu
def test_window_block_routes_wide_blocks_to_the_perhead_kernels():
    """At C = 512 the autograd pair launches #4 and #5 and neither #2 nor
    #3, and its gradients match autograd of the plain version."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    B, N, C, H, nW = 40, 9, 512, 4, 4
    rng = np.random.default_rng(12)
    args = _args(rng, B, N, C, H, nW, dev)
    leaves = [a.clone().requires_grad_(True) for a in args[:6]]
    counts = [k.launches for k in (pk.fused_window_block_dropout, pk.fused_window_block_backward,
                                   pk.fused_window_block_perhead,
                                   pk.fused_window_block_perhead_backward)]
    y = pk.window_block(*leaves, args[6], seed=4, rate=0.2)
    dy = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32)).to(dev)
    got = torch.autograd.grad(y, leaves, dy)
    after = [k.launches for k in (pk.fused_window_block_dropout, pk.fused_window_block_backward,
                                  pk.fused_window_block_perhead,
                                  pk.fused_window_block_perhead_backward)]
    assert [a - b for a, b in zip(after, counts)] == [0, 0, 1, 1]
    _, keep = pk.fused_window_block_perhead(*args, seed=4, rate=0.2)
    ref_leaves = [a.clone().requires_grad_(True) for a in args[:6]]
    ref = pk.fused_window_block_reference(*ref_leaves, args[6], keep, 0.2)
    assert float((y - ref).detach().abs().max()) <= 1e-4
    for g, w in zip(got, torch.autograd.grad(ref, ref_leaves, dy)):
        assert _rel(g, w) <= 1e-4


@pytest.mark.gpu
def test_wrappers_raise_on_a_failed_launch_plan():
    """A geometry that the kernels have no plan for raises before anything
    launches; nothing falls back: #2-#5 at C = 4096 with one head (one
    (window, head) pair's rows of 4,096 floats do not fit the attention's
    shared memory). Narrower heads take fewer pairs a block
    (test_training_kernels_at_other_head_widths)."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    wide = _args(np.random.default_rng(3), 2, 9, 4096, 1, 0, dev)
    dy = torch.zeros_like(wide[0])
    before = [k.launches for k in (pk.fused_window_block_dropout, pk.fused_window_block_perhead)]
    with pytest.raises(RuntimeError, match="no launch plan"):
        pk.fused_window_block_dropout(*wide, seed=1, rate=0.2)
    with pytest.raises(RuntimeError, match="no launch plan"):
        pk.fused_window_block_perhead(*wide)
    with pytest.raises(RuntimeError, match="no launch plan"):
        pk.fused_window_block_backward(*wide, dy)
    with pytest.raises(RuntimeError, match="no launch plan"):
        pk.fused_window_block_perhead_backward(*wide, dy)
    assert [k.launches for k in (pk.fused_window_block_dropout,
                                 pk.fused_window_block_perhead)] == before


# ---------------------------------------------------------------------------
# conv-tower kernels: #13 (forward) and #14 (backward) at the MOD (C = 64,
# views fused: 512 samples of 10 intervals) and MOD_WIDE (C = 256, 256
# samples) tower geometries of DeepSense, seismic (first conv inside, KW 3,
# Cin 2) and audio (first conv outside, KW 5). Output, means and variances
# 1e-5 relative to the plain version; the five gradients 1e-4 relative, and
# where both are below 1e-2 absolutely to 1e-2, as the JAX package's own
# test holds its kernels (a conv bias before a BatchNorm has a true
# gradient of 0: both sides sum ~1e5 rows of cancellation noise, ~1e-3);
# a second call gives the same bits.

def _tower_args(rng, samples, intervals, S, C, kw, external, layers, dev, cin=2):
    """A tower's inputs: its first conv over ``cin`` channels (C for an
    external one, whose width 80 is a placeholder), every later one of
    width ``kw``."""
    R = samples * intervals
    cin0 = C if external else cin
    cfgs = tuple((kw if k else (kw if not external else 80), cin0 if k == 0 else C, C, k > 0)
                 for k in range(layers))
    x0 = rng.normal(size=(R, S, cin0)).astype(np.float32)
    ws, bs, scales, biases, masks = [], [], [], [], []
    for kwk, cin, cout, _ in cfgs:
        fan = (kwk * cin) ** -0.5
        ws.append(np.zeros((1, 1), np.float32) if (external and not ws) else
                  (rng.normal(size=(kwk * cin, cout)) * fan).astype(np.float32))
        bs.append((rng.normal(size=(cout,)) * 0.1).astype(np.float32))
        scales.append((1.0 + 0.1 * rng.normal(size=(cout,))).astype(np.float32))
        biases.append((0.1 * rng.normal(size=(cout,))).astype(np.float32))
        masks.append(((rng.random((samples, cout)) > 0.2) / 0.8).astype(np.float32))

    def t(a, grad=False):
        return torch.from_numpy(a).to(dev).requires_grad_(grad)

    return cfgs, t(x0, True), [[t(a, True) for a in g] for g in (ws, bs, scales, biases)], \
        [t(m) for m in masks]


def _tower_grads(fn, cfgs, x0, params, masks, dy, external):
    y, mus, vars_ = fn(x0, cfgs, *params, masks, external)
    # an external first conv's w and b are the tower's placeholders: left out
    leaves = [x0] + [p for gi, group in enumerate(params) for k, p in enumerate(group)
                     if not (external and k == 0 and gi < 2)]
    return y, mus, vars_, torch.autograd.grad(y, leaves, dy)


def _exact(t):
    return t.detach().double().requires_grad_(t.requires_grad)


def _tower_case(samples, C, external, S=20, layers=5, cin=2, kw=None, exact=False):
    """A tower against autograd of its plain version on the card: output,
    statistics and gradients within the gates above, and the same bits on
    a second call. The first conv takes ``cin`` channels; every conv but
    an external first one has width ``kw`` (5 after an external first
    conv, else 3). With ``exact`` the plain version runs in float64: a conv
    bias before a BatchNorm has a true gradient of 0, and where the tower
    sums ~6.6e5 rows (S 128) the f32 plain version's cancellation noise
    there reaches ~2e-2, past the 1e-2 absolute gate, while the float64
    one stays ~1e-10."""
    from focal_tpu_torch.ops.conv_tower import fused_conv_tower, fused_conv_tower_reference

    dev = _card()
    rng = np.random.default_rng(samples + C + external)
    if kw is None:
        kw = 5 if external else 3
    cfgs, x0, params, masks = _tower_args(rng, samples, 10, S, C, kw, external, layers, dev, cin)
    dy = torch.from_numpy(rng.normal(size=(samples * 10, S, C)).astype(np.float32)).to(dev)
    got = _tower_grads(fused_conv_tower, cfgs, x0, params, masks, dy, external)
    again = _tower_grads(fused_conv_tower, cfgs, x0, params, masks, dy, external)
    if exact:
        want = _tower_grads(fused_conv_tower_reference, cfgs, _exact(x0),
                            [[_exact(p) for p in group] for group in params],
                            [m.double() for m in masks], dy.double(), external)
    else:
        want = _tower_grads(fused_conv_tower_reference, cfgs, x0, params, masks, dy, external)
    torch.cuda.synchronize()
    assert _rel(got[0].detach(), want[0].detach()) <= 1e-5
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        assert _rel(a, b) <= 1e-5
    for i, (g, w) in enumerate(zip(got[3], want[3])):
        if max(float(g.abs().max()), float(w.abs().max())) < 1e-2:
            assert float((g - w).abs().max()) <= 1e-2, i
        else:
            assert _rel(g, w) <= 1e-4, (i, _rel(g, w))
    for a, b in zip([got[0], *got[1], *got[2], *got[3]], [again[0], *again[1], *again[2], *again[3]]):
        assert torch.equal(a, b)  # fixed-order sums: bitwise repeatable


# (samples, C, external): MOD (C 64) and MOD_WIDE (C 256) at their fused
# batches, and a few samples (ragged row tiles, weight-gradient splits) at
# either width
@pytest.mark.gpu
@pytest.mark.parametrize("samples,C,external", [
    (512, 64, False), (512, 64, True), (256, 256, False), (256, 256, True), (7, 64, False),
    (7, 256, True),
])
def test_conv_tower_matches_plain_on_card(samples, C, external):
    _tower_case(samples, C, external)


@pytest.mark.gpu
@pytest.mark.parametrize("S,C", [(200, 64), (1, 16)])
def test_conv_tower_at_other_spectra_and_widths(S, C):
    """A spectrum longer than a 128-row tile, and a spectrum of one position
    (every tap but the centre reads padding) at MOD_TINY's width C 16 (a
    32-deep K-slice spans two taps)."""
    _tower_case(5, C, False, S=S, layers=3)


# The towers of the ACIDS, PAMAP2 and RealWorld_HAR recipes and of the
# two-location mod_extractor, at their fused batch (512 samples) and at 7
# samples: cin 6 (the narrow first conv on the CUDA cores) at S 20 and 25;
# ACIDS's S 41 after its strided first conv (kw 3 inside); cin 1 with kw 4
# (even: SAME pads one position before, two after) in every layer at S 128.
# Held against the plain version in float64 (``_tower_case``'s ``exact``).
@pytest.mark.gpu
@pytest.mark.parametrize("samples,S,cin,kw,external,layers", [
    (512, 20, 6, 3, False, 5), (512, 25, 6, 3, False, 5), (7, 25, 6, 3, False, 5),
    (512, 41, 64, 3, True, 5), (7, 41, 64, 3, True, 5),
    (512, 128, 1, 4, False, 4), (7, 128, 1, 4, False, 4),
])
def test_conv_tower_at_the_recipe_and_two_location_geometries(samples, S, cin, kw, external,
                                                              layers):
    _tower_case(samples, 64, external, S=S, layers=layers, cin=cin, kw=kw, exact=True)


@pytest.mark.gpu
@pytest.mark.parametrize("external", [False, True])
def test_conv_tower_launch_counts(external):
    """A five-layer tower: forward the first conv (inside) and five applies,
    or five applies; backward five sums and five applies, or four and the
    external first conv's dc."""
    from focal_tpu_torch.ops.conv_tower import fused_conv_tower, fused_conv_tower_backward

    dev = _card()
    rng = np.random.default_rng(4)
    cfgs, x0, params, masks = _tower_args(rng, 16, 10, 20, 64, 5 if external else 3, external, 5,
                                          dev)
    f0, b0 = fused_conv_tower.launches, fused_conv_tower_backward.launches
    y, _, _ = fused_conv_tower(x0, cfgs, *params, masks, external)
    assert fused_conv_tower.launches - f0 == (5 if external else 6)
    y.sum().backward()
    torch.cuda.synchronize()
    assert fused_conv_tower_backward.launches - b0 == 10


@pytest.mark.gpu
def test_conv_tower_raises_on_what_its_plan_cannot_take():
    """C 6: the products take C % 4 == 0, so the wrapper raises and the
    route's gate (``tower_takes``) sends such a block to its cuDNN convs
    (``tower_fits``, the JAX package's gate, admits it)."""
    from focal_tpu_torch.ops.conv_tower import fused_conv_tower, tower_fits, tower_takes

    dev = _card()
    rng = np.random.default_rng(6)
    cfgs, x0, params, masks = _tower_args(rng, 4, 10, 20, 6, 3, False, 2, dev)
    assert tower_fits(40, 20, 6, kw_max=3) and not tower_takes(40, 20, 6, 2, kw_max=3)
    with pytest.raises(RuntimeError, match="no launch plan"):
        fused_conv_tower(x0, cfgs, *params, masks, False)
    cfgs, x0, params, masks = _tower_args(rng, 4, 10, 20, 64, 3, False, 2, dev)
    with pytest.raises(TypeError):
        fused_conv_tower(x0.double(), cfgs, *params, masks, False)
    with pytest.raises(ValueError):  # 3 mask rows do not divide R = 40
        fused_conv_tower(x0, cfgs, *params, [m[:3] for m in masks], False)


@pytest.mark.gpu
def test_conv_tower_workspaces_are_the_plan_models():
    """focal_ct_workspace's sizes on this card equal ops/conv_tower.py's
    layer_plan (the plan the CPU tests hold) at the MOD and MOD_WIDE tower
    layers and at MOD_TINY's width."""
    from focal_tpu_torch.ops import conv_tower as ct

    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for R, C, layers in ((5120, 64, [(3, 2), (3, 64), (5, 64)]),
                         (2560, 256, [(3, 2), (3, 256), (5, 256)]), (50, 16, [(3, 2), (3, 16)])):
        for kw, cin in layers:
            want = ct.layer_plan(R, 20, kw, cin, C, sms)["workspace"]
            got = {"forward": ct._workspace("forward", R, 20, cin, C, kw, dev),
                   "bwd_stats": ct._workspace("bwd_stats", R, 20, C, C, 1, dev),
                   "bwd_apply": ct._workspace("bwd_apply", R, 20, cin, C, kw, dev)}
            assert {k: t.numel() for k, t in got.items()} == want, (R, C, kw, cin)


@pytest.mark.gpu
@pytest.mark.parametrize("C,external", [(64, False), (256, True)])
def test_conv_tower_launches_only_conv_tower_kernels(C, external):
    """Profiled calls of each wrapper of #13 (the first conv, the apply
    with the next conv, the last apply) and #14 (the sums, the backward
    apply of a residual and of the first layer, dc alone) runs only
    csrc/conv_tower.cu's kernels, gemm_splitk.cuh's reduction of the weight
    gradients as instantiated for it among them; no cuDNN, cuBLAS or
    PyTorch kernel."""
    import math
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from focal_tpu_torch.ops import conv_tower as ct

    dev = _card()
    rng = np.random.default_rng(C + external)
    kw = 5 if external else 3
    cfgs, x0, params, masks = _tower_args(rng, 16, 10, 20, C, kw, external, 3, dev)
    x0, params = x0.detach(), [[p.detach() for p in g] for g in params]
    _, _, _, sv = ct.tower_forward(x0, cfgs, *params, masks, external)
    R, S = sv.R, sv.S
    da = torch.from_numpy(rng.normal(size=(R * S, C)).astype(np.float32)).to(dev)
    m = torch.zeros((2, C), dtype=torch.float32, device=dev)
    ws = params[0]

    def calls():
        if not external:
            ct._conv0(sv.x2, ws[0], params[1][0], params[2][0], params[3][0], kw, R, S)
        ct._apply(sv.c_list[1], sv.rows_list[1], masks[1], sv.a_list[0],
                  (ws[2], params[1][2], kw, params[2][2], params[3][2]), R, S)
        ct._apply(sv.c_list[2], sv.rows_list[2], masks[2], sv.a_list[1], None, R, S)
        ct._bwd_stats(da, sv.c_list[2], masks[2], sv.rows_list[2], R, S)
        ct._bwd_apply(da, sv.c_list[2], masks[2], sv.rows_list[2], m, sv.a_list[1], ws[2], kw, True,
                      R, S)
        if external:
            ct._bwd_dc(da, sv.c_list[0], masks[0], sv.rows_list[0], m, R, S)
        else:
            ct._bwd_apply(da, sv.c_list[0], masks[0], sv.rows_list[0], m, sv.x2, ws[0], kw, False,
                          R, S)

    calls()  # built and warm
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    calls()
    end.record()
    torch.cuda.synchronize()
    # at least 20 ms of calls: a trace of a millisecond can lose a kernel's records
    reps = max(5, math.ceil(20.0 / start.elapsed_time(end)))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            calls()
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    kernels = {m.group(1) if m else n for n in names
               for m in [re.search(r"::(\w+)(?:<[^()]*>)?\(", n)]}
    want = {"bn_elementwise_kernel", "conv_gemm_kernel", "bn_stats_kernel", "bn_grad_sums_kernel",
            "bn_grad_stats_kernel", "tap_transpose_kernel", "conv_wgrad_kernel",
            "reduce_partials_kernel"}
    want |= set() if external else {"narrow_conv_kernel", "narrow_convT_kernel",
                                    "narrow_wgrad_kernel"}
    assert kernels == want, names
    shared = [n for n in names if "reduce_partials_kernel" in n]
    assert shared and all("ConvTowerSrc" in n for n in shared), shared


# ---------------------------------------------------------------------------
# the fused MLP (#10, #11, #12): rows T, width C, hidden 4C at the MOD
# widths, T not a multiple of the kernels' 32-row tile


def _mlp_args(rng, T, C, dev, H=None):
    H = 4 * C if H is None else H
    shapes = [(T, C), (C, H), (H,), (H, C), (C,)]
    scales = [1.0, C**-0.5, 0.1, H**-0.5, 0.1]
    return [torch.from_numpy((rng.normal(size=s) * k).astype(np.float32)).to(dev)
            for s, k in zip(shapes, scales)]


def _mlp_rel(got, want):
    return max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("T,C", [(2311, 64), (1170, 128), (301, 256), (77, 32)])
def test_fused_mlp_forward_matches_plain(T, C):
    from focal_tpu_torch.ops import fused_mlp as fm

    dev = _card()
    x, w1, b1, w2, b2 = _mlp_args(np.random.default_rng(T), T, C, dev)
    before = fm.fused_mlp_forward.launches
    y = fm.fused_mlp_forward(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert fm.fused_mlp_forward.launches == before + 1
    assert float((y - fm.fused_mlp_reference(x, w1, b1, w2, b2)).abs().max()) <= 1e-4
    keep1, keep2 = fm.mlp_keep_masks(7, T, C, 4 * C, 0.2, dev)
    yd = fm.fused_mlp_dropout_forward(x, w1, b1, w2, b2, 7, 0.2)
    want = fm.fused_mlp_dropout_reference(x, w1, b1, w2, b2, keep1, keep2, 0.2)
    assert float((yd - want).abs().max()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("T,C", [(2311, 64), (301, 256)])
@pytest.mark.parametrize("seed", [None, 11])
def test_fused_mlp_backward_matches_autograd_of_plain_and_repeats(T, C, seed):
    from focal_tpu_torch.ops import fused_mlp as fm

    dev = _card()
    rng = np.random.default_rng(T + C)
    x, w1, b1, w2, b2 = _mlp_args(rng, T, C, dev)
    g = torch.from_numpy(rng.normal(size=(T, C)).astype(np.float32)).to(dev)
    keep = (None, None) if seed is None else fm.mlp_keep_masks(seed, T, C, 4 * C, 0.2, dev)
    args = (x, w1, b1, w1.t().contiguous(), w2.t().contiguous(), g, seed, 0.2)
    got = fm.fused_mlp_backward(*args)
    again = fm.fused_mlp_backward(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = fm.fused_mlp_backward_reference(x, w1, b1, w2, b2, g, *keep, 0.2)
    assert _mlp_rel(got, want) <= 1e-4


@pytest.mark.gpu
def test_fused_mlp_keep_rates_and_autograd_counts():
    from focal_tpu_torch.ops import fused_mlp as fm

    dev = _card()
    T, C = 4096, 64
    keep1, keep2 = fm.mlp_keep_masks(3, T, C, 4 * C, 0.2, dev)
    for k in (keep1, keep2):
        rate = float(k.double().mean())
        assert abs(rate - 0.8) <= 5 * (0.16 / k.numel()) ** 0.5
    assert not torch.equal(keep1, fm.mlp_keep_masks(4, T, C, 4 * C, 0.2, dev)[0])
    x, w1, b1, w2, b2 = [t.requires_grad_(True) for t in _mlp_args(np.random.default_rng(1), T, C, dev)]
    counts = [fm.fused_mlp_forward.launches, fm.fused_mlp_dropout_forward.launches,
              fm.fused_mlp_backward.launches]
    fm.fused_mlp_dropout(x, w1, b1, w2, b2, 5, 0.2).sum().backward()
    fm.fused_mlp(x, w1, b1, w2, b2).sum().backward()
    assert [fm.fused_mlp_forward.launches, fm.fused_mlp_dropout_forward.launches,
            fm.fused_mlp_backward.launches] == [counts[0] + 1, counts[1] + 1, counts[2] + 2]


@pytest.mark.gpu
def test_fused_mlp_raises_on_a_width_it_cannot_take():
    """H or C not a multiple of 4 raises (the route's gate, ``mlp_takes``,
    sends such widths to the Linears); any C that is one is taken: C 512 at
    H 2048, which ``mlp_fits`` does not route, launches."""
    from focal_tpu_torch.ops import fused_mlp as fm

    dev = _card()
    x, w1, b1, w2, b2 = _mlp_args(np.random.default_rng(2), 64, 512, dev)
    y = fm.fused_mlp_forward(x, w1, b1, w2, b2)
    assert float((y - fm.fused_mlp_reference(x, w1, b1, w2, b2)).abs().max()) <= 1e-4
    with pytest.raises(ValueError, match="unsupported width"):
        fm.fused_mlp_forward(x, w1[:, :2046].contiguous(), b1[:2046].contiguous(),
                             w2[:2046].contiguous(), b2)
    x, w1, b1, w2, b2 = _mlp_args(np.random.default_rng(2), 64, 64, dev)
    with pytest.raises(ValueError, match="unsupported width"):
        fm.fused_mlp_forward(x[:, :62].contiguous(), w1[:62].contiguous(), b1, w2[:, :62].contiguous(),
                             b2[:62].contiguous())
    with pytest.raises(TypeError):
        fm.fused_mlp_forward(x.double(), w1, b1, w2, b2)


@pytest.mark.gpu
@pytest.mark.parametrize("T,C", [(1537, 384), (405, 412)])
def test_fused_mlp_at_the_widest_routed_widths(T, C):
    """The widest widths ``mlp_takes`` routes to the kernels (C 384 / H
    1,536, a Swin-T third stage; C 412 / H 1,648, whose columns end inside a
    64-wide tile): #10, and #11 fed its own masks, within 1e-4 of plain;
    #12 with the masks and without within 1e-4 relative; the same bits on a
    second call."""
    from focal_tpu_torch.ops import fused_mlp as fm

    dev = _card()
    assert fm.mlp_takes(C, 4 * C)
    rng = np.random.default_rng(C)
    x, w1, b1, w2, b2 = _mlp_args(rng, T, C, dev)
    g = torch.from_numpy(rng.normal(size=(T, C)).astype(np.float32)).to(dev)
    tr = w1.t().contiguous(), w2.t().contiguous()
    got = _mlp_calls(fm, x, w1, b1, w2, b2, g, 9, *tr)
    again = _mlp_calls(fm, x, w1, b1, w2, b2, g, 9, *tr)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        for u, v in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            assert torch.equal(u, v)
    keep1, keep2 = fm.mlp_keep_masks(9, T, C, 4 * C, 0.2, dev)
    assert float((got[0] - fm.fused_mlp_reference(x, w1, b1, w2, b2)).abs().max()) <= 1e-4
    want = fm.fused_mlp_dropout_reference(x, w1, b1, w2, b2, keep1, keep2, 0.2)
    assert float((got[1] - want).abs().max()) <= 1e-4
    assert _mlp_rel(got[2], fm.fused_mlp_backward_reference(x, w1, b1, w2, b2, g, keep1, keep2,
                                                           0.2)) <= 1e-4
    assert _mlp_rel(got[3], fm.fused_mlp_backward_reference(x, w1, b1, w2, b2, g)) <= 1e-4


@pytest.mark.gpu
def test_every_width_a_gate_admits_has_a_launch_plan():
    """Each route's gate admits only widths its kernels plan for, and the
    window block's gate refuses only where they do: the MLP at every C
    (H = 4C and 2C), the conv tower at every C it routes, the whole-block
    kernels at every (C, H) from 4 to 2,048 columns a head, the
    attention-only kernels at every head width; the bf16 MLP gate and the
    bf16 whole-block gate (#1-bf16 to #5-bf16) exactly where the bf16
    kernels plan. Plans only: nothing launches."""
    from focal_tpu_torch.ops import conv_tower as ct
    from focal_tpu_torch.ops import fused_mlp as fm
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    for C in range(1, 480):
        for H in (2 * C, 4 * C):
            if fm.mlp_takes(C, H):
                for backward in (False, True):
                    fm.mlp_launch_plan(8192, C, H, backward, dev)
    for C in range(1, 300):
        for cin in (2, C):
            if ct.tower_takes(5120, 20, C, cin, kw_max=5):
                for kind, a, b in (("forward", cin, C), ("bwd_stats", C, C), ("bwd_apply", cin, C)):
                    ct._workspace(kind, 5120, 20, a, b, 5, dev)
    lib = pk._window_block_lib()
    for H in (1, 2, 4):
        for hd in list(range(1, 64)) + list(range(64, 2049, 16)):
            C = H * hd
            ok = all(lib.focal_wblock_bwd_workspace(7, 9, C, C, H, d, pk.ctypes.byref(
                pk.ctypes.c_longlong(0))) == 0 for d in (0, 1))
            ok = ok and lib.focal_wblock_fwd_workspace(7, 9, C, C, H, pk.ctypes.byref(
                pk.ctypes.c_longlong(0))) == 0
            assert ok == pk.wblock_takes(9, C, H), (C, H)
    for C in range(1, 480):
        for H in (2 * C, 4 * C):
            if fm.mlp_fits(C, H):
                ok = True
                for backward in (False, True):
                    try:
                        fm.mlp_launch_plan(8192, C, H, backward, dev, torch.bfloat16)
                    except RuntimeError:
                        ok = False
                assert ok == fm.mlp_takes(C, H, torch.bfloat16), (C, H)
    null = [None] * 10
    for H in (1, 2, 4):
        for hd in list(range(1, 64)) + list(range(64, 2049, 16)):
            C = H * hd
            # the bf16 backward's and forward's own plans (two slots of their
            # rings, or one)
            ok = all(fn(7, 9, C, C, H, d, pk.ctypes.byref(pk.ctypes.c_longlong(0))) == 0
                     for fn in (lib.focal_wblock_bwd_workspace_bf16,
                                lib.focal_wblock_fwd_workspace_bf16) for d in (0, 1))
            # zero windows: the bf16 entry points check the geometry and launch nothing
            ok = ok and lib.focal_wblock_fwd_bf16(*null, 0, 9, C, C, H, 1, 0, 0, 1.0, None) == 0
            ok = ok and lib.focal_wblock_bwd_bf16(*null[:8], 1.0, *null[:4], 0, 9, C, C, H, 1,
                                                  None) == 0
            assert ok == pk.wblock_takes(9, C, H, torch.bfloat16), (C, H)
    alib = pk._window_attention_lib()
    for hd in range(1, 300):
        ok = all(alib.focal_wattn_bwd_workspace(37, 4, 9, hd, d, pk.ctypes.byref(
            pk.ctypes.c_longlong(0))) == 0 for d in (0, 1))
        assert ok == pk.attention_takes(9, hd), hd


def _traced(calls, reps=5):
    """``calls`` ``reps`` times between pauses, synchronised: a trace of one
    round of small launches can lose the records of its shortest kernels
    (the masked gradient's), as chip_smoke.py's kernel_phase_split found."""
    import time

    time.sleep(0.05)
    for _ in range(reps):
        calls()
    torch.cuda.synchronize()
    time.sleep(0.05)


def _mlp_calls(fm, x, w1, b1, w2, b2, g, seed, w1t, w2t):
    """#10, #11 (``seed``, rate 0.2) and #12 with #11's masks and without;
    w1t and w2t are w1 and w2 transposed."""
    return (fm.fused_mlp_forward(x, w1, b1, w2, b2),
            fm.fused_mlp_dropout_forward(x, w1, b1, w2, b2, seed, 0.2),
            fm.fused_mlp_backward(x, w1, b1, w1t, w2t, g, seed, 0.2),
            fm.fused_mlp_backward(x, w1, b1, w1t, w2t, g))


@pytest.mark.gpu
def test_fused_mlp_in_row_chunks_matches_plain_and_repeats_bitwise():
    """A full MOD_WIDE stage-0 launch (audio: T 73,728 rows, C 256, H 1,024)
    runs in three row chunks (each [rows, H] workspace within 128 MiB): #10,
    and #11 fed its own masks, within 1e-4 of plain; #12's gradients with
    the masks and without within 1e-4 relative; the same bits on a second
    call of each."""
    from focal_tpu_torch.ops import fused_mlp as fm

    dev = _card()
    T, C = 73728, 256
    rng = np.random.default_rng(21)
    x, w1, b1, w2, b2 = _mlp_args(rng, T, C, dev)
    g = torch.from_numpy(rng.normal(size=(T, C)).astype(np.float32)).to(dev)
    tr = w1.t().contiguous(), w2.t().contiguous()
    for backward in (False, True):
        floats, chunks = fm.mlp_launch_plan(T, C, 4 * C, backward, dev)
        assert chunks == 3 and floats * 4 <= (1 + 2 * backward) * 2**27
    got = _mlp_calls(fm, x, w1, b1, w2, b2, g, 9, *tr)
    again = _mlp_calls(fm, x, w1, b1, w2, b2, g, 9, *tr)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        for u, v in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            assert torch.equal(u, v)
    keep1, keep2 = fm.mlp_keep_masks(9, T, C, 4 * C, 0.2, dev)
    assert float((got[0] - fm.fused_mlp_reference(x, w1, b1, w2, b2)).abs().max()) <= 1e-4
    want = fm.fused_mlp_dropout_reference(x, w1, b1, w2, b2, keep1, keep2, 0.2)
    assert float((got[1] - want).abs().max()) <= 1e-4
    assert _mlp_rel(got[2], fm.fused_mlp_backward_reference(x, w1, b1, w2, b2, g, keep1, keep2,
                                                           0.2)) <= 1e-4
    assert _mlp_rel(got[3], fm.fused_mlp_backward_reference(x, w1, b1, w2, b2, g)) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("T,C", [(2311, 64), (301, 256)])
def test_fused_mlp_launches_only_fused_mlp_kernels(T, C):
    """A profiled call of #10, #11 and #12 (with masks and without) runs only
    csrc/fused_mlp.cu's kernels: the hidden and output products, the masked
    gradient, and gemm_splitk.cuh's weight gradients and reduction as
    instantiated for fused_mlp.cu; no cuBLAS kernel."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from focal_tpu_torch.ops import fused_mlp as fm

    dev = _card()
    rng = np.random.default_rng(T)
    x, w1, b1, w2, b2 = _mlp_args(rng, T, C, dev)
    g = torch.from_numpy(rng.normal(size=(T, C)).astype(np.float32)).to(dev)
    tr = w1.t().contiguous(), w2.t().contiguous()
    _mlp_calls(fm, x, w1, b1, w2, b2, g, 3, *tr)  # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _traced(lambda: _mlp_calls(fm, x, w1, b1, w2, b2, g, 3, *tr))
    names = {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    kernels = {m.group(1) if m else n for n in names
               for m in [re.search(r"::(\w+)(?:<[^()]*>)?\(", n)]}
    assert kernels == {"mlp_hidden_kernel", "mlp_out_kernel", "mlp_g2_kernel",
                       "wgrad_gemm_kernel", "reduce_partials_kernel"}, names
    shared = [n for n in names if "wgrad_gemm_kernel" in n or "reduce_partials_kernel" in n]
    assert shared and all("FusedMlpSrc" in n for n in shared), shared


# ---------------------------------------------------------------------------
# attention-only kernels (-no_pallas_block): #6 (forward), #7 (forward with
# attention dropout), #8 and #9 (their backwards) on q, k, v [B_, H, N, hd]
# at the MOD head widths (16, 32, 64) and MOD_WIDE's (128, 256), window
# batches that are not a multiple of the kernels' pairs per block or of nW.
# #6, and #7 against the plain forward fed #7's mask, 1e-4 absolute; #8/#9
# 1e-4 relative per gradient and the same bits on a second call.


def _attn_args(rng, B, H, N, hd, nW, dev):
    """q (pre-scaled by hd**-0.5), k, v, the output gradient g, rel_bias
    and a shift-style mask of 0 / -100 (or None)."""
    q, k, v, g = (rng.normal(size=(B, H, N, hd)).astype(np.float32) for _ in range(4))
    q *= np.float32(hd**-0.5)
    rel_bias = (0.02 * rng.normal(size=(H, N, N))).astype(np.float32)
    mask = None
    if nW:
        mask = np.where(rng.random((nW, N, N)) < 0.3, -100.0, 0.0).astype(np.float32)
    return [None if a is None else torch.from_numpy(a).to(dev) for a in (q, k, v, rel_bias, mask, g)]


ATTN_GEOMETRIES = [(509, 4, 9, 16, 16), (512, 4, 9, 32, 64), (511, 4, 9, 64, 0),
                   (130, 4, 9, 128, 4), (67, 4, 9, 256, 4), (37, 2, 4, 8, 3), (64, 4, 16, 256, 8),
                   (33, 2, 9, 4, 0),
                   # RealWorld_HAR's shifted stages: nW 48 at hd 16, nW 12 at hd 32
                   (528, 4, 9, 16, 48), (516, 4, 9, 32, 12)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,N,hd,nW", ATTN_GEOMETRIES)
def test_attention_forwards_match_plain(B, H, N, hd, nW):
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    q, k, v, rel_bias, mask, _ = _attn_args(np.random.default_rng(B + hd), B, H, N, hd, nW, dev)
    before = [pk.fused_window_attention.launches, pk.fused_window_attention_dropout.launches]
    y = pk.fused_window_attention(q, k, v, rel_bias, mask)
    yd = pk.fused_window_attention_dropout(q, k, v, rel_bias, mask, 21, 0.2)
    keep = pk.window_attention_keep_mask(21, B, H, N, 0.2, dev)
    torch.cuda.synchronize()
    assert [pk.fused_window_attention.launches,
            pk.fused_window_attention_dropout.launches] == [before[0] + 1, before[1] + 1]
    ref = pk.fused_window_attention_reference(q, k, v, rel_bias, mask)
    assert y.shape == ref.shape and float((y - ref).abs().max()) <= 1e-4
    ref_d = pk.fused_window_attention_dropout_reference(q, k, v, rel_bias, mask, keep, 0.2)
    assert float((yd - ref_d).abs().max()) <= 1e-4
    assert keep.dtype == torch.uint8 and keep.shape == (B, H, N, N) and int(keep.max()) <= 1
    kept = float(keep.double().mean())
    assert abs(kept - 0.8) <= 5 * (0.16 / keep.numel()) ** 0.5, kept
    assert torch.equal(yd, pk.fused_window_attention_dropout(q, k, v, rel_bias, mask, 21, 0.2))


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,N,hd,nW", ATTN_GEOMETRIES)
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_attention_backward_matches_autograd_of_plain_and_repeats(B, H, N, hd, nW, rate):
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    q, k, v, rel_bias, mask, g = _attn_args(np.random.default_rng(B + hd + 1), B, H, N, hd, nW, dev)
    seed, keep = None, None
    if rate:
        seed, keep = 5, pk.window_attention_keep_mask(5, B, H, N, rate, dev)
    kernel = pk.fused_window_attention_dropout_backward if rate else pk.fused_window_attention_backward
    before = kernel.launches
    got = pk.fused_window_attention_backward(q, k, v, rel_bias, mask, g, seed, rate)
    again = pk.fused_window_attention_backward(q, k, v, rel_bias, mask, g, seed, rate)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: the same bits
    want = pk.fused_window_attention_backward_reference(q, k, v, rel_bias, mask, g, keep, rate)
    for name, a, w in zip(["dq", "dk", "dv", "drel_bias"], got, want):
        assert a.shape == w.shape, name
        assert _rel(a, w) <= 1e-4, (name, _rel(a, w))


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,N,hd,nW", ATTN_GEOMETRIES)
def test_attention_q_scale_and_out_forms_are_the_prescaled_calls_bitwise(B, H, N, hd, nW):
    """The route's forms: q unscaled (the head view of a [B_, N, 3C]
    tensor) with ``q_scale``, #6/#7 writing into the head view of a [B_,
    N, C] tensor, #8/#9 with ``q_scale``: the same bits as the calls on q *
    scale with contiguous outputs (the kernels' f32 multiply rounds as the
    caller's), one launch counted a call."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    rng = np.random.default_rng(B + hd + 11)
    C, s = H * hd, hd**-0.5
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * C)).astype(np.float32)).to(dev)
    q, k, v = pk._head_views(qkv, H)
    qs = q * s
    _, _, _, rel_bias, mask, g = _attn_args(rng, B, H, N, hd, nW, dev)
    kernels = (pk.fused_window_attention, pk.fused_window_attention_dropout,
               pk.fused_window_attention_backward, pk.fused_window_attention_dropout_backward)
    before = [f.launches for f in kernels]
    for seed, rate in ((None, 0.0), (17, 0.2)):
        y = torch.empty((B, N, C), device=dev)
        view = y.view(B, N, H, hd).transpose(1, 2)
        if rate:
            want = pk.fused_window_attention_dropout(qs, k, v, rel_bias, mask, seed, rate)
            got = pk.fused_window_attention_dropout(q, k, v, rel_bias, mask, seed, rate, q_scale=s,
                                                    out=view)
        else:
            want = pk.fused_window_attention(qs, k, v, rel_bias, mask)
            got = pk.fused_window_attention(q, k, v, rel_bias, mask, q_scale=s, out=view)
        assert got is view and torch.equal(y, want.transpose(1, 2).reshape(B, N, C))
        want = pk.fused_window_attention_backward(qs, k, v, rel_bias, mask, g, seed, rate)
        got = pk.fused_window_attention_backward(q, k, v, rel_bias, mask, g, seed, rate, q_scale=s)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(kernels, before)] == [2, 2, 2, 2]


@pytest.mark.gpu
def test_attention_mask_equals_the_whole_block_kernels_mask():
    """#7 draws #2's mask: the same seed and geometry give the same bits."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    B, N, C, H, nW = 300, 9, 64, 4, 4
    args = _args(np.random.default_rng(8), B, N, C, H, nW, dev)
    _, keep2 = pk.fused_window_block_dropout(*args, seed=31, rate=0.2)
    keep7 = pk.window_attention_keep_mask(31, B, H, N, 0.2, dev)
    assert torch.equal(keep2, keep7)
    assert not torch.equal(keep7, pk.window_attention_keep_mask(32, B, H, N, 0.2, dev))


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,N,hd,nW", [(509, 4, 9, 16, 16), (512, 4, 9, 32, 64),
                                         (511, 4, 9, 64, 0), (67, 4, 9, 256, 4),
                                         (37, 2, 4, 8, 3), (33, 4, 16, 12, 2),
                                         (528, 4, 9, 16, 48), (516, 4, 9, 32, 12)])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_window_attention_function_on_qkv_views(B, H, N, hd, nW, rate):
    """window_attention_qkv, the route's autograd pair on the qkv Linear's
    [B_, N, 3C] output: #6/#7 forward, #8/#9 writing d(qkv) in that layout
    with dq times the q scale. Output within 1e-4, d(qkv) and d rel_bias
    within 1e-4 relative of autograd of the plain version fed the kernel's
    mask; the same bits as the [B_, H, N, hd] backward scaled and laid out
    on the host, and on a second call. Window batches that end in a ragged
    chunk of pairs."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    rng = np.random.default_rng(B + hd + 7)
    C = H * hd
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * C)).astype(np.float32)).to(dev)
    _, _, _, rel_bias, mask, _ = _attn_args(rng, B, H, N, hd, nW, dev)
    gy = torch.from_numpy(rng.normal(size=(B, H, N, hd)).astype(np.float32)).to(dev)
    keep = pk.window_attention_keep_mask(23, B, H, N, rate, dev) if rate else None
    bwd = pk.fused_window_attention_dropout_backward if rate else pk.fused_window_attention_backward
    runs = []
    for _ in range(2):
        leaves = [qkv.clone().requires_grad_(True), rel_bias.clone().requires_grad_(True)]
        before = bwd.launches
        y = pk.window_attention_qkv(leaves[0], H, leaves[1], mask, seed=23, rate=rate)
        runs.append((y.detach(), torch.autograd.grad(y, leaves, gy)))
        torch.cuda.synchronize()
        assert bwd.launches == before + 1
    (y, got), (y2, again) = runs
    assert torch.equal(y, y2) and all(torch.equal(a, b) for a, b in zip(got, again))
    leaves = [qkv.clone().requires_grad_(True), rel_bias.clone().requires_grad_(True)]
    q, k, v = leaves[0].view(B, N, 3, H, hd).permute(2, 0, 3, 1, 4).unbind(0)
    ref = pk.fused_window_attention_reference(q * hd**-0.5, k, v, leaves[1], mask, keep, rate)
    want = torch.autograd.grad(ref, leaves, gy)
    assert float((y - ref.detach()).abs().max()) <= 1e-4
    for a, w in zip(got, want):
        assert a.shape == w.shape and _rel(a, w) <= 1e-4, _rel(a, w)
    qs = (q * hd**-0.5).detach()
    dq, dk, dv, drb = pk.fused_window_attention_backward(qs, k.detach(), v.detach(), rel_bias,
                                                         mask, gy, 23 if rate else None, rate)
    laid = torch.stack([dq * hd**-0.5, dk, dv]).permute(1, 3, 0, 2, 4).reshape(B, N, 3 * C)
    assert torch.equal(got[0], laid) and torch.equal(got[1], drb)


@pytest.mark.gpu
def test_attention_wrappers_raise_on_what_the_kernels_cannot_take():
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    q, k, v, rel_bias, mask, g = _attn_args(np.random.default_rng(4), 8, 4, 9, 16, 4, dev)
    with pytest.raises(TypeError):
        pk.fused_window_attention(q.double(), k, v, rel_bias, mask)
    with pytest.raises(ValueError, match="geometry"):  # N above the register tile
        pk.fused_window_attention(*_attn_args(np.random.default_rng(5), 2, 4, 17, 16, 0, dev)[:5])
    with pytest.raises(ValueError, match="geometry"):  # hd not a multiple of 4
        pk.fused_window_attention(*_attn_args(np.random.default_rng(6), 2, 4, 9, 18, 0, dev)[:5])
    with pytest.raises(ValueError, match="geometry"):  # hd above 256
        pk.fused_window_attention(*_attn_args(np.random.default_rng(7), 2, 1, 9, 260, 0, dev)[:5])
    wide = torch.zeros((8, 4, 9, 17), device=dev)[..., :16]  # rows of 17 floats: not aligned
    with pytest.raises(ValueError, match="rows"):
        pk.fused_window_attention(wide, k, v, rel_bias, mask)
    with pytest.raises(ValueError, match="mask"):
        pk.fused_window_attention(q, k, v, rel_bias, mask[:, :8])


# ---------------------------------------------------------------------------
# the epoch's ragged tail (-ragged_tail): a MOD pretrain step on 3 or 2
# leftover subsequences of 4 samples, the two views fused to 24 or 16
# samples. #2/#3 at every block geometry of such a step and #13/#14 at its
# two towers, to the gates of the full-batch tests; then the full batch's
# and the tail's plans alternating in one process, each call the same bits
# as the first of its geometry.

TAIL_SAMPLES = (24, 16)  # fused samples of a 3- and a 2-subsequence tail


def _block_training_outputs(B, N, C, H, mask, check=True):
    """[y, keep, six gradients] of #2/#3 (rate 0.2, one seed) at one block
    geometry; with ``check`` held to the plain versions: #2's output given
    its mask 1e-4 absolute, #3's gradients 1e-4 relative."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    rng = np.random.default_rng(B + C)
    args = _args(rng, B, N, C, H, 0, dev)
    args[-1] = None if mask is None else torch.from_numpy(mask).to(dev)
    dy = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32)).to(dev)
    rate = 0.2
    y, keep, got = _training_pair(_with_transposes(args), dy, rate, 17)
    torch.cuda.synchronize()
    if check:
        ref = pk.fused_window_block_dropout_reference(*args, keep, rate)
        assert float((y - ref).abs().max()) <= 1e-4, (B, N, C)
        want = pk.fused_window_block_backward_reference(*args, dy, keep, rate)
        for name, g, w in zip(["dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "drel_bias"], got,
                              want):
            assert _rel(g, w) <= 1e-4, (B, N, C, name, _rel(g, w))
    return [y, keep, *got]


@pytest.mark.gpu
@pytest.mark.parametrize("samples", TAIL_SAMPLES)
def test_training_kernels_at_the_tail_geometries(samples):
    """#2 and #3 at the ten block geometries of a MOD tail step: the plain
    gates, one launch each a call."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    geos = _mod_block_geometries(samples)
    assert len(geos) == 10
    f0, b0 = pk.fused_window_block_dropout.launches, pk.fused_window_block_backward.launches
    for B, N, C, H, mask in geos:
        _block_training_outputs(B, N, C, H, mask)
    assert pk.fused_window_block_dropout.launches - f0 == 10
    assert pk.fused_window_block_backward.launches - b0 == 10


@pytest.mark.gpu
def test_training_kernels_alternating_full_and_tail_plans_repeat_bitwise():
    """A full MOD batch (512 fused samples) and a tail (24) at each block
    geometry, called full, tail, full, tail: each call the same bits as the
    first at its geometry (the same seed draws the same mask)."""
    firsts = {}
    for rnd in range(2):
        for samples in (512, 24):
            for B, N, C, H, mask in _mod_block_geometries(samples):
                out = _block_training_outputs(B, N, C, H, mask, check=False)
                key = (B, N, C, None if mask is None else mask.tobytes())
                if rnd == 0:
                    firsts[key] = out
                    continue
                for a, b in zip(out, firsts[key]):
                    assert torch.equal(a, b), key


# MOD's two towers at the tail's fused samples: seismic (first conv inside,
# kw 3, cin 2) and audio (first conv outside, kw 5), S 20, C 64
@pytest.mark.gpu
@pytest.mark.parametrize("samples", TAIL_SAMPLES)
@pytest.mark.parametrize("external", [False, True])
def test_conv_tower_at_the_tail_geometries(samples, external):
    _tower_case(samples, 64, external)


@pytest.mark.gpu
@pytest.mark.parametrize("external", [False, True])
def test_conv_tower_alternating_full_and_tail_plans_repeat_bitwise(external):
    """The full MOD batch's tower (512 fused samples) and the tail's (24),
    forward and backward, called full, tail, full, tail: each call the same
    bits as the first of its geometry."""
    from focal_tpu_torch.ops.conv_tower import fused_conv_tower

    dev = _card()
    cases = {}
    for samples in (512, 24):
        rng = np.random.default_rng(samples + external)
        kw = 5 if external else 3
        cfgs, x0, params, masks = _tower_args(rng, samples, 10, 20, 64, kw, external, 5, dev)
        dy = torch.from_numpy(rng.normal(size=(samples * 10, 20, 64)).astype(np.float32)).to(dev)
        cases[samples] = (cfgs, x0, params, masks, dy)
    firsts = {}
    for rnd in range(2):
        for samples, (cfgs, x0, params, masks, dy) in cases.items():
            y, mus, vars_, grads = _tower_grads(fused_conv_tower, cfgs, x0, params, masks, dy,
                                                external)
            torch.cuda.synchronize()
            out = [y.detach(), *mus, *vars_, *grads]
            if rnd == 0:
                firsts[samples] = out
            else:
                for a, b in zip(out, firsts[samples]):
                    assert torch.equal(a, b), samples


# ---------------------------------------------------------------------------
# the bf16 forms of the whole-block kernels (#1-bf16, #2-bf16, #3-bf16):
# against their bf16 plain versions on the same bf16 inputs, in the working
# type. Gates as chip_smoke.py's phase 29: y within 8e-3 of max|y| (one bf16
# step is 2^-8), every gradient within 1e-2 relative (measured on the H100
# <= 3.5e-3 and <= 4.3e-3).


def _bf16_args(rng, B, N, C, H, nW, dev):
    args = _args(rng, B, N, C, H, nW, dev)
    for i in (0, 1, 3):  # x, wqkv, wproj
        args[i] = args[i].to(torch.bfloat16)
    return args


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,C,H,nW", [
    (512, 9, 64, 4, 64), (509, 9, 128, 4, 16), (511, 9, 256, 4, 0), (37, 4, 32, 2, 3),
    (64, 16, 64, 4, 8),
])
def test_bf16_forward_matches_plain_on_card(B, N, C, H, nW):
    """#1-bf16, and #2-bf16 fed its own keep mask (keep rate within 5
    sigma), against the bf16 plain version; one launch counted a call."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    args = _bf16_args(np.random.default_rng(B + C), B, N, C, H, nW, dev)
    before = (pk.fused_window_block_bf16.launches, pk.fused_window_block_dropout_bf16.launches)
    y = pk.fused_window_block_bf16(*args)
    y2, keep = pk.fused_window_block_dropout_bf16(*args, 11, 0.2)
    torch.cuda.synchronize()
    assert (pk.fused_window_block_bf16.launches, pk.fused_window_block_dropout_bf16.launches) == (
        before[0] + 1, before[1] + 1)
    assert y.dtype == y2.dtype == torch.bfloat16 and keep.dtype == torch.uint8
    assert _rel(y, pk.fused_window_block_bf16_reference(*args)) <= 8e-3
    assert _rel(y2, pk.fused_window_block_bf16_reference(*args, keep, 0.2)) <= 8e-3
    kept = float(keep.double().mean())
    assert abs(kept - 0.8) <= 5 * (0.16 / keep.numel()) ** 0.5
    # the same seed and geometry give #2's mask
    f32 = [a.float() if a is not None and a.dtype == torch.bfloat16 else a for a in args]
    assert torch.equal(pk.fused_window_block_dropout(*f32, 11, 0.2)[1], keep)


# every whole-block width (C, shift-mask windows nW, 0 for a stage's plain
# blocks) of MOD, MOD_WIDE (C 512 and 1024: #5-bf16), ACIDS, PAMAP2 and
# RealWorld_HAR at N 9 and 4 heads
RECIPE_BLOCKS_BF16 = [(64, 0), (64, 32), (64, 48), (64, 64), (128, 0), (128, 8), (128, 12),
                      (128, 16), (256, 0), (256, 2), (256, 3), (256, 4), (256, 32), (256, 64),
                      (512, 0), (512, 8), (512, 16), (1024, 0), (1024, 2), (1024, 4)]


def _bf16_backward_case(B, N, C, H, nW, seed):
    """#3-bf16 (or #5-bf16 where wblock_fits refuses) with a keep mask and
    without, against the bf16 plain version: dx bf16, the rest f32, each
    within 1e-2 relative; the same bits on a second call; one launch
    counted a call."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    rng = np.random.default_rng(seed)
    args = _bf16_args(rng, B, N, C, H, nW, dev)
    dy = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32)).to(dev).to(torch.bfloat16)
    keep = torch.from_numpy((rng.random((B, H, N, N)) >= 0.2).astype(np.uint8)).to(dev)
    bwd = (pk.fused_window_block_backward_bf16 if pk.wblock_fits(N, C, H)
           else pk.fused_window_block_perhead_backward_bf16)
    for kp, rate in ((keep, 0.2), (None, 0.0)):
        before = bwd.launches
        got = bwd(*args, dy, kp, rate)
        again = bwd(*args, dy, kp, rate)
        torch.cuda.synchronize()
        assert bwd.launches == before + 2
        assert got[0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in got[1:])
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        want = pk.fused_window_block_backward_bf16_reference(*args, dy, kp, rate)
        for name, g, w in zip(["dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "drel_bias"], got,
                              want):
            assert _rel(g, w) <= 1e-2, (name, _rel(g, w))


@pytest.mark.gpu
@pytest.mark.parametrize("C,nW", RECIPE_BLOCKS_BF16)
def test_bf16_backward_matches_plain_at_every_recipe_block(C, nW):
    """#3-bf16 and #5-bf16 at every packaged whole-block width, at rows that
    are no multiple of the products' 128-row tiles (129 or 37 windows of
    9)."""
    _bf16_backward_case(129 if C <= 256 else 37, 9, C, 4, nW, C + nW)


def _bf16_forward_case(B, N, C, H, nW, seed):
    """#1-bf16 and #2-bf16 (#4-bf16 at rate 0 and 0.2 where wblock_fits
    refuses) against the bf16 plain version given the kernel's own keep
    mask: y within 8e-3 of max|y|, the same bits on a second call, one
    launch counted a call; the keep mask the f32 #2's for the same seed
    (the same Philox counters)."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    args = _bf16_args(np.random.default_rng(seed), B, N, C, H, nW, dev)
    f32 = [a.float() if a is not None and a.dtype == torch.bfloat16 else a for a in args]
    if pk.wblock_fits(N, C, H):
        runs = {0.0: (pk.fused_window_block_bf16, lambda: (pk.fused_window_block_bf16(*args), None)),
                0.2: (pk.fused_window_block_dropout_bf16,
                      lambda: pk.fused_window_block_dropout_bf16(*args, 11, 0.2))}
    else:
        fn = pk.fused_window_block_perhead_bf16
        runs = {r: (fn, lambda r=r: fn(*args, 11, r)) for r in (0.0, 0.2)}
    for rate, (fn, run) in runs.items():
        before = fn.launches
        y, keep = run()
        again, keep2 = run()
        torch.cuda.synchronize()
        assert fn.launches == before + 2
        assert y.dtype == torch.bfloat16 and torch.equal(y, again), rate
        if rate:
            assert keep.dtype == torch.uint8 and torch.equal(keep, keep2)
            assert torch.equal(keep, pk.fused_window_block_dropout(*f32, 11, 0.2)[1])
        else:
            assert keep is None
        err = _rel(y, pk.fused_window_block_bf16_reference(*args, keep, rate))
        assert err <= 8e-3, (rate, err)


@pytest.mark.gpu
@pytest.mark.parametrize("C,nW", RECIPE_BLOCKS_BF16)
def test_bf16_forward_matches_plain_at_every_recipe_block(C, nW):
    """#1-bf16, #2-bf16 and #4-bf16 at every packaged whole-block width, at
    rows that are no multiple of the products' 128-row tiles."""
    _bf16_forward_case(129 if C <= 256 else 37, 9, C, 4, nW, 3 * C + nW)


# other windows and heads the bf16 gate admits: N 16 and 4, heads of 5
# and 12 columns (not multiples of 8 or 4), one head of 1,600 columns, the
# widest at N 9 (two slots of the attention's ring do not fit: one), and a
# call of fewer rows than one product tile
@pytest.mark.gpu
@pytest.mark.parametrize("B,N,C,H,nW", [(1031, 9, 64, 4, 4), (64, 16, 64, 4, 8),
                                        (77, 4, 96, 8, 0), (21, 9, 40, 8, 3), (30, 9, 48, 4, 2),
                                        (3, 9, 1600, 1, 0), (5, 9, 128, 4, 2)])
def test_bf16_forward_at_the_other_widths_the_gate_admits(B, N, C, H, nW):
    _bf16_forward_case(B, N, C, H, nW, B + C + nW)


# other windows and heads the bf16 gate admits: N 16 and 4, heads of 5
# and 12 columns (not multiples of 8 or 4), and one head of 1,600 columns,
# the widest at N 9 (two slots of the attention's ring do not fit: one)
@pytest.mark.gpu
@pytest.mark.parametrize("B,N,C,H,nW", [(1031, 9, 64, 4, 4), (64, 16, 64, 4, 8),
                                        (77, 4, 96, 8, 0), (21, 9, 40, 8, 3), (30, 9, 48, 4, 2),
                                        (3, 9, 1600, 1, 0)])
def test_bf16_backward_matches_plain_and_repeats_bitwise(B, N, C, H, nW):
    """#3-bf16 (#5-bf16) at the other widths the bf16 gate admits."""
    _bf16_backward_case(B, N, C, H, nW, B + C + nW)


@pytest.mark.gpu
def test_bf16_backward_kernels_run_on_wgmma():
    """The bf16 whole-block kernels' products and weight gradients (wb_wg_*:
    the forward's qkv and y, the backward's qkv and g and dx; wg_wgrad)
    compile to wgmma (HGMMA) and no mma.sync (HMMA), with no wgmma pipeline
    serialized (ptxas C7510-C7518, C7520; C7519 notes are harmless); their
    attentions (forward and backward) and reduction run no mma.sync either,
    and the mma.sync forward (bf16_proj_kernel) is gone."""
    import os
    import re
    import subprocess

    from focal_tpu_torch.ops import _build

    _card()
    _build.build_all(("window_block.cu",))
    ours = ("wb_wg_", "wg_wgrad", "wg_reduce", "attn_bwd_bf16", "attn_fwd_bf16")
    with open(_build.log_path("window_block.cu")) as f:
        serialized = [line for line in f
                      if re.search(r"\(C75(1[0-8]|20)\)", line) and any(k in line for k in ours)]
    assert not serialized, serialized
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", _build.library_path("window_block.cu")],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if any(k in m.group(1) for k in ours) else None
            if fn:
                counts[fn] = [0, 0]
        elif fn:
            counts[fn][0] += "HGMMA" in line
            counts[fn][1] += bool(re.search(r"\bHMMA\b", line))
    assert {k for k in ours if any(k in name for name in counts)} == set(ours), sorted(counts)
    assert "wb_wg_y_kernel" in " ".join(counts) and "bf16_proj_kernel" not in sass
    for name, (hgmma, hmma) in counts.items():
        assert hmma == 0, name
        assert (hgmma > 0) == ("wb_wg_" in name or "wg_wgrad" in name), (name, hgmma)


@pytest.mark.gpu
def test_bf16_window_block_on_card_launches_the_bf16_kernels_only():
    """window_block at rate 0 on a bf16 x with f32 weights: #1-bf16
    forward, #3-bf16 backward, no f32 kernel; gradients of the f32 weights
    in f32 within 1e-2 of the plain stand-in's; the eval route at a
    per-head width launches #4-bf16."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    rng = np.random.default_rng(7)
    args = _args(rng, 300, 9, 128, 4, 4, dev)
    x = args[0].to(torch.bfloat16)
    kernels = (pk.fused_window_block, pk.fused_window_block_dropout, pk.fused_window_block_backward,
               pk.fused_window_block_bf16, pk.fused_window_block_dropout_bf16,
               pk.fused_window_block_backward_bf16)
    before = [k.launches for k in kernels]
    runs = []
    for fn in (pk.window_block, pk.window_block_reference):
        leaves = [x.clone().requires_grad_(True)] + [a.clone().requires_grad_(True)
                                                     for a in args[1:6]]
        y = fn(*leaves, args[6], seed=3, rate=0.0)
        runs.append(torch.autograd.grad(y.float().square().sum(), leaves))
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [0, 0, 0, 1, 0, 1]
    for g, w in zip(*runs):
        assert g.dtype == w.dtype and _rel(g, w) <= 1e-2
    wide = _args(rng, 8, 9, 512, 4, 0, dev)
    before = pk.fused_window_block_perhead_bf16.launches
    y = pk.window_block_forward(wide[0].to(torch.bfloat16), *wide[1:])
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and pk.fused_window_block_perhead_bf16.launches == before + 1


@pytest.mark.gpu
def test_bf16_wrappers_raise_on_what_they_cannot_take():
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    args = _bf16_args(np.random.default_rng(0), 8, 9, 64, 4, 0, dev)
    with pytest.raises(TypeError):  # f32 weights to the bf16 kernel
        pk.fused_window_block_bf16(args[0], args[1].float(), *args[2:])
    with pytest.raises(ValueError):  # C not a multiple of 8
        pk.fused_window_block_bf16(*_bf16_args(np.random.default_rng(1), 8, 9, 20, 4, 0, dev))
    with pytest.raises(ValueError):  # not 16-byte aligned
        x = torch.empty(8 * 9 * 64 + 1, dtype=torch.bfloat16, device=dev)[1:].view(8, 9, 64)
        pk.fused_window_block_bf16(x, *args[1:])


# ---------------------------------------------------------------------------
# the conv tower's bf16 forms (#13-bf16, #14-bf16) against the bf16 plain
# tower on the same bf16 inputs, at the MOD (C 64, 512 samples) and MOD_WIDE
# (C 256, 256 samples) geometries, the recipes' and the two-location
# mod_extractor's, and a few samples: the output within 8e-3 of max|a| (one
# bf16 step is 2^-8), the statistics 1e-3 relative, the gradients 1e-2
# relative (the conv biases', true value 0, absolutely to 1e-2); the same
# bits on a second call.

def _tower_case_bf16(samples, C, external, S=20, layers=5, cin=2, kw=None, exact=False):
    """With ``exact`` the plain version's f32 steps run in float64 (its
    roundings to bf16 kept): a conv bias before a BatchNorm has a true
    gradient of 0, and over 6.6e5 rows (S 128) the f32 plain version's
    value there, set by the rounding of the batch mean, reaches ~1.6e-2."""
    from focal_tpu_torch.ops.conv_tower import fused_conv_tower, fused_conv_tower_reference

    dev = _card()
    rng = np.random.default_rng(samples + C + external + 1)
    if kw is None:
        kw = 5 if external else 3
    cfgs, x0, params, masks = _tower_args(rng, samples, 10, S, C, kw, external, layers, dev, cin)
    x0 = x0.detach().to(torch.bfloat16).requires_grad_(True)
    dy = torch.from_numpy(rng.normal(size=(samples * 10, S, C)).astype(np.float32)).to(dev)
    dy = dy.to(torch.bfloat16)
    got = _tower_grads(fused_conv_tower, cfgs, x0, params, masks, dy, external)
    again = _tower_grads(fused_conv_tower, cfgs, x0, params, masks, dy, external)
    if exact:
        want = _tower_grads(fused_conv_tower_reference, cfgs, x0,
                            [[_exact(p) for p in group] for group in params],
                            [m.double() for m in masks], dy, external)
    else:
        want = _tower_grads(fused_conv_tower_reference, cfgs, x0, params, masks, dy, external)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.bfloat16 and got[3][0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got[3][1:])
    assert _rel(got[0].detach().float(), want[0].detach().float()) <= 8e-3
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        assert _rel(a, b) <= 1e-3
    for i, (g, w) in enumerate(zip(got[3], want[3])):
        g, w = g.float(), w.float()
        if max(float(g.abs().max()), float(w.abs().max())) < 1e-2:
            assert float((g - w).abs().max()) <= 1e-2, i
        else:
            assert _rel(g, w) <= 1e-2, (i, _rel(g, w))
    for a, b in zip([got[0], *got[1], *got[2], *got[3]], [again[0], *again[1], *again[2], *again[3]]):
        assert torch.equal(a, b)  # fixed-order sums: bitwise repeatable


@pytest.mark.gpu
@pytest.mark.parametrize("samples,C,external", [
    (512, 64, False), (512, 64, True), (256, 256, False), (256, 256, True), (7, 64, False),
    (7, 256, True),
])
def test_conv_tower_bf16_matches_plain_on_card(samples, C, external):
    _tower_case_bf16(samples, C, external)


@pytest.mark.gpu
@pytest.mark.parametrize("samples,S,C,cin,kw,external,layers", [
    (512, 20, 64, 6, 3, False, 5), (512, 25, 64, 6, 3, False, 5), (512, 41, 64, 64, 3, True, 5),
    (512, 128, 64, 1, 4, False, 4), (7, 128, 64, 1, 4, False, 4), (5, 200, 64, 8, 3, False, 3),
    (5, 1, 16, 2, 3, False, 3), (3, 300, 256, 256, 5, True, 3), (4, 70, 64, 64, 3, True, 3),
    (7, 20, 96, 96, 3, True, 3), (13, 9, 64, 64, 5, True, 3),
])
def test_conv_tower_bf16_at_the_recipe_and_other_geometries(samples, S, C, cin, kw, external,
                                                            layers):
    """The recipes' cin 6 and the mod_extractor's cin 1 (the narrow bf16
    first conv), ACIDS's strided first conv, cin 8 (the first conv on the
    bf16 tensor cores), a spectrum past a 128-row tile and one of a single
    position at MOD_TINY's width; for the products' tiles of whole samples:
    S 300 at C 256 (three 100-position boxes a sample, two 128-column
    tiles), S 70 (two 35-position K stages a sample in the weight
    gradient), C 96 (a tap's K padded to two 64-channel blocks, a ragged
    64-column tile) and S 9 (14 samples a 126-row tile: the last tile masks
    the rows of its 10 samples past R = 130). Held against the plain
    version with its f32 steps in float64 (``exact``)."""
    _tower_case_bf16(samples, C, external, S=S, layers=layers, cin=cin, kw=kw, exact=True)


@pytest.mark.gpu
@pytest.mark.parametrize("external", [False, True])
def test_conv_tower_bf16_launch_counts_and_kernels(external):
    """A bf16 tower launches #13-bf16/#14-bf16 (their own counts) as often
    as the f32 one launches #13/#14, and its wrappers' calls run only csrc/conv_tower.cu's
    kernels (the bf16 products, the dc pass with its block sums, no f32
    product), gemm_splitk.cuh's reduction as instantiated for it among
    them."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from focal_tpu_torch.ops import conv_tower as ct

    dev = _card()
    rng = np.random.default_rng(40 + external)
    kw = 5 if external else 3
    cfgs, x0, params, masks = _tower_args(rng, 16, 10, 20, 64, kw, external, 5, dev)
    x0 = x0.detach().to(torch.bfloat16).requires_grad_(True)
    counters = (ct.fused_conv_tower, ct.fused_conv_tower_backward, ct.fused_conv_tower_bf16,
                ct.fused_conv_tower_backward_bf16)
    before = [k.launches for k in counters]
    y, _, _ = ct.fused_conv_tower_bf16(x0, cfgs, *params, masks, external)
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(counters, before)] == [0, 0, 5 if external else 6, 10]
    wb = [w.detach().to(torch.bfloat16) for w in params[0]]
    p = [[t.detach() for t in g] for g in params[1:]]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            _, _, _, sv = ct.tower_forward(x0.detach(), cfgs, wb, *p, masks, external)
            ct.fused_conv_tower_backward(sv, torch.ones_like(y))
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}

    def short(n):
        m = re.search(r"::(\w+)(?:<[^()]*>)?\(", n)
        return m.group(1) if m else n

    want = {"bn_elementwise_kernel", "ct_wg_conv_kernel", "bn_stats_sliced_kernel",
            "bn_grad_sums_kernel", "bn_grad_stats_sliced_kernel", "bn_dc_sums_kernel",
            "ct_wg_wgrad_kernel", "wg_reduce_kernel"}
    want |= set() if external else {"narrow_conv_kernel", "narrow_convT_kernel",
                                    "narrow_wgrad_kernel"}
    # PyTorch's own kernels: an external first conv's [C]-sized statistics,
    # the placeholders' zero gradients
    others = [n for n in names if short(n) not in want and not n.startswith(("void at::", "Memset"))]
    assert want <= {short(n) for n in names} and not others, names
    # no f32 product, per-tap transpose or one-SM walk of the sums ran
    assert not {"tap_transpose_kernel", "reduce_partials_kernel", "bn_stats_kernel",
                "bn_grad_stats_kernel"} & {short(n) for n in names}, names
    assert all("ConvTowerSrc" in n for n in names if "wg_reduce" in n), names


@pytest.mark.gpu
def test_conv_tower_bf16_workspaces_and_refusals():
    """focal_ct_workspace's bf16 sizes equal layer_plan's (the fold's
    partials, kind 3, where the layer's input runs on the tensor cores) at
    MOD's, MOD_WIDE's and MOD_TINY's layers and at S > 128; C 12 (not a
    multiple of 8) has no bf16 launch plan; bf16 rows with f32 weights
    raise."""
    from focal_tpu_torch.ops import conv_tower as ct

    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for R, S, C, layers in ((5120, 20, 64, [(3, 2), (3, 64), (5, 64)]),
                            (2560, 20, 256, [(3, 2), (3, 256), (5, 256)]),
                            (50, 20, 16, [(3, 8), (3, 16)]), (30, 300, 64, [(4, 1), (4, 64)])):
        for kw, cin in layers:
            want = ct.layer_plan(R, S, kw, cin, C, sms, torch.bfloat16)["workspace"]
            got = {"forward": ct._workspace("forward", R, S, cin, C, kw, dev, 1),
                   "bwd_stats": ct._workspace("bwd_stats", R, S, C, C, 1, dev, 1),
                   "bwd_apply": ct._workspace("bwd_apply", R, S, cin, C, kw, dev, 1)}
            if ct.on_tensor_cores(cin, torch.bfloat16):
                got["fold"] = ct._workspace("fold", R, S, cin, cin, kw, dev, 1)
            assert {k: t.numel() for k, t in got.items()} == want, (R, S, C, kw, cin)
    rng = np.random.default_rng(12)
    cfgs, x0, params, masks = _tower_args(rng, 4, 10, 20, 12, 3, False, 2, dev)
    with pytest.raises(RuntimeError, match="no launch plan"):
        ct.fused_conv_tower(x0.detach().to(torch.bfloat16), cfgs, *params, masks, False)
    cfgs, x0, params, masks = _tower_args(rng, 4, 10, 20, 64, 3, False, 2, dev)
    with pytest.raises(TypeError):
        ct.tower_forward(x0.detach().to(torch.bfloat16), cfgs, *[[t.detach() for t in g]
                                                                  for g in params], masks, False)


# sha-256 (first 16 hex digits) of the f32 #13/#14 outputs (a, the batch
# statistics and the VJP of _tower_grads) at (samples, C, external, S), four
# layers, as the parent commit's build gave them before the bf16 forms moved
# to wgmma (NVIDIA H100 80GB HBM3, 132 SMs: the weight gradients' row splits
# follow the SM count)
F32_TOWER_DIGESTS = {(64, 64, False, 20): "52c236c9af4ab951", (16, 256, True, 20): "0b05c82cc31643db",
                     (5, 64, False, 200): "3be90c1e996e44bf"}


def _f32_tower_digest(ct, samples, C, external, S, dev):
    import hashlib

    rng = np.random.default_rng(900 + samples + C + external + S)
    kw = 5 if external else 3
    cfgs, x0, params, masks = _tower_args(rng, samples, 10, S, C, kw, external, 4, dev)
    dy = torch.from_numpy(rng.normal(size=(samples * 10, S, C)).astype(np.float32)).to(dev)
    y, mus, vars_, grads = _tower_grads(ct.fused_conv_tower, cfgs, x0, params, masks, dy, external)
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in (y, *mus, *vars_, *grads):
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.gpu
@pytest.mark.parametrize("samples,C,external,S", sorted(F32_TOWER_DIGESTS))
def test_f32_conv_tower_gives_the_parents_bits(samples, C, external, S):
    """The f32 #13/#14, whose kernels the bf16 redesign left as they were,
    give the bits they gave before it (F32_TOWER_DIGESTS)."""
    from focal_tpu_torch.ops import conv_tower as ct

    dev = _card()
    assert torch.cuda.get_device_properties(dev).multi_processor_count == 132, (
        "the digests were taken on a 132-SM H100")
    key = (samples, C, external, S)
    assert _f32_tower_digest(ct, *key, dev) == F32_TOWER_DIGESTS[key]


# ---------------------------------------------------------------------------
# the per-head kernels' bf16 forms (#4-bf16, #5-bf16) at MOD_WIDE's per-head
# widths (C 512, hd 128; C 1024, hd 256; 4 heads) and the fused MLP's (#10-
# bf16 to #12-bf16) at MOD's C 64/128/256 and MOD_WIDE stage 0 (C 256 at
# the audio stage's 73,728 rows: three row chunks), against their bf16 plain
# versions on the same bf16 inputs: y within 8e-3 of max|y|, every gradient
# within 1e-2 relative, the same bits on a second call; the masks #2's (#4-
# bf16) and #11's (#11-bf16, #12-bf16).


@pytest.mark.gpu
@pytest.mark.parametrize("B", [37, 131])
@pytest.mark.parametrize("C", [512, 1024])
@pytest.mark.parametrize("nW,rate", [(0, 0.0), (4, 0.2)])
def test_perhead_bf16_matches_plain_and_repeats_bitwise(B, C, nW, rate):
    """#4-bf16 (its mask #2's for the same seed; keep rate within 5 sigma)
    and #5-bf16 with that mask against the bf16 plain versions; one launch
    counted a call."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    N, H = 9, 4
    rng = np.random.default_rng(C + nW + B + 7)
    args = _bf16_args(rng, B, N, C, H, nW, dev)
    dy = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32)).to(dev).to(torch.bfloat16)
    before = (pk.fused_window_block_perhead_bf16.launches,
              pk.fused_window_block_perhead_backward_bf16.launches)
    y, keep = pk.fused_window_block_perhead_bf16(*args, seed=31, rate=rate)
    got = pk.fused_window_block_perhead_backward_bf16(*args, dy, keep, rate)
    again = pk.fused_window_block_perhead_backward_bf16(*args, dy, keep, rate)
    torch.cuda.synchronize()
    assert (pk.fused_window_block_perhead_bf16.launches,
            pk.fused_window_block_perhead_backward_bf16.launches) == (before[0] + 1, before[1] + 2)
    assert y.dtype == torch.bfloat16
    assert _rel(y, pk.fused_window_block_bf16_reference(*args, keep, rate)) <= 8e-3
    if rate:
        kept = float(keep.double().mean())
        assert abs(kept - 0.8) <= 5 * (0.16 / keep.numel()) ** 0.5
        f32 = [a.float() if a is not None and a.dtype == torch.bfloat16 else a for a in args]
        assert torch.equal(pk.fused_window_block_dropout(*f32, 31, rate)[1], keep)
    else:
        assert keep is None
    assert got[0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in got[1:])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = pk.fused_window_block_backward_bf16_reference(*args, dy, keep, rate)
    for name, g, w in zip(["dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "drel_bias"], got, want):
        assert _rel(g, w) <= 1e-2, (name, _rel(g, w))


@pytest.mark.gpu
def test_window_block_bf16_routes_wide_blocks_to_the_perhead_bf16_kernels():
    """At C 512 in bf16 the autograd pair launches #4-bf16 and #5-bf16 and
    no other whole-block kernel; the f32 weights' gradients in f32 within
    1e-2 of the plain stand-in's."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    rng = np.random.default_rng(13)
    args = _args(rng, 40, 9, 512, 4, 4, dev)
    kernels = (pk.fused_window_block_dropout, pk.fused_window_block_backward,
               pk.fused_window_block_perhead, pk.fused_window_block_perhead_backward,
               pk.fused_window_block_bf16, pk.fused_window_block_dropout_bf16,
               pk.fused_window_block_backward_bf16, pk.fused_window_block_perhead_bf16,
               pk.fused_window_block_perhead_backward_bf16)
    before = [k.launches for k in kernels]
    runs = []
    for fn in (pk.window_block, pk.window_block_reference):
        leaves = [args[0].to(torch.bfloat16).requires_grad_(True)] + [
            a.clone().requires_grad_(True) for a in args[1:6]]
        y = fn(*leaves, args[6], seed=3, rate=0.0)
        runs.append(torch.autograd.grad(y.float().square().sum(), leaves))
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [0, 0, 0, 0, 0, 0, 0, 1, 1]
    for g, w in zip(*runs):
        assert g.dtype == w.dtype and _rel(g, w) <= 1e-2


def _mlp_bf16_args(rng, T, C, dev, H=None):
    x, w1, b1, w2, b2 = _mlp_args(rng, T, C, dev, H)
    return [x.to(torch.bfloat16), w1, b1, w2, b2]


def _mlp_bf16_calls(fm, x, w1, b1, w2, b2, g, seed, w1t, w2t):
    """#10-bf16, #11-bf16 (``seed``, rate 0.2) and #12-bf16 with #11's masks
    and without."""
    return (fm.fused_mlp_forward_bf16(x, w1, b1, w2, b2),
            fm.fused_mlp_dropout_forward_bf16(x, w1, b1, w2, b2, seed, 0.2),
            fm.fused_mlp_backward_bf16(x, w1, b1, w1t, w2t, g, seed, 0.2),
            fm.fused_mlp_backward_bf16(x, w1, b1, w1t, w2t, g))


@pytest.mark.gpu
@pytest.mark.parametrize("T,C,H", [(2311, 64, 256), (1170, 128, 512), (301, 256, 1024),
                                   (73728, 256, 1024), (517, 320, 1280), (777, 96, 192),
                                   (1000, 256, 512)])
def test_fused_mlp_bf16_matches_plain_and_repeats_bitwise(T, C, H):
    """#10-bf16, and #11-bf16 against the bf16 plain version fed #11's own
    masks (mlp_keep_masks), y within 8e-3 of max|y|; #12-bf16 with the masks
    and without, dx bf16 and the rest f32, each within 1e-2 relative; the
    same bits on a second call; one launch counted a call. T 73,728 at C
    256 is MOD_WIDE's audio stage 0 (the backward in two row chunks); C 320
    takes the forward's two-launch form (C > 256); H = 2C at C 96 and 256;
    every other T is not a multiple of the 128-row tiles."""
    from focal_tpu_torch.ops import fused_mlp as fm

    dev = _card()
    rng = np.random.default_rng(T + C)
    x, w1, b1, w2, b2 = _mlp_bf16_args(rng, T, C, dev, H)
    g = torch.from_numpy(rng.normal(size=(T, C)).astype(np.float32)).to(dev).to(torch.bfloat16)
    tr = w1.t().contiguous(), w2.t().contiguous()
    kernels = (fm.fused_mlp_forward_bf16, fm.fused_mlp_dropout_forward_bf16,
               fm.fused_mlp_backward_bf16)
    before = [k.launches for k in kernels]
    got = _mlp_bf16_calls(fm, x, w1, b1, w2, b2, g, 9, *tr)
    again = _mlp_bf16_calls(fm, x, w1, b1, w2, b2, g, 9, *tr)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [2, 2, 4]
    for a, b in zip(got, again):
        for u, v in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            assert torch.equal(u, v)
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    keep1, keep2 = fm.mlp_keep_masks(9, T, C, H, 0.2, dev)
    assert _rel(got[0], fm.fused_mlp_bf16_reference(x, w1, b1, w2, b2)) <= 8e-3
    assert _rel(got[1], fm.fused_mlp_bf16_reference(x, w1, b1, w2, b2, keep1, keep2, 0.2)) <= 8e-3
    for grads, masks in ((got[2], (keep1, keep2, 0.2)), (got[3], ())):
        want = fm.fused_mlp_backward_bf16_reference(x, w1, b1, w2, b2, g, *masks)
        assert grads[0].dtype == torch.bfloat16 and all(t.dtype == torch.float32
                                                        for t in grads[1:])
        for name, a, b in zip(["dx", "dw1", "db1", "dw2", "db2"], grads, want):
            assert _rel(a, b) <= 1e-2, (name, _rel(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("T,C", [(2311, 64), (301, 256)])
def test_fused_mlp_bf16_launches_only_fused_mlp_kernels(T, C):
    """A profiled call of #10-bf16, #11-bf16 and #12-bf16 (with masks and
    without) runs only csrc/fused_mlp.cu's wgmma kernels: the weights' bf16
    pass, the fused forward (C <= 256), the backward's g2, hidden and dx
    (output) products, and csrc/gemm_wgmma.cuh's weight gradients and
    reduction as fused_mlp.cu instantiates them (tagged FusedMlpSrc); no
    PyTorch cast, no cuBLAS kernel, no gemm_splitk.cuh kernel."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from focal_tpu_torch.ops import fused_mlp as fm

    dev = _card()
    rng = np.random.default_rng(T)
    x, w1, b1, w2, b2 = _mlp_bf16_args(rng, T, C, dev)
    g = torch.from_numpy(rng.normal(size=(T, C)).astype(np.float32)).to(dev).to(torch.bfloat16)
    tr = w1.t().contiguous(), w2.t().contiguous()
    _mlp_bf16_calls(fm, x, w1, b1, w2, b2, g, 3, *tr)  # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _traced(lambda: _mlp_bf16_calls(fm, x, w1, b1, w2, b2, g, 3, *tr))
    names = {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    kernels = {m.group(1) if m else n for n in names
               for m in [re.search(r"::(\w+)(?:<[^()]*>)?\(", n)]}
    assert kernels == {"mlp_wcast_kernel", "mlp_wg_fwd_kernel", "mlp_wg_g2_kernel",
                       "mlp_wg_hidden_kernel", "mlp_wg_out_kernel", "wg_wgrad_kernel",
                       "wg_reduce_kernel"}, names
    assert all("FusedMlpSrc" in n for n in names if "wg_wgrad" in n or "wg_reduce" in n), names


# sha-256 (first 16 hex digits) of the f32 #10, #11 (seed 9, rate 0.2) and
# #12 (with #11's masks, and without) outputs at (T, C), H = 4C, on the
# inputs of _f32_mlp_digest, as the f32 kernels gave them before the bf16
# forms moved to wgmma (the parent commit's build, NVIDIA H100 80GB HBM3,
# 132 SMs: the weight gradients' row splits follow the SM count)
F32_MLP_DIGESTS = {(1000, 64): "91e9620a2c1bd8f8", (333, 128): "abeabfcf98f0c1fc"}


def _f32_mlp_digest(fm, T, C, dev):
    import hashlib

    rng = np.random.default_rng(7 * T + C)
    x, w1, b1, w2, b2 = _mlp_args(rng, T, C, dev)
    g = torch.from_numpy(rng.normal(size=(T, C)).astype(np.float32)).to(dev)
    outs = _mlp_calls(fm, x, w1, b1, w2, b2, g, 9, w1.t().contiguous(), w2.t().contiguous())
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in (outs[0], outs[1], *outs[2], *outs[3]):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.gpu
@pytest.mark.parametrize("T,C", sorted(F32_MLP_DIGESTS))
def test_f32_fused_mlp_gives_the_parents_bits(T, C):
    """The f32 #10-#12, whose code the bf16 redesign left as it was, give
    the bits they gave before it (F32_MLP_DIGESTS)."""
    from focal_tpu_torch.ops import fused_mlp as fm

    dev = _card()
    assert torch.cuda.get_device_properties(dev).multi_processor_count == 132, (
        "the digests were taken on a 132-SM H100")
    assert _f32_mlp_digest(fm, T, C, dev) == F32_MLP_DIGESTS[(T, C)]


# sha-256 (first 16 hex digits) of outputs that the bf16 whole-block
# backward's redesign must leave as they were, as the parent commit's build
# gave them (NVIDIA H100 80GB HBM3, 132 SMs: row splits and persistent grids
# follow the SM count): the f32 #3 and #5 (_f32_block_digest, with a keep
# mask and without) and #12-bf16 (_mlp_bf16_digest, with #11's masks and
# without), whose weight-gradient and reduction kernels moved into
# csrc/gemm_wgmma.cuh for #3-bf16 and #5-bf16 to share.
F32_BLOCK_DIGESTS = {(131, 64, 4): "39c4b649a29d468d", (37, 512, 0): "bd829287d44309e1"}
# The f32 #1, #2 and #4 (_f32_fwd_digest), which the bf16 forward's redesign
# left as they were, as the parent commit's build gave them (the same card).
F32_FWD_DIGESTS = {(131, 64, 4): "5fe71663319caea3", (37, 512, 0): "032b542fc947a7fa"}
MLP_BF16_DIGESTS = {(2311, 64): "187d44466a9c36b4", (301, 256): "0f81bb9b7f29a003"}


def _digest(tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def _f32_block_digest(pk, B, C, nW, dev):
    """#3 (C <= 256) or #5 (C 512) at N 9, 4 heads, with a keep mask and
    without; the weights also passed transposed, as the route passes them."""
    rng = np.random.default_rng(5 * B + C)
    args = _args(rng, B, 9, C, 4, nW, dev)
    dy = torch.from_numpy(rng.normal(size=(B, 9, C)).astype(np.float32)).to(dev)
    keep = torch.from_numpy((rng.random((B, 4, 9, 9)) >= 0.2).astype(np.uint8)).to(dev)
    tr = (args[1].t().contiguous(), args[3].t().contiguous())
    bwd = (pk.fused_window_block_backward if pk.wblock_fits(9, C, 4)
           else pk.fused_window_block_perhead_backward)
    outs = [*bwd(*args, dy, keep, 0.2, *tr), *bwd(*args, dy, None, 0.0, *tr)]
    torch.cuda.synchronize()
    return _digest(outs)


def _f32_fwd_digest(pk, B, C, nW, dev):
    """#1 and #2 (C <= 256) or #4 at rate 0 and 0.2 (C 512) at N 9, 4
    heads: y and the keep mask."""
    args = _args(np.random.default_rng(7 * B + C), B, 9, C, 4, nW, dev)
    if pk.wblock_fits(9, C, 4):
        outs = [pk.fused_window_block(*args), *pk.fused_window_block_dropout(*args, 5, 0.2)]
    else:
        outs = [pk.fused_window_block_perhead(*args)[0],
                *pk.fused_window_block_perhead(*args, 5, 0.2)]
    torch.cuda.synchronize()
    return _digest(outs)


def _mlp_bf16_digest(fm, T, C, dev):
    """#12-bf16 with #11-bf16's masks (seed 9, rate 0.2) and without."""
    rng = np.random.default_rng(3 * T + C)
    x, w1, b1, w2, b2 = _mlp_bf16_args(rng, T, C, dev)
    g = torch.from_numpy(rng.normal(size=(T, C)).astype(np.float32)).to(dev).to(torch.bfloat16)
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    outs = [*fm.fused_mlp_backward_bf16(x, w1, b1, w1t, w2t, g, 9, 0.2),
            *fm.fused_mlp_backward_bf16(x, w1, b1, w1t, w2t, g)]
    torch.cuda.synchronize()
    return _digest(outs)


@pytest.mark.gpu
@pytest.mark.parametrize("B,C,nW", sorted(F32_BLOCK_DIGESTS))
def test_f32_block_backward_gives_the_parents_bits(B, C, nW):
    """The f32 #3 and #5, whose kernels the bf16 redesign left as they were,
    give the parent's bits (F32_BLOCK_DIGESTS)."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    assert torch.cuda.get_device_properties(dev).multi_processor_count == 132, (
        "the digests were taken on a 132-SM H100")
    assert _f32_block_digest(pk, B, C, nW, dev) == F32_BLOCK_DIGESTS[(B, C, nW)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,C,nW", sorted(F32_FWD_DIGESTS))
def test_f32_block_forward_gives_the_parents_bits(B, C, nW):
    """The f32 #1, #2 and #4, whose kernels the bf16 forward's redesign left
    as they were, give the parent's bits (F32_FWD_DIGESTS)."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    assert torch.cuda.get_device_properties(dev).multi_processor_count == 132, (
        "the digests were taken on a 132-SM H100")
    assert _f32_fwd_digest(pk, B, C, nW, dev) == F32_FWD_DIGESTS[(B, C, nW)]


@pytest.mark.gpu
@pytest.mark.parametrize("T,C", sorted(MLP_BF16_DIGESTS))
def test_mlp_bf16_backward_gives_the_parents_bits(T, C):
    """#12-bf16 on the weight-gradient and reduction kernels it now shares
    with #3-bf16 and #5-bf16 gives the parent's bits (MLP_BF16_DIGESTS)."""
    from focal_tpu_torch.ops import fused_mlp as fm

    dev = _card()
    assert torch.cuda.get_device_properties(dev).multi_processor_count == 132, (
        "the digests were taken on a 132-SM H100")
    assert _mlp_bf16_digest(fm, T, C, dev) == MLP_BF16_DIGESTS[(T, C)]


@pytest.mark.gpu
def test_fused_mlp_bf16_route_and_refusals():
    """fused_mlp and fused_mlp_dropout on a bf16 x with f32 weights launch
    #10-bf16/#11-bf16 and #12-bf16 and no f32 kernel, the weights'
    gradients f32 within 1e-2 of the plain bf16 pair's (same masks); the
    wrappers refuse f32 x, bf16 weights and C not a multiple of 8."""
    from focal_tpu_torch.ops import fused_mlp as fm

    dev = _card()
    T, C = 999, 64
    rng = np.random.default_rng(5)
    x, w1, b1, w2, b2 = _mlp_bf16_args(rng, T, C, dev)
    kernels = (fm.fused_mlp_forward, fm.fused_mlp_dropout_forward, fm.fused_mlp_backward,
               fm.fused_mlp_forward_bf16, fm.fused_mlp_dropout_forward_bf16,
               fm.fused_mlp_backward_bf16)
    before = [k.launches for k in kernels]
    leaves = [x.clone().requires_grad_(True)] + [t.clone().requires_grad_(True)
                                                for t in (w1, b1, w2, b2)]
    y0 = fm.fused_mlp(*leaves)
    y1 = fm.fused_mlp_dropout(*leaves, 4, 0.2)
    got = torch.autograd.grad(y0.float().square().sum() + y1.float().square().sum(), leaves)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [0, 0, 0, 1, 1, 2]
    keep1, keep2 = fm.mlp_keep_masks(4, T, C, 4 * C, 0.2, dev)
    pl = [t.detach().clone().requires_grad_(True) for t in leaves]
    p0 = fm.fused_mlp_bf16_reference(*pl)
    p1 = fm.fused_mlp_bf16_reference(*pl, keep1, keep2, 0.2)
    g0 = fm.fused_mlp_backward_bf16_reference(*[t.detach() for t in pl], 2 * p0.float().to(
        torch.bfloat16))
    g1 = fm.fused_mlp_backward_bf16_reference(*[t.detach() for t in pl], 2 * p1.float().to(
        torch.bfloat16), keep1, keep2, 0.2)
    assert got[0].dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in got[1:])
    for a, b, c in zip(got, g0, g1):
        assert _rel(a.float(), b.float() + c.float()) <= 2e-2
    with pytest.raises(TypeError):
        fm.fused_mlp_forward_bf16(x.float(), w1, b1, w2, b2)
    with pytest.raises(ValueError):
        fm.fused_mlp_forward_bf16(*_mlp_bf16_args(rng, 8, 20, dev))


# ---------------------------------------------------------------------------
# the bf16 forms of the attention-only kernels (#6-bf16 to #9-bf16): against
# their bf16 plain versions on the same bf16 inputs, q unscaled with q_scale
# as the route passes it. Gates as chip_smoke.py's phase 33: y within 8e-3
# of max|y| (one bf16 step is 2^-8), every gradient within 1e-2 relative,
# #8-bf16 and #9-bf16 bitwise repeatable.

ATTN_BF16_GEOMETRIES = [(509, 4, 9, 16, 16), (512, 4, 9, 32, 64), (511, 4, 9, 64, 0),
                        (130, 4, 9, 128, 4), (67, 4, 9, 256, 4), (37, 2, 4, 8, 3),
                        (33, 2, 16, 24, 2), (41, 2, 16, 8, 0), (19, 2, 16, 256, 3),
                        (29, 3, 9, 24, 0)]


def _attn_bf16_args(rng, B, H, N, hd, nW, dev):
    """qkv [B, N, 3C] bf16 (q unscaled), rel_bias, a 0 / -100 mask (or
    None) and the output gradient [B, N, C] bf16."""
    C = H * hd
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * C)).astype(np.float32)).to(dev)
    _, _, _, rel_bias, mask, _ = _attn_args(rng, B, H, N, hd, nW, dev)
    gy = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32)).to(dev)
    return qkv.to(torch.bfloat16), rel_bias, mask, gy.to(torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,N,hd,nW", ATTN_BF16_GEOMETRIES)
def test_attention_bf16_kernels_match_plain_and_repeat(B, H, N, hd, nW):
    """#6-bf16 (its output in the head view of a [B_, N, C] bf16 tensor) and
    #7-bf16 fed #7's mask against their plain versions; #8-bf16 and
    #9-bf16 with q_scale against theirs, the same bits on a second call;
    one launch counted a call."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    bf = torch.bfloat16
    qkv, rel_bias, mask, gy = _attn_bf16_args(np.random.default_rng(B + hd + 3), B, H, N, hd,
                                              nW, dev)
    q, k, v = pk._head_views(qkv, H)
    g = pk._heads(gy, H)
    s = hd**-0.5
    kernels = (pk.fused_window_attention_bf16, pk.fused_window_attention_dropout_bf16,
               pk.fused_window_attention_backward_bf16,
               pk.fused_window_attention_dropout_backward_bf16)
    f32_kernels = (pk.fused_window_attention, pk.fused_window_attention_dropout,
                   pk.fused_window_attention_backward, pk.fused_window_attention_dropout_backward)
    before = [f.launches for f in kernels + f32_kernels]
    y = torch.empty((B, N, H * hd), dtype=bf, device=dev)
    got = pk.fused_window_attention_bf16(q, k, v, rel_bias, mask, q_scale=s, out=pk._heads(y, H))
    assert got.dtype == bf and got.data_ptr() == y.data_ptr()
    assert _rel(got.float(), pk.fused_window_attention_bf16_reference(
        q, k, v, rel_bias, mask, q_scale=s).float()) <= 8e-3
    yd = pk.fused_window_attention_dropout_bf16(q, k, v, rel_bias, mask, 9, 0.2, q_scale=s)
    keep = pk.window_attention_keep_mask(9, B, H, N, 0.2, dev)
    assert _rel(yd.float(), pk.fused_window_attention_bf16_reference(
        q, k, v, rel_bias, mask, keep, 0.2, s).float()) <= 8e-3
    assert torch.equal(yd, pk.fused_window_attention_dropout_bf16(q, k, v, rel_bias, mask, 9, 0.2,
                                                                  q_scale=s))
    for seed, rate, kp in ((None, 0.0, None), (9, 0.2, keep)):
        grads = pk.fused_window_attention_backward_bf16(q, k, v, rel_bias, mask, g, seed, rate,
                                                        q_scale=s)
        again = pk.fused_window_attention_backward_bf16(q, k, v, rel_bias, mask, g, seed, rate,
                                                        q_scale=s)
        torch.cuda.synchronize()
        assert [t.dtype for t in grads] == [bf, bf, bf, torch.float32]
        assert all(torch.equal(a, b) for a, b in zip(grads, again))
        want = pk.fused_window_attention_backward_bf16_reference(q, k, v, rel_bias, mask, g, kp,
                                                                 rate, s)
        for name, a, w in zip(["dq", "dk", "dv", "drel_bias"], grads, want):
            assert _rel(a.float(), w.float()) <= 1e-2, (name, rate, _rel(a.float(), w.float()))
    assert [f.launches - b for f, b in zip(kernels + f32_kernels, before)] == [1, 2, 2, 2, 0, 0, 0,
                                                                              0]


def _mod_attention_geometries(batch):
    """(windows, heads, N, hd, shift-mask arguments or None) of every
    distinct attention launch of a MOD forward at ``batch`` samples, as
    chip_smoke.py's attention_geometries finds them."""
    from focal_tpu_torch.models.sw_transformer import mod_geometry
    from focal_tpu_torch.models.swin import block_geometry
    from focal_tpu_torch.params import load_dataset_config

    cfg = load_dataset_config("MOD")
    heads = cfg["SW_Transformer"]["time_freq_head_num"]
    geos = {}
    for loc in cfg["location_names"]:
        for mod in cfg["modality_names"]:
            geo = mod_geometry(cfg, loc, mod)
            for stage, ((H, W), C) in enumerate(geo["stages"]):
                for i in range(geo["block_num"][stage]):
                    shift = [0, 0] if i % 2 == 0 else [w // 2 for w in geo["window"]]
                    wh, ww, sh, sw, shifted = block_geometry((H, W), geo["window"], shift)
                    geos[(H, W, C, wh, ww, sh, sw, shifted)] = (
                        batch * (H // wh) * (W // ww), heads, wh * ww, C // heads,
                        (H, W, wh, ww, sh, sw) if shifted else None)
    return list(geos.values())


@pytest.mark.gpu
def test_attention_bf16_kernels_at_every_mod_geometry():
    """#6-bf16 to #9-bf16 on qkv head views at every attention geometry of a
    MOD forward at 128 samples (hd 16, 32, 64; the shifted windows' masks)
    against their plain versions (y within 8e-3 of max|y|, gradients within
    1e-2 relative), the same bits on a second call."""
    from focal_tpu_torch.models.swin import shifted_window_mask
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    geos = _mod_attention_geometries(128)
    assert sorted({g[3] for g in geos}) == [16, 32, 64] and any(g[4] for g in geos)
    for i, (B, H, N, hd, shifted) in enumerate(geos):
        rng = np.random.default_rng(i)
        qkv, rel_bias, _, gy = _attn_bf16_args(rng, B, H, N, hd, 0, dev)
        mask = None if shifted is None else torch.from_numpy(shifted_window_mask(*shifted)).to(dev)
        q, k, v = pk._head_views(qkv, H)
        g = pk._heads(gy, H)
        s = hd**-0.5
        keep = pk.window_attention_keep_mask(i, B, H, N, 0.2, dev)
        for seed, rate, kp in ((None, 0.0, None), (i, 0.2, keep)):
            fwd = (pk.fused_window_attention_bf16(q, k, v, rel_bias, mask, q_scale=s)
                   if seed is None else
                   pk.fused_window_attention_dropout_bf16(q, k, v, rel_bias, mask, seed, rate,
                                                          q_scale=s))
            want = pk.fused_window_attention_bf16_reference(q, k, v, rel_bias, mask, kp, rate, s)
            assert _rel(fwd.float(), want.float()) <= 8e-3, (B, hd, rate)
            grads = pk.fused_window_attention_backward_bf16(q, k, v, rel_bias, mask, g, seed, rate,
                                                            q_scale=s)
            again = pk.fused_window_attention_backward_bf16(q, k, v, rel_bias, mask, g, seed, rate,
                                                            q_scale=s)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(grads, again)), (B, hd, rate)
            wgrads = pk.fused_window_attention_backward_bf16_reference(q, k, v, rel_bias, mask, g,
                                                                       kp, rate, s)
            for name, a, w in zip(["dq", "dk", "dv", "drel_bias"], grads, wgrads):
                assert _rel(a.float(), w.float()) <= 1e-2, (name, B, hd, rate)


@pytest.mark.gpu
def test_attention_bf16_runs_the_tensor_core_kernels():
    """The bf16 wrappers launch window_attention.cu's tensor-core kernels
    (wattn_bf16_fwd_kernel, wattn_bf16_bwd_kernel and the drel_bias
    reduction tagged WindowAttentionSrc) and none of the f32 bodies; the
    f32 wrappers the f32 bodies."""
    import re
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    qkv, rel_bias, mask, gy = _attn_bf16_args(np.random.default_rng(4), 203, 4, 9, 32, 8, dev)
    q, k, v = pk._head_views(qkv, 4)
    g = pk._heads(gy, 4)

    def names(fn):
        # a trace in a process that traced before may lose its records (as
        # chip_smoke.py's kernel_phase_split finds): take it again, up to 3 times
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            time.sleep(0.05)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            time.sleep(0.05)
            got = {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
            if got:
                return got
        return got

    def short(n):
        m = re.search(r"::(\w+)(?:<[^()]*>)?\(", n)
        return m.group(1) if m else n

    got = names(lambda: (pk.fused_window_attention_bf16(q, k, v, rel_bias, mask, q_scale=0.25),
                         pk.fused_window_attention_dropout_backward_bf16(
                             q, k, v, rel_bias, mask, g, 3, 0.2, q_scale=0.25)))
    assert {short(n) for n in got} == {"wattn_bf16_fwd_kernel", "wattn_bf16_bwd_kernel",
                                       "reduce_partials_kernel"}, got
    assert all("WindowAttentionSrc" in n for n in got if "reduce_partials" in n), got
    f = [t.float().contiguous() for t in (q, k, v, g)]
    got = names(lambda: (pk.fused_window_attention(*f[:3], rel_bias, mask),
                         pk.fused_window_attention_backward(*f[:3], rel_bias, mask, f[3])))
    assert {short(n) for n in got} == {"wattn_fwd_kernel", "wattn_bwd_kernel",
                                       "reduce_partials_kernel"}, got


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_attention_bf16_mask_is_the_f32_kernels_mask(hd):
    """#7-bf16 drops exactly the weights #7 drops: with v one-hot per key
    (v[j] = e_j) and no shift mask, its output's first N columns are the
    dropped weights, zero exactly where window_attention_keep_mask (#7's
    and #2's mask) is 0."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    B, H, N = 301, 4, 9
    rng = np.random.default_rng(hd)
    q, k = (torch.from_numpy(rng.normal(size=(B, H, N, hd)).astype(np.float32)).to(dev).to(
        torch.bfloat16) for _ in range(2))
    v = torch.zeros((B, H, N, hd), device=dev)
    v[..., torch.arange(N), torch.arange(N)] = 1.0
    rel_bias = torch.zeros((H, N, N), device=dev)
    y = pk.fused_window_attention_dropout_bf16(q, k, v.to(torch.bfloat16), rel_bias, None, 41, 0.2,
                                               q_scale=hd**-0.5)
    keep = pk.window_attention_keep_mask(41, B, H, N, 0.2, dev)
    assert torch.equal((y[..., :N] != 0).to(torch.uint8), keep)
    yf = pk.fused_window_attention_dropout(q.float(), k.float(), v, rel_bias, None, 41, 0.2,
                                           q_scale=hd**-0.5)
    assert torch.equal((yf[..., :N] != 0).to(torch.uint8), keep)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,N,hd,nW", [(509, 4, 9, 16, 16), (512, 4, 9, 32, 64),
                                         (511, 4, 9, 64, 0)])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_window_attention_qkv_in_bf16(B, H, N, hd, nW, rate):
    """window_attention_qkv on a bf16 qkv: #6-bf16/#7-bf16 forward, #8-bf16/
    #9-bf16 writing d(qkv) in bf16 (the q columns bf16(bf16(dq) bf16(scale)))
    against autograd of window_attention_qkv_reference fed the kernels'
    mask; launches only of the bf16 kernels; the same bits on a second
    call."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    qkv, rel_bias, mask, gy = _attn_bf16_args(np.random.default_rng(B + hd + 5), B, H, N, hd, nW,
                                              dev)
    fwd = pk.fused_window_attention_dropout_bf16 if rate else pk.fused_window_attention_bf16
    bwd = (pk.fused_window_attention_dropout_backward_bf16 if rate
           else pk.fused_window_attention_backward_bf16)
    f32 = (pk.fused_window_attention, pk.fused_window_attention_dropout,
           pk.fused_window_attention_backward, pk.fused_window_attention_dropout_backward)
    runs = []
    for _ in range(2):
        before = [fwd.launches, bwd.launches] + [f.launches for f in f32]
        leaves = [qkv.clone().requires_grad_(True), rel_bias.clone().requires_grad_(True)]
        y = pk.window_attention_qkv(leaves[0], H, leaves[1], mask, seed=23, rate=rate)
        runs.append((y.detach(), torch.autograd.grad(y, leaves, pk._heads(gy, H))))
        torch.cuda.synchronize()
        assert [fwd.launches, bwd.launches] + [f.launches for f in f32] == [
            b + d for b, d in zip(before, [1, 1, 0, 0, 0, 0])]
    (y, got), (y2, again) = runs
    assert torch.equal(y, y2) and all(torch.equal(a, b) for a, b in zip(got, again))
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    keep = pk.window_attention_keep_mask(23, B, H, N, rate, dev) if rate else None
    leaves = [qkv.clone().requires_grad_(True), rel_bias.clone().requires_grad_(True)]
    q, k, v = pk._head_views(leaves[0], H)
    f = torch.float32
    want_y = pk.fused_window_attention_reference(pk.scale_bf16(q, hd**-0.5).to(f), k.to(f),
                                                 v.to(f), leaves[1], mask, keep,
                                                 rate).to(torch.bfloat16)
    want = torch.autograd.grad(want_y, leaves, pk._heads(gy, H))
    assert _rel(y.float(), want_y.detach().float()) <= 8e-3
    for a, w in zip(got, want):
        assert _rel(a.float(), w.float()) <= 1e-2


@pytest.mark.gpu
def test_attention_bf16_gate_is_where_the_kernels_take_the_width():
    """attention_takes(N, hd, bf16) admits exactly the head widths that the
    bf16 kernels' launch plans take (multiples of 8 up to 256); a bf16 CUDA
    tensor of another width raises, as do tensors of the wrong type for a
    wrapper."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    lib = pk._window_attention_lib()
    for hd in range(1, 300):
        ok = all(lib.focal_wattn_bwd_workspace_bf16(37, 4, 9, hd, d, pk.ctypes.byref(
            pk.ctypes.c_longlong(0))) == 0 for d in (0, 1))
        assert ok == pk.attention_takes(9, hd, torch.bfloat16) == (hd % 8 == 0 and hd <= 256), hd
    assert pk.attention_takes(9, 12) and not pk.attention_takes(9, 12, torch.bfloat16)
    qkv, rel_bias, mask, _ = _attn_bf16_args(np.random.default_rng(1), 8, 2, 9, 12, 0, dev)
    q, k, v = pk._head_views(qkv, 2)
    with pytest.raises(ValueError, match="unsupported geometry"):
        pk.fused_window_attention_bf16(q, k, v, rel_bias, None)
    qkv, rel_bias, _, _ = _attn_bf16_args(np.random.default_rng(2), 8, 2, 9, 16, 0, dev)
    q, k, v = pk._head_views(qkv, 2)
    with pytest.raises(TypeError):
        pk.fused_window_attention(q, k, v, rel_bias, None)
    with pytest.raises(TypeError):
        pk.fused_window_attention_bf16(q.float(), k.float(), v.float(), rel_bias, None)


# ---------------------------------------------------------------------------
# #4-TP/#5-TP: the whole-block kernels on a tensor-parallel shard's heads, at
# every local geometry of MOD's and MOD_WIDE's stages (N 9, H 4; C 64-1024)
# at mp 2 and 4 (H 2 and 1 a shard; D = C / 2, C / 4)


def _tp_shard(args, mp, m):
    """Model rank m's kernel arguments from whole ones: its heads' columns
    of wqkv [C, 3C] and bqkv, rows of wproj, heads of rel_bias; bproj on
    rank 0 alone."""
    from focal_tpu_torch.parallel.tp import Spec, local_slice

    x, wqkv, bqkv, wproj, bproj, rel_bias, mask = args
    H = rel_bias.shape[0]
    return [x, local_slice(wqkv, Spec(1, 3, H), mp, m), local_slice(bqkv, Spec(0, 3, H), mp, m),
            local_slice(wproj, Spec(0, 1, H), mp, m), bproj if m == 0 else torch.zeros_like(bproj),
            local_slice(rel_bias, Spec(0, 1, H), mp, m), mask]


TP_GEOMETRIES = [(C, mp) for C in (64, 128, 256, 512, 1024) for mp in (2, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("C,mp", TP_GEOMETRIES)
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_tp_kernels_match_plain(C, mp, rate):
    """#4-TP and #5-TP on one shard against the plain versions at its
    geometry (the keep mask #4-TP wrote), within 1e-4; #5-TP twice gives
    the same bits."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    rng = np.random.default_rng(C + mp)
    whole = _args(rng, 131, 9, C, 4, 4, dev)
    args = _tp_shard(whole, mp, mp - 1)
    dy = torch.from_numpy(rng.normal(size=(131, 9, C)).astype(np.float32)).to(dev)
    f0, b0 = pk.fused_window_block_tp.launches, pk.fused_window_block_tp_backward.launches
    y, keep = pk.fused_window_block_tp(*args, seed=11, rate=rate)
    got = pk.fused_window_block_tp_backward(*args, dy, keep, rate)
    torch.cuda.synchronize()
    assert (pk.fused_window_block_tp.launches, pk.fused_window_block_tp_backward.launches) == (
        f0 + 1, b0 + 1)
    assert (keep is None) == (rate == 0.0)
    assert _rel(y, pk.fused_window_block_reference(*args, keep, rate)) <= 1e-4
    want = pk.fused_window_block_backward_reference(*args, dy, keep, rate)
    for name, g, w in zip(["dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "drel_bias"], got, want):
        assert g.shape == w.shape, name
        assert _rel(g, w) <= 1e-4, (name, _rel(g, w))
    again = pk.fused_window_block_tp_backward(*args, dy, keep, rate)
    for g, h in zip(got, again):
        assert torch.equal(g, h)


@pytest.mark.gpu
@pytest.mark.parametrize("C,mp", TP_GEOMETRIES)
def test_tp_shards_sum_to_the_whole_block(C, mp):
    """The shards' #4-TP outputs, bproj added once, sum to #4 at full heads
    within 1e-4 of max|y|, and so do their #5-TP dx; each shard's weight
    gradients equal the matching slices of #5's within 1e-4, dbproj the
    same on every shard."""
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.parallel.tp import Spec, local_slice

    dev = _card()
    rng = np.random.default_rng(C * mp)
    whole = _args(rng, 131, 9, C, 4, 4, dev)
    dy = torch.from_numpy(rng.normal(size=(131, 9, C)).astype(np.float32)).to(dev)
    y_full = pk.fused_window_block_perhead(*whole)[0]
    g_full = pk.fused_window_block_perhead_backward(*whole, dy)
    H = 4
    specs = [None, Spec(1, 3, H), Spec(0, 3, H), Spec(0, 1, H), None, Spec(0, 1, H)]
    y_sum, dx_sum = torch.zeros_like(y_full), torch.zeros_like(y_full)
    for m in range(mp):
        args = _tp_shard(whole, mp, m)
        y_sum += pk.fused_window_block_tp(*args)[0]
        dx, *dws = pk.fused_window_block_tp_backward(*args, dy)
        dx_sum += dx
        for name, g, w, spec in zip(["dwqkv", "dbqkv", "dwproj", "dbproj", "drel_bias"], dws,
                                    g_full[1:], specs[1:]):
            want = w if spec is None else local_slice(w, spec, mp, m)
            assert _rel(g, want) <= 1e-4, (name, m, _rel(g, want))
    torch.cuda.synchronize()
    assert _rel(y_sum, y_full) <= 1e-4 and _rel(dx_sum, g_full[0]) <= 1e-4


# ---------------------------------------------------------------------------
# #4-TP-bf16/#5-TP-bf16: the bf16 whole-block kernels on a tensor-parallel
# shard's heads (D = C / mp), at every local geometry of MOD's and
# MOD_WIDE's stages at mp 2 and 4; the bf16 kernels at D = C keep the
# parent's bits


def _tp_bf16_shard(whole, mp, m):
    args = _tp_shard(whole, mp, m)
    for i in (0, 1, 3):  # x, wqkv, wproj
        args[i] = args[i].to(torch.bfloat16)
    return args


@pytest.mark.gpu
@pytest.mark.parametrize("C,mp", TP_GEOMETRIES)
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_tp_bf16_kernels_match_plain(C, mp, rate):
    """#4-TP-bf16 and #5-TP-bf16 on one shard against the bf16 plain
    versions at its geometry (the keep mask #4-TP-bf16 wrote): y within
    8e-3 of max|y|, every gradient within 1e-2 relative; both twice give
    the same bits; the keep rate within 5 sigma and the mask #4-TP's for
    the same seed; one launch counted a call."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    rng = np.random.default_rng(C + mp + 1)
    whole = _args(rng, 131, 9, C, 4, 4, dev)
    args = _tp_bf16_shard(whole, mp, mp - 1)
    dy = torch.from_numpy(rng.normal(size=(131, 9, C)).astype(np.float32)).to(dev)
    dy = dy.to(torch.bfloat16)
    fwd, bwd = pk.fused_window_block_tp_bf16, pk.fused_window_block_tp_backward_bf16
    f0, b0 = fwd.launches, bwd.launches
    y, keep = fwd(*args, seed=11, rate=rate)
    y2, keep2 = fwd(*args, seed=11, rate=rate)
    got = bwd(*args, dy, keep, rate)
    again = bwd(*args, dy, keep, rate)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (f0 + 2, b0 + 2)
    assert y.dtype == torch.bfloat16 and torch.equal(y, y2)
    assert (keep is None) == (rate == 0.0)
    if rate:
        assert torch.equal(keep, keep2)
        kept = float(keep.double().mean())
        assert abs(kept - 0.8) <= 5 * (0.16 / keep.numel()) ** 0.5
        f32 = [a.float() if a is not None and a.dtype == torch.bfloat16 else a for a in args]
        assert torch.equal(pk.fused_window_block_tp(*f32, 11, rate)[1], keep)
    assert _rel(y, pk.fused_window_block_bf16_reference(*args, keep, rate)) <= 8e-3
    want = pk.fused_window_block_backward_bf16_reference(*args, dy, keep, rate)
    assert got[0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in got[1:])
    for name, g, w in zip(["dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "drel_bias"], got, want):
        assert g.shape == w.shape, name
        assert _rel(g, w) <= 1e-2, (name, _rel(g, w))
    for g, h in zip(got, again):
        assert torch.equal(g, h)


@pytest.mark.gpu
@pytest.mark.parametrize("C,mp", TP_GEOMETRIES)
def test_tp_bf16_shards_sum_to_the_whole_block(C, mp):
    """The shards' #4-TP-bf16 y partials, bproj added once, summed in f32
    come within 8e-3 of max|y| of #4-bf16 at full heads (each partial
    rounded to bf16 once), and so do their #5-TP-bf16 dx against #5-bf16's;
    each shard's weight gradients are the matching slices of #5-bf16's
    within 1e-2."""
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.parallel.tp import Spec, local_slice

    dev = _card()
    rng = np.random.default_rng(C * mp + 1)
    whole = _args(rng, 131, 9, C, 4, 4, dev)
    for i in (0, 1, 3):
        whole[i] = whole[i].to(torch.bfloat16)
    dy = torch.from_numpy(rng.normal(size=(131, 9, C)).astype(np.float32)).to(dev)
    dy = dy.to(torch.bfloat16)
    y_full = pk.fused_window_block_perhead_bf16(*whole)[0]
    g_full = pk.fused_window_block_perhead_backward_bf16(*whole, dy)
    H = 4
    specs = [Spec(1, 3, H), Spec(0, 3, H), Spec(0, 1, H), None, Spec(0, 1, H)]
    y_sum = torch.zeros(y_full.shape, device=dev)
    dx_sum = torch.zeros(y_full.shape, device=dev)
    for m in range(mp):
        args = _tp_shard(whole, mp, m)
        y_sum += pk.fused_window_block_tp_bf16(*args)[0].float()
        dx, *dws = pk.fused_window_block_tp_backward_bf16(*args, dy)
        dx_sum += dx.float()
        for name, g, w, spec in zip(["dwqkv", "dbqkv", "dwproj", "dbproj", "drel_bias"], dws,
                                    g_full[1:], specs):
            want = w if spec is None else local_slice(w, spec, mp, m)
            assert _rel(g, want) <= 1e-2, (name, m, _rel(g, want))
    torch.cuda.synchronize()
    assert _rel(y_sum, y_full) <= 8e-3 and _rel(dx_sum, g_full[0]) <= 1e-2


def _bf16_block_digest(pk, B, C, nW, dev):
    """The bf16 whole-block kernels at D = C, N 9, 4 heads: #1-bf16 and
    #2-bf16 (C <= 256) or #4-bf16 at rate 0 and 0.2 (C 512), y and the keep
    mask, then #3-bf16 (#5-bf16) with that mask and without."""
    rng = np.random.default_rng(11 * B + C)
    args = _bf16_args(rng, B, 9, C, 4, nW, dev)
    dy = torch.from_numpy(rng.normal(size=(B, 9, C)).astype(np.float32)).to(dev)
    dy = dy.to(torch.bfloat16)
    if pk.wblock_fits(9, C, 4):
        y0 = pk.fused_window_block_bf16(*args)
        y, keep = pk.fused_window_block_dropout_bf16(*args, 5, 0.2)
        bwd = pk.fused_window_block_backward_bf16
    else:
        y0 = pk.fused_window_block_perhead_bf16(*args)[0]
        y, keep = pk.fused_window_block_perhead_bf16(*args, 5, 0.2)
        bwd = pk.fused_window_block_perhead_backward_bf16
    outs = [y0, y, keep, *bwd(*args, dy, keep, 0.2), *bwd(*args, dy, None, 0.0)]
    torch.cuda.synchronize()
    return _digest(outs)


# _bf16_block_digest as the parent commit's build gave it (NVIDIA H100 80GB
# HBM3, 132 SMs), before the bf16 kernels took an inner width D apart from C
BF16_BLOCK_DIGESTS = {(131, 64, 4): "e250c8aeec7735b6", (129, 256, 0): "9a3358d42e578920",
                      (37, 512, 0): "bdc8c11351af3288"}


@pytest.mark.gpu
@pytest.mark.parametrize("B,C,nW", sorted(BF16_BLOCK_DIGESTS))
def test_bf16_block_gives_the_parents_bits_at_d_equal_c(B, C, nW):
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    assert torch.cuda.get_device_properties(dev).multi_processor_count == 132, (
        "the digests were taken on a 132-SM H100")
    assert _bf16_block_digest(pk, B, C, nW, dev) == BF16_BLOCK_DIGESTS[(B, C, nW)]


# ---------------------------------------------------------------------------
# DP-13-14(-bf16): the conv tower over several data ranks. Each conv's launch
# writes its raw sums [Σc; Σc²] in place of the BatchNorm rows, the
# backward's statistics launch s2 alone; the tower sums them over the data
# ranks (``plan.sum_data_``). Two data ranks that hold the same rows give
# the single-process tower: every sum doubles, and so does the count.


class _TwinRanks:
    """A stand-in plan of two data ranks that hold the same rows: the sum
    over them doubles a tensor (in place, as all_reduce does)."""
    dp = 2

    @staticmethod
    def sum_data_(t):
        return t.mul_(2.0)

    @staticmethod
    def sum_data(t):
        return 2.0 * t


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_tower_raw_sums_match_plain(dtype):
    """_conv0 and _apply without the BatchNorm's affine write the raw sums
    of the conv they launch (Σc, Σc² over every row of c, within 1e-5 of
    the f32 sums of the c they stored); _bwd_stats without means gives the
    s2 of the launch with them and no m."""
    from focal_tpu_torch.ops import conv_tower as ct

    dev = _card()
    rng = np.random.default_rng(17)
    cfgs, x0, params, masks = _tower_args(rng, 64, 10, 20, 64, 3, False, 3, dev)
    ws, bs, scales, biases = ([p.detach() for p in g] for g in params)
    if dtype == torch.bfloat16:
        x0, ws = x0.to(dtype), [w.to(dtype) for w in ws]
    R, S = x0.shape[:2]
    x2 = x0.detach().reshape(R * S, -1).contiguous()
    c, sums, mu, var = ct._conv0(x2, ws[0], bs[0], None, None, 3, R, S)
    assert sums.shape == (2, 64) and mu is None and var is None
    cf = c.float()
    want = torch.stack([cf.sum(0), (cf * cf).sum(0)])
    assert _rel(sums, want) <= 1e-5
    rows = ct._finalize_stats(sums, float(R * S), scales[0], biases[0])[0]
    a, c1, sums1, _, _ = ct._apply(c, rows, masks[0], None, (ws[1], bs[1], 3, None, None), R, S)
    c1f = c1.float()
    assert _rel(sums1, torch.stack([c1f.sum(0), (c1f * c1f).sum(0)])) <= 1e-5
    da = torch.from_numpy(rng.normal(size=(R * S, 64)).astype(np.float32)).to(dev).to(dtype)
    s2, m = ct._bwd_stats(da, c, masks[0], rows, R, S)
    s2_raw, none = ct._bwd_stats(da, c, masks[0], rows, R, S, means=False)
    torch.cuda.synchronize()
    assert none is None and torch.equal(s2, s2_raw)
    assert _rel(m, s2 * rows[4] / float(R * S)) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("external", [False, True])
def test_conv_tower_over_twin_data_ranks_is_the_single_tower(dtype, external):
    """The tower with a plan of two data ranks that hold the same rows
    (_TwinRanks) against the single-process tower: the output, the
    statistics and every gradient within 1e-5 relative (f32; the
    statistics' last steps run in torch there, in the kernel here), 8e-3 /
    1e-2 in bf16; the launches of one process (DP-13-14 counts through
    #13's and #14's wrappers)."""
    from focal_tpu_torch.ops import conv_tower as ct

    dev = _card()
    rng = np.random.default_rng(23 + external)
    cfgs, x0, params, masks = _tower_args(rng, 32, 10, 20, 64, 5 if external else 3, external,
                                          4, dev)
    x0 = x0.detach().to(dtype).requires_grad_(True)
    dy = torch.from_numpy(rng.normal(size=(320, 20, 64)).astype(np.float32)).to(dev).to(dtype)
    fwd = ct.fused_conv_tower_bf16 if dtype == torch.bfloat16 else ct.fused_conv_tower
    bwd = ct.fused_conv_tower_backward_bf16 if dtype == torch.bfloat16 else \
        ct.fused_conv_tower_backward
    single = _tower_grads(ct.fused_conv_tower, cfgs, x0, params, masks, dy, external)
    f0, b0 = fwd.launches, bwd.launches
    twin = _tower_grads(lambda *a: ct.fused_conv_tower(*a, plan=_TwinRanks()), cfgs, x0, params,
                        masks, dy, external)
    torch.cuda.synchronize()
    assert (fwd.launches - f0, bwd.launches - b0) == (len(cfgs) + 1 - external, 2 * len(cfgs))
    tol_y, tol_g = (1e-5, 1e-5) if dtype == torch.float32 else (8e-3, 1e-2)
    assert _rel(twin[0].detach().float(), single[0].detach().float()) <= tol_y
    for a, b in zip(twin[1] + twin[2], single[1] + single[2]):
        assert _rel(a, b) <= tol_y
    for i, (g, w) in enumerate(zip(twin[3], single[3])):
        g, w = g.float(), w.float()
        if max(float(g.abs().max()), float(w.abs().max())) < 1e-2:
            assert float((g - w).abs().max()) <= 1e-2, i  # C7: a conv bias before its BatchNorm
        else:
            assert _rel(g, w) <= tol_g, (i, _rel(g, w))


# GradCache's replay and the streamed split (-grad_accum, -hbm_budget_gb):
# MOD_TINY, the recipe's drop rates, micro-batches of 8


GRADCACHE_ROUTES = {
    "sw": ["-model", "SW_Transformer"],
    "sw_bf16": ["-model", "SW_Transformer", "-compute_dtype", "bfloat16"],
    "sw_no_pallas_block": ["-model", "SW_Transformer", "-no_pallas_block"],
    "sw_pallas_mlp": ["-model", "SW_Transformer", "-pallas_mlp"],
    "ds_pallas_conv": ["-model", "DeepSense", "-pallas_conv"],
}


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(GRADCACHE_ROUTES))
def test_gradcache_replays_pass_one_bitwise_through_the_kernels(route):
    """One GradCache update of 2 micro-batches: pass 2's features bitwise
    pass 1's through the route's kernels (which launched), the loss
    finite."""
    from focal_tpu_torch.data import synthetic_arrays, to_device
    from focal_tpu_torch.models import build_backbone, init_params
    from focal_tpu_torch.ops import conv_tower, fused_mlp
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.ops.augment import build_augmenter
    from focal_tpu_torch.params import parse_train_params
    from focal_tpu_torch.train.losses import make_focal_loss
    from focal_tpu_torch.train.state import create_train_state
    from focal_tpu_torch.train.steps import make_gathered_pretrain_step
    from torch_port_replay import recorded_passes, replayed_bitwise

    dev = _card()
    args = parse_train_params(["-dataset", "MOD_TINY", "-batch_size", "8", "-grad_accum", "2",
                               *GRADCACHE_ROUTES[route]])
    model = build_backbone(args.dataset_config, args.model, args.task, args.learn_framework,
                           pallas_conv=args.pallas_conv, pallas_mlp=args.pallas_mlp,
                           pallas_block=not args.no_pallas_block, compute_dtype=args.compute_dtype)
    init_params(model, seed=0).to(dev)
    state = create_train_state(args, model, 10, seed=1, accum_in_step=True)
    data = to_device(synthetic_arrays(args.dataset_config, args.task, 16, seed=0)[0], dev)
    step = make_gathered_pretrain_step(model, build_augmenter(args), make_focal_loss(args), 2)
    wrappers = [pk.fused_window_block_dropout, pk.fused_window_block_dropout_bf16,
                pk.fused_window_attention_dropout, fused_mlp.fused_mlp_dropout_forward,
                conv_tower.fused_conv_tower]
    before = [w.launches for w in wrappers]
    with recorded_passes(model) as seen:
        _, metrics = step(state, [(data, torch.arange(i * 8, (i + 1) * 8, device=dev))
                                  for i in range(2)])
    torch.cuda.synchronize()
    assert replayed_bitwise(seen) and np.isfinite(float(metrics["loss"]))
    assert any(w.launches > b for w, b in zip(wrappers, before))


@pytest.mark.gpu
def test_streamed_steps_equal_resident_steps_on_card():
    """The pretrain loop's steps fed by BlockStream (blocks of 3 steps from
    pinned memory on a side stream) against the same steps on the resident
    split: the losses and the parameters bit for bit."""
    from focal_tpu_torch.data import synthetic_arrays, to_device
    from focal_tpu_torch.models import build_backbone, init_params
    from focal_tpu_torch.ops.augment import build_augmenter
    from focal_tpu_torch.params import parse_train_params
    from focal_tpu_torch.streaming import BlockStream
    from focal_tpu_torch.train.losses import make_focal_loss
    from focal_tpu_torch.train.state import create_train_state
    from focal_tpu_torch.train.steps import make_pretrain_step

    dev = _card()
    args = parse_train_params(["-dataset", "MOD_TINY", "-batch_size", "8"])
    host, labels, _ = synthetic_arrays(args.dataset_config, args.task, 64, seed=0)
    steps = torch.randperm(64, generator=torch.Generator().manual_seed(0)).view(8, 8)
    runs = []
    for streamed in (False, True):
        model = init_params(build_backbone(args.dataset_config, args.model, args.task,
                                           args.learn_framework), seed=0).to(dev)
        state = create_train_state(args, model, 10, seed=1)
        step = make_pretrain_step(model, build_augmenter(args), make_focal_loss(args))
        if streamed:
            stream = BlockStream(host, labels, dev, block_steps=3)
            assert stream.labels.is_pinned()
            feed = [(d, idx) for d, _, idx in stream.feed(steps)]
        else:
            data = to_device(host, dev)
            feed = [(data, idx) for idx in steps.to(dev)]
        losses = [step(state, d, idx)[1]["loss"] for d, idx in feed]
        runs.append((torch.stack(losses).cpu(), {k: v.cpu() for k, v in
                                                  model.state_dict().items()}))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])
