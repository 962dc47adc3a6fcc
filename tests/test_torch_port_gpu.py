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

def _tower_args(rng, samples, intervals, S, C, kw, external, layers, dev):
    R = samples * intervals
    cin0 = C if external else 2
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


def _tower_case(samples, C, external, S=20, layers=5):
    """A tower against autograd of its plain version on the card: output,
    statistics and gradients within the gates above, and the same bits on
    a second call."""
    from focal_tpu_torch.ops.conv_tower import fused_conv_tower, fused_conv_tower_reference

    dev = _card()
    rng = np.random.default_rng(samples + C + external)
    kw = 5 if external else 3
    cfgs, x0, params, masks = _tower_args(rng, samples, 10, S, C, kw, external, layers, dev)
    dy = torch.from_numpy(rng.normal(size=(samples * 10, S, C)).astype(np.float32)).to(dev)
    got = _tower_grads(fused_conv_tower, cfgs, x0, params, masks, dy, external)
    again = _tower_grads(fused_conv_tower, cfgs, x0, params, masks, dy, external)
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
    from focal_tpu_torch.ops.conv_tower import fused_conv_tower

    dev = _card()
    rng = np.random.default_rng(6)
    cfgs, x0, params, masks = _tower_args(rng, 4, 10, 20, 6, 3, False, 2, dev)
    with pytest.raises(RuntimeError, match="no launch plan"):  # C 6: the products take C % 4 == 0
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


def _mlp_args(rng, T, C, dev):
    H = 4 * C
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
    from focal_tpu_torch.ops import fused_mlp as fm

    dev = _card()
    x, w1, b1, w2, b2 = _mlp_args(np.random.default_rng(2), 64, 512, dev)
    with pytest.raises(ValueError, match="unsupported width"):
        fm.fused_mlp_forward(x, w1, b1, w2, b2)
    x, w1, b1, w2, b2 = _mlp_args(np.random.default_rng(2), 64, 64, dev)
    with pytest.raises(ValueError, match="unsupported width"):
        fm.fused_mlp_forward(x[:, :62].contiguous(), w1[:62].contiguous(), b1, w2[:, :62].contiguous(),
                             b2[:62].contiguous())
    with pytest.raises(TypeError):
        fm.fused_mlp_forward(x.double(), w1, b1, w2, b2)


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
        _mlp_calls(fm, x, w1, b1, w2, b2, g, 3, *tr)
        torch.cuda.synchronize()
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
                   (33, 2, 9, 4, 0)]


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
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_window_attention_function_on_qkv_views(rate):
    """The autograd pair on strided views of one qkv tensor, as the Swin
    block hands them over: #7 (or #6) forward, #9 (or #8) backward, its
    gradients in qkv and rel_bias against autograd of the plain version
    with the same mask."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    dev = _card()
    B, H, N, hd, nW = 130, 4, 9, 16, 4
    rng = np.random.default_rng(13)
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3, H, hd)).astype(np.float32)).to(dev)
    _, _, _, rel_bias, mask, g = _attn_args(rng, B, H, N, hd, nW, dev)
    keep = pk.window_attention_keep_mask(17, B, H, N, rate, dev) if rate else None
    kernels = ((pk.fused_window_attention_dropout, pk.fused_window_attention_dropout_backward)
               if rate else (pk.fused_window_attention, pk.fused_window_attention_backward))
    before = [f.launches for f in kernels]
    runs = []
    for kernel in (True, False):
        leaves = [qkv.clone().requires_grad_(True), rel_bias.clone().requires_grad_(True)]
        q, k, v = leaves[0].permute(2, 0, 3, 1, 4).unbind(0)
        q = q * hd**-0.5
        if kernel:
            y = pk.window_attention(q, k, v, leaves[1], mask, seed=17, rate=rate)
        else:
            y = pk.fused_window_attention_reference(q, k, v, leaves[1], mask, keep, rate)
        runs.append((y.detach(), torch.autograd.grad(y, leaves, g)))
    torch.cuda.synchronize()
    assert [f.launches for f in kernels] == [b + 1 for b in before]
    (y, got), (ref, want) = runs
    assert float((y - ref).abs().max()) <= 1e-4
    for a, w in zip(got, want):
        assert _rel(a, w) <= 1e-4


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
