"""The per-head kernels' phase order (#4, #5) in plain PyTorch, held on the
CPU against the plain block and the JAX package's per-head Pallas kernels,
and the 3xTF32 arithmetic of their tensor-core products.

On the card #4 and #5 run over all R = B_ N rows of a call, not a window at
a time (csrc/window_block.cu):
  #4: qkv = x Wqkv + bqkv [R, 3C]; the attention per (window, head) pair
      into ao [R, C]; y = ao Wproj + bproj.
  #5: qkv and g = dy Wproj^T [R, C]; the attention backward per pair into
      dqkv [R, 3C] and ao; dx = dqkv Wqkv^T; dWqkv | dbqkv = x^T dqkv and
      the column sums of dqkv, dWproj | dbproj = ao^T dy and those of dy, as
      partials over fixed row splits summed in split order; d rel_bias
      summed over the windows.
``stages_forward`` and ``stages_backward`` run that order with every
product through ``gemm``: torch.matmul, or the plain emulation of the
kernels' 3xTF32 tensor-core product (``gemm_3xtf32_reference``).

Tolerances: y within 1e-5 absolute and each gradient within 1e-5 relative
(max|got - want| / max|want|) of ``fused_window_block_reference`` and its
autograd backward, and of ``_wblock_ph_fwd_impl`` / ``_wblock_ph_bwd_impl``
in interpret mode at C = 64 (f32). At C = 512 the JAX kernels compute in
bf16 (tests/test_torch_port_wide_kernel.py), so there the bound against
them is that file's 1e-2 on bf16-representable inputs. The emulation is
held to the card's f32 gates (1e-4) at K = 512, 1024, 3072 with
MOD_WIDE-scaled inputs, and one TF32 product is shown to miss them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.ops.pallas_kernels import _wblock_ph_bwd_impl, _wblock_ph_fwd_impl
from focal_tpu.ops.pallas_kernels import expand_bias_lanes
from focal_tpu_torch.ops import pallas_kernels as pk
from test_torch_port_wide_kernel import NAMES, _inputs, _jax_keep, _rel

GEMMS = {"f32": torch.matmul, "3xtf32": pk.gemm_3xtf32_reference}


def _heads(t, B, N, H, parts):
    """[R, parts C] rows -> parts tensors [B, H, N, hd] (column order
    part | head | dim, as the qkv projection lays them out)."""
    hd = t.shape[1] // (parts * H)
    return t.view(B, N, parts, H, hd).permute(2, 0, 3, 1, 4).unbind(0)


def _rows(*ts):
    """parts tensors [B, H, N, hd] -> [R, parts C] rows."""
    B, H, N, hd = ts[0].shape
    return torch.stack(ts).permute(1, 3, 0, 2, 4).reshape(B * N, len(ts) * H * hd)


def _softmax(q, k, rel_bias, mask):
    s = q @ k.transpose(-1, -2) + rel_bias[None]
    if mask is not None:
        s = s + mask[torch.arange(q.shape[0]) % mask.shape[0]][:, None]
    return torch.softmax(s, dim=-1)


def stages_forward(x, wqkv, bqkv, wproj, bproj, rel_bias, mask=None, keep=None, rate=0.0,
                   gemm=torch.matmul):
    """#4's phase order: y and the workspaces {qkv, ao}."""
    B, N, C = x.shape
    H = rel_bias.shape[0]
    qkv = gemm(x.reshape(B * N, C), wqkv) + bqkv
    q, k, v = _heads(qkv, B, N, H, 3)
    a = _softmax(q, k, rel_bias, mask)
    if keep is not None:
        a = torch.where(keep.bool(), a / (1.0 - rate), 0.0)
    ao = _rows(a @ v)
    return (gemm(ao, wproj) + bproj).view(B, N, C), {"qkv": qkv, "ao": ao}


def weight_splits(R, C, sms=132):
    """Rows per split of the weight gradients of #3 and #5, as bwd_plan sets
    them on a card of ``sms`` SMs (128 x 128 tiles, 128 x 64 at C = 64; ~4
    tiles an SM, >= 256 rows a split, a multiple of 32)."""
    bn = 128 if C % 128 == 0 else 64
    wtiles = -(-C // 128) * (-(-3 * C // bn) + -(-C // bn))
    splits = max(1, min(-(-4 * sms // wtiles), -(-R // 256)))
    rps = -(-R // splits)
    return -(-rps // 32) * 32


def stages_backward(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, dy, keep=None, rate=0.0,
                    gemm=torch.matmul):
    """#5's phase order: (dx, dwqkv, dbqkv, dwproj, dbproj, drel_bias) and
    the workspaces {qkv, g, dqkv, ao, partials}."""
    B, N, C = x.shape
    H = rel_bias.shape[0]
    R = B * N
    xr, dyr = x.reshape(R, C), dy.reshape(R, C)
    qkv = gemm(xr, wqkv) + bqkv
    g = gemm(dyr, wproj.t().contiguous())
    q, k, v = _heads(qkv, B, N, H, 3)
    (gh,) = _heads(g, B, N, H, 1)
    p = _softmax(q, k, rel_bias, mask)
    da = gh @ v.transpose(-1, -2)
    a_v = p
    if keep is not None:
        a_v = torch.where(keep.bool(), p / (1.0 - rate), 0.0)
        da = torch.where(keep.bool(), da / (1.0 - rate), 0.0)
    ds = p * (da - (da * p).sum(-1, keepdim=True))
    dqkv = _rows(ds @ k, ds.transpose(-1, -2) @ q, a_v.transpose(-1, -2) @ gh)
    ao = _rows(a_v @ v)
    dx = gemm(dqkv, wqkv.t().contiguous()).view(B, N, C)
    rps = weight_splits(R, C)
    partials = []
    for r0 in range(0, R, rps):
        rows = slice(r0, r0 + rps)
        partials.append(torch.cat([
            gemm(xr[rows].t().contiguous(), dqkv[rows]).flatten(), dqkv[rows].sum(0),
            gemm(ao[rows].t().contiguous(), dyr[rows]).flatten(), dyr[rows].sum(0)]))
    total = torch.zeros_like(partials[0])
    for part in partials:  # in split order, as reduce_partials_kernel
        total = total + part
    q3 = 3 * C * C
    grads = (dx, total[:q3].view(C, 3 * C), total[q3:q3 + 3 * C],
             total[q3 + 3 * C:q3 + 3 * C + C * C].view(C, C), total[q3 + 3 * C + C * C:],
             ds.sum(0))
    return grads, {"qkv": qkv, "g": g, "dqkv": dqkv, "ao": ao, "partials": partials}


def _case(C, nW, rate, seed, B=8):
    rng = np.random.default_rng(seed)
    N, H = 9, 4
    arrs, mask = _inputs(rng, B, N, C, H, nW)
    keep = (rng.random((B, H, N, N)) >= rate).astype(np.uint8) if rate else None
    return arrs, mask, keep


def _torch(arrs, mask, keep):
    t = [torch.tensor(a) for a in arrs]
    return (t[:6], None if mask is None else torch.from_numpy(mask), t[6],
            None if keep is None else torch.from_numpy(keep))


def _abs(got, want):
    return float((got - want).abs().max())


@pytest.mark.parametrize("gemm", sorted(GEMMS))
@pytest.mark.parametrize("C", [64, 512])
@pytest.mark.parametrize("nW", [1, 4])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_stages_forward_match_the_plain_block(gemm, C, nW, rate):
    arrs, mask, keep = _case(C, nW, rate, C + nW)
    args, tmask, _, tkeep = _torch(arrs, mask, keep)
    y, ws = stages_forward(*args, tmask, tkeep, rate, gemm=GEMMS[gemm])
    assert _abs(y, pk.fused_window_block_reference(*args, tmask, tkeep, rate)) <= 1e-5
    x, wqkv, bqkv = args[:3]
    assert _abs(ws["qkv"], x.reshape(-1, C) @ wqkv + bqkv) <= 1e-5


@pytest.mark.parametrize("gemm", sorted(GEMMS))
@pytest.mark.parametrize("C", [64, 512])
@pytest.mark.parametrize("nW", [1, 4])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_stages_backward_match_autograd_of_the_plain_block(gemm, C, nW, rate):
    arrs, mask, keep = _case(C, nW, rate, 2 * C + nW)
    args, tmask, dy, tkeep = _torch(arrs, mask, keep)
    got, _ = stages_backward(*args, tmask, dy, tkeep, rate, gemm=GEMMS[gemm])
    want = pk.fused_window_block_backward_reference(*args, tmask, dy, tkeep, rate)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w.numpy()) <= 1e-5, (name, _rel(g.numpy(), w.numpy()))


@pytest.mark.parametrize("C", [64, 512])
@pytest.mark.parametrize("nW", [1, 4])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_stages_backward_workspaces(C, nW, rate):
    """qkv and the attention output are the forward's; g is the gradient of
    the attention output and dqkv that of qkv (autograd through the plain
    attention); the three split partials (576 rows) sum to the whole
    products."""
    arrs, mask, keep = _case(C, nW, rate, 3 * C + nW, B=64)
    args, tmask, dy, tkeep = _torch(arrs, mask, keep)
    _, ws = stages_backward(*args, tmask, dy, tkeep, rate)
    _, fwd = stages_forward(*args, tmask, tkeep, rate)
    assert _abs(ws["qkv"], fwd["qkv"]) == 0.0 and _abs(ws["ao"], fwd["ao"]) <= 1e-6
    x, wqkv, bqkv, wproj, bproj, rel_bias = args
    B, N, _ = x.shape
    H = rel_bias.shape[0]
    with torch.enable_grad():
        qkv = fwd["qkv"].clone().requires_grad_(True)
        ao = _rows(pk.fused_window_attention_reference(*_heads(qkv, B, N, H, 3), rel_bias, tmask,
                                                       tkeep, rate))
        ao_leaf = ao.detach().requires_grad_(True)
        y = ao_leaf @ wproj + bproj
        (g,) = torch.autograd.grad(y, ao_leaf, dy.reshape(B * N, C))
        (dqkv,) = torch.autograd.grad(ao, qkv, g)
    assert _rel(ws["g"].numpy(), g.numpy()) <= 1e-6
    assert _rel(ws["dqkv"].numpy(), dqkv.numpy()) <= 1e-5
    assert len(ws["partials"]) == 3 == -(-B * N // weight_splits(B * N, C))
    whole = (x.reshape(-1, C).t() @ ws["dqkv"]).flatten()
    assert _rel(sum(p[:whole.numel()] for p in ws["partials"]).numpy(), whole.numpy()) <= 1e-5


@pytest.mark.parametrize("C", [64, 512])
@pytest.mark.parametrize("nW", [1, 4])
def test_stages_forward_match_the_jax_kernel(C, nW):
    arrs, mask, _ = _case(C, nW, 0.0, 4 * C + nW)
    args, tmask, _, _ = _torch(arrs, mask, None)
    y, _ = stages_forward(*args, tmask, gemm=pk.gemm_3xtf32_reference)
    x, wqkv, bqkv, wproj, bproj, rel_bias, _ = arrs
    want = np.asarray(_wblock_ph_fwd_impl(*(jnp.asarray(a) for a in (x, wqkv, bqkv, wproj, bproj)),
                                          expand_bias_lanes(jnp.asarray(rel_bias), mask)),
                      np.float32)
    if C < 128:
        assert float(np.abs(y.numpy() - want).max()) <= 1e-5
    else:
        assert _rel(y.numpy(), want) <= 1e-2


@pytest.mark.parametrize("C", [64, 512])
@pytest.mark.parametrize("nW", [1, 4])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_stages_backward_match_the_jax_kernel(C, nW, rate):
    arrs, mask, keep = _case(C, nW, rate, 5 * C + nW)
    args, tmask, dy, tkeep = _torch(arrs, mask, keep)
    got, _ = stages_backward(*args, tmask, dy, tkeep, rate, gemm=pk.gemm_3xtf32_reference)
    B, N, H = 8, 9, 4
    x, wqkv, bqkv, wproj, bproj, rel_bias, dyn = arrs
    want = _wblock_ph_bwd_impl(
        *(jnp.asarray(a) for a in (x, wqkv, bqkv, wproj, bproj)),
        expand_bias_lanes(jnp.asarray(rel_bias), mask), jnp.asarray(dyn),
        mask=None if keep is None else _jax_keep(keep, N, C, H, B), rate=rate)
    want = [np.asarray(w, np.float32) for w in want]
    want[5] = want[5].sum(-1)  # d bias_l [H, N, N, 128] -> d rel_bias
    tol = 1e-5 if C < 128 else 1e-2
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w) <= tol, (name, _rel(g.numpy(), w))


def test_tf32_round_is_cvt_rna():
    """Round to nearest on the low 13 mantissa bits, ties away from zero,
    either sign; values with those bits clear pass unchanged."""
    one_ulp = 2.0**-10  # a TF32 ulp at 1.0
    x = torch.tensor([1.0, 1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 2 - 2**-23,
                      1 + 1.5 * one_ulp, 3.0, -0.0], dtype=torch.float32)
    want = [1.0, 1 + one_ulp, -(1 + one_ulp), 1.0, 1 + 2 * one_ulp, 3.0, -0.0]
    assert pk.tf32_round(x).tolist() == want
    r = pk.tf32_round(torch.randn(1000, generator=torch.Generator().manual_seed(0)))
    assert int((r.view(torch.int32) & 0x1FFF).abs().max()) == 0


@pytest.mark.parametrize("K", [512, 1024, 3072])
def test_3xtf32_emulation_holds_the_gates(K):
    """MOD_WIDE-scaled products (unit activations, weights of std K**-0.5,
    K = C or 3C): 3xTF32 meets the card's gates (1e-4 absolute on O(1)
    outputs, 1e-4 relative), one TF32 product misses the relative one."""
    rng = np.random.default_rng(K)
    a = rng.normal(size=(512, K)).astype(np.float32)
    b = (rng.normal(size=(K, 512)) * K**-0.5).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    three = pk.gemm_3xtf32_reference(torch.from_numpy(a), torch.from_numpy(b)).double().numpy()
    one = pk.gemm_3xtf32_reference(torch.from_numpy(a), torch.from_numpy(b), passes=1)
    one = one.double().numpy()
    assert np.abs(three - exact).max() <= 1e-4 and _rel(three, exact) <= 1e-5
    assert _rel(one, exact) > 2e-4


@pytest.mark.parametrize("transpose_a", [False, True])
def test_gemm_wrapper_takes_its_emulation_on_the_cpu(transpose_a):
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.normal(size=(96, 40)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(96 if transpose_a else 40, 24)).astype(np.float32))
    got = pk.gemm_3xtf32(a, b, transpose_a)
    want = pk.gemm_3xtf32_reference(a.t() if transpose_a else a, b)
    assert torch.equal(got, want) and pk.gemm_3xtf32.launches == 0
