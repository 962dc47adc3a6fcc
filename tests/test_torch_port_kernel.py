"""Port's whole-block window attention (focal_tpu_torch.ops.pallas_kernels.
fused_window_block) against the JAX package, on the CPU.

On a CPU tensor the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is held against that plain version on the card by
chip_smoke.py. Inputs and parameters come from one numpy seed and pass to
both frameworks as numpy arrays.

Tolerances:
  * 5e-5 against the JAX XLA path (use_pallas=False): both are f32; the
    difference is summation order only.
  * against the JAX Pallas kernel run in interpret mode: 5e-5 at C < 128,
    3e-2 at C >= 128, where the JAX kernel computes in bf16
    (_wblock_compute_dtype) and the port stays in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.models.swin import WindowAttention, shifted_window_mask
from focal_tpu.ops.pallas_kernels import expand_bias_lanes
from focal_tpu.ops.pallas_kernels import fused_window_block as jax_fused_window_block
from focal_tpu_torch.models import swin as tswin
from focal_tpu_torch.ops.pallas_kernels import (
    fused_window_block,
    fused_window_block_reference,
)
from focal_tpu_torch.weights import params_from_flax


def _mask(nW):
    if nW == 1:
        return None
    if nW == 4:
        return shifted_window_mask(6, 6, 3, 3, 1, 1)
    return shifted_window_mask(6, 3, 3, 3, 1, 1)  # nW == 2


def _setup(C, nW, H=4, B_=128):
    rng = np.random.default_rng(C + nW)
    x = rng.normal(size=(B_, 9, C)).astype(np.float32)
    mask = _mask(nW)
    assert mask is None or mask.shape[0] == nW
    jax_attn = WindowAttention(dim=C, window_size=(3, 3), num_heads=H, use_pallas=False)
    v = jax_attn.init({"params": jax.random.key(0)}, jnp.asarray(x), mask, train=False)
    # non-trivial biases: the flax init zeroes them
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    params["qkv"]["bias"] = rng.normal(size=params["qkv"]["bias"].shape).astype(np.float32) * 0.1
    params["proj"]["bias"] = rng.normal(size=params["proj"]["bias"].shape).astype(np.float32) * 0.1
    return x, mask, jax_attn, params


@pytest.mark.parametrize("C,nW", [(64, 1), (64, 4), (256, 2)])
def test_plain_block_matches_jax_xla_path(C, nW):
    x, mask, jax_attn, params = _setup(C, nW)
    ref = np.asarray(jax_attn.apply({"params": params}, jnp.asarray(x), mask, train=False))

    port = tswin.WindowAttention(C, (3, 3), 4).eval()
    port.load_state_dict(params_from_flax(params, {}, {"location_names": ["l"]}), strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-5)


@pytest.mark.parametrize("C,nW", [(64, 1), (64, 4), (256, 2)])
def test_plain_block_matches_jax_pallas_kernel(C, nW):
    """The same function through the JAX package's own kernel, in interpret
    mode on the CPU as tests/test_pallas_kernels.py runs it."""
    x, mask, _, params = _setup(C, nW)
    port = tswin.WindowAttention(C, (3, 3), 4).eval()
    port.load_state_dict(params_from_flax(params, {}, {"location_names": ["l"]}), strict=True)
    with torch.no_grad():
        wqkv, bqkv, wproj, bproj, rel_bias = (t.numpy() for t in port.kernel_args())
        tmask = None if mask is None else torch.from_numpy(mask)
        out = fused_window_block(torch.from_numpy(x), *(torch.from_numpy(a) for a in
                                 (wqkv, bqkv, wproj, bproj, rel_bias)), tmask)
    bias_l = expand_bias_lanes(jnp.asarray(rel_bias), mask)
    ref = jax_fused_window_block(
        jnp.asarray(x), jnp.asarray(wqkv), jnp.asarray(bqkv), jnp.asarray(wproj),
        jnp.asarray(bproj), bias_l,
    )
    tol = 5e-5 if C < 128 else 3e-2
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=tol)


def test_mask_indexing_ragged_window_batch():
    """Window w takes mask[w % nW] even when B_ is not a multiple of nW."""
    rng = np.random.default_rng(1)
    C, H, N, nW, B = 16, 2, 9, 4, 10
    args = [rng.normal(size=s).astype(np.float32) for s in
            [(B, N, C), (C, 3 * C), (3 * C,), (C, C), (C,), (H, N, N)]]
    mask = shifted_window_mask(6, 6, 3, 3, 1, 1)
    t = [torch.from_numpy(a) for a in args]
    full = fused_window_block_reference(*t, torch.from_numpy(mask))
    for w in range(B):
        one = fused_window_block_reference(
            t[0][w:w + 1], *t[1:], torch.from_numpy(mask[w % nW][None]))
        np.testing.assert_allclose(full[w:w + 1].numpy(), one.numpy(), atol=1e-6)


def test_wrapper_counts_only_kernel_launches():
    """The CPU path is the plain version: it launches nothing and counts
    nothing."""
    before = fused_window_block.launches
    rng = np.random.default_rng(2)
    C, H = 16, 2
    args = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in
            [(3, 9, C), (C, 3 * C), (3 * C,), (C, C), (C,), (H, 9, 9)]]
    fused_window_block(*args)
    assert fused_window_block.launches == before



def test_folded_weights_are_reused_until_a_parameter_changes():
    """The served block folds the q scale into its weights once, and folds
    anew after load_state_dict or an in-place write."""
    C, H = 16, 2
    attn = tswin.WindowAttention(C, (3, 3), H).eval()
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 9, C)).astype(np.float32))
    with torch.inference_mode():
        first = attn.folded_kernel_args()
        y0 = attn(x)
        assert attn.folded_kernel_args() is first
    fresh = tswin.WindowAttention(C, (3, 3), H).eval()
    with torch.no_grad():
        fresh.relative_position_bias_table.normal_()
    attn.load_state_dict(fresh.state_dict())
    with torch.inference_mode():
        assert attn.folded_kernel_args() is not first
        for got, want in zip(attn.folded_kernel_args(), fresh.kernel_args()):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(attn(x), fresh(x), rtol=0, atol=0)
        assert not torch.equal(attn(x), y0)
    with torch.no_grad():
        attn.proj.bias.add_(1.0)
    with torch.inference_mode():
        torch.testing.assert_close(attn(x), fresh(x) + 1.0, rtol=0, atol=1e-6)
