"""The training path's dropouts on the CPU: ``ops.dropout.remat_dropout``
(quantized keep rate and scale, as the JAX package's), DropPath, and the
Swin modules' train mode.

Statistical checks allow 5 binomial standard deviations; scales and
gradients are exact (the same float multiply on both sides).
"""

import numpy as np
import pytest
import torch

from focal_tpu.ops.dropout import _inv_keep as jax_inv_keep
from focal_tpu.ops.dropout import _threshold as jax_threshold
from focal_tpu_torch.models import swin as tswin
from focal_tpu_torch.ops.dropout import StepRngs, _threshold, keep_scale, remat_dropout


def _rngs(seed=0):
    return StepRngs(torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed + 1))


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5, 0.001, 0.999])
def test_quantized_threshold_and_scale_match_jax(rate):
    assert _threshold(rate) == jax_threshold(rate)
    assert keep_scale(rate) == jax_inv_keep(rate)


def test_remat_dropout_keep_rate_and_scale():
    rate = 0.2
    x = torch.rand(256, 1024) + 0.5
    y = remat_dropout(x, rate, torch.Generator().manual_seed(0))
    kept = y != 0
    p_keep = (256 - _threshold(rate)) / 256  # 205/256, not 0.8
    n = x.numel()
    assert abs(float(kept.double().mean()) - p_keep) <= 5 * (p_keep * (1 - p_keep) / n) ** 0.5
    torch.testing.assert_close(y[kept], x[kept] * (256 / 205), rtol=0, atol=0)
    # E[y] == x: the realized keep rate is what the scale inverts
    assert abs(float(y.mean() / x.mean()) - 1) < 5e-3


def test_remat_dropout_gradient_is_the_mask_times_scale():
    x = torch.randn(64, 128, requires_grad=True)
    y = remat_dropout(x, 0.3, torch.Generator().manual_seed(1))
    g = torch.randn(64, 128)
    (dx,) = torch.autograd.grad(y, x, g)
    kept = (y != 0) | (x == 0)
    torch.testing.assert_close(dx, torch.where(kept, g * keep_scale(0.3), 0.0), rtol=0, atol=0)


def test_remat_dropout_is_seeded():
    x = torch.ones(1000)
    a = remat_dropout(x, 0.2, torch.Generator().manual_seed(5))
    b = remat_dropout(x, 0.2, torch.Generator().manual_seed(5))
    c = remat_dropout(x, 0.2, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_drop_path_is_per_sample():
    dp = tswin.DropPath(0.25).train()
    x = torch.rand(4000, 3, 5) + 1.0
    y = dp(x, _rngs())
    kept = (y != 0).all(dim=(1, 2))
    dropped = (y == 0).all(dim=(1, 2))
    assert bool((kept | dropped).all())  # whole samples
    frac = float(kept.double().mean())
    assert abs(frac - 0.75) <= 5 * (0.75 * 0.25 / 4000) ** 0.5
    torch.testing.assert_close(y[kept], x[kept] / 0.75, rtol=0, atol=0)
    assert torch.equal(dp.eval()(x), x)


def test_block_train_mode_needs_the_step_rng():
    blk = tswin.SwinBlock(16, (6, 6), 2, (3, 3), (1, 1), drop=0.2, attn_drop=0.2,
                          drop_path=0.1).train()
    x = torch.randn(2, 36, 16)
    with pytest.raises(ValueError, match="StepRngs"):
        blk(x)
    y1 = blk(x, _rngs(3))
    y2 = blk(x, _rngs(3))
    y3 = blk(x, _rngs(4))
    assert torch.equal(y1, y2) and not torch.equal(y1, y3)
    # eval: identity dropouts, the same as a block built without them
    plain = tswin.SwinBlock(16, (6, 6), 2, (3, 3), (1, 1)).eval()
    plain.load_state_dict(blk.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(blk.eval()(x), plain(x), rtol=0, atol=0)


def test_train_mode_gradients_reach_every_parameter():
    """Training folds the q scale, transposes and bias-table gather with
    grad, so the WindowAttention parameters get gradients (the eval fold
    cache does not carry them)."""
    blk = tswin.SwinBlock(16, (6, 6), 2, (3, 3), (1, 1), attn_drop=0.2).train()
    x = torch.randn(2, 36, 16)
    blk(x, _rngs()).square().sum().backward()
    for name, p in blk.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
    # and the table's gradient is the gather's: entries no (i, j) pair uses get none
    assert blk.attn.relative_position_bias_table.grad.shape == (25, 2)


def test_eval_fold_is_not_used_in_training():
    attn = tswin.WindowAttention(16, (3, 3), 2).train()
    x = torch.randn(3, 9, 16)
    attn(x).sum().backward()
    assert attn.qkv.weight.grad is not None
    assert attn._kernel_key is None  # nothing cached in training
