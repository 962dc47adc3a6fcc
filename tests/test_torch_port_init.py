"""The port's seeded init draws flax's truncated normal, not a clipped one.

flax's ``lecun_normal`` is a normal of std fan_in**-0.5 / 0.8796 truncated
(resampled) at 2 std, so its values have std fan_in**-0.5 and none sits on
the bound; ``truncated_normal(0.02)`` truncates N(0, 0.02^2) at 2 std. A
clip instead piles ~4.5 % of the values onto the bounds and leaves the std
~9 % high. Tolerance: std within 2 % of flax's over a Linear(256, 1024)
(262,144 values: the sampling error of the std is ~0.14 %) and over a
bias table (64,000 values, ~0.3 %).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn as nn

from focal_tpu_torch.models.sw_transformer import init_params


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(256, 1024)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(16000, 4))


def test_lecun_weights_are_truncated_not_clipped():
    m = init_params(_Tiny(), seed=0)
    w = m.fc.weight.detach().numpy().astype(np.float64)
    s = 256**-0.5 / 0.87962566
    ref = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.key(0), (256, 1024)), np.float64)
    assert np.abs(w).max() <= 2 * s * (1 + 1e-6)
    assert np.isclose(np.abs(w), 2 * s, rtol=1e-6).sum() == 0  # nothing on the bound
    assert abs(w.std() / ref.std() - 1) < 0.02
    assert abs(w.std() / 256**-0.5 - 1) < 0.02
    assert np.all(m.fc.bias.detach().numpy() == 0)


def test_bias_table_is_truncated_normal_002():
    m = init_params(_Tiny(), seed=1)
    t = m.relative_position_bias_table.detach().numpy().astype(np.float64)
    ref = np.asarray(jax.nn.initializers.truncated_normal(0.02)(
        jax.random.key(1), (16000, 4), jnp.float32), np.float64)
    assert np.abs(t).max() <= 0.04 * (1 + 1e-6)
    assert np.isclose(np.abs(t), 0.04, rtol=1e-6).sum() == 0
    assert abs(t.std() / ref.std() - 1) < 0.02


def test_init_is_seeded():
    a = init_params(_Tiny(), seed=3).fc.weight
    b = init_params(_Tiny(), seed=3).fc.weight
    c = init_params(_Tiny(), seed=4).fc.weight
    assert torch.equal(a, b) and not torch.equal(a, c)
