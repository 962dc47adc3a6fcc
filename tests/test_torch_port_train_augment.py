"""The port's pretrain augmenters (``ops.augment``) against the JAX
package's on the CPU.

Deterministic augmenters are fed the very values the JAX augmenter drew
from its key (permutation, scale, angle, curve knots), re-derived here by
the JAX package's own key splits, and must agree to f32 rounding: 1e-6
relative for permutation, negation, flip, scaling and phase_shift (exact
for the first three), 1e-5 for mag_warp's interpolated curve, and 1e-3
absolute for time_warp, which samples the signal at positions from an f32
cumulative sum over the 960 time points: the two frameworks associate
that sum differently, which moves a position by up to ~3e-4 samples, and
the unit-variance test signal changes by about 1 per sample. The gates, the augmenter choice and the draws themselves come from
a different generator in the port, so they are held by distribution
(5 binomial standard deviations, or moments of 2,000 draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.ops import augment as jaug
from focal_tpu_torch.ops import augment as taug
from focal_tpu_torch.ops.fft import fft_preprocess
from focal_tpu_torch.params import load_dataset_config
from torch_port_threads import one_torch_thread  # noqa: F401

CFG = load_dataset_config("MOD_TINY")


def _x(seed=0, shape=(3, 1, 10, 96)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_aug(name, x, key):
    """The JAX augmenter with its gate forced open (prob 1)."""
    fn = dict(jaug.TIME_AUGMENTERS, **jaug.FREQ_AUGMENTERS)[name]
    cfg = dict(CFG.get(name, {}), prob=1.0)
    return np.asarray(fn(key, jnp.asarray(x), cfg, {}))


def _jax_draw_key(key):
    return jax.random.split(key)[1]  # _gated: (kgate, kaug)


def test_permutation_matches_jax_given_its_draw():
    x, key = _x(1), jax.random.key(3)
    perm = np.array(jax.random.permutation(_jax_draw_key(key), x.shape[2]))
    got = taug.aug_permutation(torch.from_numpy(x), torch.from_numpy(perm), CFG["permutation"])
    np.testing.assert_array_equal(got.numpy(), _jax_aug("permutation", x, key))


@pytest.mark.parametrize("name", ["negation", "horizontal_flip"])
def test_drawless_augmenters_match_jax(name):
    x, key = _x(2), jax.random.key(4)
    _, apply = taug.TIME_AUGMENTERS[name]
    got = apply(torch.from_numpy(x), None, CFG[name])
    np.testing.assert_array_equal(got.numpy(), _jax_aug(name, x, key))


def test_scaling_matches_jax_given_its_draw():
    x, key = _x(3), jax.random.key(5)
    z = float(jax.random.normal(_jax_draw_key(key)))
    got = taug.aug_scaling(torch.from_numpy(x), z, CFG["scaling"])
    np.testing.assert_allclose(got.numpy(), _jax_aug("scaling", x, key), rtol=1e-6, atol=1e-6)


def test_phase_shift_matches_jax_given_its_draw():
    x, key = _x(4, (3, 2, 10, 96)), jax.random.key(6)
    u = float(jax.random.uniform(_jax_draw_key(key)))
    theta = (u - 0.5) * 2.0 * np.pi
    got = taug.aug_phase_shift(torch.from_numpy(x), theta, CFG["phase_shift"])
    np.testing.assert_allclose(got.numpy(), _jax_aug("phase_shift", x, key), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["time_warp", "mag_warp"])
def test_curve_augmenters_match_jax_given_the_knots(name):
    x, key = _x(5), jax.random.key(7)
    cfg = CFG[name]
    n_knots = 3 * (max(cfg["order"], 2) - 1) + 1
    knots = 1.0 + cfg["magnitude"] * np.asarray(
        jax.random.normal(_jax_draw_key(key), (n_knots,)), np.float32)
    _, apply = taug.TIME_AUGMENTERS[name]
    got = apply(torch.from_numpy(x), torch.from_numpy(knots), cfg)
    tol = 1e-3 if name == "time_warp" else 1e-5
    np.testing.assert_allclose(got.numpy(), _jax_aug(name, x, key), rtol=0, atol=tol)


def test_random_curve_matches_jnp_interp():
    knots = np.random.default_rng(0).normal(size=13).astype(np.float32)
    got = taug._random_curve(torch.from_numpy(knots), 500).numpy()
    want = np.interp(np.arange(500), np.linspace(0, 499, 13), knots)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_draws_have_the_jax_distributions():
    g = torch.Generator().manual_seed(0)
    n = 2000
    tw = CFG["time_warp"]
    knots = torch.stack([taug.draw_knots(g, None, tw) for _ in range(n // 10)])
    assert knots.shape[1] == 3 * (tw["order"] - 1) + 1
    assert abs(float(knots.mean()) - 1.0) < 5 * tw["magnitude"] / knots.numel() ** 0.5
    assert abs(float(knots.std()) / tw["magnitude"] - 1) < 0.05
    z = np.array([taug.draw_scaling(g, None, CFG["scaling"]) for _ in range(n)])
    assert abs(z.mean()) < 5 / n**0.5 and abs(z.std() - 1) < 0.05
    th = np.array([taug.draw_phase_shift(g, None, {}) for _ in range(n)])
    assert th.min() > -np.pi and th.max() < np.pi and abs(th.mean()) < 5 * np.pi / (3 * n) ** 0.5
    perm = taug.draw_permutation(g, (1, 1, 10, 5), {})
    assert sorted(perm.tolist()) == list(range(10))


def _aug(pool):
    return taug.Augmenter(CFG, pool)


def test_random_picks_one_augmenter_uniformly_and_gates_per_mod():
    """Over many views: each pool member is chosen ~1/7 of the time, and a
    chosen augmenter touches each (loc, mod) with its prob, independently."""
    pool = CFG["FOCAL"]["random_augmenters"]
    aug = _aug(pool)
    x = {"shake": {m: torch.from_numpy(_x(6, (2, 1, 10, CFG["loc_mod_spectrum_len"]["shake"][m])))
                   for m in CFG["modality_names"]}}
    base = fft_preprocess(x)
    g = torch.Generator().manual_seed(1)
    n = 700
    changed = {m: 0 for m in CFG["modality_names"]}
    both = 0
    for _ in range(n):
        out = aug.random(g, x)
        diff = {m: not torch.equal(out["shake"][m], base["shake"][m]) for m in changed}
        for m in changed:
            changed[m] += diff[m]
        both += all(diff.values())
    # every pool member except none changes its input when applied; gate p = 0.5
    p_change = 0.5
    for m, c in changed.items():
        assert abs(c / n - p_change) <= 5 * (p_change * (1 - p_change) / n) ** 0.5, (m, c)
    assert abs(both / n - p_change**2) <= 5 * (p_change**2 * (1 - p_change**2) / n) ** 0.5


def test_random_choice_is_uniform_over_the_pool():
    pool = CFG["FOCAL"]["random_augmenters"]
    k = len(pool["time_augmenters"]) + len(pool["freq_augmenters"])
    g = torch.Generator().manual_seed(2)
    ids = np.array([int(torch.randint(0, k, (), generator=g)) for _ in range(7000)])
    counts = np.bincount(ids, minlength=k)
    assert np.all(np.abs(counts / 7000 - 1 / k) <= 5 * ((1 / k) * (1 - 1 / k) / 7000) ** 0.5)


def test_no_pool_is_the_fft_and_waiting_augmenters_raise():
    """The pool ["no"] is the FFT alone; the augmenters that once waited for
    the supervised stage (jitter, channel_shuffle, time_mask, freq_mask,
    mixup) now build."""
    aug = _aug({"time_augmenters": ["no"], "freq_augmenters": ["no"]})
    x = {"shake": {"seismic": torch.from_numpy(_x(7, (2, 1, 10, 20)))}}
    out = aug.random(torch.Generator().manual_seed(0), x)
    torch.testing.assert_close(out["shake"]["seismic"], fft_preprocess(x)["shake"]["seismic"],
                               rtol=0, atol=0)
    built = _aug({"time_augmenters": ["jitter", "channel_shuffle", "time_mask", "mixup"],
                  "freq_augmenters": ["freq_mask"]})
    assert built.time_aug_names == ["jitter", "channel_shuffle", "time_mask", "mixup"]


def test_unknown_augmenter_and_unported_stages_raise():
    """An unknown name raises; each stage gets the JAX package's pool: the
    random pool for pretraining, the backbone's fixed pool otherwise, and
    mixup is refused in a random pool."""
    from types import SimpleNamespace

    with pytest.raises(ValueError, match="Invalid augmenter"):
        _aug({"time_augmenters": ["phase_shift"], "freq_augmenters": ["no"]})
    for mode, stage, want in (("contrastive", "finetune", CFG["SW_Transformer"]["fixed_augmenters"]),
                              ("supervised", "pretrain", CFG["SW_Transformer"]["fixed_augmenters"]),
                              ("contrastive", "pretrain", CFG["FOCAL"]["random_augmenters"])):
        args = SimpleNamespace(dataset_config=CFG, train_mode=mode, stage=stage, dataset="MOD_TINY",
                               learn_framework="FOCAL", model="SW_Transformer",
                               task="vehicle_classification")
        aug = taug.build_augmenter(args)
        assert aug.time_aug_names == list(want["time_augmenters"])
        assert aug.freq_aug_names == list(want["freq_augmenters"])
    cfg = dict(CFG, FOCAL=dict(CFG["FOCAL"], random_augmenters={
        "time_augmenters": ["mixup"], "freq_augmenters": ["no"]}))
    args = SimpleNamespace(dataset_config=cfg, train_mode="contrastive", stage="pretrain",
                           dataset="MOD_TINY", learn_framework="FOCAL", model="SW_Transformer",
                           task="vehicle_classification")
    with pytest.raises(ValueError, match="mixup"):
        taug.build_augmenter(args)
