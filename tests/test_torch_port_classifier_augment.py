"""The port's supervised augmentation (``ops.augment``: ``fixed``,
``mixup_batch``, jitter, channel_shuffle, time_mask, freq_mask, the ctx
table) against the JAX package's on the CPU.

Each augmenter is fed the very values the JAX one drew from its key,
re-derived here by the JAX package's own key splits, and must agree
exactly (permutations, masks, cutmix boxes) or to 1e-6 (jitter's sum, the
mixup blend and the soft targets, f32 rounding). The pipeline's order
(time augmenters in order, the FFT, freq augmenters) is recorded; its
targets are the hard labels unless -mixup_labels. The port draws from
another generator, so the gates and draws are held by distribution (5
binomial standard deviations, or moments of 2,000 draws).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.ops import augment as jaug
from focal_tpu_torch.ops import augment as taug
from focal_tpu_torch.ops.fft import fft_mod, fft_preprocess, ifft_mod
from focal_tpu_torch.params import load_dataset_config

CFG = load_dataset_config("MOD_TINY")
TASK = "vehicle_classification"


def _x(seed=0, shape=(6, 2, 10, 20)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _inputs(seed=0, b=6):
    sl = CFG["loc_mod_spectrum_len"]["shake"]
    return {"shake": {m: _x(seed + i, (b, 1, CFG["num_segments"], sl[m]))
                      for i, m in enumerate(CFG["modality_names"])}}


def _torch(tree):
    return {loc: {m: torch.from_numpy(a) for m, a in mods.items()} for loc, mods in tree.items()}


def _jax(tree):
    return {loc: {m: jnp.asarray(a) for m, a in mods.items()} for loc, mods in tree.items()}


def _kaug(key):
    return jax.random.split(key)[1]  # _gated: (kgate, kaug)


def _jax_args(dataset, cfg, model="SW_Transformer", mixup_labels=False):
    return SimpleNamespace(dataset_config=cfg, dataset=dataset, task=TASK, model=model,
                           learn_framework="no", train_mode="supervised", stage="pretrain",
                           mixup_labels=mixup_labels)


def _jax_draws(key, inputs, labels, cfg):
    """The values the JAX mixup_batch draws from ``key``, as draw_mixup's dict."""
    k_apply, k_switch, k_lam_mix, k_lam_cut, k_perm, k_bbox = jax.random.split(key, 6)
    b = labels.shape[0]
    d = {"apply": bool(jax.random.uniform(k_apply) < cfg["prob"]),
         "cutmix": bool(jax.random.uniform(k_switch) < cfg["switch_prob"])
         and cfg.get("cutmix_alpha", 0) > 0,
         "lam_mix": float(jax.random.beta(k_lam_mix, cfg["mixup_alpha"], cfg["mixup_alpha"])),
         "lam_cut": float(jax.random.beta(k_lam_cut, cfg["cutmix_alpha"], cfg["cutmix_alpha"]))}
    d["rand_index"] = (torch.arange(b - 1, -1, -1) if cfg.get("mode") == "batch" else
                       torch.from_numpy(np.array(jax.random.permutation(k_perm, b))))
    d["centers"] = {}
    for li, (loc, mods) in enumerate(inputs.items()):
        for mi, (mod, x) in enumerate(mods.items()):
            ky, kx = jax.random.split(jax.random.fold_in(k_bbox, li * 131 + mi))
            d["centers"][(loc, mod)] = (int(jax.random.randint(ky, (), 0, x.shape[2])),
                                        int(jax.random.randint(kx, (), 0, x.shape[3])))
    return d


@pytest.mark.parametrize("mode,switch,smoothing,seed", [
    ("random_batch", 0.0, 0.0, 0), ("random_batch", 1.0, 0.0, 1), ("batch", 0.0, 0.1, 2),
    ("batch", 1.0, 0.1, 3), ("random_batch", 1.0, 0.1, 4),
])
def test_mixup_batch_matches_jax_given_its_draws(mode, switch, smoothing, seed):
    cfg = dict(CFG["mixup"], mode=mode, switch_prob=switch, label_smoothing=smoothing)
    inputs = _inputs(seed)
    labels = np.random.default_rng(seed).integers(0, 7, size=6).astype(np.int32)
    key = jax.random.key(seed)
    want_x, want_soft = jaug.mixup_batch(key, _jax(inputs), jnp.asarray(labels), cfg, 7)
    d = _jax_draws(key, inputs, labels, cfg)
    assert d["cutmix"] == (switch == 1.0)
    got_x, got_soft = taug.mixup_batch(_torch(inputs), torch.from_numpy(labels), d, cfg, 7)
    for m in CFG["modality_names"]:
        np.testing.assert_allclose(got_x["shake"][m].numpy(), np.asarray(want_x["shake"][m]),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_soft.numpy(), np.asarray(want_soft), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_soft.sum(-1).numpy(), 1.0, atol=1e-6)
    if smoothing:
        assert float(got_soft.min()) >= smoothing / 7 - 1e-7


def test_mixup_not_applied_keeps_inputs_and_one_hot_targets():
    inputs = _inputs(5)
    labels = torch.tensor([0, 1, 2, 3, 4, 5])
    d = taug.draw_mixup(torch.Generator().manual_seed(0), 6,
                        {("shake", m): a.shape for m, a in inputs["shake"].items()},
                        dict(CFG["mixup"], prob=0.0))
    assert not d["apply"] and taug.mixup_lambda(d) == 1.0
    out, soft = taug.mixup_batch(_torch(inputs), labels, d, CFG["mixup"], 7)
    for m, a in inputs["shake"].items():
        assert np.array_equal(out["shake"][m].numpy(), a)
    assert torch.equal(soft, torch.nn.functional.one_hot(labels, 7).float())


def _jax_aug(name, x, key, ctx):
    fn = dict(jaug.TIME_AUGMENTERS, **jaug.FREQ_AUGMENTERS)[name]
    return np.asarray(fn(key, jnp.asarray(x), dict(CFG.get(name, {}), prob=1.0), ctx))


def _ctx(dataset="MOD"):
    return taug.Augmenter(CFG, None, dataset=dataset).ctx[("shake", "seismic")]


def test_jitter_matches_jax_given_its_noise():
    x, key, ctx = _x(1), jax.random.key(3), _ctx()
    noise = np.float32(ctx["jitter_std"]) * np.asarray(
        jax.random.normal(_kaug(key), x.shape, dtype=jnp.float32))
    got = taug.aug_jitter(torch.from_numpy(x), torch.from_numpy(noise), {})
    np.testing.assert_allclose(got.numpy(), _jax_aug("jitter", x, key, ctx), rtol=1e-6, atol=1e-6)


def test_channel_shuffle_matches_jax_given_its_permutation():
    x, key = _x(2, (3, 4, 10, 20)), jax.random.key(4)
    perm = np.array(jax.random.permutation(_kaug(key), x.shape[1]))
    got = taug.aug_channel_shuffle(torch.from_numpy(x), torch.from_numpy(perm), {})
    np.testing.assert_array_equal(got.numpy(), _jax_aug("channel_shuffle", x, key, {}))


@pytest.mark.parametrize("name,seed", [("time_mask", 5), ("time_mask", 6), ("freq_mask", 7),
                                       ("freq_mask", 8)])
def test_masks_match_jax_given_their_bounds(name, seed):
    x, key, ctx = _x(seed), jax.random.key(seed), _ctx()
    k_len, k_start = jax.random.split(_kaug(key))
    axis, top = (2, ctx["time_mask_max"]) if name == "time_mask" else (3, ctx["freq_mask_max"])
    width = int(jax.random.randint(k_len, (), 1, top + 1))
    start = int(jax.random.randint(k_start, (), 0, x.shape[axis] - width + 1))
    _, apply = (taug.TIME_AUGMENTERS if name == "time_mask" else taug.FREQ_AUGMENTERS)[name]
    got = apply(torch.from_numpy(x), (start, width), CFG[name]).numpy()
    np.testing.assert_array_equal(got, _jax_aug(name, x, key, ctx))
    zeroed = np.moveaxis(got == 0, axis, 0).all(axis=tuple(range(1, 4)))
    assert zeroed.sum() == width


@pytest.mark.parametrize("dataset,cfg_name", [("MOD", "MOD"), ("MOD_TINY", "MOD_TINY")])
def test_ctx_table_equals_jax(dataset, cfg_name):
    cfg = load_dataset_config(cfg_name)
    want = jaug.Augmenter(_jax_args(dataset, cfg)).ctx
    got = taug.Augmenter(cfg, cfg["SW_Transformer"]["fixed_augmenters"], dataset=dataset,
                         task=TASK).ctx
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_fixed_applies_time_augmenters_in_order_then_fft_then_freq(monkeypatch):
    calls = []

    def recorder(name, fn):
        def apply(x, values, cfg):
            calls.append(name)
            return fn(x, values, cfg)
        return apply

    for table, name in ((taug.TIME_AUGMENTERS, "negation"), (taug.TIME_AUGMENTERS, "horizontal_flip"),
                        (taug.FREQ_AUGMENTERS, "phase_shift")):
        draw, fn = table[name]
        monkeypatch.setitem(table, name, (draw, recorder(name, fn)))
    real_fft = taug.fft_preprocess
    monkeypatch.setattr(taug, "fft_preprocess", lambda x: calls.append("fft") or real_fft(x))
    cfg = dict(CFG, negation={"prob": 1.0}, horizontal_flip={"prob": 1.0}, phase_shift={"prob": 1.0})
    pool = {"time_augmenters": ["horizontal_flip", "mixup", "negation"],
            "freq_augmenters": ["phase_shift"]}
    aug = taug.Augmenter(cfg, pool, dataset="MOD_TINY", task=TASK)
    labels = torch.arange(6) % 7
    x, targets = aug.fixed(torch.Generator().manual_seed(0), _torch(_inputs(9)), labels)
    assert calls == ["horizontal_flip"] * 2 + ["negation"] * 2 + ["fft"] + ["phase_shift"] * 2
    assert targets is labels  # mixup's soft targets are dropped without -mixup_labels
    soft_aug = taug.Augmenter(cfg, pool, dataset="MOD_TINY", task=TASK, mixup_labels=True)
    _, soft = soft_aug.fixed(torch.Generator().manual_seed(0), _torch(_inputs(9)), labels)
    assert soft.shape == (6, 7) and torch.allclose(soft.sum(-1), torch.ones(6))


def test_fixed_without_random_augmenters_matches_jax():
    """A pool whose augmenters draw nothing (gates at 1): the two pipelines
    give the same frequency inputs and the hard labels."""
    cfg = dict(CFG, negation={"prob": 1.0}, horizontal_flip={"prob": 1.0})
    pool = {"time_augmenters": ["negation", "horizontal_flip"], "freq_augmenters": ["no"]}
    jcfg = dict(cfg, SW_Transformer=dict(cfg["SW_Transformer"], fixed_augmenters=pool))
    inputs, labels = _inputs(10), np.arange(6, dtype=np.int32)
    want_x, want_y = jaug.Augmenter(_jax_args("MOD_TINY", jcfg)).fixed(
        jax.random.key(0), _jax(inputs), jnp.asarray(labels))
    got_x, got_y = taug.Augmenter(cfg, pool, dataset="MOD_TINY", task=TASK).fixed(
        torch.Generator().manual_seed(0), _torch(inputs), torch.from_numpy(labels))
    for m in CFG["modality_names"]:
        np.testing.assert_allclose(got_x["shake"][m].numpy(), np.asarray(want_x["shake"][m]),
                                   rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))


def test_gates_and_mixup_draws_have_the_jax_distributions():
    n = 2000
    g = torch.Generator().manual_seed(0)
    cfg = dict(CFG["mixup"], prob=0.7, switch_prob=0.75)
    shapes = {("shake", "seismic"): (6, 1, 10, 20)}
    draws = [taug.draw_mixup(g, 6, shapes, cfg) for _ in range(n)]
    applied = np.mean([d["apply"] for d in draws])
    cut = np.mean([d["cutmix"] for d in draws])
    assert abs(applied - 0.7) <= 5 * (0.21 / n) ** 0.5
    assert abs(cut - 0.75) <= 5 * (0.1875 / n) ** 0.5
    lam = np.array([d["lam_mix"] for d in draws])  # Beta(1, 1): uniform
    assert abs(lam.mean() - 0.5) <= 5 * (1 / 12 / n) ** 0.5 and lam.min() >= 0 and lam.max() <= 1
    cy = np.array([d["centers"][("shake", "seismic")][0] for d in draws])
    assert cy.min() == 0 and cy.max() == 9
    aug = taug.Augmenter(dict(CFG, negation={"prob": 0.5}),
                         {"time_augmenters": ["negation"], "freq_augmenters": ["no"]},
                         dataset="MOD_TINY", task=TASK)
    x = _torch(_inputs(11))
    base = fft_preprocess(x)
    changed = sum(not torch.equal(aug.fixed(g, x, torch.zeros(6))[0]["shake"]["seismic"],
                                  base["shake"]["seismic"]) for _ in range(400))
    assert abs(changed / 400 - 0.5) <= 5 * (0.25 / 400) ** 0.5
    ctx = _ctx()
    tm = [taug.draw_time_mask(g, (2, 1, 10, 20), {}, ctx)[1] for _ in range(500)]
    assert min(tm) == 1 and max(tm) == ctx["time_mask_max"]


def test_ifft_mod_inverts_fft_mod():
    x = torch.from_numpy(_x(12, (2, 3, 4, 20)))
    torch.testing.assert_close(ifft_mod(fft_mod(x)), x, rtol=1e-5, atol=1e-5)
