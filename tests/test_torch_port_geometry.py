"""Static geometry, data and FFT of the port against the JAX package.

Pure numpy-scale checks, cheap at full width: padded sizes, patch grids,
the window-shrink rule, relative position indices, shift masks and per-block
window counts at MOD and MOD_TINY must equal focal_tpu's exactly. The JAX
side's per-block geometry is recorded from an abstract (eval_shape) init of
its SW_Transformer, so no full-width arrays are computed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import focal_tpu.models.swin as jswin
from focal_tpu.data.synthetic import synthetic_arrays as jax_synthetic_arrays
from focal_tpu.models.sw_transformer import SWTransformer as JaxSWTransformer
from focal_tpu.models.sw_transformer import get_padded_size as jax_get_padded_size
from focal_tpu.ops.fft import fft_mod as jax_fft_mod
from focal_tpu.params.yaml_utils import load_dataset_config as jax_load_config
from focal_tpu_torch.data import synthetic_arrays
from focal_tpu_torch.models import build_backbone
from focal_tpu_torch.models import swin as tswin
from focal_tpu_torch.models.sw_transformer import get_padded_size, mod_geometry
from focal_tpu_torch.ops.fft import fft_mod
from focal_tpu_torch.params import load_dataset_config

TASK = "vehicle_classification"


def _jax_block_geometry(cfg, monkeypatch):
    """[(H, W, wh, ww, shift args or None, nW)] for every Swin block, in call
    order, from an abstract init of the JAX model."""
    calls, masks = [], []
    orig_part, orig_mask = jswin.window_partition, jswin.shifted_window_mask

    def part(x, wh, ww):
        B, H, W, _ = x.shape
        calls.append((H, W, wh, ww, (H // wh) * (W // ww)))
        return orig_part(x, wh, ww)

    def mask(*a):
        masks.append((len(calls), a))
        return orig_mask(*a)

    monkeypatch.setattr(jswin, "window_partition", part)
    monkeypatch.setattr(jswin, "shifted_window_mask", mask)
    model = JaxSWTransformer(dataset_config=cfg, task=TASK)
    loc = cfg["location_names"][0]
    x = {loc: {}}
    for mod in cfg["modality_names"]:
        c = 2 * cfg["loc_mod_in_time_channels"][loc][mod]
        x[loc][mod] = jax.ShapeDtypeStruct((2, c, cfg["num_segments"],
                                            cfg["loc_mod_spectrum_len"][loc][mod]), jnp.float32)
    jax.eval_shape(lambda xx: model.init(jax.random.key(0), xx, train=False, head="both"), x)
    # the mask for block k is built before block k's partition
    by_block = {k: a for k, a in masks}
    return [c + (by_block.get(i),) for i, c in enumerate(calls)]


@pytest.mark.parametrize("dataset", ["MOD", "MOD_TINY"])
def test_model_geometry_matches_jax(dataset, monkeypatch):
    cfg = load_dataset_config(dataset)
    assert cfg == jax_load_config(dataset)  # the port's own copy of the recipe
    jax_blocks = _jax_block_geometry(cfg, monkeypatch)

    model = build_backbone(cfg, "SW_Transformer", TASK)
    loc = cfg["location_names"][0]
    port_blocks = []
    for mod in cfg["modality_names"]:
        geo = mod_geometry(cfg, loc, mod)
        c = cfg["SW_Transformer"]
        img = (cfg["num_segments"], cfg["loc_mod_spectrum_len"][loc][mod] // c["in_stride"][mod])
        assert geo["padded"] == jax_get_padded_size(
            img, c["window_size"][mod], c["patch_size"]["freq"][mod], len(c["time_freq_block_num"][mod]))
        for stage in model.stages(loc, mod):
            for blk in stage.blocks():
                H, W = blk.input_resolution
                nW = (H // blk.wh) * (W // blk.ww)
                shift = (H, W, blk.wh, blk.ww, blk.sh, blk.sw) if blk.shifted else None
                port_blocks.append((H, W, blk.wh, blk.ww, nW, shift))
                if blk.shifted:
                    assert blk.attn_mask.shape[0] == nW
                    np.testing.assert_array_equal(
                        blk.attn_mask.numpy(), jswin.shifted_window_mask(*shift))
                idx = blk.attn.relative_position_index.numpy().reshape(blk.wh * blk.ww, -1)
                np.testing.assert_array_equal(idx, jswin.relative_position_index(blk.wh, blk.ww))
    assert port_blocks == jax_blocks


def test_mod_stage_table():
    """The MOD geometry the kernel serves: audio 12x48 patches, seismic
    12x24, window counts per stage, and no shift mask at the last stage."""
    cfg = load_dataset_config("MOD")
    audio = mod_geometry(cfg, "shake", "audio")
    seismic = mod_geometry(cfg, "shake", "seismic")
    assert audio["padded"] == (12, 1920) and audio["patches_res"] == (12, 48)
    assert seismic["padded"] == (12, 24) and seismic["patches_res"] == (12, 24)
    assert [s for s in audio["stages"]] == [((12, 48), 64), ((6, 24), 128), ((3, 12), 256)]
    assert [r for r, _ in seismic["stages"]] == [(12, 24), (6, 12), (3, 6)]
    assert tswin.block_geometry((3, 12), (3, 3), (1, 1))[4] is False
    assert tswin.block_geometry((6, 24), (3, 3), (1, 1))[4] is True


@pytest.mark.parametrize("wh,ww", [(3, 3), (2, 3), (3, 1), (4, 4)])
def test_relative_position_index(wh, ww):
    np.testing.assert_array_equal(tswin.relative_position_index(wh, ww),
                                  jswin.relative_position_index(wh, ww))


@pytest.mark.parametrize("args", [(6, 6, 3, 3, 1, 1), (12, 48, 3, 3, 1, 1), (6, 12, 3, 3, 1, 1)])
def test_shifted_window_mask(args):
    np.testing.assert_array_equal(tswin.shifted_window_mask(*args), jswin.shifted_window_mask(*args))


@pytest.mark.parametrize("dataset", ["MOD", "MOD_TINY"])
def test_synthetic_arrays_identical(dataset):
    cfg = load_dataset_config(dataset)
    d1, l1, n1 = synthetic_arrays(cfg, TASK, 12, seed=7)
    d2, l2, n2 = jax_synthetic_arrays(cfg, TASK, 12, seed=7)
    np.testing.assert_array_equal(l1, l2)
    assert n1 == n2
    for loc in d2:
        for mod in d2[loc]:
            np.testing.assert_array_equal(d1[loc][mod], d2[loc][mod])


@pytest.mark.parametrize("s", [20, 1600, 15])
def test_fft_matches_jax(s):
    """Interleaved re/im spectrum, f32; 1e-5 relative to the spectrum's scale
    (the FFT libraries sum in different orders)."""
    x = np.random.default_rng(s).normal(size=(3, 2, 10, s)).astype(np.float32)
    ours = fft_mod(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_fft_mod(jnp.asarray(x)))
    assert ours.shape == ref.shape == (3, 4, 10, s)
    np.testing.assert_allclose(ours, ref, atol=1e-5 * np.abs(ref).max())
