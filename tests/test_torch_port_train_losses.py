"""The port's FOCAL loss (``train.losses``) against the JAX package's on the
CPU, values and gradients at identical features.

Tolerance 1e-5 relative (atol 1e-6) on values and gradients: both are f32;
the difference is the order of the sums (logsumexp, matmuls, means).
"""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.train import losses as jl
from focal_tpu_torch.params import load_dataset_config
from focal_tpu_torch.train import losses as tl
from torch_port_threads import one_torch_thread  # noqa: F401


def _feats(seed, b=8, d=32, mods=("seismic", "audio")):
    rng = np.random.default_rng(seed)
    return [{m: rng.normal(size=(b, d)).astype(np.float32) for m in mods} for _ in range(2)]


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=1e-6)


@pytest.mark.parametrize("finegrain", [False, True])
def test_info_nce(finegrain):
    rng = np.random.default_rng(0)
    e1, e2 = (rng.normal(size=(6, 4, 16)).astype(np.float32) for _ in range(2))
    want = jl.info_nce(jnp.asarray(e1), jnp.asarray(e2), 0.07, finegrain)
    got = tl.info_nce(torch.from_numpy(e1), torch.from_numpy(e2), 0.07, finegrain)
    _close(got, want)


def test_orthogonality_and_ranking():
    rng = np.random.default_rng(1)
    e1, e2 = (rng.normal(size=(3, 4, 16)).astype(np.float32) for _ in range(2))
    _close(tl.orthogonality_loss(torch.from_numpy(e1), torch.from_numpy(e2)),
           jl.orthogonality_loss(jnp.asarray(e1), jnp.asarray(e2)))
    _close(tl.temporal_ranking_loss(torch.from_numpy(e1), 1.0),
           jl.temporal_ranking_loss(jnp.asarray(e1), 1.0))


def test_split_features():
    x = torch.arange(12.0).reshape(2, 6)
    a, b = tl.split_features(x)
    assert a.tolist() == [[0, 1, 2], [6, 7, 8]] and b.tolist() == [[3, 4, 5], [9, 10, 11]]


@pytest.mark.parametrize("labels", ["int", "soft"])
def test_cross_entropy(labels):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(5, 7)).astype(np.float32)
    if labels == "int":
        y = rng.integers(0, 7, size=5).astype(np.int32)
    else:
        y = rng.dirichlet(np.ones(7), size=5).astype(np.float32)
    w = rng.random(5).astype(np.float32)
    for weight in (None, w):
        want = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(y),
                                None if weight is None else jnp.asarray(weight))
        got = tl.cross_entropy(torch.from_numpy(logits), torch.from_numpy(y),
                               None if weight is None else torch.from_numpy(weight))
        _close(got, want)


@pytest.mark.parametrize("model,tag", [("SW_Transformer", None), ("DeepSense", "noPrivate")])
def test_focal_loss_value_parts_and_gradients(model, tag):
    """The whole 4-term loss: per-model temperature (0.07 / 0.5) and the
    noPrivate tag."""
    cfg = copy.deepcopy(load_dataset_config("MOD"))
    args = SimpleNamespace(dataset_config=cfg, model=model, tag=tag)
    f1, f2 = _feats(3)
    jloss = jl.make_focal_loss(args)
    tloss = tl.make_focal_loss(args)

    (want, wparts), wgrads = jax.value_and_grad(
        lambda a, b: jloss(a, b), argnums=(0, 1), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, f1), jax.tree_util.tree_map(jnp.asarray, f2))
    t1 = {m: torch.from_numpy(a).requires_grad_(True) for m, a in f1.items()}
    t2 = {m: torch.from_numpy(a).requires_grad_(True) for m, a in f2.items()}
    got, parts = tloss(t1, t2)
    _close(got.detach(), want)
    assert set(parts) == set(wparts)
    for k in parts:
        _close(parts[k].detach(), wparts[k])
    got.backward()
    for tf, wf in ((t1, wgrads[0]), (t2, wgrads[1])):
        for m in tf:
            _close(tf[m].grad, wf[m])
