"""The port's schedules and optimizers (``train.optim``) against the JAX
package's optax chains on the CPU.

The same gradients are fed to both for three updates. Tolerance 1e-6
relative (atol 1e-9): both apply the same f32 Adam arithmetic in a
different order. Frozen parameters must not move at all. Schedules agree
to 1e-5 relative: the JAX package evaluates lr(epoch) in float32, the port
in float64.
"""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from focal_tpu.train import optim as jo
from focal_tpu_torch.params import load_dataset_config
from focal_tpu_torch.train import optim as to

CFG = load_dataset_config("MOD")


@pytest.mark.parametrize("section,name", [
    ("FOCAL", "pretrain"), ("FOCAL", "finetune"), ("DeepSense", None),
])
def test_epoch_schedule_matches_jax(section, name):
    if name:
        opt, sch = CFG[section][f"{name}_optimizer"], CFG[section][f"{name}_lr_scheduler"]
    else:
        opt, sch = CFG[section]["optimizer"], CFG[section]["lr_scheduler"]
    for warmup in (0, 3):
        sch = dict(sch, warmup_epochs=warmup, train_epochs=20, decay_epochs=4)
        want, got = jo.make_epoch_schedule(sch, opt), to.make_epoch_schedule(sch, opt)
        for e in [0, 1, 2, 3, 5, 10, 19, 20, 25]:
            np.testing.assert_allclose(got(e), float(want(e)), rtol=1e-5)


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.patch_embed_a = nn.Linear(4, 3)
        self.dense = nn.Linear(3, 5)
        self.class_layer = nn.Linear(5, 2)


def _tree(net):
    """The net as a flax-style tree (kernel [in, out])."""
    return {name: {"kernel": jnp.asarray(m.weight.detach().numpy().T),
                   "bias": jnp.asarray(m.bias.detach().numpy())}
            for name, m in net.named_children()}


def _to_tree(grads_by_name):
    tree = {}
    for name, g in grads_by_name.items():
        mod, leaf = name.split(".")
        tree.setdefault(mod, {})["kernel" if leaf == "weight" else "bias"] = jnp.asarray(
            g.T if leaf == "weight" else g)
    return tree


def _pretrain_args(optimizer="AdamW", clip=False):
    """A FOCAL pretrain run whose recipe has a 4-epoch schedule and the
    given optimizer (MOD's pretrain recipe names AdamW)."""
    cfg = copy.deepcopy(CFG)
    cfg["FOCAL"]["pretrain_optimizer"]["name"] = optimizer
    cfg["FOCAL"]["pretrain_lr_scheduler"]["train_epochs"] = 4
    return SimpleNamespace(dataset_config=cfg, train_mode="contrastive", learn_framework="FOCAL",
                           stage="pretrain", model="SW_Transformer", clip_grad=clip)


@pytest.mark.parametrize("optimizer,clip", [("AdamW", False), ("Adam", False), ("AdamW", True)])
def test_updates_match_optax(optimizer, clip):
    """AdamW: decoupled decay; Adam: L2 in the gradient; clip: global-norm
    clipping of large gradients. patch_embed is frozen in each."""
    args = _pretrain_args(optimizer, clip)
    torch.manual_seed(0)
    net = _Net()
    params = _tree(net)
    tx, _ = jo.build_optimizer(args, params, steps_per_epoch=2)
    opt_state = tx.init(params)
    sopt, _ = to.build_optimizer(args, net, steps_per_epoch=2)

    rng = np.random.default_rng(1)
    scale = 100.0 if clip else 1.0
    for k in range(3):
        grads = {n: (rng.normal(size=tuple(p.shape)) * scale).astype(np.float32)
                 for n, p in net.named_parameters()}
        upd, opt_state = tx.update(_to_tree(grads), opt_state, params)
        params = optax.apply_updates(params, upd)
        sopt.zero_grad()
        for n, p in net.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(grads[n])
        sopt.step(k)
    want = _tree_flat(params)
    mask = to.trainable_mask(net)
    for n, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-6, atol=1e-9, err_msg=n)
        assert p.requires_grad == mask[n]
    assert [n for n, m in mask.items() if not m] == ["patch_embed_a.weight", "patch_embed_a.bias"]


def _tree_flat(tree):
    out = {}
    for mod, leaves in tree.items():
        out[f"{mod}.weight"] = np.asarray(leaves["kernel"]).T
        out[f"{mod}.bias"] = np.asarray(leaves["bias"])
    return out


def test_lr_of_update_k_is_its_epochs():
    sopt, lr_epoch = to.build_optimizer(_pretrain_args(), _Net(), steps_per_epoch=3)
    assert [sopt.lr(k) for k in (0, 2, 3, 8, 9)] == [lr_epoch(0), lr_epoch(0), lr_epoch(1),
                                                    lr_epoch(2), lr_epoch(3)]
