"""Training steps (port of the JAX package's ``train/steps.py``).

A step gathers its batch from data already resident on the device (``idx``
selects the rows, as the JAX package's jitted steps do), augments it (two
random views for pretraining; the fixed pool or none for the classifier
stages), runs the model, the loss and the update, and returns its metrics
as device tensors: nothing in the step waits for the device.
"""

import torch

from focal_tpu_torch.train.losses import cross_entropy


def gather_batch(data, idx):
    """{loc: {mod: [N, ...]}} -> the rows idx, on the data's device."""
    return {loc: {m: a.index_select(0, idx) for m, a in mods.items()} for loc, mods in data.items()}


def make_pretrain_step(model, augmenter, focal_loss, fused_views=True):
    """FOCAL pretraining: two random views -> projector features -> loss ->
    update. Returns step(state, data, idx, aug_ids=None) -> (state, metrics)
    with metrics {"loss", "shared", "private", "orthogonality", "ranking"};
    the state is updated in place and the gradients of the update stay in
    ``.grad``. ``aug_ids`` (-py_aug_draws) forces each view's augmenter.
    Any number of rows is a step: the epoch's ragged tail (-ragged_tail)
    runs through the same function.

    fused_views runs both views through the backbone as ONE [2B] batch (the
    JAX package's default); otherwise as two forwards. A backbone with
    BatchNorm (DeepSense) updates its running statistics in each training
    forward, as the JAX step carries ``batch_stats``: once from the [2B]
    batch, or view 1's update and then view 2's."""

    def step(state, data, idx, aug_ids=None):
        rngs = state.generators()
        batch = gather_batch(data, idx)
        a1, a2 = (None, None) if aug_ids is None else aug_ids
        view1 = augmenter.random(rngs.host, batch, force_aug_id=a1)
        view2 = augmenter.random(rngs.host, batch, force_aug_id=a2)
        model.train()
        if fused_views:
            b = idx.shape[0]
            both = {
                loc: {m: torch.cat([a, view2[loc][m]], dim=0) for m, a in mods.items()}
                for loc, mods in view1.items()
            }
            feats = model(both, head="proj", rng=rngs)
            f1 = {m: v[:b] for m, v in feats.items()}
            f2 = {m: v[b:] for m, v in feats.items()}
        else:
            f1 = model(view1, head="proj", rng=rngs)
            f2 = model(view2, head="proj", rng=rngs)
        loss, parts = focal_loss(f1, f2)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step(state.step)
        state.step += 1
        return state, {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}

    return step


def make_supervised_train_step(model, augmenter, fixed_aug=True):
    """A classifier step, supervised (``fixed_aug``: the fixed augmenter
    pool) or finetune (augmenter ``no``), as the JAX package's
    ``make_supervised_train_step`` and classifier epoch: augment -> the
    class head -> cross-entropy (hard labels, or mixup's soft targets) ->
    update. Returns step(state, data, labels, idx) -> (state, metrics) with
    metrics {"loss", "acc"} as device tensors; ``labels`` are the split's
    device labels. A backbone with BatchNorm updates its running statistics
    in the training forward, frozen or not, as the JAX step carries
    ``batch_stats``."""

    def step(state, data, labels, idx):
        rngs = state.generators()
        batch = gather_batch(data, idx)
        batch_labels = labels.index_select(0, idx)
        if fixed_aug:
            freq_x, targets = augmenter.fixed(rngs.host, batch, batch_labels)
        else:
            freq_x, targets = augmenter.no(batch), batch_labels
        model.train()
        logits = model(freq_x, head="class", rng=rngs)
        loss = cross_entropy(logits, targets)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step(state.step)
        state.step += 1
        hard = targets.argmax(-1) if targets.dim() > 1 else targets
        acc = (logits.detach().argmax(-1) == hard).to(torch.float32).mean()
        return state, {"loss": loss.detach(), "acc": acc}

    return step
