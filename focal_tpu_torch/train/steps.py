"""Training steps (port of the JAX package's ``train/steps.py``).

A step gathers its batch from data already resident on the device (``idx``
selects the rows, as the JAX package's jitted steps do), augments it (two
random views for pretraining; the fixed pool or none for the classifier
stages), runs the model, the loss and the update, and returns its metrics
as device tensors: nothing in the step waits for the device.

Over several processes (``plan``, a ``parallel.mesh.MeshPlan``) every rank
draws the views of the global batch from the same host generator and keeps
its data shard's rows (the fused [2B] batch is each shard's view-1 rows then
its view-2 rows, as the JAX package's ``make_view_fuser`` orders them), runs
the model on them, and gathers the outputs over the data ranks with autograd
(``parallel.distributed.gather_from``): the loss is the single-process loss
of the global batch, the same on every rank. Each rank's gradients are then
its rows' part of the true gradient, and one flat sum over the data ranks
(``reduce_gradients``) completes them; parameters whole on every model rank
get the same gradient there, so the sum runs over ``data`` only.
"""

import torch

from focal_tpu_torch.train.losses import cross_entropy


def gather_batch(data, idx):
    """{loc: {mod: [N, ...]}} -> the rows idx, on the data's device."""
    return {loc: {m: a.index_select(0, idx) for m, a in mods.items()} for loc, mods in data.items()}


def local_batch(batch, plan):
    """This data rank's rows of a {loc: {mod: [B, ...]}} global batch."""
    if plan is None:
        return batch
    return {loc: {m: plan.local_rows(a) for m, a in mods.items()} for loc, mods in batch.items()}


def gather_outputs(out, plan):
    """The data ranks' outputs ({mod: [b, ...]} or a tensor) concatenated in
    rank order, differentiable."""
    if plan is None:
        return out
    if isinstance(out, dict):
        return {m: plan.gather_data(v) for m, v in out.items()}
    return plan.gather_data(out)


def reduce_gradients(params, plan):
    """Sum the parameters' gradients over the data ranks: one flat sum."""
    if plan is None or plan.dp == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = plan.sum_data_(torch.cat([g.reshape(-1) for g in grads]))
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def make_pretrain_step(model, augmenter, focal_loss, fused_views=True, plan=None):
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
    batch, or view 1's update and then view 2's. ``plan``: see the module
    docstring (the statistics over the global batch)."""

    def step(state, data, idx, aug_ids=None):
        rngs = state.generators()
        batch = gather_batch(data, idx)
        a1, a2 = (None, None) if aug_ids is None else aug_ids
        view1 = local_batch(augmenter.random(rngs.host, batch, force_aug_id=a1), plan)
        view2 = local_batch(augmenter.random(rngs.host, batch, force_aug_id=a2), plan)
        model.train()
        if fused_views:
            both = {
                loc: {m: torch.cat([a, view2[loc][m]], dim=0) for m, a in mods.items()}
                for loc, mods in view1.items()
            }
            feats = model(both, head="proj", rng=rngs)
            b = next(iter(feats.values())).shape[0] // 2
            f1 = gather_outputs({m: v[:b] for m, v in feats.items()}, plan)
            f2 = gather_outputs({m: v[b:] for m, v in feats.items()}, plan)
        else:
            f1 = gather_outputs(model(view1, head="proj", rng=rngs), plan)
            f2 = gather_outputs(model(view2, head="proj", rng=rngs), plan)
        loss, parts = focal_loss(f1, f2)
        state.optimizer.zero_grad()
        loss.backward()
        reduce_gradients(state.optimizer.params, plan)
        state.optimizer.step(state.step)
        state.step += 1
        return state, {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}

    return step


def make_supervised_train_step(model, augmenter, fixed_aug=True, plan=None):
    """A classifier step, supervised (``fixed_aug``: the fixed augmenter
    pool) or finetune (augmenter ``no``), as the JAX package's
    ``make_supervised_train_step`` and classifier epoch: augment -> the
    class head -> cross-entropy (hard labels, or mixup's soft targets) ->
    update. Returns step(state, data, labels, idx) -> (state, metrics) with
    metrics {"loss", "acc"} as device tensors; ``labels`` are the split's
    device labels. A backbone with BatchNorm updates its running statistics
    in the training forward, frozen or not, as the JAX step carries
    ``batch_stats``. ``plan``: see the module docstring (the loss and the
    accuracy over the global batch)."""

    def step(state, data, labels, idx):
        rngs = state.generators()
        batch = gather_batch(data, idx)
        batch_labels = labels.index_select(0, idx)
        if fixed_aug:
            freq_x, targets = augmenter.fixed(rngs.host, batch, batch_labels)
        else:
            freq_x, targets = augmenter.no(batch), batch_labels
        model.train()
        logits = gather_outputs(model(local_batch(freq_x, plan), head="class", rng=rngs), plan)
        loss = cross_entropy(logits, targets)
        state.optimizer.zero_grad()
        loss.backward()
        reduce_gradients(state.optimizer.params, plan)
        state.optimizer.step(state.step)
        state.step += 1
        hard = targets.argmax(-1) if targets.dim() > 1 else targets
        acc = (logits.detach().argmax(-1) == hard).to(torch.float32).mean()
        return state, {"loss": loss.detach(), "acc": acc}

    return step
