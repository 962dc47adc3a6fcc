"""Training steps (port of the JAX package's ``train/steps.py``).

A step gathers its batch from data already resident on the device (``idx``
selects the rows, as the JAX package's jitted steps do; a streamed split
hands each step its block, ``streaming``), augments it (two random views
for pretraining; the fixed pool or none for the classifier stages), runs
the model, the loss and the update, and returns its metrics as device
tensors: nothing in the step waits for the device.

Over several processes (``plan``, a ``parallel.mesh.MeshPlan``) every rank
draws the views of the global batch from the same host generator and keeps
its data shard's rows (the fused [2B] batch is each shard's view-1 rows then
its view-2 rows, as the JAX package's ``make_view_fuser`` orders them), runs
the model on them, and gathers the outputs over the data ranks with autograd
(``parallel.distributed.gather_from``): the loss is the single-process loss
of the global batch, the same on every rank. Each rank's gradients are then
its rows' part of the true gradient, and one flat sum over the data ranks
(``optim.reduce_gradients``, in the optimizer's update) completes them;
parameters whole on every model rank get the same gradient there, so the
sum runs over ``data`` only. Under the sharded layout (``sharded``) ``idx``
selects the rank's own rows of the global batch, which is the data ranks'
rows in rank order: the rank makes the global batch's draws and applies
them to its rows (``ops.augment.Augmenter.for_rows``).

``make_gathered_pretrain_step`` is the JAX package's GradCache step
(``gathered_accum_update``): k micro-batches' features without gradient,
one FOCAL loss over all of them, then each micro-batch's forward replayed
with gradient, its features' cotangents pulled back into ``.grad``.
"""

import torch

from focal_tpu_torch.models.layers import statistics_frozen
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


def shard_rows(plan, local):
    """(lo, hi, global rows) of this data rank's ``local`` rows of a
    sharded global batch (``Augmenter.for_rows``)."""
    return plan.d * local, (plan.d + 1) * local, local * plan.dp


def _rows(batch):
    return next(iter(next(iter(batch.values())).values())).shape[0]


def pretrain_views(augmenter, rngs, batch, plan=None, sharded=False, aug_ids=None):
    """The two random views of a gathered batch, this rank's rows of them:
    drawn over the global batch and sliced (replicated), or drawn over it
    and applied to the rank's rows (``sharded``)."""
    a1, a2 = (None, None) if aug_ids is None else aug_ids
    if sharded:
        augmenter = augmenter.for_rows(shard_rows(plan, _rows(batch)), plan.gather_data_)
        return (augmenter.random(rngs.host, batch, force_aug_id=a1),
                augmenter.random(rngs.host, batch, force_aug_id=a2))
    return (local_batch(augmenter.random(rngs.host, batch, force_aug_id=a1), plan),
            local_batch(augmenter.random(rngs.host, batch, force_aug_id=a2), plan))


def pretrain_features(model, rngs, view1, view2, fused_views=True, plan=None):
    """(f1, f2): the projector features of both views of the global batch,
    gathered over the data ranks, in training mode. A backbone with
    BatchNorm (DeepSense) updates its running statistics in each training
    forward, as the JAX step carries ``batch_stats``: once from the [2B]
    batch, or view 1's update and then view 2's."""
    model.train()
    if not fused_views:
        return (gather_outputs(model(view1, head="proj", rng=rngs), plan),
                gather_outputs(model(view2, head="proj", rng=rngs), plan))
    both = {loc: {m: torch.cat([a, view2[loc][m]], dim=0) for m, a in mods.items()}
            for loc, mods in view1.items()}
    feats = model(both, head="proj", rng=rngs)
    b = next(iter(feats.values())).shape[0] // 2
    return (gather_outputs({m: v[:b] for m, v in feats.items()}, plan),
            gather_outputs({m: v[b:] for m, v in feats.items()}, plan))


def _update(state):
    state.optimizer.step(state.step)
    state.step += 1


def make_pretrain_step(model, augmenter, focal_loss, fused_views=True, plan=None, sharded=False):
    """FOCAL pretraining: two random views -> projector features -> loss ->
    update. Returns step(state, data, idx, aug_ids=None) -> (state, metrics)
    with metrics {"loss", "shared", "private", "orthogonality", "ranking"};
    the state is updated in place and the gradients of the update stay in
    ``.grad`` (under -grad_accum the optimizer updates at a cycle's last
    step). ``aug_ids`` (-py_aug_draws) forces each view's augmenter.
    Any number of rows is a step: the epoch's ragged tail (-ragged_tail)
    runs through the same function.

    fused_views runs both views through the backbone as ONE [2B] batch (the
    JAX package's default); otherwise as two forwards (pretrain_features).
    ``plan`` and ``sharded``: see the module docstring."""

    def step(state, data, idx, aug_ids=None):
        rngs = state.generators()
        view1, view2 = pretrain_views(augmenter, rngs, gather_batch(data, idx), plan, sharded,
                                      aug_ids)
        f1, f2 = pretrain_features(model, rngs, view1, view2, fused_views, plan)
        loss, parts = focal_loss(f1, f2)
        state.optimizer.zero_grad()
        loss.backward()
        _update(state)
        return state, {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}

    return step


def make_gathered_pretrain_step(model, augmenter, focal_loss, accum, fused_views=True, plan=None,
                                sharded=False):
    """GradCache pretraining (the JAX package's ``gathered_accum_update``):
    step(state, micro) -> (state, metrics) over ``micro``, ``accum`` pairs
    (data, idx) of equal micro-batches. Pass 1 computes each micro-batch's
    features without gradient; one FOCAL loss over their concatenation
    (micro-batch after micro-batch, so the negatives and the ranking span
    the effective batch) gives the features' cotangents, by autograd on
    detached leaves; pass 2 replays each micro-batch's forward with
    gradient and pulls its cotangents back into ``.grad``, summed over the
    micro-batches; then one update (``state.step`` counts updates). This is
    the effective batch's exact gradient at one micro-batch's activations.

    Micro-batch i of update u draws its views, kernel seeds and masks as
    step u * accum + i would (``TrainState.generators``), from generators
    made anew in each pass, so pass 2 draws what pass 1 drew. Pass 1 folds
    the BatchNorm statistics micro-batch after micro-batch, as the JAX
    package chains ``batch_stats``; pass 2 folds none
    (``statistics_frozen``). Pass 1's model forwards run without gradient
    and pass 2's with, one a micro-batch (two with unfused views), in the
    same order."""

    def features(state, i, data, idx):
        rngs = state.generators(state.step * accum + i)
        view1, view2 = pretrain_views(augmenter, rngs, gather_batch(data, idx), plan, sharded)
        return pretrain_features(model, rngs, view1, view2, fused_views, plan)

    def step(state, micro):
        if len(micro) != accum:
            raise ValueError(f"a GradCache step takes {accum} micro-batches, got {len(micro)}")
        with torch.no_grad():
            first = [features(state, i, d, idx) for i, (d, idx) in enumerate(micro)]
        mods = sorted(first[0][0])
        leaves = [torch.cat([f[v][m] for f in first]).requires_grad_(True)
                  for v in (0, 1) for m in mods]
        n = len(mods)
        with torch.enable_grad():
            loss, parts = focal_loss(dict(zip(mods, leaves[:n])), dict(zip(mods, leaves[n:])))
            cotangents = torch.autograd.grad(loss, leaves)
        state.optimizer.zero_grad()
        with statistics_frozen(model):
            for i, (d, idx) in enumerate(micro):
                f1, f2 = features(state, i, d, idx)
                outs = [f1[m] for m in mods] + [f2[m] for m in mods]
                b = outs[0].shape[0]
                torch.autograd.backward(outs, [c[i * b:(i + 1) * b] for c in cotangents])
        _update(state)
        return state, {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}

    return step


def make_supervised_train_step(model, augmenter, fixed_aug=True, plan=None, sharded=False):
    """A classifier step, supervised (``fixed_aug``: the fixed augmenter
    pool) or finetune (augmenter ``no``), as the JAX package's
    ``make_supervised_train_step`` and classifier epoch: augment -> the
    class head -> cross-entropy (hard labels, or mixup's soft targets) ->
    update. Returns step(state, data, labels, idx) -> (state, metrics) with
    metrics {"loss", "acc"} as device tensors; ``labels`` are the split's
    device labels. A backbone with BatchNorm updates its running statistics
    in the training forward, frozen or not, as the JAX step carries
    ``batch_stats``. ``plan`` and ``sharded``: see the module docstring
    (the loss and the accuracy over the global batch)."""

    def step(state, data, labels, idx):
        rngs = state.generators()
        batch = gather_batch(data, idx)
        batch_labels = labels.index_select(0, idx)
        if not fixed_aug:
            freq_x, targets = augmenter.no(batch), batch_labels
        elif sharded:
            freq_x, targets = augmenter.for_rows(shard_rows(plan, idx.shape[0]),
                                                 plan.gather_data_).fixed(rngs.host, batch,
                                                                          batch_labels)
        else:
            freq_x, targets = augmenter.fixed(rngs.host, batch, batch_labels)
        if sharded:  # the rank's rows, their targets gathered with the logits
            targets = plan.gather_data_(targets)
        else:
            freq_x = local_batch(freq_x, plan)
        model.train()
        logits = gather_outputs(model(freq_x, head="class", rng=rngs), plan)
        loss = cross_entropy(logits, targets)
        state.optimizer.zero_grad()
        loss.backward()
        _update(state)
        hard = targets.argmax(-1) if targets.dim() > 1 else targets
        acc = (logits.detach().argmax(-1) == hard).to(torch.float32).mean()
        return state, {"loss": loss.detach(), "acc": acc}

    return step
