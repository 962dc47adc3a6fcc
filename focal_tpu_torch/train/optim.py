"""Optimizers and learning-rate schedules (port of the JAX package's
``train/optim.py``).

Schedules are timm's epoch-granular cosine (warmup prefix, one cycle) and
step decay, as pure ``lr(epoch)`` functions; the step at update k uses
lr(floor(k / steps_per_epoch)), as the JAX package maps them onto optax.
With ``-grad_accum k`` the optimizer is the JAX package's
``optax.MultiSteps`` around the whole chain: each micro-step's gradient goes
into a running mean (optax's Welford update), and the k-th clips, decays
and updates from that mean; the schedule then counts effective updates,
lr(floor(u / (steps_per_epoch / k))). GradCache pretraining accumulates
inside its step instead (``accum_in_step``): one update a step, the
schedule over steps_per_epoch // k of them.
Adam puts weight decay into the gradient (L2, torch ``Adam``); AdamW
decouples it (torch ``AdamW``). Gradients are clipped to the recipe's
``clip_grad`` global norm only when the run asks for it (``-clip_grad``).
Frozen parameters are left out of the optimizer: no update, no decay.
Under data parallelism the gradients are summed over the data ranks once
an update, before the clip (on the cycle's mean under accumulation). Under
tensor parallelism each rank's optimizer holds its slices of the
parameters, of their moments and of the accumulator; the clip's global norm
sums the sliced gradients over the model ranks.
"""

import logging
import math

import torch

from focal_tpu_torch.parallel.tp import is_sharded


def make_epoch_schedule(scheduler_config, optimizer_config):
    """Return a pure lr(epoch) -> float with timm semantics."""
    name = scheduler_config["name"]
    base_lr = float(optimizer_config["start_lr"])
    warmup_lr = float(optimizer_config.get("warmup_lr", 0.0))
    min_lr = float(optimizer_config.get("min_lr", 0.0))
    warmup_t = int(scheduler_config.get("warmup_epochs", 0))
    warmup_prefix = bool(scheduler_config.get("warmup_prefix", False))
    train_epochs = int(scheduler_config["train_epochs"])

    def warm(epoch):
        return warmup_lr + epoch * ((base_lr - warmup_lr) / max(warmup_t, 1))

    if name == "cosine":
        t_initial = train_epochs - warmup_t if warmup_prefix else train_epochs

        def lr(epoch):
            if epoch < warmup_t:
                return warm(epoch)
            t = epoch - warmup_t if warmup_prefix else epoch
            if t >= t_initial:
                return min_lr
            return min_lr + 0.5 * (base_lr - min_lr) * (1.0 + math.cos(math.pi * t / t_initial))

        return lr

    if name == "step":
        decay_t = int(scheduler_config["decay_epochs"])
        decay_rate = float(scheduler_config["decay_rate"])

        def lr(epoch):
            if epoch < warmup_t:
                return warm(epoch)
            return base_lr * decay_rate ** math.floor(epoch / decay_t)

        return lr

    raise ValueError(f"Unknown LR scheduler: {name}")


def _stage_configs(args):
    """The (optimizer, scheduler) recipe sections of the run's stage:
    ``[model]`` optimizer/lr_scheduler for supervised training, the
    framework's pretrain_* or finetune_* ones otherwise."""
    if args.train_mode == "supervised":
        section = args.dataset_config[args.model]
        return section["optimizer"], section["lr_scheduler"]
    section = args.dataset_config[args.learn_framework]
    if args.stage in ("pretrain", "finetune"):
        return section[f"{args.stage}_optimizer"], section[f"{args.stage}_lr_scheduler"]
    raise ValueError(f"No optimizer defined for stage {args.stage}")


def trainable_mask(model, args=None):
    """{parameter name: trainable}, the JAX package's freezing rules:
    contrastive pretraining (the default without ``args``) freezes every
    ``patch_embed`` parameter; finetuning trains only ``class_layer`` and
    ``mod_fusion_layer``; supervised training trains everything."""
    names = [name for name, _ in model.named_parameters()]
    if args is None or (args.train_mode != "supervised" and args.stage == "pretrain"):
        return {n: "patch_embed" not in n for n in names}
    if args.train_mode != "supervised" and args.stage == "finetune":
        return {n: "class_layer" in n or "mod_fusion_layer" in n for n in names}
    return {n: True for n in names}


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


class StepOptimizer:
    """A torch optimizer over the trainable parameters with the run's
    schedule and optional clipping. ``step(k)`` takes step k's gradients
    (0-based, from the parameters' ``.grad``): with ``accum`` 1 it applies
    update k; with ``accum`` n > 1 it adds them to ``acc``, the running mean
    of the cycle (None entries: no gradient yet), and at the cycle's last
    micro-step applies update k // n from that mean."""

    def __init__(self, optimizer, params, lr_epoch, steps_per_epoch, clip=None, plan=None,
                 accum=1):
        self.optimizer = optimizer
        self.params = params
        self.lr_epoch = lr_epoch
        self.steps_per_epoch = steps_per_epoch
        self.clip = clip
        self.plan = plan
        self.accum = accum
        self.acc = None

    def lr(self, k):
        return self.lr_epoch(math.floor(k / (self.steps_per_epoch / self.accum)))

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def _accumulate(self, n):
        """Fold the gradients of micro-step n of the cycle into ``acc`` as
        optax's MultiSteps does, acc + (g - acc) / (n + 1), a missing
        gradient counting 0. True at the cycle's last micro-step, with the
        mean left in ``.grad`` and ``acc`` cleared."""
        if self.acc is None:
            self.acc = [None] * len(self.params)
        for i, p in enumerate(self.params):
            g, a = p.grad, self.acc[i]
            if g is None and a is None:
                continue
            g = torch.zeros_like(a) if g is None else g
            self.acc[i] = g / (n + 1) if a is None else a + (g - a) / (n + 1)
        if n + 1 < self.accum:
            return False
        for p, a in zip(self.params, self.acc):
            p.grad = a
        self.acc = None
        return True

    def step(self, k):
        if self.accum > 1:
            if not self._accumulate(k % self.accum):
                return
            k //= self.accum
        reduce_gradients(self.params, self.plan)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr(k)
        if self.clip:
            with_grad = [p for p in self.params if p.grad is not None]
            clip_by_global_norm([p.grad for p in with_grad], self.clip, self.plan,
                                [is_sharded(p) for p in with_grad])
        self.optimizer.step()


def clip_by_global_norm(grads, max_norm, plan=None, sharded=None):
    """optax.clip_by_global_norm in place: g * max_norm / norm when the
    global norm reaches max_norm. Stays on the device (no host sync). Under
    tensor parallelism (``plan``, ``sharded`` flagging the gradients of cut
    parameters) the squares of the cut ones are summed over the model ranks
    and the whole ones counted once."""
    if not grads:
        return
    if plan is not None and plan.mp > 1:
        sq = [torch.linalg.vector_norm(g) ** 2 for g in grads]
        part = torch.stack([s for s, cut in zip(sq, sharded) if cut] or [sq[0] * 0]).sum()
        whole = torch.stack([s for s, cut in zip(sq, sharded) if not cut] or [sq[0] * 0]).sum()
        norm = torch.sqrt(whole + plan.sum_model_(part))
    else:
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


def build_optimizer(args, model, steps_per_epoch, plan=None, accum_in_step=False):
    """(StepOptimizer over the trainable parameters, lr(epoch)) from the
    stage's recipe sections; a run's -epochs, when given, is also the
    schedule's length, as in the JAX package; -ref_lr_timing shifts the
    schedule one epoch later. -grad_accum k accumulates k steps an update
    (``accum``), or with ``accum_in_step`` (GradCache, whose step takes k
    micro-batches) paces the schedule by steps_per_epoch // k updates an
    epoch; the JAX package's warnings where cycles straddle epochs. Frozen parameters
    (``trainable_mask``) get requires_grad False here: autograd then skips
    them, where the JAX step computes their gradients and zeroes the
    updates (the parameters come out the same)."""
    accum = max(1, int(getattr(args, "grad_accum", 1) or 1))
    if accum > 1 and not accum_in_step and steps_per_epoch % accum:
        if accum > steps_per_epoch:
            logging.warning(f"= -grad_accum {accum} exceeds steps_per_epoch {steps_per_epoch}: "
                            "some epochs will produce ZERO optimizer updates (accumulation "
                            "cycles span epochs). Lower -grad_accum or raise -batch_size.")
        else:
            logging.warning(f"= steps_per_epoch {steps_per_epoch} is not divisible by "
                            f"-grad_accum {accum}: accumulation cycles straddle epoch "
                            "boundaries, so the lr(epoch) mapping drifts slightly at them.")
    if accum_in_step:
        steps_per_epoch, accum = max(1, steps_per_epoch // accum), 1
    optimizer_config, scheduler_config = _stage_configs(args)
    if getattr(args, "epochs", None):
        scheduler_config = dict(scheduler_config, train_epochs=args.epochs)
    lr_epoch = make_epoch_schedule(scheduler_config, optimizer_config)
    if getattr(args, "ref_lr_timing", False):
        # the reference steps timm's scheduler at the epoch's end: epoch e
        # trains at lr(e - 1), epoch 0 at the constructor's lr(0)
        base_lr_epoch = lr_epoch

        def lr_epoch(epoch):
            return base_lr_epoch(max(epoch - 1, 0))
    wd = optimizer_config.get("weight_decay", 0.0)
    if isinstance(wd, dict):
        wd = wd[args.model]
    wd = float(wd)

    mask = trainable_mask(model, args)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    name = optimizer_config["name"]
    lr0 = lr_epoch(0)
    if name == "Adam":
        opt = torch.optim.Adam(params, lr=lr0, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    elif name == "AdamW":
        opt = torch.optim.AdamW(params, lr=lr0, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    else:
        raise NotImplementedError(f"Optimizer {name} not implemented.")
    clip = None
    if args.clip_grad and optimizer_config.get("clip_grad"):
        clip = float(optimizer_config["clip_grad"])
    return StepOptimizer(opt, params, lr_epoch, steps_per_epoch, clip, plan, accum), lr_epoch
