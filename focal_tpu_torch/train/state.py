"""Train state: the model, its optimizer, the update counter, the process
layout and the generators each step draws from."""

import torch

from focal_tpu_torch.ops.dropout import StepRngs
from focal_tpu_torch.parallel.mesh import SEED_STRIDE
from focal_tpu_torch.train.optim import build_optimizer


class TrainState:
    """``step`` counts updates. The step's generators are derived from
    (seed, step), as the JAX package folds the step into its key: a step
    draws the same augmentations and dropout masks whatever ran before it.
    Over several processes (``plan``) the host generator is the same on
    every rank (the views of the global batch, the kernel seeds before each
    shard's offset); the device generator differs between data ranks (their
    rows' masks) and agrees between model ranks (what they hold whole); the
    split generator differs between every two ranks (what the model ranks
    split), its seed past every device generator's."""

    def __init__(self, model, optimizer, seed=0, step=0, plan=None):
        self.model = model
        self.optimizer = optimizer
        self.seed = int(seed)
        self.step = int(step)
        self.plan = plan

    @property
    def device(self):
        return next(self.model.parameters()).device

    def generators(self, step=None):
        """StepRngs of the current step (or of step ``step``: GradCache's
        micro-steps, each drawn as the step of that count, in both passes):
        a host generator, and the device generators seeded from it."""
        step = self.step if step is None else step
        host = torch.Generator().manual_seed((self.seed * 1_000_003 + step) % 2**63)
        dev_seed = int(torch.randint(0, 2**62, (1,), generator=host))
        make = lambda s: torch.Generator(device=self.device).manual_seed(s)  # noqa: E731
        plan = self.plan
        if plan is None:
            return StepRngs(host, make(dev_seed))
        shard = plan.d * plan.mp + plan.m
        split = make(dev_seed + (plan.dp + shard) * SEED_STRIDE) if plan.mp > 1 else None
        return StepRngs(host, make(dev_seed + plan.d * SEED_STRIDE), split,
                        plan.d * SEED_STRIDE, shard * SEED_STRIDE)


def create_train_state(args, model, steps_per_epoch, seed=0, accum_in_step=False):
    """Wrap a model (already on its device and layout: the ``plan``
    models.apply_plan gave it) with the run's optimizer
    (``optim.build_optimizer``)."""
    plan = getattr(model, "plan", None)
    optimizer, _ = build_optimizer(args, model, steps_per_epoch, plan, accum_in_step)
    return TrainState(model, optimizer, seed=seed, plan=plan)
