"""Train state: the model, its optimizer, the update counter and the
generators each step draws from."""

import torch

from focal_tpu_torch.ops.dropout import StepRngs
from focal_tpu_torch.train.optim import build_optimizer


class TrainState:
    """``step`` counts updates. The step's generators are derived from
    (seed, step), as the JAX package folds the step into its key: a step
    draws the same augmentations and dropout masks whatever ran before it."""

    def __init__(self, model, optimizer, seed=0, step=0):
        self.model = model
        self.optimizer = optimizer
        self.seed = int(seed)
        self.step = int(step)

    @property
    def device(self):
        return next(self.model.parameters()).device

    def generators(self):
        """StepRngs of the current step: a host generator, and a device
        generator seeded from it."""
        host = torch.Generator().manual_seed((self.seed * 1_000_003 + self.step) % 2**63)
        dev_seed = int(torch.randint(0, 2**62, (1,), generator=host))
        device = torch.Generator(device=self.device).manual_seed(dev_seed)
        return StepRngs(host, device)


def create_train_state(args, model, steps_per_epoch, seed=0):
    """Wrap a model (already on its device) with the run's optimizer."""
    optimizer, _ = build_optimizer(args, model, steps_per_epoch)
    return TrainState(model, optimizer, seed=seed)
