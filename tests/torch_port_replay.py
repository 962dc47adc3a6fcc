"""GradCache's replay, seen from outside the step: ``recorded_passes``
records a model's forward outputs during a ``make_gathered_pretrain_step``
update, pass 1's (run without gradient) apart from pass 2's (with), and
``replayed_bitwise`` holds pass 2's to pass 1's, call by call."""

import contextlib

import torch


@contextlib.contextmanager
def recorded_passes(model):
    """{False: pass 1's outputs, True: pass 2's}, each a list of
    {mod: tensor} copies in call order, keyed by the grad mode the forward
    ran under."""
    seen = {False: [], True: []}

    def hook(module, inputs, out):
        seen[torch.is_grad_enabled()].append({m: v.detach().clone() for m, v in out.items()})

    handle = model.register_forward_hook(hook)
    try:
        yield seen
    finally:
        handle.remove()


def replayed_bitwise(seen):
    """Whether pass 2 made as many forwards as pass 1, each bitwise its
    pass-1 counterpart."""
    first, second = seen[False], seen[True]
    return len(first) == len(second) > 0 and all(
        a.keys() == b.keys() and all(torch.equal(a[m], b[m]) for m in a)
        for a, b in zip(first, second))
