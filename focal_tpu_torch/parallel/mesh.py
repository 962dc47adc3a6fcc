"""The (data, model) layout of the processes (the port's form of the JAX
package's ``parallel/mesh.py``).

The JAX package lays its local devices out as a ``data`` x ``model`` mesh,
``model`` innermost; the port lays its processes out the same way, one per
card: rank r sits at (d, m) = (r // mp, r % mp). ``MeshPlan`` holds the
process groups of both axes: ``data``, the dp ranks that share m (they
split the batch, and sum the weight gradients), and ``model``, the mp ranks
that share d (they split the heads and hidden widths of SW_Transformer, and
sum partial activations).
"""

from dataclasses import dataclass
from typing import Any, Optional

import torch.distributed as dist

from focal_tpu_torch.parallel import distributed

SEED_STRIDE = 1000003  # a shard's kernel seed: seed + shard * SEED_STRIDE, as the JAX package's
# (train.state.TrainState: the data shard d, or the (data, model) shard d mp + m)


@dataclass
class MeshPlan:
    dp: int  # ranks on the "data" axis
    mp: int  # ranks on the "model" axis (1 = no tensor parallelism)
    d: int  # this rank's data coordinate
    m: int  # this rank's model coordinate
    data: Any = None  # process group of the data axis (None: the default group)
    model: Any = None  # process group of the model axis (None: the default group)

    def rows(self, n):
        """(lo, hi): this rank's rows of a batch of n, which dp must divide."""
        if n % self.dp:
            raise ValueError(f"a batch of {n} rows does not split over {self.dp} data ranks")
        per = n // self.dp
        return self.d * per, (self.d + 1) * per

    # the collectives of each axis; identities where the axis has one rank
    # (its group would be the default, every process)

    def local_rows(self, x):
        """This rank's rows of a global batch tensor."""
        if self.dp == 1:
            return x
        lo, hi = self.rows(x.shape[0])
        return x[lo:hi]

    def gather_data(self, x):
        """The data ranks' rows concatenated, differentiable (gather_from)."""
        return x if self.dp == 1 else distributed.gather_from(x, self.data, 0)

    def gather_data_(self, x):
        """The same, no gradient (eval)."""
        return x if self.dp == 1 else distributed.all_gather(x, self.data, 0)

    def sum_data(self, x):
        """The sum over the data ranks, differentiable both ways."""
        return x if self.dp == 1 else distributed.all_reduce(x, self.data)

    def sum_data_(self, t):
        """The sum over the data ranks in place (the weight gradients)."""
        return t if self.dp == 1 else distributed.all_reduce_(t, self.data)

    def sum_model_(self, t):
        """The sum over the model ranks in place."""
        return t if self.mp == 1 else distributed.all_reduce_(t, self.model)


def make_mesh_plan(data_parallel=0, model_parallel=1, world=None, rank=None) -> Optional[MeshPlan]:
    """The layout of ``world`` processes (the process group's, by default):
    data_parallel=0 fills the data axis with world // mp. Raises where
    model_parallel does not divide the world and where dp x mp exceeds it,
    as the JAX package's does, and also where dp x mp falls short of it (a
    process would hold no part of the mesh). None for one process."""
    world = distributed.process_count() if world is None else world
    rank = distributed.process_index() if rank is None else rank
    mp = max(1, model_parallel)
    if world % mp:
        raise ValueError(f"model_parallel={mp} does not divide {world} devices")
    dp = data_parallel if data_parallel > 0 else world // mp
    n = dp * mp
    if n <= 1:
        return None
    if n > world:
        raise ValueError(f"Requested {dp} (data) x {mp} (model) devices, have {world}")
    if n < world:
        raise ValueError(f"{dp} (data) x {mp} (model) devices leave {world - n} of the {world} "
                         "processes out of the mesh; pass -data_parallel 0")
    d, m = divmod(rank, mp)
    data = model = None  # the default group where one axis spans every process
    if dist.is_initialized():
        # every rank creates every group, in the same order
        if mp > 1 and dp > 1:
            for j in range(mp):
                g = dist.new_group([i * mp + j for i in range(dp)])
                data = g if j == m else data
            for i in range(dp):
                g = dist.new_group([i * mp + j for j in range(mp)])
                model = g if i == d else model
    return MeshPlan(dp=dp, mp=mp, d=d, m=m, data=data, model=model)
