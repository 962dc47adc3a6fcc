"""Multi-process execution, one process per card, through torch.distributed
(the port's form of the JAX package's ``parallel/distributed.py``).

The JAX package drives every local device from one process; the port runs
one process per device, so the world size is dp x mp. The topology comes
from flags or the environment, the flags winning:

    -dist_coordinator host:port -dist_num_processes N -dist_process_id R
    FOCAL_DIST_COORDINATOR / FOCAL_DIST_NUM_PROCESSES / FOCAL_DIST_PROCESS_ID

``maybe_initialize`` sets up the default process group over ``tcp://`` and
must run before the first device query (``params.parse_train_params`` calls
it before ``select_device``). A process's card is ``cuda:{local rank %
device_count}``, its local rank ``LOCAL_RANK`` where a launcher sets it, else
its process id. The backend is NCCL where every local rank has a card of its
own, else gloo: on the CPU, and where ranks share one card (NCCL refuses two
ranks on one device). gloo runs the collectives used here (all_reduce,
all_gather) on CUDA tensors itself, through host memory.

The autograd collectives of data and tensor parallelism are here too:
``copy_to`` (identity forward, sum of the gradients backward), ``reduce_from``
(sum forward, identity backward), ``gather_from`` (concatenation forward, the
local slice of the gradient backward) and ``all_reduce`` (sum both ways).
"""

import atexit
import datetime
import logging
import os
import socket

import torch
import torch.distributed as dist

_TIMEOUT = datetime.timedelta(minutes=15)


def _env_int(name, default=None):
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def topology(args=None):
    """(coordinator, process count, process id) from the flags, else the
    FOCAL_DIST_* environment; (None, 0, None) where neither names one."""
    coord = getattr(args, "dist_coordinator", None) or os.environ.get("FOCAL_DIST_COORDINATOR")
    nproc = getattr(args, "dist_num_processes", None)
    if nproc in (None, 0):
        nproc = _env_int("FOCAL_DIST_NUM_PROCESSES", 0)
    pid = getattr(args, "dist_process_id", None)
    if pid is None:
        pid = _env_int("FOCAL_DIST_PROCESS_ID")
    return coord, nproc, pid


def local_rank():
    """This process's index among the processes of its host: ``LOCAL_RANK``
    where a launcher sets it, else the process id (one host)."""
    return _env_int("LOCAL_RANK", process_index())


def _local_count():
    return _env_int("LOCAL_WORLD_SIZE", process_count())


def device_for(device="cuda"):
    """The device name of this process: ``cuda:{local rank % cards}`` for a
    CUDA ``device`` in a multi-process run, else ``device`` unchanged."""
    if device != "cuda" or process_count() == 1 or not torch.cuda.is_available():
        return device
    return f"cuda:{local_rank() % torch.cuda.device_count()}"


def _backend(device):
    """NCCL where every local rank has a card of its own, else gloo."""
    if device != "cuda" or not torch.cuda.is_available():
        return "gloo"
    return "nccl" if _local_count() <= torch.cuda.device_count() else "gloo"


def maybe_initialize(args=None):
    """Join the process group that the flags or the environment describe.
    Returns True when the run has more than one process; a second call is a
    no-op. A process count above 1 without a process id raises: every
    process would claim id 0 and the rendezvous would hang."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coord, nproc, pid = topology(args)
    if not coord:
        return False
    if not nproc or nproc < 1:
        raise ValueError("-dist_coordinator needs -dist_num_processes (or "
                         "FOCAL_DIST_NUM_PROCESSES): the port does not detect the process count")
    if pid is None:
        if nproc > 1:
            raise ValueError(
                "dist_num_processes > 1 requires -dist_process_id (or FOCAL_DIST_PROCESS_ID) "
                "— it cannot be defaulted: every process would claim id 0 and the rendezvous "
                "would hang")
        pid = 0
    if not 0 <= pid < nproc:
        raise ValueError(f"-dist_process_id {pid} is outside [0, {nproc})")
    os.environ.setdefault("LOCAL_WORLD_SIZE", str(nproc))
    backend = _backend(getattr(args, "device", "cuda"))
    dist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=nproc, rank=pid,
                            timeout=_TIMEOUT)
    # left alive to the interpreter's teardown, gloo's threads can abort the exit
    atexit.register(_leave)
    logging.info(f"= torch.distributed: process {pid}/{nproc}, backend {backend}")
    return nproc > 1


def _leave():
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index():
    return dist.get_rank() if dist.is_initialized() else 0


def process_count():
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main():
    """True on the process that writes checkpoints and logs."""
    return process_index() == 0


def barrier():
    """Wait for every process; a no-op in a single process."""
    if process_count() > 1:
        dist.barrier()


def backend():
    return dist.get_backend() if dist.is_initialized() else None


def all_reduce_(tensor, group=None):
    """Sum ``tensor`` over ``group`` in place; returns it. A bf16 tensor is
    summed in f32 and rounded to bf16 once (gloo reduces no bf16; over two
    ranks that is the bf16 add, as the JAX package's psum of bf16 partials
    gives, over more the order of an f32 sum)."""
    if tensor.dtype == torch.bfloat16:
        wide = tensor.float()
        dist.all_reduce(wide, group=group)
        return tensor.copy_(wide)
    dist.all_reduce(tensor, group=group)
    return tensor


def all_gather(tensor, group=None, dim=0):
    """The tensors of every rank of ``group``, concatenated along ``dim`` in
    rank order (equal shapes; a bf16 tensor moves as its bytes, which gloo
    takes)."""
    if tensor.dtype == torch.bfloat16:
        return all_gather(tensor.contiguous().view(torch.uint8), group, dim).view(torch.bfloat16)
    parts = [torch.empty_like(tensor) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, tensor.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def broadcast_object(obj, src=0):
    """Rank ``src``'s picklable ``obj`` on every process."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def group_rank(group):
    return dist.get_rank(group) if dist.is_initialized() else 0


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.n, ctx.size = dim, group_rank(group), x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.n * ctx.size, ctx.size), None, None


def copy_to(x, group):
    """Identity forward; the gradient summed over ``group`` backward (the
    input of a column-parallel product, whose ranks each give a part of
    it)."""
    return _CopyTo.apply(x, group)


def reduce_from(x, group):
    """The sum over ``group`` forward; identity backward (the output of a
    row-parallel product: the gradient of the sum is the same on every
    rank)."""
    return _ReduceFrom.apply(x, group)


def all_reduce(x, group):
    """The sum over ``group`` both ways (statistics that every rank's rows
    feed and every rank's rows read: BatchNorm's over the data group)."""
    return _AllReduce.apply(x, group)


def gather_from(x, group, dim=0):
    """The ranks' tensors concatenated along ``dim`` forward; backward, this
    rank's slice of the gradient. Exact where what reads the result runs the
    same on every rank of ``group`` (the loss over the gathered batch, the
    layers after a column-parallel product), so that every rank holds the
    same gradient: the slice is then this rank's true partial derivative,
    and the data reduction of the weight gradients is a plain sum."""
    return _GatherFrom.apply(x, group, dim)


def free_port():
    """A free TCP port on localhost for a local rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(rank, world, port, fn, args, queue, device, init, threads):
    os.environ.update({"LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world)})
    if device == "cpu":  # the ranks share the caller's cores
        torch.set_num_threads(threads)
    try:
        if init:
            dist.init_process_group(_backend(device), init_method=f"tcp://127.0.0.1:{port}",
                                    world_size=world, rank=rank, timeout=_TIMEOUT)
        else:  # fn joins through the entry points, as a user's processes do
            os.environ.update({"FOCAL_DIST_COORDINATOR": f"127.0.0.1:{port}",
                               "FOCAL_DIST_NUM_PROCESSES": str(world),
                               "FOCAL_DIST_PROCESS_ID": str(rank)})
        out = fn(rank, world, *args)
        queue.put((rank, "ok", out))
    except BaseException as err:  # noqa: BLE001 - reported to the parent, which raises
        import traceback

        queue.put((rank, "error", f"{type(err).__name__}: {err}\n{traceback.format_exc()}"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_local(fn, world, *args, device="cpu", timeout=600, init=True):
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined in
    one process group on this host (gloo on the CPU and on a shared card,
    NCCL where each rank has a card), and return the ranks' results in rank
    order. ``fn`` must be importable by name. Without ``init`` the processes
    get the FOCAL_DIST_* variables instead, for ``fn`` to join through an
    entry point. On the CPU each rank takes the caller's intra-op threads,
    at most its share of the cores. A rank that fails fails the job: its
    error is raised here and the other ranks are stopped."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    threads = max(1, min(torch.get_num_threads(), (os.cpu_count() or 1) // world))
    procs = [ctx.Process(target=_spawned, args=(r, world, port, fn, args, queue, device, init,
                                                 threads))
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, timeout
    try:
        while len(results) < world:
            try:
                rank, status, out = queue.get(timeout=deadline)
            except queue_mod.Empty:
                raise TimeoutError(f"run_local: ranks {sorted(set(range(world)) - set(results))} "
                                   f"gave no result in {timeout} s") from None
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed: {out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30 if len(results) == world else 1)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]
