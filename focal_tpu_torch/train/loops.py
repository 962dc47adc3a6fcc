"""Stage loops (port of the JAX package's ``train/loops.py``): FOCAL
pretraining (``pretrain``), supervised training
(``supervised_train``) and finetuning (``finetune``).

Epochs of steps over the device-resident train split; validation after
epochs 0, val_epochs, 2 val_epochs, ... and the last. Epochs run in the JAX
package's blocks (``blocks``): a whole val interval once at least five of
them remain, else one epoch (``-epochs_per_call`` sets the size, capped at
val_epochs); a block never crosses a validation point, and the train loss
(the classifier's train accuracy too) at a point is the mean of the epoch
means of the block that ends there. Pretraining fits a
KNN probe on the train split's encoder features and reports the pretrain
loss and the probe's metrics on val and test; its `_best` has the lowest
val loss. The classifier stages report the class head's loss and metrics
(``evaluate.eval_supervised``); their `_best` has the highest val accuracy.
Supervised training draws the fixed augmenter pool; finetuning loads the
pretrained backbone (pretraining's `_latest`, without its class layer),
trains only ``class_layer`` and ``mod_fusion_layer`` and runs the
augmenter ``no``. Every validation point saves the model (`_latest`, and
`_best`) and the full state (`_resume`). A non-finite train loss stops the
run.

Randomness is derived, never carried: an epoch's permutation from (seed,
epoch), a step's augmentation and dropout from (seed, update count), a
validation's views from (seed, epoch). A run resumed from `_resume` thus
takes the steps a straight run takes.

``-profile_dir`` traces the first epoch after the start with torch.profiler
(``epoch_trace``), that epoch a block of its own, as the JAX package traces
it. ``-knn_backend`` names one of the JAX package's probes (scikit-learn's,
or its on-device top-k); both run ``ops/knn.py``'s KNN on the features'
device, and the name is logged.

``-init_weight`` loads a params file into the model before any stage
trains (finetuning then loads the pretrained backbone over it). The
pretraining attribution arms, as in the JAX package: ``-ragged_tail`` runs
one more update an epoch on the permutation's leftover subsequences (at
least two; the schedule counts it, so lr still paces by epochs);
``-py_aug_draws`` forces each view's augmenter from a table of Python
``random.Random(seed)`` draws, the JAX package's table exactly. Unlike the JAX loops, `_resume` holds
the best val loss (accuracy) after this point's update, so that a resumed
run also picks `_best` as a straight run does.

``-grad_accum k`` (the JAX package's loops): pretraining takes GradCache
steps of k micro-batches (``steps.make_gathered_pretrain_step``; steps //
k updates an epoch, the ragged micro-step tail dropped), or with
``-no_accum_gather``, and in the classifier stages, one step a micro-batch
with the optimizer's MultiSteps accumulation (``optim.StepOptimizer``),
whose cycles may straddle epochs. An epoch's train loss is the mean over
its updates (GradCache) or its micro-steps (MultiSteps), as in the JAX
package.

Over several processes (``-data_parallel``, ``-model_parallel``: one
process per card, ``parallel.mesh.MeshPlan``) every rank holds the splits
whole (the ``replicated`` layout, what ``-data_layout auto`` means here),
draws the same batches and views, and trains its shard of the batch (and of
SW_Transformer's heads and widths); the process of rank 0 alone makes the
experiment folder, logs and writes the checkpoints, in the single-process
format. ``-data_layout sharded`` (data ranks only, as in the JAX package)
holds on each rank only its rows of the train split (``Run._shard``) and
draws each epoch a permutation of them keyed by (seed, epoch, rank); the
global batch is the ranks' local batches in rank order. A train split
over the device budget (``streaming.device_budget_bytes``) streams from
the host (``streaming.BlockStream``) under the replicated layout, the
resident permutation and rows step by step.
"""

import contextlib
import itertools
import logging
import math
import os
import random
import time

import numpy as np
import torch

from focal_tpu_torch import streaming
from focal_tpu_torch.data import DeviceDataLoader, Split, load_split, sequence_batches
from focal_tpu_torch.models import apply_plan, build_backbone, init_params
from focal_tpu_torch.ops.augment import build_augmenter
from focal_tpu_torch.output_paths import checkpoint_paths, set_model_weight_folder
from focal_tpu_torch.parallel import distributed, tp
from focal_tpu_torch.parallel.mesh import make_mesh_plan
from focal_tpu_torch.params import select_device
from focal_tpu_torch.train import checkpoint as ckpt
from focal_tpu_torch.train import evaluate as ev
from focal_tpu_torch.train.losses import make_focal_loss
from focal_tpu_torch.train.state import create_train_state
from focal_tpu_torch.train.steps import (make_gathered_pretrain_step, make_pretrain_step,
                                         make_supervised_train_step)

_PERMUTATION, _EVAL = 1, 2  # generator streams derived from the seed
_SHARD_SEED = 17  # the sharded layout's row assignment: default_rng(seed + 17), the JAX package's


def _generator(seed, stream, *keys):
    """A CPU generator keyed by (seed, stream, *keys)."""
    key = int(np.random.SeedSequence([seed, stream, *keys]).generate_state(1, np.uint64)[0])
    return torch.Generator().manual_seed(key % 2**63)


def prepare_folder(args):
    """set_model_weight_folder on the process of rank 0, the folder then
    handed to the others (which log warnings alone, to stderr)."""
    if distributed.is_main():
        set_model_weight_folder(args)
    else:
        logging.basicConfig(level=logging.WARNING, force=True, format="%(message)s")
    args.weight_folder = distributed.broadcast_object(args.weight_folder if distributed.is_main()
                                                      else None)
    return args


def place_model(model, device, plan, weights=None):
    """A built backbone moved to ``device`` and placed on ``plan``
    (models.apply_plan), then a params file's values loaded (``weights``:
    -init_weight, or the file the test CLI evaluates)."""
    model = apply_plan(model.to(device), plan)
    if weights:
        ckpt.load_params_into(model, weights, load_class_layer=True, plan=plan)
    return model


class Run:
    """What a stage loop needs, built once, on this process's device: the
    val and test splits resident there, the train split as its layout
    (``layout``) places it, the train split's loader (its steps), the
    augmenter, the process layout (``plan``; None for one process) and the
    model in the flax package's init from -seed, placed on it."""

    def __init__(self, args):
        self.args = args
        self.device = select_device(args.device)
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)
        self.plan = make_mesh_plan(args.data_parallel, args.model_parallel)
        if self.plan is not None:
            if args.batch_size % self.plan.dp:
                raise ValueError(f"-batch_size {args.batch_size} does not split over "
                                 f"{self.plan.dp} data ranks")
            logging.info(f"= Mesh: {self.plan.dp} (data) x {self.plan.mp} (model) processes, "
                         f"this one ({self.plan.d}, {self.plan.m}) on {self.device}, "
                         f"{distributed.backend()}")
        self.stream = None
        self.splits = {name: self._place(name, load_split(name, args))
                       for name in ("train", "val", "test")}
        batch = args.batch_size // (self.plan.dp if self.layout == "sharded" else 1)
        self.train_loader = train = DeviceDataLoader(self.splits["train"], batch, drop_last=True,
                                                     sequence=sequence_batches(args))
        if not len(train):
            raise ValueError("the train split holds less than one batch")
        logging.info(f"= Splits: train {len(self.splits['train'])} samples / {len(train)} steps "
                     f"of {train.batch_size} ({self.layout}), val {len(self.splits['val'])}, "
                     f"test {len(self.splits['test'])}; device {self.device}")
        self.augmenter = build_augmenter(args)
        model = build_backbone(args.dataset_config, args.model, args.task, args.learn_framework,
                               pallas_conv=args.pallas_conv, pallas_mlp=args.pallas_mlp,
                               pallas_block=not args.no_pallas_block,
                               compute_dtype=args.compute_dtype)
        if args.init_weight:
            logging.info(f"= Initialising params from {args.init_weight}")
        self.model = place_model(init_params(model, seed=args.seed), self.device, self.plan,
                                 args.init_weight)
        if self.plan is not None and self.plan.mp > 1:
            logging.info(f"= TP: {tp.sharded_leaf_count(model, self.plan.mp)} model-sharded "
                         "parameters")
        self._plans = {}

    def _place(self, name, split):
        """A split on the device; the train split by its layout: streamed
        where it exceeds the device budget (replicated, as in the JAX
        package), else sharded where -data_layout sharded asks on data ranks
        only, else replicated."""
        if name != "train":
            return split.to(self.device)
        args, plan = self.args, self.plan
        layout = args.data_layout
        if layout == "auto" or plan is None or plan.mp > 1:
            layout = "replicated"
        nbytes = streaming.split_nbytes(split.data)
        per_device = nbytes // plan.dp if layout == "sharded" else nbytes
        budget = streaming.device_budget_bytes(args, self.device)
        if per_device > budget:
            if args.py_aug_draws or args.ragged_tail:
                raise ValueError("-py_aug_draws/-ragged_tail are attribution arms for the "
                                 "replicated single-step layout (no streaming/sharded/grad_accum)")
            logging.info(f"= Train split {nbytes / 1e9:.2f} GB exceeds the {budget / 1e9:.2f} GB "
                         "device budget: streaming host->device in double-buffered blocks")
            self.layout = "streamed"
            self.stream = streaming.BlockStream(split.data, split.labels, self.device,
                                                args.stream_block_steps)
            return split
        self.layout = layout
        if layout == "sharded":
            split = self._shard(split)
        return split.to(self.device)

    def _shard(self, split):
        """This data rank's rows of the train split (the JAX package's
        ``_place_sharded_train``): the units (subsequences, or samples)
        trimmed to a multiple of dp and assigned by a permutation from
        default_rng(seed + 17), rank d taking the d-th contiguous part, its
        subsequences whole and stored one after another. Also keeps
        ``labels_grouped`` [dp, local rows], every rank's labels, for the
        KNN plan."""
        dp, d = self.plan.dp, self.plan.d
        rng = np.random.default_rng(self.args.seed + _SHARD_SEED)
        sequence = sequence_batches(self.args)
        units = split.num_subseqs if sequence else len(split)
        n = units // dp * dp
        per = self.args.batch_size // (split.subseq_idx.shape[1] if sequence else 1)
        if n == 0 or per % dp:
            raise ValueError(f"the sharded layout needs the train units ({units}) and a batch's "
                             f"units ({per}) to split over the {dp} data ranks")
        order = rng.permutation(units)[:n]
        rows = split.subseq_idx[order].reshape(-1) if sequence else order
        mine = rows.reshape(dp, -1)[d]
        self.labels_grouped = split.labels[rows].reshape(dp, -1)
        local = Split({loc: {m: a[mine] for m, a in mods.items()}
                       for loc, mods in split.data.items()},
                      split.labels[mine], [split.names[i] for i in mine])
        if sequence:
            seq_len = split.subseq_idx.shape[1]
            local.subseq_idx = np.arange(len(mine), dtype=np.int32).reshape(-1, seq_len)
        return local

    def eval_plan(self, split):
        """Every unit of a split once, in order, in batches of -batch_size
        (the sharded train split's: each rank's rows, ``ShardedEvalPlan``)."""
        if split not in self._plans:
            if split == "train" and self.layout == "sharded":
                self._plans[split] = ev.ShardedEvalPlan(self.labels_grouped, self.args.batch_size,
                                                        self.plan, self.device)
                return self._plans[split]
            loader = DeviceDataLoader(self.splits[split], self.args.batch_size,
                                      sequence=sequence_batches(self.args))
            stream = self.stream if split == "train" else None
            self._plans[split] = ev.EvalPlan(loader, self.device, stream)
        return self._plans[split]

    @property
    def step_samples(self):
        """Samples of the global batch of a train step."""
        ways = self.plan.dp if self.layout == "sharded" else 1
        return self.train_loader.batch_size * ways

    def epoch_steps(self, epoch):
        """(steps, tail): ``steps`` yields (data, labels, idx) for each full
        step of an epoch, ``idx`` the step's rows of ``data`` (the resident
        split, or a streamed block), from a permutation of the train units
        keyed by (seed, epoch), and of this rank's units by (seed, epoch,
        rank) under the sharded layout, ``per`` units a step; ``tail`` the
        rows of the permutation's leftover units (the ragged tail, which
        only -ragged_tail trains on, resident layouts only). A resident
        epoch's rows go to the device in one copy, so no step waits on the
        host."""
        loader = self.train_loader
        keys = (epoch, self.plan.d) if self.layout == "sharded" else (epoch,)
        perm = torch.randperm(loader.units, generator=_generator(self.args.seed, _PERMUTATION,
                                                                  *keys))
        rows = torch.from_numpy(loader.rows(perm.numpy()).astype(np.int64))
        full = len(loader) * loader.batch_size
        steps = rows[:full].view(len(loader), -1)
        if self.stream is not None:
            return self.stream.feed(steps), None
        train = self.splits["train"]
        return (((train.data, train.device_labels, idx) for idx in steps.to(self.device)),
                rows[full:].to(self.device))


def tail_steps(loader, ragged_tail):
    """1 where -ragged_tail trains on the tail of the train ``loader``'s
    epoch: two or more leftover subsequences (a tail of one has a NaN
    ranking loss and stays dropped, as in the JAX package), or any leftover
    samples; else 0."""
    tail = loader.units % loader.per
    return int(bool(ragged_tail) and (tail >= 2 if loader.sequence else tail > 0))


def aug_id_table(loader, augmenter, epochs, seed, ragged_tail):
    """-py_aug_draws: int32 [epochs, columns, 2] indices into the
    augmenter's pool from ``random.Random(seed)``, drawn in the JAX
    package's order: epoch, step, view. A column for each full step of the
    train ``loader``, and one for the tail when -ragged_tail leaves one,
    even a tail of one subsequence."""
    cols = len(loader) + int(bool(ragged_tail) and loader.units % loader.per > 0)
    n_augs = len(augmenter.time_aug_names) + len(augmenter.freq_aug_names)
    draws = random.Random(seed)
    return np.asarray([[[draws.randrange(n_augs) for _ in range(2)] for _ in range(cols)]
                       for _ in range(epochs)], dtype=np.int32)


def _block_size(args, val_epochs, remaining_epochs):
    """Max epochs per block, the JAX package's: a whole val block when the
    run is long enough (at least 5 val blocks remain); -epochs_per_call
    overrides, capped at val_epochs. Actual blocks never cross a validation
    point (see _next_block)."""
    if args.epochs_per_call:
        return max(1, min(args.epochs_per_call, val_epochs))
    if val_epochs > 1 and remaining_epochs >= 5 * val_epochs:
        return val_epochs
    return 1


def _next_block(epoch, k, val_epochs, train_epochs):
    """Epochs to run from ``epoch`` before the next stop point, keeping the
    validation cadence (after epochs 0, val_epochs, 2 val_epochs, ...)."""
    # the next epoch that is validated: smallest l >= epoch with l % val_epochs == 0
    next_val = epoch if epoch % val_epochs == 0 else epoch + (val_epochs - epoch % val_epochs)
    return max(1, min(k, next_val + 1 - epoch, train_epochs - epoch))


@contextlib.contextmanager
def epoch_trace(profile_dir, device, stage, epoch):
    """-profile_dir: a torch.profiler trace of the work inside (the host's
    operations, and on the card its kernels and copies), written as a
    Chrome trace to ``{profile_dir}/{stage}_epoch{epoch}.pt.trace.json``
    (``_rank{r}`` before the suffix when there are several processes)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda) as prof:
        yield
        if cuda:
            torch.cuda.synchronize(device)
    rank = f"_rank{distributed.process_index()}" if distributed.process_count() > 1 else ""
    path = os.path.join(profile_dir, f"{stage}_epoch{epoch}{rank}.pt.trace.json")
    prof.export_chrome_trace(path)
    logging.info(f"= Profiler trace of epoch {epoch} written to {path}")


def blocks(args, run, stage, val_epochs, start_epoch, train_epochs, train_epoch):
    """Run epochs start_epoch .. train_epochs - 1 through ``train_epoch``
    (epoch -> (train metrics, samples trained)) in the JAX package's blocks
    (``_block_size``, ``_next_block``; a streamed split takes blocks of one,
    as there) and yield (epoch, metrics, samples/s) at each validation
    point: ``metrics`` what ``train_epoch`` returned for each epoch of the
    block that ends there (the train metrics at a point are the means of
    these epoch means, as the JAX package's epoch functions return them),
    samples/s over the samples and time since the last point. With -profile_dir the first epoch after
    ``start_epoch`` runs as a block of its own, traced (``epoch_trace``),
    as the JAX package's loops trace it."""
    k = 1 if run.layout == "streamed" else _block_size(args, val_epochs,
                                                         train_epochs - start_epoch)
    if k > 1:
        logging.info(f"= Blocks of up to {k} epochs: the train loss at a validation point is the "
                     "mean of its block's epoch means")
    epoch, profiled = start_epoch, False
    t0, samples = time.time(), 0
    while epoch < train_epochs:
        n = _next_block(epoch, k, val_epochs, train_epochs)
        traced = bool(args.profile_dir) and not profiled and epoch > start_epoch
        if traced:
            n, profiled = 1, True
        with (epoch_trace(args.profile_dir, run.device, stage, epoch) if traced
              else contextlib.nullcontext()):
            done = [train_epoch(e) for e in range(epoch, epoch + n)]
        samples += sum(s for _, s in done)
        epoch += n
        if (epoch - 1) % val_epochs == 0 or epoch == train_epochs:
            yield epoch - 1, [m for m, _ in done], samples / max(time.time() - t0, 1e-9)
            t0, samples = time.time(), 0


def _nan_guard(train_loss, stage, epoch):
    if not math.isfinite(train_loss):
        logging.error(f"[{stage}] non-finite train loss at epoch {epoch}; aborting. "
                      "Restart from the _resume checkpoint with -resume.")
        raise FloatingPointError(f"{stage} diverged at epoch {epoch}: loss={train_loss}")


def log_val_test(stage, epoch, val_loss, val_metrics, test_loss, test_metrics):
    logging.info(f"[{stage}] epoch {epoch}: val loss {val_loss:.5f}")
    logging.info(f"Val acc: {val_metrics[0]:.5f}, val f1: {val_metrics[1]:.5f}")
    logging.info(f"Val confusion matrix:\n {val_metrics[2]}")
    logging.info(f"Test loss: {test_loss:.5f}")
    logging.info(f"Test acc: {test_metrics[0]:.5f}, test f1: {test_metrics[1]:.5f}")
    logging.info(f"Test confusion matrix:\n {test_metrics[2]}")


def pretrain(args):
    """FOCAL pretraining of ``args`` (parse_train_params). Returns (state,
    best val loss, validation points), a point being a dict of the epoch,
    the train loss and the val/test losses and metrics."""
    select_device(args.device)  # no card and no -device cpu: raise before any folder is made
    prepare_folder(args)
    run = Run(args)
    train_epochs = args.epochs or (
        args.dataset_config[args.learn_framework]["pretrain_lr_scheduler"]["train_epochs"])
    steps_per_epoch = len(run.train_loader)
    tail = tail_steps(run.train_loader, args.ragged_tail)
    accum = args.grad_accum
    gather = accum > 1 and not args.no_accum_gather
    if gather and steps_per_epoch < accum:
        raise ValueError(f"-grad_accum {accum} exceeds the {steps_per_epoch} steps per epoch; "
                         "lower -grad_accum or -batch_size")
    # the tail's update is one more an epoch; the schedule counts it, so
    # lr(epoch) still paces by epochs
    state = create_train_state(args, run.model, steps_per_epoch + tail, seed=args.seed,
                               accum_in_step=gather)
    logging.info(f"= Model params: {sum(p.numel() for p in run.model.parameters()):,}")
    table = None
    if args.py_aug_draws:
        table = aug_id_table(run.train_loader, run.augmenter, train_epochs, args.seed,
                             args.ragged_tail)
        logging.info(f"= -py_aug_draws: augmenter table {list(table.shape)} over "
                     f"{len(run.augmenter.time_aug_names) + len(run.augmenter.freq_aug_names)} "
                     "augmenters")
    focal_loss = make_focal_loss(args)
    sharded = run.layout == "sharded"
    if gather:
        logging.info(f"= -grad_accum {accum}: GradCache updates of {accum} micro-batches, "
                     f"{steps_per_epoch // accum} an epoch")
        step = make_gathered_pretrain_step(run.model, run.augmenter, focal_loss, accum,
                                           fused_views=not args.no_fused_views, plan=run.plan,
                                           sharded=sharded)
    else:
        step = make_pretrain_step(run.model, run.augmenter, focal_loss,
                                  fused_views=not args.no_fused_views, plan=run.plan,
                                  sharded=sharded)
    loss_fn = ev.make_batched_pretrain_loss(run.model, run.augmenter, focal_loss, run.plan)
    logging.info(f"= KNN probe (-knn_backend {args.knn_backend}): ops/knn.py's KNN on {run.device}")
    best_path, latest_path, resume_path = checkpoint_paths(args)
    val_epochs = args.val_epochs or 10
    best_val_loss, start_epoch = math.inf, 0
    if args.resume:
        epoch, best_val_loss = ckpt.restore_state(resume_path, state, accum)
        start_epoch = epoch + 1
        logging.info(f"= Resumed from {resume_path} at epoch {start_epoch}, best {best_val_loss:.5f}")
    data = run.splits["train"].data

    def train_epoch(epoch):
        steps, tail_rows = run.epoch_steps(epoch)
        if gather:  # the ragged micro-step tail is dropped
            losses = [step(state, [(d, idx) for d, _, idx in itertools.islice(steps, accum)])[1][
                "loss"] for _ in range(steps_per_epoch // accum)]
            return torch.stack(losses).mean(), steps_per_epoch // accum * accum * run.step_samples
        ids = table[epoch] if table is not None else None
        losses = [step(state, d, idx, None if ids is None else ids[i])[1]["loss"]
                  for i, (d, _, idx) in enumerate(steps)]
        samples = steps_per_epoch * run.step_samples
        if tail:  # the tail takes column `steps` of the table
            losses.append(step(state, data, tail_rows,
                               None if ids is None else ids[steps_per_epoch])[1]["loss"])
            samples += len(tail_rows)
        return torch.stack(losses).mean(), samples

    points = []
    start = time.time()
    for epoch, means, rate in blocks(args, run, "pretrain", val_epochs, start_epoch,
                                     train_epochs, train_epoch):
        train_loss = float(torch.stack(means).mean())
        _nan_guard(train_loss, "pretrain", epoch)
        logging.info(f"[pretrain] epoch {epoch}: train loss {train_loss:.5f} ({rate:.1f} samples/s)")
        estimator = ev.compute_knn(run.model, run.augmenter, run.eval_plan("train"), data,
                                   run.plan)
        val_loss, val_metrics = ev.eval_pretrained(
            args, run.model, run.augmenter, loss_fn, estimator, run.eval_plan("val"),
            run.splits["val"].data, _generator(args.seed, _EVAL, epoch), run.plan)
        test_loss, test_metrics = ev.eval_pretrained(
            args, run.model, run.augmenter, loss_fn, estimator, run.eval_plan("test"),
            run.splits["test"].data, _generator(args.seed, _EVAL, epoch + 1), run.plan)
        log_val_test("pretrain", epoch, val_loss, val_metrics, test_loss, test_metrics)
        ckpt.save_params(latest_path, run.model, run.plan)
        if val_loss < best_val_loss:
            best_val_loss = val_loss
            ckpt.save_params(best_path, run.model, run.plan)
        ckpt.save_state(resume_path, state, epoch, best_val_loss, accum)
        points.append({"epoch": epoch, "train_loss": train_loss, "val_loss": val_loss,
                       "val_acc": val_metrics[0], "val_f1": val_metrics[1],
                       "test_loss": test_loss, "test_acc": test_metrics[0],
                       "test_f1": test_metrics[1]})
    logging.info(f"[pretrain] total time {time.time() - start:.1f}s, best val loss {best_val_loss:.5f}")
    distributed.barrier()  # rank 0's files are whole when any rank returns
    return state, best_val_loss, points


def supervised_train(args):
    """Supervised training of ``args`` (parse_train_params, -learn_framework
    no): the backbone's recipe schedule and fixed augmenter pool. Returns
    (state, best val accuracy, validation points)."""
    return _classifier_loop(args, "supervised", fixed_aug=True,
                            scheduler=args.dataset_config[args.model]["lr_scheduler"])


def finetune(args):
    """Finetuning of a FOCAL-pretrained backbone (-stage finetune): the
    framework's finetune recipe, augmenter ``no``. Returns (state, best val
    accuracy, validation points)."""
    return _classifier_loop(args, "finetune", fixed_aug=False,
                            scheduler=args.dataset_config[args.learn_framework]["finetune_lr_scheduler"])


def _classifier_loop(args, stage, fixed_aug, scheduler):
    """The loop the two classifier stages share (they differ in
    augmentation and in the initial weights)."""
    select_device(args.device)  # no card and no -device cpu: raise before any folder is made
    prepare_folder(args)
    run = Run(args)
    train_epochs = args.epochs or scheduler["train_epochs"]
    if stage == "finetune":
        pretrain_latest = checkpoint_paths(args, stage="pretrain")[1]
        logging.info(f"= Loading the pretrained backbone from {pretrain_latest}")
        ckpt.load_params_into(run.model, pretrain_latest, load_class_layer=False, plan=run.plan)
    steps_per_epoch = len(run.train_loader)
    state = create_train_state(args, run.model, steps_per_epoch, seed=args.seed)
    logging.info(f"= Model params: {sum(p.numel() for p in run.model.parameters()):,} "
                 f"({sum(p.numel() for p in state.optimizer.params):,} trained)")
    step = make_supervised_train_step(run.model, run.augmenter, fixed_aug=fixed_aug,
                                      plan=run.plan, sharded=run.layout == "sharded")
    best_path, latest_path, resume_path = checkpoint_paths(args)
    val_epochs = args.val_epochs or 5
    best_val_acc, start_epoch = -1.0, 0
    if args.resume:
        epoch, best_val_acc = ckpt.restore_state(resume_path, state, args.grad_accum)
        start_epoch = epoch + 1
        logging.info(f"= Resumed from {resume_path} at epoch {start_epoch}, best {best_val_acc:.5f}")

    def train_epoch(epoch):
        metrics = [step(state, d, labels, idx)[1] for d, labels, idx in run.epoch_steps(epoch)[0]]
        return ((torch.stack([m["loss"] for m in metrics]).mean(),
                 torch.stack([m["acc"] for m in metrics]).mean()),
                steps_per_epoch * run.step_samples)

    points = []
    start = time.time()
    for epoch, means, rate in blocks(args, run, stage, val_epochs, start_epoch, train_epochs,
                                     train_epoch):
        train_loss = float(torch.stack([loss for loss, _ in means]).mean())
        train_acc = float(torch.stack([acc for _, acc in means]).mean())
        _nan_guard(train_loss, stage, epoch)
        logging.info(f"[{stage}] epoch {epoch}: train loss {train_loss:.5f}, train acc "
                     f"{train_acc:.5f} ({rate:.1f} samples/s)")
        val_loss, val_metrics = ev.eval_supervised(args, run.model, run.augmenter,
                                                   run.eval_plan("val"), run.splits["val"].data,
                                                   run.plan)
        test_loss, test_metrics = ev.eval_supervised(args, run.model, run.augmenter,
                                                     run.eval_plan("test"), run.splits["test"].data,
                                                     run.plan)
        log_val_test(stage, epoch, val_loss, val_metrics, test_loss, test_metrics)
        ckpt.save_params(latest_path, run.model, run.plan)
        if val_metrics[0] > best_val_acc:
            best_val_acc = val_metrics[0]
            ckpt.save_params(best_path, run.model, run.plan)
        ckpt.save_state(resume_path, state, epoch, best_val_acc, args.grad_accum)
        points.append({"epoch": epoch, "train_loss": train_loss, "train_acc": train_acc,
                       "val_loss": val_loss, "val_acc": val_metrics[0], "val_f1": val_metrics[1],
                       "test_loss": test_loss, "test_acc": test_metrics[0],
                       "test_f1": test_metrics[1]})
    logging.info(f"[{stage}] total time {time.time() - start:.1f}s, best val acc {best_val_acc:.5f}")
    distributed.barrier()  # rank 0's files are whole when any rank returns
    return state, best_val_acc, points
