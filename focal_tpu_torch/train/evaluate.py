"""Evaluation (port of the JAX package's ``train/evaluate.py``): the
pretrain loss over a split, encoder features for the KNN probe, the class
head's loss over a split (``eval_supervised``), and the task metrics
(accuracy, macro-F1, confusion matrix) in numpy.

A split's batches follow an ``EvalPlan``: every unit once, in order, the
ragged tail padded and weighted 0. The model runs in eval mode, so its
window attention goes through the eval kernels (#1, or #4 for wide blocks;
#6 with -no_pallas_block) and, with -pallas_mlp, its MLPs through #10.

Over several processes (``mesh``, a ``parallel.mesh.MeshPlan``) each data
rank runs its rows of an eval batch and the outputs are gathered, so the
features, the KNN probe and the metrics are the single-process ones; a
batch that the data ranks do not divide runs whole on every rank. A train
split of the sharded layout has its ``ShardedEvalPlan`` (each rank's batch
its own rows, the outputs gathered); a streamed one takes its batches from
the stream (``EvalPlan``'s ``stream``), in the resident plan's order.
"""

import numpy as np
import torch

from focal_tpu_torch.ops.knn import KNN
from focal_tpu_torch.train.steps import gather_batch, local_batch


def _forward(model, x, head, mesh, local=False):
    """model(x, head=head) on a global eval batch, split over the data ranks
    and gathered back (no gradient); with ``local``, x is this rank's rows
    of it already."""
    rows = next(iter(next(iter(x.values())).values())).shape[0]
    if not local and (mesh is None or mesh.dp == 1 or rows % mesh.dp):
        return model(x, head=head)
    out = model(x if local else local_batch(x, mesh), head=head)
    if isinstance(out, dict):
        return {m: mesh.gather_data_(v) for m, v in out.items()}
    return mesh.gather_data_(out)


class EvalPlan:
    """Static batch schedule of a split from an eval loader (every unit
    once, in order, the tail padded): ``idx`` [nb, B] rows on ``device``
    (on the host where ``stream``, a ``streaming.BlockStream`` of the
    split, feeds the batches), ``weight`` and ``labels`` [nb, B] in
    numpy."""

    local = False  # each rank's batch is the global one

    def __init__(self, loader, device, stream=None):
        plans = list(loader)
        idx = np.stack([p.idx for p in plans])
        self.stream = stream
        self.idx = torch.from_numpy(idx)
        if stream is None:
            self.idx = self.idx.to(device)
        self.weight = np.stack([p.weight for p in plans])
        self.labels = loader.split.labels[idx]

    def batches(self, data):
        """(data, idx) of every batch, in order."""
        if self.stream is not None:
            return ((d, idx) for d, _, idx in self.stream.feed(self.idx))
        return ((data, idx) for idx in self.idx)


class ShardedEvalPlan(EvalPlan):
    """The plan of a train split of the sharded layout (the JAX package's
    ``ShardedEvalPlan``): batch b is every data rank's local rows [b L,
    (b + 1) L), L = batch_size // dp, the tail wrapped with weight 0, the
    outputs gathered in rank order, so every row counts once.
    ``labels_grouped`` [dp, n_local]: the ranks' labels."""

    local = True

    def __init__(self, labels_grouped, batch_size, plan, device):
        n_dev, n_local = labels_grouped.shape
        L = max(1, batch_size // n_dev)
        nb = -(-n_local // L)
        idx = (np.arange(nb * L) % n_local).reshape(nb, L)
        wloc = (np.arange(nb * L) < n_local).reshape(nb, L)
        self.stream = None
        self.idx = torch.from_numpy(idx.astype(np.int64)).to(device)
        self.weight = np.repeat(wloc[:, None, :], n_dev, axis=1).reshape(nb, n_dev * L)
        self.weight = self.weight.astype(np.float32)
        self.labels = np.stack([labels_grouped[:, idx[b]].reshape(-1) for b in range(nb)])


def extract_features(model, augmenter, plan, data, mesh=None):
    """Per-mod encoder features (no projection) of every batch of a plan,
    concatenated in mod-name order, the padded rows dropped -> (features
    [n, d] f32 on the device, whatever the compute dtype; labels [n]
    numpy)."""
    model.eval()
    rows = []
    with torch.no_grad():
        for d, idx in plan.batches(data):
            feats = _forward(model, augmenter.no(gather_batch(d, idx)), "feat", mesh, plan.local)
            rows.append(torch.cat([feats[m] for m in sorted(feats)], dim=-1).to(torch.float32))
    keep = plan.weight.reshape(-1) > 0
    stacked = torch.cat(rows)
    return stacked[torch.from_numpy(keep).to(stacked.device)], plan.labels.reshape(-1)[keep]


def compute_knn(model, augmenter, plan, train_data, mesh=None):
    """The KNN probe fitted on the train split's features."""
    feats, labels = extract_features(model, augmenter, plan, train_data, mesh)
    return KNN().fit(feats, torch.from_numpy(labels).to(feats.device))


def make_batched_pretrain_loss(model, augmenter, focal_loss, mesh=None):
    """(data, plan, generator) -> mean FOCAL loss over the plan's batches:
    two random views of each batch (drawn from ``generator``) through the
    eval forward. Padded rows count, as in the JAX package."""

    def loss_fn(data, plan, gen):
        model.eval()
        losses = []
        with torch.no_grad():
            for idx in plan.idx:
                batch = gather_batch(data, idx)
                f1 = _forward(model, augmenter.random(gen, batch), "proj", mesh)
                f2 = _forward(model, augmenter.random(gen, batch), "proj", mesh)
                losses.append(focal_loss(f1, f2)[0])
        return float(torch.stack(losses).mean())

    return loss_fn


def eval_task_metrics(args, labels, predictions):
    """(accuracy, macro-F1, confusion matrix) as scikit-learn computes
    them. Accuracy is the ordinal closeness for distance and speed tasks.
    F1 per class present in labels or predictions is 2 tp / (2 tp + fp +
    fn); the confusion matrix's rows are true classes and its columns
    predicted ones, over the sorted classes present in either."""
    labels = np.asarray(labels)
    predictions = np.asarray(predictions)
    if args.task in {"distance_classification", "speed_classification"}:
        num_classes = args.dataset_config[args.task]["num_classes"]
        with np.errstate(divide="ignore", invalid="ignore"):
            closeness = 1 - (np.abs(labels - predictions)
                             / np.maximum(labels, (num_classes - 1) - labels))
        mean_acc = float(np.nan_to_num(closeness, nan=1.0).mean())
    else:
        mean_acc = float((labels == predictions).mean())
    classes = np.unique(np.concatenate([labels, predictions]))
    li, pi = np.searchsorted(classes, labels), np.searchsorted(classes, predictions)
    conf = np.zeros((len(classes), len(classes)), np.int64)
    np.add.at(conf, (li, pi), 1)
    tp = np.diag(conf)
    f1 = 2 * tp / (2 * tp + (conf.sum(0) - tp) + (conf.sum(1) - tp))
    return mean_acc, float(f1.mean()), conf


def eval_pretrained(args, model, augmenter, loss_fn, estimator, plan, data, gen, mesh=None):
    """(mean pretrain loss, (accuracy, macro-F1, confusion)) of a split,
    the metrics from the KNN probe's predictions."""
    mean_loss = loss_fn(data, plan, gen)
    feats, labels = extract_features(model, augmenter, plan, data, mesh)
    preds = estimator.predict(feats).cpu().numpy()
    return mean_loss, eval_task_metrics(args, labels, preds)


def class_logits(model, augmenter, plan, data, mesh=None):
    """[nb, B, num_classes] f32 numpy: the class head's logits of every
    batch of a plan, FFT-only inputs, eval forward."""
    model.eval()
    rows = []
    with torch.no_grad():
        for d, idx in plan.batches(data):
            rows.append(_forward(model, augmenter.no(gather_batch(d, idx)), "class", mesh,
                                 plan.local).float())
    return torch.stack(rows).cpu().numpy()


def _np_cross_entropy(logits, labels, weight):
    """Weighted mean cross-entropy in numpy on [B, C] host arrays."""
    shifted = logits - logits.max(axis=-1, keepdims=True)
    logp = shifted - np.log(np.exp(shifted).sum(axis=-1, keepdims=True))
    per = -logp[np.arange(len(labels)), labels]
    return float((per * weight).sum() / max(weight.sum(), 1.0))


def eval_supervised(args, model, augmenter, plan, data, mesh=None):
    """(mean loss, (accuracy, macro-F1, confusion)) of a split through the
    class head: the loss is the mean of per-batch weighted means (the
    reference's one loss per batch), the metrics over the unpadded rows.
    A task whose name holds "regression" gives (mean weighted MSE, (MSE,)),
    the head's first output regressing the label, as in the JAX package."""
    return supervised_metrics(args, class_logits(model, augmenter, plan, data, mesh), plan)


def supervised_metrics(args, logits, plan):
    """eval_supervised's numbers from the logits [nb, B, C] of a plan (a
    regression task's predictions may come as [nb, B])."""
    if "regression" in args.task:
        preds = logits[..., 0] if logits.ndim == 3 else logits
        y = plan.labels.astype(np.float32)
        w = plan.weight
        batch_mse = [float(((preds[b] - y[b]) ** 2 * w[b]).sum() / max(w[b].sum(), 1.0))
                     for b in range(preds.shape[0])]
        keep = w.reshape(-1) > 0
        mse = float(((preds.reshape(-1) - y.reshape(-1))[keep] ** 2).mean())
        return float(np.mean(batch_mse)), (mse,)
    losses = [_np_cross_entropy(logits[b], plan.labels[b], plan.weight[b])
              for b in range(logits.shape[0])]
    keep = plan.weight.reshape(-1) > 0
    preds = logits.reshape(-1, logits.shape[-1]).argmax(-1)
    return float(np.mean(losses)), eval_task_metrics(args, plan.labels.reshape(-1)[keep], preds[keep])
