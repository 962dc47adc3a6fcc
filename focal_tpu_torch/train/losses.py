"""Loss functions (port of the JAX package's ``train/losses.py``).

FOCAL objective:
  total = 1 * shared InfoNCE (cross-modality, per temporal slot)
        + 1 * private InfoNCE (cross-view, per modality)
        + 3 * orthogonality (shared vs private, private vs private)
        + 5 * temporal ranking (intra-seq distance < inter-seq distance)
with the weights from the recipe. Loss math runs in float32.
"""

import torch
import torch.nn.functional as F


def cross_entropy(logits, labels, weight=None):
    """Mean CE. Accepts integer labels [b] or soft targets [b, C]."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    if labels.dim() == logits.dim():
        per = -(labels * logp).sum(-1)
    else:
        per = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if weight is None:
        return per.mean()
    weight = weight.to(torch.float32)
    return (per * weight).sum() / weight.sum().clamp(min=1.0)


def _l2_normalize(x, eps=1e-12):
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=eps))


def info_nce(emb1, emb2, temperature, finegrain=False):
    """NT-Xent over paired temporal slots. emb1, emb2: [b, seq, d]. With
    finegrain=False the comparison dimension is the batch: for each temporal
    slot, 2b views form positives on the cross-view diagonals and negatives
    everywhere else except self: -sim[r, partner] + logsumexp_{c != r} sim[r, c]."""
    if not finegrain:
        emb1 = emb1.transpose(0, 1)  # [seq, b, d]
        emb2 = emb2.transpose(0, 1)
    n = emb1.shape[1]
    z = _l2_normalize(torch.cat([emb1, emb2], dim=1).to(torch.float32))  # [p, 2n, d]
    sim = torch.einsum("pid,pjd->pij", z, z) / temperature
    idx = torch.arange(2 * n, device=z.device)
    partner = torch.where(idx < n, idx + n, idx - n)
    pos = sim.gather(2, partner[None, :, None].expand(sim.shape[0], -1, 1))[..., 0]
    self_mask = torch.eye(2 * n, dtype=torch.bool, device=z.device)[None]
    denom = torch.logsumexp(sim.masked_fill(self_mask, float("-inf")), dim=2)
    return (denom - pos).mean()


def orthogonality_loss(emb1, emb2):
    """CosineEmbeddingLoss with target=-1: mean(max(0, cos(x1, x2)))."""
    f1 = _l2_normalize(emb1.reshape(-1, emb1.shape[-1]).to(torch.float32))
    f2 = _l2_normalize(emb2.reshape(-1, emb2.shape[-1]).to(torch.float32))
    return F.relu((f1 * f2).sum(-1)).mean()


def temporal_ranking_loss(emb, margin):
    """MarginRankingLoss(margin, y=-1) between the mean intra-subsequence
    and inter-subsequence euclidean distances."""
    n, seq, d = emb.shape
    flat = emb.reshape(n * seq, d).to(torch.float32)
    sq = (flat * flat).sum(1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * flat @ flat.T
    dist = torch.sqrt(torch.clamp(d2, min=1e-12))
    dist = dist.reshape(n, seq, n, seq).permute(0, 2, 1, 3)  # [n, n, seq, seq]
    pair_mask = 1.0 - torch.eye(n * seq, device=emb.device)
    pair_mask = pair_mask.reshape(n, seq, n, seq).permute(0, 2, 1, 3)
    seq_dist = (dist * pair_mask).sum((2, 3)) / pair_mask.sum((2, 3))  # [n, n]
    intra = torch.diagonal(seq_dist)
    hinge = F.relu(intra[:, None] - seq_dist + margin)
    off_diag = 1.0 - torch.eye(n, device=emb.device)
    return (hinge * off_diag).sum() / (n * (n - 1))


def split_features(feat):
    """First half = shared space, second half = private space."""
    d = feat.shape[-1] // 2
    return feat[..., :d], feat[..., d:2 * d]


def make_focal_loss(args):
    """The FOCAL loss of this run's recipe: per-model temperature, and the
    ``noPrivate`` tag (shared InfoNCE on the full features)."""
    config = args.dataset_config["FOCAL"]
    modalities = list(args.dataset_config["modality_names"])
    seq_len = args.dataset_config["seq_len"]
    temp = config["temperature"]
    temperature = temp[args.model] if isinstance(temp, dict) else temp
    no_private = args.tag == "noPrivate"
    weights = (
        config["shared_contrastive_loss_weight"],
        config["private_contrastive_loss_weight"],
        config["orthogonal_loss_weight"],
        config["rank_loss_weight"],
    )
    margin = config["inter_rank_margin"]

    def loss_fn(mod_features1, mod_features2):
        """mod_features*: {mod: [B, dim]} with B = n_subseq * seq_len.
        Returns (total, {"shared", "private", "orthogonality", "ranking"})."""
        f1 = {m: mod_features1[m].reshape(-1, seq_len, mod_features1[m].shape[-1]) for m in modalities}
        f2 = {m: mod_features2[m].reshape(-1, seq_len, mod_features2[m].shape[-1]) for m in modalities}
        s1 = {m: split_features(f1[m]) for m in modalities}
        s2 = {m: split_features(f2[m]) for m in modalities}

        shared = 0.0
        for view_full, view_split in ((f1, s1), (f2, s2)):
            for i, m1 in enumerate(modalities):
                for m2 in modalities[i + 1:]:
                    if no_private:
                        shared = shared + info_nce(view_full[m1], view_full[m2], temperature)
                    else:
                        shared = shared + info_nce(view_split[m1][0], view_split[m2][0], temperature)

        private = 0.0
        for m in modalities:
            private = private + info_nce(s1[m][1], s2[m][1], temperature)

        rank = 0.0
        for view in (f1, f2):
            for m in modalities:
                rank = rank + temporal_ranking_loss(view[m], margin)

        orth = 0.0
        for view in (s1, s2):
            for i, m in enumerate(modalities):
                orth = orth + orthogonality_loss(view[m][0], view[m][1])
                for m2 in modalities[i + 1:]:
                    orth = orth + orthogonality_loss(view[m][1], view[m2][1])

        total = weights[0] * shared + weights[1] * private + weights[2] * orth + weights[3] * rank
        return total, {"shared": shared, "private": private, "orthogonality": orth, "ranking": rank}

    return loss_fn
