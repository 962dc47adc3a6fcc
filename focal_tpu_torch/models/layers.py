"""Shared heads and fusion blocks (port of the JAX package's ``models/layers.py``)."""

import torch
import torch.nn as nn
import torch.nn.functional as F


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (no mask, eval): per-head
    q/k/v projections, query scaled by hd**-0.5, softmax over keys, output
    projection. Each flax DenseGeneral kernel ([c, H, hd] for q/k/v,
    [H, hd, c] for out) is held as an ``nn.Linear`` over the flattened heads."""

    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, q_in, kv_in):
        b, lq, c = q_in.shape
        lk = kv_in.shape[1]
        H = self.num_heads
        hd = c // H
        q = self.query(q_in).reshape(b, lq, H, hd).transpose(1, 2) / hd**0.5
        k = self.key(kv_in).reshape(b, lk, H, hd).transpose(1, 2)
        v = self.value(kv_in).reshape(b, lk, H, hd).transpose(1, 2)
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, lq, c)
        return self.out(out)


class AttentionFusion(nn.Module):
    """LayerNorm + mean-query multi-head attention pooling.

    Input [b, i, n, c] -> Output [b, i, c]: the mean over the n fused items
    queries them."""

    def __init__(self, dim, num_heads):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-5)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(dim, num_heads)

    def forward(self, x):
        b, i, n, c = x.shape
        x = self.LayerNorm_0(x.reshape(b * i, n, c))
        query = x.mean(dim=1, keepdim=True)
        return self.MultiHeadDotProductAttention_0(query, x).reshape(b, i, c)


class ProjectionHead(nn.Module):
    """Linear -> ReLU -> Linear."""

    def __init__(self, in_dim, out_dim):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, out_dim)
        self.Dense_1 = nn.Linear(out_dim, out_dim)

    def forward(self, x):
        return self.Dense_1(F.relu(self.Dense_0(x)))


class ClassHead(nn.Module):
    """Linear classifier, or Linear -> exact GELU -> Linear (SSL head)."""

    def __init__(self, in_dim, num_classes, fc_dim, linear=True):
        super().__init__()
        self.linear = linear
        if linear:
            self.Dense_0 = nn.Linear(in_dim, num_classes)
        else:
            self.Dense_0 = nn.Linear(in_dim, fc_dim)
            self.Dense_1 = nn.Linear(fc_dim, num_classes)

    def forward(self, x):
        if self.linear:
            return self.Dense_0(x)
        return self.Dense_1(F.gelu(self.Dense_0(x), approximate="none"))
