"""Per-lane norms over the last axis (empty vectors have norm 0).

Every function reduces over the last axis only, so a (B, m) batch gives
(B,) norms and one lane's NaN never reaches another lane."""

import math

import torch


def inf_norm(v):
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return v.abs().amax(dim=-1)


def one_norm(v):
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return v.abs().sum(dim=-1)


def norm_p(v, p):
    """||v||_p over the last axis for p in {1, 2, inf} (any other p > 0
    takes the general formula)."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    if p == 1.0 or p == 1:
        return one_norm(v)
    if p == 2.0 or p == 2:
        return torch.sqrt((v * v).sum(dim=-1))
    if math.isinf(p):
        return inf_norm(v)
    return (v.abs() ** p).sum(dim=-1) ** (1.0 / p)
