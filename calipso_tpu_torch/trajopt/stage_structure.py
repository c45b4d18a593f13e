"""Static stage-structure metadata of a trajopt problem: per-stage column
blocks of the interleaved [x1,u1,...,xT] layout and row spans of the
constraint blocks, with gather/scatter tables between flat vectors and
padded (T, d_max) block form. The counterpart of
`calipso_tpu/trajopt/stage_structure.py`; every method takes any leading
axes (the lane axis first)."""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch


class EqSpan(NamedTuple):
    row_start: int
    num_rows: int
    stage: int
    two_stage: bool  # dynamics rows couple stages (stage, stage+1)
    next_width: int  # nx_{t+1} for two-stage spans


class ConeSpan(NamedTuple):
    row_start: int
    num_rows: int
    stage: int


class StageStructure:
    def __init__(
        self,
        col_starts: List[int],
        col_dims: List[int],
        eq_spans: List[EqSpan],
        cone_spans: List[ConeSpan],
        has_general: bool,
        num_general: int = 0,
        general_stages: Tuple[int, ...] = (),
    ):
        self.col_starts = col_starts
        self.col_dims = col_dims
        self.eq_spans = eq_spans
        self.cone_spans = cone_spans
        self.has_general = has_general
        # general-equality rows are the LAST num_general rows of the flat
        # equality block; general_stages are the stages they touch
        self.num_general = int(num_general)
        self.general_stages = tuple(int(t) for t in general_stages)
        self.horizon = len(col_dims)
        self.dmax = max(col_dims)
        n = col_starts[-1] + col_dims[-1]
        self.num_variables = n

        T, dmax = self.horizon, self.dmax
        blk_idx = np.full((T, dmax), n, dtype=np.int64)  # sentinel -> 0 pad
        inv_t = np.zeros(n, dtype=np.int64)
        inv_o = np.zeros(n, dtype=np.int64)
        for t, (cs, d) in enumerate(zip(col_starts, col_dims)):
            blk_idx[t, :d] = np.arange(cs, cs + d)
            inv_t[cs : cs + d] = t
            inv_o[cs : cs + d] = np.arange(d)
        self.blk_idx = blk_idx
        self.inv_t = inv_t
        self.inv_o = inv_o
        self._on_device = {}

    def tensor(self, key, value, device):
        """`value` (a static numpy array or list) as a tensor on `device`,
        made once per (key, device): a copy from host memory to the card
        waits for the card's queue, so the solve loop must not make one
        per call."""
        k = (key, str(device))
        if k not in self._on_device:
            self._on_device[k] = torch.as_tensor(value, device=device)
        return self._on_device[k]

    def pad_mask(self, device):
        """(T, dmax) bool: the padded slots of ragged stages."""
        return self.tensor("pad_mask", self.blk_idx == self.num_variables, device)

    def to_blocks(self, v):
        """(..., n) flat -> (..., T, dmax) padded with zeros."""
        vpad = torch.cat([v, v.new_zeros(v.shape[:-1] + (1,))], dim=-1)
        return vpad[..., self.tensor("blk_idx", self.blk_idx, v.device)]

    def from_blocks(self, V):
        """(..., T, dmax) -> (..., n) flat."""
        it = self.tensor("inv_t", self.inv_t, V.device)
        io = self.tensor("inv_o", self.inv_o, V.device)
        return V[..., it, io]

    def densify(self, D, O):
        """Stage-block tridiagonal (D (..., T, dmax, dmax), O (..., T-1,
        dmax, dmax)) -> dense symmetric (..., n, n), by slice writes."""
        n = self.num_variables
        out = D.new_zeros(D.shape[:-3] + (n, n))
        for t in range(self.horizon):
            cs, d = self.col_starts[t], self.col_dims[t]
            out[..., cs : cs + d, cs : cs + d] = D[..., t, :d, :d]
        for t in range(self.horizon - 1):
            cs0, d0 = self.col_starts[t], self.col_dims[t]
            cs1, d1 = self.col_starts[t + 1], self.col_dims[t + 1]
            blk = O[..., t, :d1, :d0]
            out[..., cs1 : cs1 + d1, cs0 : cs0 + d0] = blk
            out[..., cs0 : cs0 + d0, cs1 : cs1 + d1] = blk.mT
        return out

    def band_matvec(self, D, O, v):
        """y = S v for the stage-block tridiagonal S given as (D, O) and a
        flat (..., n) vector v, without forming S."""
        Vb = self.to_blocks(v)
        out = torch.einsum("...tab,...tb->...ta", D, Vb)
        if self.horizon > 1:
            lower = torch.einsum("...tab,...tb->...ta", O, Vb[..., :-1, :])
            upper = torch.einsum("...tab,...ta->...tb", O, Vb[..., 1:, :])
            zero = out.new_zeros(out.shape[:-2] + (1, out.shape[-1]))
            out = out + torch.cat([zero, lower], dim=-2) + torch.cat([upper, zero], dim=-2)
        return self.from_blocks(out)
