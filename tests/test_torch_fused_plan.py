"""A model of where the fused solve past d = 32
(`solve_batched_fused_wide_kernel`, `csrc/riccati_fused.cu`) keeps its
factor, checked on the CPU for every width from 33 to 300 in float32 and
float64: the three tiers of `wide_tier` (the horizon's L and M in shared
memory; else L and M in the lane's workspace and the stage S_t in shared
memory; else all of it in the workspace), each within a block's opt-in
shared memory on an H100; every address the kernel forms for L_t, M_t and
the stage inside its array, the workspace's inside the lane's (2T - 1) d
(d + 1) words of `fused_workspace`, in both layouts; no two blocks
overlapping; and every index the kernel computes in int within
`shape_ok`'s T d (d + 1) <= 2^31 - 1. The model's formulas are the
kernel's, written again in numpy; the card runs the kernel itself
(`tests/test_torch_cuda_kernels.py`, `chip_smoke.py` phase 12e)."""

import numpy as np
import pytest

from calipso_tpu_torch.ops import cuda_riccati

OPTIN = 232_448  # a block's opt-in shared memory on an H100, bytes
WORD = {"float32": 4, "float64": 8}
WIDTHS = range(33, 301)


def wide_smem(word, tier, T, d):
    """wide_smem: v and r (d + 1 words each), plus the horizon's 2T - 1
    blocks of d (d + 1) words (tier 1), the stage's one (tier 2) or none."""
    ld = d + 1
    return word * (2 * ld + {1: 2 * T - 1, 2: 1, 3: 0}[tier] * d * ld)


def wide_tier(word, T, d):
    return next(tier for tier in (1, 2, 3) if wide_smem(word, tier, T, d) <= OPTIN or tier == 3)


def workspace_words(word, T, d):
    """fused_workspace past d = 32: words a lane."""
    return 0 if wide_tier(word, T, d) == 1 else (2 * T - 1) * d * (d + 1)


def block_spans(T, d, tier, batch_last):
    """The (first, last) word of each block the kernel addresses, by name,
    relative to its array's start for one lane: in shared memory v, r,
    the stage S (tier 2) and, in tier 1, L_t and M_t; in the workspace
    (tiers 2 and 3) L_t and M_t. L_t's element (i, j) at t blk + i ld + j
    (i >= j), M_t's column c at row c: R[c ld + i] batch-first and, as
    O_t' lands, R[j ld + i] for the element (i, j) batch-last, the same
    words."""
    ld, blk = d + 1, d * (d + 1)
    i, j = np.meshgrid(np.arange(d), np.arange(d), indexing="ij")
    lower = i >= j
    L_off = (i * ld + j)[lower]
    M_off = (j * ld + i) if batch_last else (i * ld + j)
    smem = {"v": (0, d - 1), "r": (ld, ld + d - 1)}
    horizon = {}
    Lf = 2 * ld if tier == 1 else 0
    for t in range(T):
        horizon[f"L{t}"] = (Lf + t * blk + int(L_off.min()), Lf + t * blk + int(L_off.max()))
    for t in range(T - 1):
        base = Lf + T * blk + t * blk
        horizon[f"M{t}"] = (base + int(M_off.min()), base + int(M_off.max()))
    if tier == 2:
        smem["S"] = (2 * ld + int(L_off.min()), 2 * ld + int(L_off.max()))
    if tier == 1:
        smem.update(horizon)
        return smem, {}
    return smem, horizon


def disjoint(spans):
    ordered = sorted(spans.values())
    return all(a[1] < b[0] for a, b in zip(ordered, ordered[1:]))


@pytest.mark.parametrize("T", [1, 2, 8, 31])
@pytest.mark.parametrize("name", ["float32", "float64"])
def test_wide_plan_fits_and_stays_inside(name, T):
    word = WORD[name]
    for d in WIDTHS:
        tier = wide_tier(word, T, d)
        smem_bytes = wide_smem(word, tier, T, d)
        assert smem_bytes <= OPTIN, (d, tier)
        words = workspace_words(word, T, d)
        for batch_last in (False, True):
            smem, work = block_spans(T, d, tier, batch_last)
            assert disjoint(smem) and disjoint(work), (d, tier)
            assert max(last for _, last in smem.values()) < smem_bytes // word
            assert all(first >= 0 for first, _ in list(smem.values()) + list(work.values()))
            if work:
                assert max(last for _, last in work.values()) < words, (d, tier)
            else:
                assert words == 0
        # the int indices: t d + i < T d, i ld + j < d (d + 1), a row of the
        # transposes T d^2 words; all within T d (d + 1) of shape_ok
        assert max(T * d, d * (d + 1), T * d * d) <= T * d * (d + 1)


@pytest.mark.parametrize("name,stage_to", [("float32", 239), ("float64", 168)])
def test_wide_tiers_change_where_the_kernel_says(name, stage_to):
    """The stage fits on chip to d = 239 in float32 and 168 in float64
    ((d + 1)(d + 2) words), the whole horizon at T = 5, d = 65 in float32
    and not in float64; the workspaces at phase 12e's widest shapes are
    63 MB and 71 MB."""
    word = WORD[name]
    assert wide_tier(word, 5, stage_to) == 2 and wide_tier(word, 5, stage_to + 1) == 3
    assert wide_tier(word, 5, 65) == (1 if name == "float32" else 2)
    assert wide_tier(word, 8, 54) == (1 if name == "float32" else 2)  # the quadruped's
    B, T, d = (16, 8, 256) if name == "float32" else (16, 8, 192)
    assert wide_tier(word, T, d) == 3
    assert round(B * workspace_words(word, T, d) * word / 1e6) == (63 if name == "float32" else 71)


def test_the_int_range_is_the_wrappers_limit():
    """The wrappers refuse the first shapes past T d (d + 1) <= 2^31 - 1
    and take the last ones inside it (checked on shapes alone)."""
    limit = cuda_riccati.FUSED_MAX_INDEX
    assert limit == 2**31 - 1
    for T, d in ((1, 46340), (130, 4063), (2**31 // 2 - 1, 1)):
        assert T * d * (d + 1) <= limit
        cuda_riccati._fused_fits(T, d)
    for T, d in ((1, 46341), (130, 4064), (2**30, 1)):
        assert T * d * (d + 1) > limit
        with pytest.raises(ValueError, match="int indices"):
            cuda_riccati._fused_fits(T, d)
