"""A model of where the fused solve past d = 32
(`solve_batched_fused_wide_kernel`, `csrc/riccati_fused.cu`) and
`factor_stream` past d = 64 (`factor_stream_wide_kernel`,
`csrc/riccati_stream.cu`) keep their stacked panel, checked on the CPU
for every width from 33 to 300 in float32 and float64: the panel ((2d +
1) rows of `panel_ld` words and r_t's d words for the fused solve, 2d rows
for the factor; rows 16-byte aligned for 16-byte loads where that fits) and
the failure flag in a block's opt-in shared memory on an H100 where they
fit, else (the fused solve alone) in the lane's workspace after L_t and
M_t' (`fused_workspace`: (2T - 1) d^2 words, and the panel's where it is
not on chip); every address the kernels form
inside its array and the blocks disjoint, in both layouts; every index
they compute in int within `shape_ok`'s T d (d + 1) <= 2^31 - 1; and the
walk that deals a product's 32 x 16 blocks to the warps
(`wide::update`), for the Schur update and each trailing update of the
32-column blocks, writing each element of its region once and none
outside it; and the wide stream sweeps' shared memory and their deal of
32 x 32 tiles to the warps (`sweep_wide`, `csrc/riccati_stream.cu`). The
model's formulas are the kernels', written again in numpy; the card runs the kernels themselves
(`tests/test_torch_cuda_kernels.py`, `chip_smoke.py` phases 12c, 12e)."""

import numpy as np
import pytest

from calipso_tpu_torch.ops import cuda_riccati

OPTIN = 232_448  # a block's opt-in shared memory on an H100, bytes
WORD = {"float32": 4, "float64": 8}
THREADS = {"float32": 384, "float64": 256}  # wide::Threads
FLAG = 16  # wide::kFlagBytes
WIDTHS = range(33, 301)


def panel_ld(word, d, vec):
    """wide::panel_ld: with 16-byte loads an odd number of 16-byte pieces,
    else an odd number of words."""
    return ((d * word + 15) // 16 | 1) * (16 // word) if vec else d | 1


def fused_panel_words(word, d, vec):
    """fused_panel_words: 2d + 1 rows of panel_ld, then r_t (d)."""
    return (2 * d + 1) * panel_ld(word, d, vec) + d


def fused_panel_bytes(word, d, vec):
    return (word * fused_panel_words(word, d, vec) + 15) // 16 * 16


def plan(word, d):
    """wide_plan: 2, the panel in shared memory with 16-byte loads; 1, with
    scalar loads; 0, in the workspace (with 16-byte loads)."""
    limit = OPTIN - FLAG
    return 2 if fused_panel_bytes(word, d, True) <= limit else (1 if fused_panel_bytes(word, d, False) <= limit else 0)


def on_chip(word, d):
    return plan(word, d) > 0


def fused_smem(word, d):
    p = plan(word, d)
    return fused_panel_bytes(word, d, p == 2) + FLAG if p else FLAG


def panel_offset(word, T, d):
    """fused_panel_offset: after L_t and M_t', at a multiple of 16 bytes."""
    per = 16 // word
    return ((2 * T - 1) * d * d + per - 1) // per * per


def workspace_words(word, T, d):
    """fused_workspace past d = 32: words a lane, a multiple of 16 bytes."""
    per = 16 // word
    words = (2 * T - 1) * d * d if on_chip(word, d) else panel_offset(word, T, d) + fused_panel_words(word, d, True)
    return (words + per - 1) // per * per


def factor_smem(word, d, vec=False):
    """factor_wide_smem: 2d rows of panel_ld, and the flag."""
    return word * 2 * d * panel_ld(word, d, vec) + FLAG


def spans(T, d, word):
    """The (first, last) word of each block the fused kernel addresses, by
    name, in shared memory and in the lane's workspace: L_t's element (i,
    j <= i) at t d^2 + i d + j, M_t''s (c, j) at (T + t) d^2 + c d + j; the
    panel's row r (r <= 2d) column j at r ld + j and r_t's j at (2d + 1)
    ld + j, from the panel's start (shared memory, or the workspace after
    M_{T-2}', 16-byte aligned); the backward sweep's x_{t+1}, r and two
    32 x 33 diagonal blocks at the panel's first 2d + 2112 words; the flag
    after the panel in shared memory."""
    p = plan(word, d)
    ld, dd = panel_ld(word, d, p != 1), d * d
    work = {f"L{t}": (t * dd, t * dd + (d - 1) * d + d - 1) for t in range(T)}
    work.update({f"M{t}": ((T + t) * dd, (T + t) * dd + (d - 1) * d + d - 1) for t in range(T - 1)})
    panel = {"P": (0, 2 * d * ld + d - 1), "r_t": ((2 * d + 1) * ld, (2 * d + 1) * ld + d - 1)}
    assert 2 * d + 2 * 32 * 33 - 1 <= panel["P"][1]  # the backward sweep's vectors and blocks
    if p:
        smem = dict(panel)
        first = fused_panel_bytes(word, d, p == 2) // word
        smem["flag"] = (first, first + FLAG // word - 1)
        return smem, work
    base = panel_offset(word, T, d)
    assert base * word % 16 == 0
    work.update({k: (base + a, base + z) for k, (a, z) in panel.items()})
    return {"flag": (0, FLAG // word - 1)}, work


def disjoint(blocks):
    ordered = sorted(blocks.values())
    return all(a[1] < b[0] for a, b in zip(ordered, ordered[1:]))


@pytest.mark.parametrize("T", [1, 2, 8, 31])
@pytest.mark.parametrize("name", ["float32", "float64"])
def test_wide_plan_fits_and_stays_inside(name, T):
    word = WORD[name]
    for d in WIDTHS:
        smem_bytes = fused_smem(word, d)
        assert smem_bytes <= OPTIN, d
        words = workspace_words(word, T, d)
        smem, work = spans(T, d, word)
        assert disjoint(smem) and disjoint(work), d
        assert max(last for _, last in smem.values()) < smem_bytes // word
        assert all(first >= 0 for first, _ in list(smem.values()) + list(work.values()))
        assert max(last for _, last in work.values()) < words, d
        # the int indices: t d + i < T d, i d + j < d^2, a lane's x T d
        # words; the panel's rows, t d^2 and the lane's workspace in 64 bits
        assert max(T * d, d * d) <= T * d * (d + 1)


@pytest.mark.parametrize("name,vec_last,last", [("float32", 167, 169), ("float64", 118, 119)])
def test_wide_tiers_change_where_the_kernel_says(name, vec_last, last):
    """The fused solve's panel fits on chip with 16-byte loads to d = 167 in
    float32 and 118 in float64, with scalar loads to 169 and 119, and the
    workspace takes it past; at phase 12e's shapes past that, (4, 5, 170),
    (4, 5, 121) and the widest, (16, 8, 256) and (16, 8, 192), the lanes'
    workspaces are 5.1 MB, 5.2 MB, 71 MB and 80 MB; a lane's words are a
    multiple of 16 bytes, so that every lane's panel is 16-byte aligned."""
    word = WORD[name]
    assert [plan(word, d) for d in (vec_last, vec_last + 1, last, last + 1)] == [2, 1, 1, 0]
    assert all(plan(word, d) == 2 for d in range(33, vec_last + 1))
    assert all(plan(word, d) == 0 for d in range(last + 1, 301))
    shapes = [((4, 5, 170), 5.1), ((16, 8, 256), 71)] if name == "float32" else [((4, 5, 121), 5.2), ((16, 8, 192), 80)]
    for (B, T, d), mb in shapes:
        assert round(B * workspace_words(word, T, d) * word / 1e6, 1 if mb < 10 else 0) == mb
    for T in (1, 2, 8, 31):
        for d in range(33, 301):
            assert workspace_words(word, T, d) * word % 16 == 0


@pytest.mark.parametrize("name", ["float32", "float64"])
def test_stream_panel_fits_to_max_d(name):
    """factor_stream's panel and flag fit a block to the stream kernels'
    MAX_D (169 in float32, 120 in float64) and not one past it, with
    16-byte loads to 168 and 119 (wide_max_d), and the strip rows of its
    first panel, 2d - 8, fit one row a thread."""
    word = WORD[name]
    top = cuda_riccati.MAX_D[getattr(__import__("torch"), name)]
    assert factor_smem(word, top) <= OPTIN < factor_smem(word, top + 1)
    assert factor_smem(word, top - 1, True) <= OPTIN < factor_smem(word, top, True)
    assert 2 * top - 8 <= THREADS[name]


def walk(j, R, cend, d, warps):
    """wide::update's walk of the region rows [j, R) x columns [j, cend)
    (the lower triangle where the row is below d): column group c0 = j + 16
    g has ceil((R - c0) / 32) blocks from its diagonal down, block m of the
    walk goes to warp m mod warps; lane l of a block at (r0, c0) takes the
    rows r0 + (l & 7) + 8 i and the columns c0 + (l >> 3) + 4 j. Returns
    the count of writes of each element of an R x d array."""
    hits = np.zeros((R, d), int)
    for warp in range(warps):
        c0, nb, m = j, (R - j + 31) >> 5, warp
        while c0 < cend:
            if m >= nb:
                m -= nb
                c0 += 16
                nb = (R - c0 + 31) >> 5
                continue
            for lane in range(32):
                r0, cc = c0 + 32 * m + (lane & 7), c0 + (lane >> 3)
                if r0 >= R or cc >= cend:
                    continue
                for i in range(4):
                    for jj in range(4):
                        r, c = r0 + 8 * i, cc + 4 * jj
                        if r < R and c < cend and (r >= d or r >= c):
                            hits[r, c] += 1
            m += warps
    return hits


@pytest.mark.parametrize("d", [33, 65, 121, 165, 169, 170])
@pytest.mark.parametrize("name", ["float32", "float64"])
def test_update_walk_writes_each_element_once(name, d):
    """The Schur update (rows [0, d + 1) with the r row, and [0, d)
    without), each 8-wide panel's update of its 32-column block's later
    columns (rows [jt, R), columns [jt, p1)) and each block's update of the
    columns past it (rows and columns from p1), for the fused panel R = 2d
    + 1, d + 1 at its last stage, and the factor's 2d and d: every element
    of the region written once, none outside it."""
    warps = THREADS[name] // 32
    cases = [(0, d + 1, d), (0, d, d)]
    for p0 in range(0, d, 32):
        p1 = min(p0 + 32, d)
        cases += [(jt, p1) for jt in range(p0 + 8, p1, 8)] + ([(p1, d)] if p1 < d else [])
    cases = cases[:2] + [(j, R, cend) for j, cend in cases[2:] for R in (2 * d + 1, d + 1, 2 * d, d)]
    for j, R, cend in cases:
        hits = walk(j, R, cend, d, warps)
        r, c = np.meshgrid(np.arange(R), np.arange(d), indexing="ij")
        inside = (r >= j) & (c >= j) & (c < cend) & ((r >= d) | (r >= c))
        assert (hits[inside] == 1).all() and (hits[~inside] == 0).all(), (j, R, cend)


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


# The wide stream sweeps past d = 64 (`sweep_wide`, csrc/riccati_stream.cu):
# 2 NB warps a block (NB = ceil(d / 32) diagonal blocks), shared memory
# the two diagonal-block slots (32 rows of 33 words) and two right-hand
# sides of 2 NB columns of 32 NB rows; in each block of a stage every warp
# takes at most one tile.
SWEEP_BLK, SWEEP_LDB = 32, 33
DEFAULT_SMEM = 48 * 1024  # a launch's shared memory without the raised limit


def sweep_layout(word, d):
    """(NB, warps, rows a column, {region: (first word, words)}, bytes)."""
    nb = -(-d // SWEEP_BLK)
    nw, ldr = 2 * nb, SWEEP_BLK * nb
    slot = SWEEP_BLK * SWEEP_LDB
    regions = {"Lb0": (0, slot), "Lb1": (slot, slot), "rc": (2 * slot, nw * ldr), "rn": (2 * slot + nw * ldr, nw * ldr)}
    return nb, nw, ldr, regions, word * (2 * slot + 2 * nw * ldr)


def sweep_tiles(nb, qq, couple, fwd):
    """The kernel's deal of one block's tiles: warp -> (kind, row group,
    coupling), kinds "diag" (the next diagonal block), "row" and "col"."""
    nw = 2 * nb
    q = qq if fwd else nb - 1 - qq
    has_next = qq + 1 < nb or couple
    n_upd = nb - 1 - qq
    out = {}
    for warp in range(nw):
        k = nw - 1 - warp - (1 if has_next else 0)
        if k == -1:
            out[warp] = ("diag", None, False)
        elif 0 <= k < n_upd:
            out[warp] = ("row" if fwd else "col", q + 1 + k if fwd else k, False)
        elif k >= n_upd and couple and k - n_upd < nb:
            out[warp] = ("col" if fwd else "row", k - n_upd, True)
    return out


@pytest.mark.parametrize("fwd", [True, False])
@pytest.mark.parametrize("name", ["float32", "float64"])
def test_wide_sweep_layout_and_tiles(name, fwd):
    """For every d from 65 to MAX_D: shared memory under the default 48 KB
    (no raised limit), the four regions disjoint, every address a column
    warp or a tile forms (for K up to the chunk, 2 NB columns) inside its
    region, a diagonal slot's row and column reads in 32 distinct banks;
    in every block of a stage, with and without a next stage, each tile
    dealt to exactly one warp: the next diagonal block where there is
    one, the block's update of each row group still to solve (forward the
    groups below, backward those above), the coupling of each row group
    where there is a next stage, and nothing else."""
    word = WORD[name]
    for d in range(65, cuda_riccati.MAX_D[getattr(__import__("torch"), name)] + 1):
        nb, nw, ldr, regions, nbytes = sweep_layout(word, d)
        assert nbytes <= DEFAULT_SMEM
        assert disjoint({k: (a, a + n - 1) for k, (a, n) in regions.items()})
        lane = np.arange(32)
        for jj in range(SWEEP_BLK):  # the diagonal solve's reads of a slot
            for idx in (lane * SWEEP_LDB + jj, jj * SWEEP_LDB + lane):
                assert idx.max() < SWEEP_BLK * SWEEP_LDB and len(set(idx % 32)) == 32
        for KC in range(1, nw + 1):
            for q in range(nb):  # the column warps' reads and writes
                idx = np.add.outer(np.arange(KC) * ldr, SWEEP_BLK * q + lane)
                assert idx.min() >= 0 and idx.max() < regions["rc"][1]
            for g in range(nb):  # a tile's writes, rows below d
                rows = SWEEP_BLK * g + lane
                idx = np.add.outer(np.arange(KC) * ldr, rows[rows < d])
                assert idx.max() < regions["rc"][1]
        for couple in (False, True):
            for qq in range(nb):
                q = qq if fwd else nb - 1 - qq
                tiles = list(sweep_tiles(nb, qq, couple, fwd).values())
                assert len(tiles) <= nw
                want = [("diag", None, False)] if qq + 1 < nb or couple else []
                todo = range(q + 1, nb) if fwd else range(q)
                want += [("row" if fwd else "col", g, False) for g in todo]
                if couple:
                    want += [("col" if fwd else "row", g, True) for g in range(nb)]
                assert sorted(tiles, key=str) == sorted(want, key=str)
