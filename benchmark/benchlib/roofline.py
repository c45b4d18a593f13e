"""The yardstick's table of peaks and the bytes and operations of the
port's hand-written kernels, computed from their shapes.

Frozen copies of `chip_smoke.py`'s `bound`, `tri`, `factor_flops`,
`factor_bound` and `solve_bound`: later changes to the program's own
scripts do not move the benchmark's rooflines.

Counting rule: each input byte is read once and each output byte written
once, whatever a kernel reads again. A kernel's least time is the larger
of its bytes over the memory rate and its operations over the peak rate
of its dtype; its roofline share is that least time over its device time.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the float32 and float64
# rates outside the tensor cores (dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 67e12, "float64": 34e12}
WORD = {"float32": 4, "float64": 8}


def bound_s(nbytes, flops, dtype="float32"):
    """Least seconds of a kernel that moves `nbytes` and does `flops`."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S[dtype])


def tri(d):
    """Words of a d x d block's lower triangle: what a kernel reads of a
    symmetric block or a triangular factor."""
    return d * (d + 1) // 2


def factor_flops(T, d):
    """Operations of one lane's block-tridiagonal factor: T Cholesky
    factors (d^3/3 each) and, for the T-1 couplings, M_t = L_t^-1 O_t' (d^3)
    and the symmetric update D_t+1 - M_t' M_t, lower triangle only
    (d^2 (d+1))."""
    return T * d**3 / 3.0 + (T - 1) * (d * d * (d + 1) + d**3)


def factor_cost(B, T, d, dtype="float32"):
    """(bytes, operations) of a block-tridiagonal factor of B lanes: the
    lower triangles of the symmetric D and all of O read; L (its upper
    zeros too, which the contract writes) and M written. T = 1 is the
    dense Cholesky of `factor_t1`."""
    dd = d * d
    words = T * tri(d) + (T - 1) * dd + T * dd + (T - 1) * dd
    return words * WORD[dtype] * B, factor_flops(T, d) * B


def solve_cost(B, T, d, K=1, sweeps=2, dtype="float32"):
    """(bytes, operations) of a block-tridiagonal solve of K right-hand
    sides, both sweeps or one: the lower triangles of L, all of M and the
    right-hand sides read, the result written. T = 1 is `solve_t1`."""
    words = T * tri(d) + (T - 1) * d * d + 2 * T * d * K
    return words * WORD[dtype] * B, 3 * sweeps * d * d * K * T * B


def kernel_cost(name, shape, dtype):
    """(bytes, operations) of one launch of the kernel wrapper `name` on
    its first argument's `shape`: factor_t1 / solve_t1 take (B, n, n),
    factor_lanes / solve_lanes (B, T, d, d)."""
    if name == "factor_t1":
        B, n = shape[0], shape[-1]
        return factor_cost(B, 1, n, dtype)
    if name == "solve_t1":
        B, n = shape[0], shape[-1]
        return solve_cost(B, 1, n, dtype=dtype)
    if name == "factor_lanes":
        B, T, d = shape[0], shape[1], shape[-1]
        return factor_cost(B, T, d, dtype)
    if name == "solve_lanes":
        B, T, d = shape[0], shape[1], shape[-1]
        return solve_cost(B, T, d, dtype=dtype)
    raise KeyError(name)


def share(calls, device, kernels):
    """Percent of the roofline the launches of the wrappers `kernels`
    reached: the sum of each recorded call's least time over the device
    time of the kernels whose names hold "<wrapper>_" (a `trace.
    DeviceSummary`); None where none of them ran."""
    least = sum(bound_s(*kernel_cost(n, shape, dt), dt) for n, shape, dt in calls if n in kernels and shape[0])
    seconds, count = device.seconds(tuple(f"{k}_" for k in kernels))
    if not count or seconds <= 0:
        return None
    return 100.0 * least / seconds
