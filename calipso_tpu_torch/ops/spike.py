"""Horizon-sharded block-tridiagonal solve (SPIKE / partitioned Schur
elimination), batch-first: the counterpart of `calipso_tpu/ops/spike.py`.

The ranks of a `parallel.mesh.Mesh` split the T stages of a (B, T)
batch of stage-block tridiagonal systems into P contiguous chunks of
Tc = T / P stages; a chunk's last stage is its separator. Every rank
holds the whole replicated system and:
  1. factors its chunk's interior (Tc - 1 stages) with `ops/riccati.factor`
     and eliminates it against the two adjacent separators: one
     `ops/riccati.solve_multi` whose K = 2d right-hand sides are the
     boundary couplings [E ; F'];
  2. gathers every chunk's three d x d Schur pieces (one `all_gather`) and
     factors the P-block separator system on every rank;
  3. solves: the interior forward (`ops/riccati.solve` or `solve_multi`),
     the separators' right-hand sides gathered (one `all_gather`) and
     solved on every rank, its interior back-substituted,
       x_i = A^{-1} r - (A^{-1} E) x_{sep, p-1} - (A^{-1} F') x_{sep, p},
     and the chunks of x gathered (one `all_gather`), so that every rank
     returns the same whole x, as the reference's `out_specs` give the
     code outside its `shard_map`.
A factorization moves 3 B d^2 numbers a rank, a solve 2 B d K and the
chunks of x. The local factor and solves are the lanes and stream
kernels of `ops/riccati` on CUDA tensors (no kernel of its own: the
reference's module reaches no Pallas kernel either); the separator
assembly and the back-substitution are small batched products.

Coupling convention: D (B, T, d, d) diagonal blocks, O (B, T-1, d, d)
sub-diagonal blocks as in `ops/riccati.py` (block row t+1 holds O_t left
of D_{t+1}); inside this module `Oin` (B, T, d, d) holds O shifted one
stage down, Oin[:, t] the coupling into stage t, Oin[:, 0] = 0, so that
the stage axis splits evenly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from calipso_tpu_torch.ops import riccati as rc
from calipso_tpu_torch.parallel.mesh import Mesh


class SpikeFactor(NamedTuple):
    """One rank's share of a sharded factorization, every tensor lane-first:
    the interior factor L (B, Tc-1, d, d), M (B, Tc-2, d, d), the boundary
    eliminations G_E = A^{-1} E and G_F = A^{-1} F' (B, Tc-1, d, d), the
    couplings E (into the chunk's first stage) and F (into its separator)
    (B, d, d), the separator system's factor Ls (B, P, d, d), Ms (B,
    P-1, d, d), the same on every rank, and the mesh whose ranks share
    it, which the solves and the reductions over the ranks read."""

    L: torch.Tensor
    M: torch.Tensor
    G_E: torch.Tensor
    G_F: torch.Tensor
    E: torch.Tensor
    F: torch.Tensor
    Ls: torch.Tensor
    Ms: torch.Tensor
    mesh: Mesh


def to_inbound(O, T):
    """O (B, T-1, d, d) in `ops/riccati.py`'s convention -> Oin (B, T, d, d)
    with Oin[:, 0] = 0."""
    return torch.cat([O.new_zeros((O.shape[0], 1) + O.shape[2:]), O], dim=1)


def check_split(T, P):
    """Refuse a horizon T that does not split into P chunks of >= 2 stages."""
    if T % P != 0 or T // P < 2:
        raise ValueError(f"horizon {T} must split into {P} chunks of >= 2 stages")


def _chunk(mesh, T):
    """This rank's stages."""
    Tc = T // mesh.size
    return slice(mesh.rank * Tc, (mesh.rank + 1) * Tc)


def _mv(A, v):
    """A @ v for one column v (B, d) or K columns v (B, d, K)."""
    return A @ v if v.dim() == 3 else (A @ v[..., None])[..., 0]


def _at_stages(G, x):
    """G (B, S, d, d) applied to the one x (B, d) or (B, d, K) at each of
    its S stages."""
    return (G @ x[:, None, :, None])[..., 0] if x.dim() == 2 else G @ x[:, None]


def _gathered(mesh, pieces):
    """Every rank's `pieces` (a list of (B, ...) tensors stacked on axis
    1), lane-first: (B, P, len(pieces), ...)."""
    return mesh.all_gather(torch.stack(pieces, dim=1)).movedim(0, 1)


def _separator_rhs(g):
    """own[k] - prev[k + 1] for the gathered (B, P, 2, ...) pieces (own,
    prev): the separator system's diagonal blocks or right-hand side."""
    out = g[:, :, 0].clone()
    out[:, :-1] -= g[:, 1:, 1]
    return out


def factor_local(D_loc, Oin_loc, mesh) -> SpikeFactor:
    """This rank's factorization of its chunk, D_loc and Oin_loc (B, Tc, d,
    d), Tc >= 2; every rank of `mesh` calls it at once (one all_gather)."""
    B, Tc, d, _ = D_loc.shape
    if Tc < 2:
        raise ValueError("horizon sharding needs >= 2 stages a rank")
    E = Oin_loc[:, 0]  # from the previous chunk's separator (0 on rank 0)
    F = Oin_loc[:, Tc - 1]  # from the interior's last stage into the separator
    L, M = rc.factor(D_loc[:, :-1], Oin_loc[:, 1 : Tc - 1])
    R = D_loc.new_zeros((B, Tc - 1, d, 2 * d))
    R[:, 0, :, :d] = E
    R[:, Tc - 2, :, d:] = F.mT
    X = rc.solve_multi(L, M, R)
    G_E, G_F = X[..., :d], X[..., d:]
    diag_own = D_loc[:, Tc - 1] - F @ G_F[:, Tc - 2]  # D_sep - F A^{-1} F'
    diag_prev = E.mT @ G_E[:, 0]  # E' A^{-1} E: the previous separator's
    off_prev = -F @ G_E[:, Tc - 2]  # couples the own separator to the previous
    g = _gathered(mesh, [diag_own, diag_prev, off_prev])
    Ls, Ms = rc.factor(_separator_rhs(g), g[:, 1:, 2])
    return SpikeFactor(L, M, G_E, G_F, E, F, Ls, Ms, mesh)


def apply_local(f: SpikeFactor, b_loc):
    """This rank's chunk of x for its chunk b_loc (B, Tc, d) or (B, Tc, d,
    K) of the right-hand side; every rank of `f.mesh` calls it at once
    (one all_gather)."""
    mesh, Tc = f.mesh, b_loc.shape[1]
    solve = rc.solve_multi if b_loc.dim() == 4 else rc.solve
    u = solve(f.L, f.M, b_loc[:, :-1])  # A^{-1} r
    rhs_own = b_loc[:, Tc - 1] - _mv(f.F, u[:, Tc - 2])
    rhs_prev = _mv(f.E.mT, u[:, 0])
    x_sep = solve(f.Ls, f.Ms, _separator_rhs(_gathered(mesh, [rhs_own, rhs_prev])))
    x_own = x_sep[:, mesh.rank]
    x_int = u - _at_stages(f.G_F, x_own)
    if mesh.rank > 0:  # rank 0 has no previous separator (E = 0)
        x_int = x_int - _at_stages(f.G_E, x_sep[:, mesh.rank - 1])
    return torch.cat([x_int, x_own[:, None]], dim=1)


def solve_local(D_loc, Oin_loc, b_loc, mesh):
    """factor_local and apply_local in one call: this rank's chunk of x."""
    return apply_local(factor_local(D_loc, Oin_loc, mesh), b_loc)


def factor_sharded(D, O, mesh) -> SpikeFactor:
    """Factor the block-tridiagonal systems D (B, T, d, d), O (B, T-1, d,
    d) with the horizon sharded over `mesh`: this rank's SpikeFactor (the
    "spike" backend's factorize; one all_gather). T must split into
    mesh.size chunks of at least 2 stages."""
    T = D.shape[1]
    check_split(T, mesh.size)
    c = _chunk(mesh, T)
    return factor_local(D[:, c], to_inbound(O, T)[:, c], mesh)


def solve_fact(fact: SpikeFactor, b):
    """x (B, T, d) for b (B, T, d), or (B, T, d, K) for b (B, T, d, K),
    against a factor_sharded factorization: the same whole x on every
    rank (two all_gathers)."""
    mesh, T = fact.mesh, b.shape[1]
    check_split(T, mesh.size)
    x_loc = apply_local(fact, b[:, _chunk(mesh, T)])
    x = mesh.all_gather(x_loc).movedim(0, 1)  # (B, P, Tc, d[, K])
    return x.reshape((b.shape[0], T) + tuple(b.shape[2:]))


def factors_finite(fact: SpikeFactor):
    """(B,) bool, the same on every rank: every interior and separator
    Cholesky factor of the lane finite on every rank of `fact.mesh` (the
    inertia signal, as riccati's finite factor; one all_reduce)."""
    ok = torch.isfinite(fact.L).flatten(1).all(dim=1) & torch.isfinite(fact.Ls).flatten(1).all(dim=1)
    return fact.mesh.all_reduce(ok, dist.ReduceOp.MIN)


def solve_sharded(D, O, b, mesh):
    """x (B, T, d) of the block-tridiagonal systems D (B, T, d, d), O (B,
    T-1, d, d) for b (B, T, d), the horizon sharded over `mesh`."""
    return solve_fact(factor_sharded(D, O, mesh), b)
