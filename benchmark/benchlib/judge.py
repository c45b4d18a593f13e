"""The plain float64 judge of a solve's answer: the first-order optimality
(KKT) conditions of the configuration's problem, written again in its
reference module (`configs/<name>.py`), at the primal-dual point that the
program returned.

It imports nothing of the program and takes from it only the answers it
judges: each sampled lane's primal-dual point (x, s, y, z, t), its
parameters (made by the benchmark) and its solved flag. For

    minimise f(x; theta)  subject to  g(x; theta) = 0,  h(x; theta) in K

with K a product of nonnegative orthants and second-order cones, the
answer is judged on

- stationarity  grad f + Jg' y + Jh' z                     (n rows)
- equality      g                                            (m_e rows)
- cone rows     h - s,  z + t                                (m_c rows each)
- complementarity  s o t (the Jordan product of each cone)
- membership    s in K and t in K

each against the tolerance the configuration states, as the solver's
contract reads it: the residual's 1-norm over the solver's total
dimension n + 2 m_e + 3 m_c, the equality and complementarity in the
largest entry, membership by how far a cone's tail outgrows its head.
A lane's reading is the largest of the four over its tolerance: 1 is the
edge of the contract.
"""

from __future__ import annotations

import torch

FIELDS = ("x", "s", "y", "z", "t")


def split(ref, w):
    """The interleaved [x_0, u_0, x_1, u_1, ..., x_{T-1}] of (B, n) as
    states (B, T, nx) and actions (B, T-1, nu)."""
    T, nx, nu = ref.HORIZON, ref.NUM_STATES, ref.NUM_ACTIONS
    body = w[:, : (T - 1) * (nx + nu)].reshape(w.shape[0], T - 1, nx + nu)
    xs = torch.cat([body[..., :nx], w[:, None, (T - 1) * (nx + nu) :]], dim=1)
    return xs, body[..., nx:]


def dims(ref):
    """(n, m_e, m_c) of the reference problem."""
    T, nx, nu = ref.HORIZON, ref.NUM_STATES, ref.NUM_ACTIONS
    n = T * nx + (T - 1) * nu
    w = torch.zeros((1, n), dtype=torch.float64)
    xs, us = split(ref, w)
    theta = torch.zeros((1, ref.NUM_PARAMETERS), dtype=torch.float64)
    return n, ref.equality(xs, us, theta).shape[1], ref.cone(xs, us, theta).shape[1]


def _cones(ref, v):
    """[(head (B, k), tail (B, k, d-1))] of each run of equal-size cones
    of v (B, m_c); a nonnegative entry is a cone of size 1."""
    sizes = [1] * ref.NONNEGATIVE + list(ref.SECOND_ORDER)
    out, off, i = [], 0, 0
    while i < len(sizes):
        j = i
        while j < len(sizes) and sizes[j] == sizes[i]:
            j += 1
        d, k = sizes[i], j - i
        block = v[:, off : off + d * k].reshape(v.shape[0], k, d)
        out.append((block[..., 0], block[..., 1:]))
        off, i = off + d * k, j
    return out


def _outside(ref, v):
    """(B,) how far v lies outside the cone: the largest |tail| - head."""
    worst = v.new_zeros(v.shape[0])
    for head, tail in _cones(ref, v):
        worst = torch.maximum(worst, (tail.norm(dim=-1) - head).amax(dim=-1))
    return worst


def _product(ref, a, b):
    """The Jordan product a o b = [<a, b>; a_0 b_bar + b_0 a_bar] per cone."""
    parts = []
    for (ha, ta), (hb, tb) in zip(_cones(ref, a), _cones(ref, b)):
        head = ha * hb + (ta * tb).sum(-1)
        tail = ha[..., None] * tb + hb[..., None] * ta
        parts.append(torch.cat([head[..., None], tail], dim=-1).flatten(1))
    return torch.cat(parts, dim=1) if parts else a.new_zeros((a.shape[0], 0))


def readings(ref, tol, point, theta):
    """Per-lane readings of the answers `point` ({field: (B, .)}) with
    parameters theta (B, p), in float64: {"residual", "equality",
    "complementarity", "membership"} each over its tolerance in `tol`
    (the configuration's options), and "worst", their largest; a lane
    with a non-finite entry reads inf."""
    x, s, y, z, t = (point[k].to(torch.float64) for k in FIELDS)
    theta = theta.to(torch.float64)
    n, me, mc = x.shape[1], y.shape[1], z.shape[1]
    with torch.enable_grad():
        w = x.detach().clone().requires_grad_(True)
        xs, us = split(ref, w)
        g, h = ref.equality(xs, us, theta), ref.cone(xs, us, theta)
        lagrangian = ref.objective(xs, us, theta).sum() + (g * y).sum() + (h * z).sum()
        (grad,) = torch.autograd.grad(lagrangian, w)
    g, h = g.detach(), h.detach()
    rows = torch.cat([grad, g, h - s, z + t], dim=1)
    total = n + 2 * me + 3 * mc
    out = {
        "residual": rows.abs().sum(1) / total / tol["residual_tolerance"],
        "equality": (g.abs().amax(1) if me else g.new_zeros(g.shape[0])) / tol["equality_tolerance"],
        "complementarity": (
            _product(ref, s, t).abs().amax(1) if mc else g.new_zeros(g.shape[0])
        ) / tol["complementarity_tolerance"],
        "membership": torch.clamp(torch.maximum(_outside(ref, s), _outside(ref, t)), min=0.0)
        / tol["slack_tolerance"],
    }
    worst = torch.stack(list(out.values())).amax(0)
    finite = torch.stack([torch.isfinite(v).all(1) for v in (x, s, y, z, t)]).all(0)
    out["worst"] = torch.where(finite & torch.isfinite(worst), worst, torch.full_like(worst, float("inf")))
    return out


def judge(ref, tol, point, theta, block=4096):
    """readings() over the lanes of `point` in blocks of `block` lanes,
    returned on the host as float64 tensors."""
    B = theta.shape[0]
    parts = []
    for lo in range(0, B, block):
        sl = slice(lo, lo + block)
        parts.append({k: v.cpu() for k, v in readings(ref, tol, {f: point[f][sl] for f in FIELDS}, theta[sl]).items()})
    if not parts:
        return {k: torch.zeros(0, dtype=torch.float64) for k in ("residual", "equality", "complementarity", "membership", "worst")}
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def sensitivity(ref, point, theta, rho, eps_p, eps_d):
    """The reference's own sensitivity (B, n + 2 m_e, p) of the answer w =
    (x, r, y) to theta, in float64, for a problem without cones: the
    derivative of the system the solve ends on, the augmented-Lagrangian
    first-order conditions at each lane's penalty rho with the last
    regularization (eps_p, eps_d), all three read from the returned state
    (B,) each:

        [H + eps_p I   0               Jg'     ] [dx]     [d/dtheta grad_x L]
        [0             (rho + eps_p) I -I      ] [dr] = - [0                ]
        [Jg            -I              -eps_d I] [dy]     [dg/dtheta        ]

    with H the Hessian of the Lagrangian f + y'g, all by plain autograd."""
    from torch.func import hessian, jacrev, vmap

    if ref.NONNEGATIVE or ref.SECOND_ORDER:
        raise NotImplementedError("the reference sensitivity covers problems without cones")
    f64 = lambda a: a.to(torch.float64)
    x, y, theta, rho, eps_p, eps_d = map(f64, (point["x"], point["y"], theta, rho, eps_p, eps_d))
    B, n, me, p = x.shape[0], x.shape[1], y.shape[1], theta.shape[1]

    def lagrangian(w, yy, th):
        xs, us = split(ref, w[None])
        return ref.objective(xs, us, th[None])[0] + (ref.equality(xs, us, th[None])[0] * yy).sum()

    def equality(w, th):
        xs, us = split(ref, w[None])
        return ref.equality(xs, us, th[None])[0]

    H = vmap(hessian(lagrangian))(x, y, theta)  # (B, n, n)
    Jg = vmap(jacrev(equality))(x, theta)  # (B, me, n)
    Lxt = vmap(jacrev(jacrev(lagrangian), argnums=2))(x, y, theta)  # (B, n, p)
    gt = vmap(jacrev(equality, argnums=1))(x, theta)  # (B, me, p)
    eye = lambda m: torch.eye(m, dtype=x.dtype, device=x.device).expand(B, m, m)
    lane = lambda a: a[:, None, None]
    Z = lambda a, b: x.new_zeros((B, a, b))
    K = torch.cat([
        torch.cat([H + lane(eps_p) * eye(n), Z(n, me), Jg.mT], 2),
        torch.cat([Z(me, n), lane(rho + eps_p) * eye(me), -eye(me)], 2),
        torch.cat([Jg, -eye(me), -lane(eps_d) * eye(me)], 2),
    ], 1)
    rhs = torch.cat([Lxt, Z(me, p), gt], 1)
    return -torch.linalg.solve(K, rhs)


def sensitivity_gap(ref, point, theta, regularization, value, block=16384):
    """Per lane, the largest entry of |program's sensitivity - the
    reference's| over the reference's largest entry, on the host
    (float64). `regularization` is (rho, eps_p, eps_d), (B,) each."""
    out = []
    for lo in range(0, theta.shape[0], block):
        sl = slice(lo, lo + block)
        want = sensitivity(ref, {k: point[k][sl] for k in ("x", "y")}, theta[sl], *(a[sl] for a in regularization))
        got = value[sl].to(torch.float64)
        gap = (got - want).abs().flatten(1).amax(1) / want.abs().flatten(1).amax(1).clamp(min=1e-300)
        out.append(torch.where(torch.isfinite(gap), gap, torch.full_like(gap, float("inf"))).cpu())
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.float64)
