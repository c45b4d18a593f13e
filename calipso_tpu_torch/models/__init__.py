"""Example systems written in torch. Each module exposes a `*_problem(...)`
builder returning a dict of TrajOptSolver arguments plus initialization
trajectories. Only the pendulum is ported so far (the other models are
ROADMAP Queue 1 items 11, 12 and 21)."""
