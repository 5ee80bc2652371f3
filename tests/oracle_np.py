"""Independent NumPy oracle for the reference solver recurrences.

Hand-written re-statements of the update rules documented in SURVEY.md §7
(behavioral contract) — used to check the JAX solvers *step for step*. Written
for clarity, not speed: float64 throughout, explicit state, no timing, no
globals. Every function takes the Lipschitz constant / start vector explicitly
so both implementations consume identical inputs.
"""
from __future__ import annotations

import numpy as np

C_ARMIJO = 1e-2  # reference module constant C (iterative_solvers.py:11)


def shrink(v, thr):
    return np.sign(v) * np.maximum(np.abs(v) - thr, 0.0)


def objective_np(x, A, b, a1, a2):
    r = A @ x - b
    return 0.5 * r @ r + 0.5 * a2 * x @ x + a1 * np.abs(x).sum()


def power_L(A, v0, n_iter=100, tol=1e-6):
    """Reference power-iteration recurrence (iterative_solvers.py:45-60) with
    an explicit start vector."""
    v = v0 / np.linalg.norm(v0)
    prev = np.inf
    L = 0.0
    for _ in range(n_iter):
        w = A.T @ (A @ v)
        L = np.linalg.norm(w)
        v = w / L
        if abs(L - prev) < tol:
            break
        prev = L
    return L


def _smooth(A, b, a2):
    def g(z):
        r = A @ z - b
        return 0.5 * r @ r + 0.5 * a2 * z @ z

    def dg(z):
        return A.T @ (A @ z - b) + a2 * z

    return g, dg


def _armijo(g, grad, point, tau, a1, eta, max_bt=60):
    """Backtracking prox search; returns (x_new, tau, n_backtracks)."""
    g0 = g(point)
    bt = 0
    while True:
        x_new = shrink(point - tau * grad, tau * a1)
        if g(x_new) <= g0 + C_ARMIJO * grad @ (x_new - point) or bt >= max_bt:
            return x_new, tau, bt
        tau *= eta
        bt += 1


def ista_np(
    A, b, a1, a2, L,
    backtracking=False, eta=0.5, t_init_factor=1.0, max_iter=500, tol=0.0,
):
    g, dg = _smooth(A, b, a2)
    x = np.zeros(A.shape[1])
    tau = t_init_factor / L
    trace = {"x": [x.copy()], "obj": [], "step": []}
    for _ in range(max_iter):
        grad = dg(x)
        if backtracking:
            x_new, tau, _ = _armijo(g, grad, x, tau, a1, eta)
        else:
            x_new = shrink(x - tau * grad, tau * a1)
        step = np.linalg.norm(x_new - x)
        x = x_new
        trace["x"].append(x.copy())
        trace["obj"].append(objective_np(x, A, b, a1, a2))
        trace["step"].append(step)
        if tol > 0.0 and step < tol:
            break
    return x, trace


def fista_np(
    A, b, a1, a2, L,
    backtracking=False, eta=0.5, t_init_factor=1.0, max_iter=500,
    tol=0.0, tol_ratio=0.0, adaptive_restart=False, restart_threshold=1.0,
    delta=None, greedy=False, greedy_xi=1.3, greedy_S=1.02,
    greedy_shrink=0.96,
):
    """FISTA (delta=None), FISTA-Δ (delta > 2) or greedy FISTA trajectory.

    ``greedy``: Liang & Schönlieb's greedy FISTA as the batched driver
    states it per step (batch/fista_gram.py): step ξ/L, unit momentum, a
    restart when ⟨y − x⁺, x⁺ − x⟩ ≥ 0, and τ shrunk toward 1/L on a restart
    or once a step outgrows S·‖x₁ − x₀‖.

    Returns (x, trace) where trace logs post-update iterates and objectives.
    """
    g, dg = _smooth(A, b, a2)
    n = A.shape[1]
    x = np.zeros(n)
    y = x.copy()
    x_prev = x.copy()
    t_mom = 1.0
    tau = (greedy_xi if greedy else t_init_factor) / L
    first_step = 0.0
    trace = {"x": [], "obj": [], "step": [], "n_iters": 0}
    for k in range(1, max_iter + 1):
        grad = dg(y)
        if tol > 0.0 and np.linalg.norm(grad) < tol:
            break
        if backtracking:
            x_next, tau, _ = _armijo(g, grad, y, tau, a1, eta)
        else:
            x_next = shrink(y - tau * grad, tau * a1)

        this_step = np.linalg.norm(x_next - x)
        prev_step = np.linalg.norm(x - x_prev)
        ratio = this_step / prev_step if prev_step > 0 else np.inf

        if greedy:
            restart = (y - x_next) @ (x_next - x) >= 0.0
            y = x_next.copy() if restart else 2.0 * x_next - x
            first_step = this_step if first_step == 0.0 else first_step
            if restart or this_step > greedy_S * first_step:
                tau = max(greedy_shrink * tau, 1.0 / L)
        elif delta is not None:
            theta = k / (k + 1 + delta)
            y = x_next + theta * (x_next - x)
        elif adaptive_restart and ratio > restart_threshold:
            t_mom = 1.0
            y = x_next.copy()
        else:
            t_new = 0.5 * (1 + np.sqrt(1 + 4 * t_mom**2))
            y = x_next + ((t_mom - 1) / t_new) * (x_next - x)
            t_mom = t_new

        x_prev, x = x, x_next
        trace["x"].append(x.copy())
        trace["obj"].append(objective_np(x, A, b, a1, a2))
        trace["step"].append(this_step)
        trace["n_iters"] = k
        if tol > 0.0 and this_step < tol:
            break
        if tol_ratio > 0.0 and ratio < tol_ratio:
            break
    return x, trace


def tv1d_np(y, lam, n_iter=20000):
    """1D total-variation denoising oracle: accelerated projected gradient on
    the dual  min_{‖w‖∞ ≤ λ} ½‖y − Dᵀw‖²  (x = y − Dᵀw), float64.

    Independent of the library's ADMM path — a different algorithm on a
    different (dual) formulation; λmax(DDᵀ) < 4 gives the fixed 1/4 step.
    """
    y = np.asarray(y, np.float64)
    n = y.shape[0]
    w = np.zeros(n - 1)
    v = w.copy()
    t = 1.0
    Dt = lambda u: np.concatenate([[-u[0]], u[:-1] - u[1:], [u[-1]]])
    D = lambda x: x[1:] - x[:-1]
    for _ in range(n_iter):
        grad = D(Dt(v) - y)
        w_new = np.clip(v - 0.25 * grad, -lam, lam)
        t_new = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t * t))
        v = w_new + ((t - 1.0) / t_new) * (w_new - w)
        w, t = w_new, t_new
    return y - Dt(w)
