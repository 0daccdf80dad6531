"""Ground-truth solvers + paper metrics for the workload zoo (§5).

Every workload scores itself against a reference computed HERE, on the host,
with dense numpy — no sklearn, no coded machinery:

  * ridge     — closed-form normal-equations optimum (paper Fig 7 plots
                suboptimality against it);
  * LASSO     — high-precision FISTA on the composite objective, plus the
                support-recovery F1 of Fig 14;
  * logistic  — damped Newton on the unregularized logistic loss (the lifted
                BCD problem's exact-optimum family), plus held-out
                classification error (Figs 10-13);
  * MF        — exact alternating ridge (per-entity closed form) as the
                reference test-RMSE for Tables 2-3.

These run at ``smoke``/``bench`` scales (dense solves); ``paper``-preset
callers should expect them to be expensive and can pass ``iters`` down.

Own copy of the reference's ``repro/workloads/ground_truth.py``, line for
line: the scorer stays on the host, independent of the code under test.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "ridge_solution", "ridge_objective", "lasso_fista", "lasso_objective",
    "logistic_newton", "logistic_objective", "classification_error",
    "support_f1", "masked_rmse", "als_reference",
]


# ---------------------------------------------------------------------------
# Ridge
# ---------------------------------------------------------------------------

def ridge_objective(X, y, lam: float, w) -> float:
    """f(w) = 1/(2n)||Xw - y||^2 + lam/2 ||w||^2 — the repo's l2 convention
    (matches ``core.data_parallel.original_objective`` with h='l2')."""
    n = X.shape[0]
    r = X @ w - y
    return float(0.5 * r @ r / n + 0.5 * lam * w @ w)


def ridge_solution(X, y, lam: float) -> np.ndarray:
    """Closed-form ridge optimum (X^T X / n + lam I)^-1 X^T y / n."""
    n, p = X.shape
    return np.linalg.solve(X.T @ X / n + lam * np.eye(p), X.T @ y / n)


# ---------------------------------------------------------------------------
# LASSO
# ---------------------------------------------------------------------------

def lasso_objective(X, y, lam: float, w) -> float:
    """f(w) = 1/(2n)||Xw - y||^2 + lam ||w||_1."""
    n = X.shape[0]
    r = X @ w - y
    return float(0.5 * r @ r / n + lam * np.abs(w).sum())


def lasso_fista(X, y, lam: float, *, iters: int = 4000,
                tol: float = 1e-12) -> np.ndarray:
    """High-precision FISTA reference solve of the composite objective."""
    n, p = X.shape
    L = float(np.linalg.eigvalsh(X.T @ X / n).max())
    step = 1.0 / L
    w = np.zeros(p)
    z = w.copy()
    t = 1.0
    f_prev = lasso_objective(X, y, lam, w)
    for _ in range(iters):
        g = X.T @ (X @ z - y) / n
        v = z - step * g
        w_new = np.sign(v) * np.maximum(np.abs(v) - step * lam, 0.0)
        t_new = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t * t))
        z = w_new + ((t - 1.0) / t_new) * (w_new - w)
        w, t = w_new, t_new
        f = lasso_objective(X, y, lam, w)
        if abs(f_prev - f) < tol * max(1.0, abs(f)):
            break
        f_prev = f
    return w


def support_f1(w_hat, w_true, tol: float = 1e-3) -> float:
    """F1 of the recovered support {|w_i| > tol} vs the true support."""
    nz_hat = np.abs(np.asarray(w_hat)) > tol
    nz_true = np.abs(np.asarray(w_true)) > 0
    tp = float((nz_hat & nz_true).sum())
    prec = tp / max(nz_hat.sum(), 1)
    rec = tp / max(nz_true.sum(), 1)
    return 2 * prec * rec / max(prec + rec, 1e-9)


# ---------------------------------------------------------------------------
# Logistic
# ---------------------------------------------------------------------------

def logistic_objective(X, labels, w) -> float:
    """phi(Xw) = mean log(1 + exp(-l_i x_i^T w)), labels in {-1, +1} —
    identical to ``core.model_parallel.phi_logistic``'s value."""
    z = np.asarray(X) @ np.asarray(w)
    return float(np.mean(np.logaddexp(0.0, -np.asarray(labels) * z)))


def logistic_newton(X, labels, *, iters: int = 50, ridge: float = 1e-8,
                    tol: float = 1e-10) -> np.ndarray:
    """Damped-Newton minimizer of the unregularized logistic loss.

    ``ridge`` is a tiny Hessian jitter for conditioning only (the data the
    logistic workload generates is non-separable, so the minimizer is
    finite).  Halves the step until the objective decreases.
    """
    X = np.asarray(X, np.float64)
    l = np.asarray(labels, np.float64)
    n, p = X.shape
    w = np.zeros(p)
    f = logistic_objective(X, l, w)
    for _ in range(iters):
        z = X @ w
        s = 0.5 * (1.0 - np.tanh(0.5 * l * z))   # sigma(-l z), overflow-safe
        g = -(X.T @ (l * s)) / n
        d = s * (1.0 - s)                        # sigma'(l z)
        H = (X.T * d) @ X / n + ridge * np.eye(p)
        step = np.linalg.solve(H, g)
        alpha = 1.0
        while alpha > 1e-8:
            w_new = w - alpha * step
            f_new = logistic_objective(X, l, w_new)
            if f_new <= f:
                break
            alpha *= 0.5
        if abs(f - f_new) < tol * max(1.0, abs(f)):
            w = w_new
            break
        w, f = w_new, f_new
    return w


def classification_error(X, labels, w) -> float:
    """Fraction of sign disagreements — the paper's held-out error metric."""
    pred = np.sign(np.asarray(X) @ np.asarray(w))
    pred[pred == 0] = 1.0
    return float(np.mean(pred != np.asarray(labels)))


# ---------------------------------------------------------------------------
# Matrix factorization
# ---------------------------------------------------------------------------

def masked_rmse(pred, R, mask) -> float:
    return float(np.sqrt(np.mean((pred[mask] - R[mask]) ** 2)))


def als_reference(R, train, test, *, rank: int = 4, lam: float = 0.3,
                  epochs: int = 8, seed: int = 1):
    """Exact (per-entity closed-form ridge) alternating least squares.

    Centers at 3.0 and fits biased factors ``[U | bu]``, ``[V | bv]`` like
    the MF workload; the reference every coded inner solver is judged
    against.  Returns (train_rmse, test_rmse).
    """
    users, movies = R.shape
    rng = np.random.default_rng(seed)
    Ub = np.concatenate([rng.standard_normal((users, rank)) * 0.1,
                         np.zeros((users, 1))], axis=1)
    Vb = np.concatenate([rng.standard_normal((movies, rank)) * 0.1,
                         np.zeros((movies, 1))], axis=1)
    Rc = R - 3.0
    for _ in range(epochs):
        for side in ("u", "v"):
            fixed = Vb if side == "u" else Ub
            mask = train if side == "u" else train.T
            targ = Rc if side == "u" else Rc.T
            out = Ub if side == "u" else Vb
            F = np.concatenate([fixed[:, :rank], np.ones((fixed.shape[0], 1))],
                               axis=1)
            for i in range(out.shape[0]):
                obs = np.nonzero(mask[i])[0]
                if obs.size == 0:
                    continue
                Fi = F[obs]
                nobs = mask.sum()  # global count: matches the joint solve
                A = Fi.T @ Fi / nobs + lam * np.eye(rank + 1)
                out[i] = np.linalg.solve(A, Fi.T @ targ[i, obs] / nobs)
    pred = 3.0 + Ub[:, :rank] @ Vb[:, :rank].T + Ub[:, rank:] + Vb[:, rank:].T
    return masked_rmse(pred, R, train), masked_rmse(pred, R, test)
