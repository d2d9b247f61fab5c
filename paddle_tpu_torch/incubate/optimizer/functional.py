"""Functional quasi-Newton minimizers of the PyTorch port (counterpart of
``paddle_tpu/incubate/optimizer/functional.py``; reference
python/paddle/incubate/optimizer/functional/{bfgs,lbfgs}.py):
``minimize_bfgs`` / ``minimize_lbfgs`` returning (is_converge,
num_func_calls, position, objective_value, objective_gradient).

The JAX package traces the whole minimization into one
``lax.while_loop``; the port runs the same iteration as a host loop of
eager ops, with the objective's gradient from ``torch.autograd.grad``.
The line search (backtracking under the Armijo rule), the first
iteration's scaling of the inverse Hessian, the curvature guard
(s.y > 1e-10), the L-BFGS rolling history of ``min(history_size,
max_iters)`` slots and the stopping rules are the JAX package's, so
iterations and objective calls count the same. Scalars stay tensors of
the position's dtype, as in the traced loop.
"""
import numpy as np
import torch

__all__ = ["minimize_bfgs", "minimize_lbfgs"]

_C1 = 1e-4


def _dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "float64": torch.float64}[str(dtype)]


def _prep(initial_position, dtype):
    x0 = initial_position if isinstance(initial_position, torch.Tensor) \
        else torch.as_tensor(np.asarray(initial_position))
    return x0.detach().to(_dtype(dtype)).reshape(-1).clone(), x0.shape


def _value_and_grad(objective_func, shape):
    def vg(x):
        with torch.enable_grad():
            xv = x.detach().requires_grad_(True)
            f = objective_func(xv.reshape(shape)).reshape(())
            (g,) = torch.autograd.grad(f, xv)
        return f.detach().to(x.dtype), g.detach()
    return vg


def _line_search(vg, xk, fk, gk, pk, max_ls, alpha0):
    """Backtracking line search with the Armijo sufficient-decrease rule.
    Returns (alpha, f_new, g_new, evaluations)."""
    gtp = torch.dot(gk, pk)
    alpha_try = torch.tensor(alpha0, dtype=xk.dtype, device=xk.device)
    fv, gv = vg(xk + alpha_try * pk)
    alpha_eval = alpha_try
    done = bool(fv <= fk + _C1 * alpha_try * gtp)
    if not done:
        alpha_try = alpha_try * 0.5
    it = 1
    while it < max_ls and not done:
        fv, gv = vg(xk + alpha_try * pk)
        done = bool(fv <= fk + _C1 * alpha_try * gtp)
        alpha_eval = alpha_try
        if not done:
            alpha_try = alpha_try * 0.5
        it += 1
    return alpha_eval, fv, gv, it


def _result(conv, calls, x, fv, g, shape):
    dev = x.device
    return (torch.tensor(bool(conv), device=dev),
            torch.tensor(calls, dtype=torch.int32, device=dev),
            x.reshape(shape), fv, g.reshape(shape))


def minimize_bfgs(objective_func, initial_position, max_iters=50,
                  tolerance_grad=1e-7, tolerance_change=1e-9,
                  initial_inverse_hessian_estimate=None,
                  line_search_fn="strong_wolfe", max_line_search_iters=50,
                  initial_step_length=1.0, dtype="float32", name=None):
    """Minimize ``objective_func`` (a tensor of the initial position's
    shape -> a scalar tensor) from ``initial_position`` with BFGS."""
    x, shape = _prep(initial_position, dtype)
    vg = _value_and_grad(objective_func, shape)
    n = x.shape[0]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    if initial_inverse_hessian_estimate is not None:
        H = torch.as_tensor(np.asarray(initial_inverse_hessian_estimate)) \
            if not isinstance(initial_inverse_hessian_estimate,
                              torch.Tensor) \
            else initial_inverse_hessian_estimate.detach()
        H = H.to(dtype=x.dtype, device=x.device)
    else:
        H = eye.clone()
    fv, g = vg(x)
    calls, k = 1, 0
    conv = bool(g.abs().max() < tolerance_grad)
    while k < max_iters and not conv:
        p = -(H @ g)
        alpha, f1, g1, evals = _line_search(
            vg, x, fv, g, p, int(max_line_search_iters),
            float(initial_step_length))
        sk = alpha * p
        x1 = x + sk
        yk = g1 - g
        sy = torch.dot(sk, yk)
        good = bool(sy > 1e-10)
        rho = 1.0 / sy if good else torch.zeros_like(sy)
        yy = torch.dot(yk, yk)
        Hs = (sy / (yy if bool(yy > 0) else torch.ones_like(yy))) * eye \
            if k == 0 and good else H
        if good:
            V = eye - rho * torch.outer(sk, yk)
            H = V @ Hs @ V.T + rho * torch.outer(sk, sk)
        conv = bool(g1.abs().max() < tolerance_grad) or \
            bool(sk.abs().max() < tolerance_change)
        k, x, fv, g, calls = k + 1, x1, f1, g1, calls + evals
    return _result(conv, calls, x, fv, g, shape)


def minimize_lbfgs(objective_func, initial_position, history_size=100,
                   max_iters=50, tolerance_grad=1e-7, tolerance_change=1e-9,
                   initial_inverse_hessian_estimate=None,
                   line_search_fn="strong_wolfe", max_line_search_iters=50,
                   initial_step_length=1.0, dtype="float32", name=None):
    """Limited-memory BFGS over a rolling history of
    ``min(history_size, max_iters)`` pairs (the two-loop recursion in age
    order; an empty slot has rho 0); same return tuple as
    ``minimize_bfgs``."""
    x, shape = _prep(initial_position, dtype)
    vg = _value_and_grad(objective_func, shape)
    m = int(min(history_size, max(1, max_iters)))
    n = x.shape[0]
    S = torch.zeros((m, n), dtype=x.dtype, device=x.device)
    Y = torch.zeros_like(S)
    R = torch.zeros(m, dtype=x.dtype, device=x.device)
    gamma = torch.ones((), dtype=x.dtype, device=x.device)

    def direction(g, k):
        q = g
        a = torch.zeros(m, dtype=g.dtype, device=g.device)
        for j in range(m):
            i = (k - 1 - j) % m
            ai = R[i] * torch.dot(S[i], q)
            q = q - ai * Y[i]
            a[i] = ai
        r = gamma * q
        for j in range(m):
            i = (k - m + j) % m
            bi = R[i] * torch.dot(Y[i], r)
            r = r + S[i] * (a[i] - bi)
        return -r

    fv, g = vg(x)
    calls, k = 1, 0
    conv = bool(g.abs().max() < tolerance_grad)
    while k < max_iters and not conv:
        p = direction(g, k)
        alpha, f1, g1, evals = _line_search(
            vg, x, fv, g, p, int(max_line_search_iters),
            float(initial_step_length))
        sk = alpha * p
        x1 = x + sk
        yk = g1 - g
        sy = torch.dot(sk, yk)
        if bool(sy > 1e-10):
            slot = k % m
            S[slot], Y[slot], R[slot] = sk, yk, 1.0 / sy
            gamma = sy / torch.dot(yk, yk)
        conv = bool(g1.abs().max() < tolerance_grad) or \
            bool(sk.abs().max() < tolerance_change)
        k, x, fv, g, calls = k + 1, x1, f1, g1, calls + evals
    return _result(conv, calls, x, fv, g, shape)
