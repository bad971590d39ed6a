"""LMS (linear multistep) sampler over the k-diffusion sigma space.

Counterpart of storygen_tpu/diffusion/lms.py: the Adams-Bashforth idea of
PLMS in sigma space (x = x0 + sigma eps) with exact per-step
coefficients, the integral of the Lagrange polynomial through the eps
history over [sigma_i, sigma_{i+1}] (diffusers LMSDiscreteScheduler). The
integrand has degree <= 3, so 3-point Gauss-Legendre integrates it
exactly. Timesteps are floats (linspace, not the DDIM grid); the tables
are built on the host in float64, and the carried state is a (4, ...)
derivative ring, newest last.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from storygen_tpu_torch.configs import SchedulerConfig
from storygen_tpu_torch.diffusion.schedule import make_betas


class LMSState(NamedTuple):
    derivatives: torch.Tensor  # (4, B, ...) fp32 eps history, newest at [3]


def init_state(sample: torch.Tensor) -> LMSState:
    return LMSState(torch.zeros((4,) + tuple(sample.shape),
                                dtype=torch.float32, device=sample.device))


def lms_tables(cfg: SchedulerConfig, num_inference_steps: int,
               order: int = 4
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(t_eval fp32 (n,), sigmas fp32 (n+1,), coeffs fp64 (n, order)).

    t_eval: linspace(0, T-1, n) descending. sigmas: sqrt((1-acp)/acp)
    interpolated linearly at t_eval, then a trailing 0. coeffs[i, j]
    weights the j-th-newest derivative at step i, zero beyond
    min(i+1, order)."""
    n = num_inference_steps
    t_eval = np.linspace(0, cfg.num_train_timesteps - 1, n,
                         dtype=np.float64)[::-1].copy()
    # float64 alphas: the Lagrange denominators are differences of nearby
    # sigmas, which amplify fp32 roundoff ~30x into the coefficients. Off
    # the linear schedules the fp32 table is used, as in the JAX package.
    acp = np.cumprod(1.0 - make_betas(cfg))
    if cfg.beta_schedule not in ("scaled_linear", "linear"):
        acp = acp.astype(np.float32).astype(np.float64)
    sig_all = ((1.0 - acp) / acp) ** 0.5
    sigmas = np.interp(t_eval, np.arange(cfg.num_train_timesteps), sig_all)
    sigmas = np.concatenate([sigmas, [0.0]])

    gl_x, gl_w = np.polynomial.legendre.leggauss(3)
    coeffs = np.zeros((n, order), dtype=np.float64)
    for i in range(n):
        k = min(i + 1, order)
        a, bnd = sigmas[i], sigmas[i + 1]
        tau = 0.5 * (bnd - a) * gl_x + 0.5 * (bnd + a)  # [-1, 1] -> [a, b]
        for j in range(k):
            # the Lagrange basis of sigma_{i-j} through sigma_i .. sigma_{i-k+1}
            prod = np.ones_like(tau)
            for m in range(k):
                if m != j:
                    prod *= (tau - sigmas[i - m]) / (sigmas[i - j]
                                                     - sigmas[i - m])
            coeffs[i, j] = 0.5 * (bnd - a) * float((gl_w * prod).sum())
    return t_eval.astype(np.float32), sigmas.astype(np.float32), coeffs


def scale_model_input(sample: torch.Tensor, sigma) -> torch.Tensor:
    """The UNet's input x / sqrt(sigma^2 + 1)."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=sample.device)
    return (sample.float() / (sigma ** 2 + 1.0).sqrt()).to(sample.dtype)


def lms_step(eps: torch.Tensor, coeffs_row, sample: torch.Tensor,
             state: LMSState) -> Tuple[torch.Tensor, LMSState]:
    """One LMS update x_i -> x_{i+1} in sigma space; `coeffs_row` is
    coeffs[i] (4,), zero-padded, so the sum over the whole ring is exact
    while the ring still holds zeros."""
    ring = torch.cat([state.derivatives[1:], eps.float()[None]])
    # coeffs_row[j] weights the j-th-newest derivative, ring[3 - j]
    w = torch.as_tensor(np.asarray(coeffs_row, np.float32)[::-1].copy(),
                        device=ring.device)
    upd = torch.tensordot(w, ring, dims=([0], [0]))
    return (sample.float() + upd).to(sample.dtype), LMSState(ring)
