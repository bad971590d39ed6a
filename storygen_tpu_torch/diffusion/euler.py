"""Euler discrete and Euler ancestral samplers.

Counterpart of storygen_tpu/diffusion/euler.py: sigma_t = sqrt((1 -
acp_t) / acp_t) (the k-diffusion parameterization), the sample carried in
sigma space (x = x0 + sigma eps) and the model input scaled by 1 /
sqrt(sigma^2 + 1). The model is eps-prediction, so the derivative dx /
dsigma is its output. prev_t < 0 (past the last step) means sigma = 0.
"""
from __future__ import annotations

import torch

from storygen_tpu_torch.diffusion.schedule import (NoiseSchedule, _bcast,
                                                   _gather)


def sigma_of(sched: NoiseSchedule, t) -> torch.Tensor:
    acp = _gather(sched.alphas_cumprod, t)
    return ((1.0 - acp) / acp).sqrt()


def _sigmas(sched: NoiseSchedule, t, prev_t, ndim: int):
    """(sigma_t, sigma_prev_t) broadcast to `ndim` dims."""
    s = _bcast(sigma_of(sched, t).reshape(-1), ndim)
    prev_t = torch.as_tensor(prev_t, device=s.device)
    s_next = sigma_of(sched, prev_t.clamp(min=0))
    s_next = torch.where(prev_t >= 0, s_next, torch.zeros_like(s_next))
    return s, _bcast(s_next.reshape(-1), ndim)


def scale_model_input(sched: NoiseSchedule, sample: torch.Tensor,
                      t) -> torch.Tensor:
    sigma = _bcast(sigma_of(sched, t).reshape(-1), sample.dim())
    return (sample.float() / (sigma ** 2 + 1.0).sqrt()).to(sample.dtype)


def euler_step(sched: NoiseSchedule, model_output: torch.Tensor, t, prev_t,
               sample: torch.Tensor) -> torch.Tensor:
    """The deterministic Euler update in sigma space."""
    s, s_next = _sigmas(sched, t, prev_t, sample.dim())
    return (sample.float() + model_output.float() * (s_next - s)
            ).to(sample.dtype)


def euler_ancestral_step(sched: NoiseSchedule, model_output: torch.Tensor,
                         t, prev_t, sample: torch.Tensor,
                         noise: torch.Tensor) -> torch.Tensor:
    """Euler ancestral: a step down to sigma_down, then `noise` scaled by
    sigma_up."""
    s, s_next = _sigmas(sched, t, prev_t, sample.dim())
    var_up = s_next ** 2 * (s ** 2 - s_next ** 2) / (s ** 2).clamp(min=1e-12)
    sigma_up = var_up.clamp(min=0.0).sqrt()
    sigma_down = (s_next ** 2 - sigma_up ** 2).clamp(min=0.0).sqrt()
    x = sample.float() + model_output.float() * (sigma_down - s)
    return (x + noise.float() * sigma_up).to(sample.dtype)
