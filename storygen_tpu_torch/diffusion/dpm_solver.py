"""DPM-Solver++(2M): the second-order multistep ODE sampler.

Counterpart of storygen_tpu/diffusion/dpm_solver.py (Lu et al. 2022,
arXiv:2211.01095, algorithm 2M, data prediction):
  alpha_t = sqrt(acp_t), sigma_t = sqrt(1 - acp_t),
  lambda_t = log(alpha_t / sigma_t), h_i = lambda_i - lambda_{i-1},
  r = h_{i-1} / h_i,
  D = (1 + 1/(2r)) x0_i - 1/(2r) x0_{i-1}      (first step: D = x0_i)
  x_i = (sigma_i / sigma_{i-1}) x_{i-1} - alpha_i (exp(-h_i) - 1) D
The state carries the previous data prediction and its timestep, a
Python int (-1 before the first step), so the first-step branch is taken
on the host.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from storygen_tpu_torch.diffusion.schedule import (NoiseSchedule, _bcast,
                                                   _gather,
                                                   pred_original_sample)


class DPMState(NamedTuple):
    prev_x0: torch.Tensor  # fp32 data prediction at the previous step
    prev_t: int            # its timestep; -1 = none yet


def init_state(sample: torch.Tensor) -> DPMState:
    return DPMState(torch.zeros_like(sample, dtype=torch.float32), -1)


def _alpha_sigma_lambda(sched: NoiseSchedule, t, ndim: int):
    acp = _bcast(_gather(sched.alphas_cumprod, t), ndim)
    alpha, sigma = acp.sqrt(), (1.0 - acp).sqrt()
    return alpha, sigma, alpha.log() - sigma.log()


def dpmpp_2m_step(sched: NoiseSchedule, model_output: torch.Tensor, t: int,
                  prev_t: int, sample: torch.Tensor, state: DPMState
                  ) -> Tuple[torch.Tensor, DPMState]:
    """One DPM-Solver++(2M) update x_t -> x_{prev_t}; past the last step
    (prev_t < 0) it returns the data prediction, the ODE's end point."""
    x = sample.float()
    x0, _ = pred_original_sample(sched, model_output, t, sample)
    new_state = DPMState(x0, int(t))
    if prev_t < 0:
        return x0.to(sample.dtype), new_state
    nd = x.dim()
    _, sigma_s, lam_s = _alpha_sigma_lambda(sched, t, nd)
    alpha_d, sigma_d, lam_d = _alpha_sigma_lambda(sched, prev_t, nd)
    h = lam_d - lam_s
    if state.prev_t < 0:
        d = x0
    else:
        _, _, lam_p = _alpha_sigma_lambda(sched, state.prev_t, nd)
        r = (lam_s - lam_p) / h
        d = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * state.prev_x0
    x_next = (sigma_d / sigma_s) * x - alpha_d * (torch.exp(-h) - 1.0) * d
    return x_next.to(sample.dtype), new_state
