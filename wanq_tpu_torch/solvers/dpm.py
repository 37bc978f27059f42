"""Flow-matching DPM-Solver++ multistep scheduler (counterpart of
wanq_tpu/solvers/dpm.py).

The dpmsolver++ algorithm: orders 1-3, ``midpoint`` / ``heun`` second
order, flow matching alpha_t = 1 - sigma, the x0-prediction
x0 = sample - sigma_t * model_output, and the lower-order-final /
euler-at-final step logic. The coefficients are host floats (float64, as in
the JAX package); the tensor updates are PyTorch expressions on the latents'
device, in their dtype (float32 in the pipelines).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch


def get_sampling_sigmas(sampling_steps: int, shift: float) -> np.ndarray:
    """The shifted sigmas of ``sampling_steps`` steps, descending from 1."""
    sigma = np.linspace(1, 0, sampling_steps + 1)[:sampling_steps]
    return shift * sigma / (1 + (shift - 1) * sigma)


def retrieve_timesteps(scheduler, num_inference_steps=None, sigmas=None, **kw):
    """Set the scheduler's timesteps from a step count or from ``sigmas``;
    returns (timesteps, their count)."""
    if sigmas is not None:
        scheduler.set_timesteps(sigmas=sigmas, **kw)
    else:
        scheduler.set_timesteps(num_inference_steps, **kw)
    return scheduler.timesteps, len(scheduler.timesteps)


def _alpha_sigma(sigma: float) -> Tuple[float, float]:
    return 1.0 - sigma, sigma


def _lambda(sigma: float) -> float:
    # clamp both ends: sigma = 1 (alpha = 0) and sigma = 0 would hit log(0)
    alpha, s = _alpha_sigma(sigma)
    return float(np.log(max(alpha, 1e-12)) - np.log(max(s, 1e-12)))


@dataclasses.dataclass
class FlowDPMSolverMultistepScheduler:
    """Host-side scheduler driving tensor updates (dpmsolver++ only, as Wan
    uses it)."""

    num_train_timesteps: int = 1000
    solver_order: int = 2
    shift: float = 1.0
    use_dynamic_shifting: bool = False
    algorithm_type: str = "dpmsolver++"
    solver_type: str = "midpoint"
    lower_order_final: bool = True
    euler_at_final: bool = False
    final_sigmas_type: str = "zero"

    def __post_init__(self):
        if self.algorithm_type != "dpmsolver++":
            raise ValueError(f"only dpmsolver++ is implemented, got {self.algorithm_type!r}")
        if self.solver_type not in ("midpoint", "heun"):
            raise ValueError(f"unknown solver_type {self.solver_type!r}")
        alphas = np.linspace(1, 1 / self.num_train_timesteps,
                             self.num_train_timesteps)[::-1].copy()
        sigmas = 1.0 - alphas
        if not self.use_dynamic_shifting:
            sigmas = self.shift * sigmas / (1 + (self.shift - 1) * sigmas)
        self.sigma_min = float(sigmas[-1])
        self.sigma_max = float(sigmas[0])
        self.sigmas = sigmas
        self.timesteps = sigmas * self.num_train_timesteps
        self._reset_state()

    def _reset_state(self):
        self.model_outputs: List[Optional[torch.Tensor]] = [None] * self.solver_order
        self.lower_order_nums = 0
        self._step_index: Optional[int] = None
        self.num_inference_steps: Optional[int] = None

    def set_timesteps(self, num_inference_steps: Optional[int] = None,
                      sigmas: Optional[np.ndarray] = None, shift: Optional[float] = None,
                      mu: Optional[float] = None):
        if sigmas is None:
            sigmas = np.linspace(self.sigma_max, self.sigma_min,
                                 num_inference_steps + 1).copy()[:-1]
            if self.use_dynamic_shifting:
                sigmas = np.exp(mu) / (np.exp(mu) + (1 / sigmas - 1) ** 1.0)
            else:
                if shift is None:
                    shift = self.shift
                sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
        sigma_last = 0.0 if self.final_sigmas_type == "zero" else self.sigma_min
        timesteps = sigmas * self.num_train_timesteps
        self.sigmas = np.concatenate([sigmas, [sigma_last]]).astype(np.float64)
        self.timesteps = np.asarray(timesteps).astype(np.int64)
        self._reset_state()
        self.num_inference_steps = len(timesteps)

    @property
    def step_index(self):
        return self._step_index

    def _sigma(self, offset: int) -> float:
        return float(self.sigmas[self._step_index + offset])

    def _first_order(self, m0, sample):
        sigma_t, sigma_s = self._sigma(1), self._sigma(0)
        alpha_t, sig_t = _alpha_sigma(sigma_t)
        _, sig_s = _alpha_sigma(sigma_s)
        h = _lambda(sigma_t) - _lambda(sigma_s)
        return (sig_t / sig_s) * sample - float(alpha_t * (np.exp(-h) - 1.0)) * m0

    def _second_order(self, sample):
        sigma_t, sigma_s0, sigma_s1 = self._sigma(1), self._sigma(0), self._sigma(-1)
        alpha_t, sig_t = _alpha_sigma(sigma_t)
        _, sig_s0 = _alpha_sigma(sigma_s0)
        h = _lambda(sigma_t) - _lambda(sigma_s0)
        r0 = (_lambda(sigma_s0) - _lambda(sigma_s1)) / h
        m0, m1 = self.model_outputs[-1], self.model_outputs[-2]
        d0 = m0
        d1 = (1.0 / r0) * (m0 - m1)
        c = float(alpha_t * (np.exp(-h) - 1.0))
        if self.solver_type == "midpoint":
            return (sig_t / sig_s0) * sample - c * d0 - (0.5 * c) * d1
        return ((sig_t / sig_s0) * sample - c * d0
                + float(alpha_t * ((np.exp(-h) - 1.0) / h + 1.0)) * d1)

    def _third_order(self, sample):
        sigma_t, sigma_s0 = self._sigma(1), self._sigma(0)
        sigma_s1, sigma_s2 = self._sigma(-1), self._sigma(-2)
        alpha_t, sig_t = _alpha_sigma(sigma_t)
        _, sig_s0 = _alpha_sigma(sigma_s0)
        h = _lambda(sigma_t) - _lambda(sigma_s0)
        r0 = (_lambda(sigma_s0) - _lambda(sigma_s1)) / h
        r1 = (_lambda(sigma_s1) - _lambda(sigma_s2)) / h
        m0, m1, m2 = self.model_outputs[-1], self.model_outputs[-2], self.model_outputs[-3]
        d1_0, d1_1 = (1.0 / r0) * (m0 - m1), (1.0 / r1) * (m1 - m2)
        d1 = d1_0 + (r0 / (r0 + r1)) * (d1_0 - d1_1)
        d2 = (1.0 / (r0 + r1)) * (d1_0 - d1_1)
        return ((sig_t / sig_s0) * sample
                - float(alpha_t * (np.exp(-h) - 1.0)) * m0
                + float(alpha_t * ((np.exp(-h) - 1.0) / h + 1.0)) * d1
                - float(alpha_t * ((np.exp(-h) - 1.0 + h) / h ** 2 - 0.5)) * d2)

    def step(self, model_output, timestep, sample):
        """One scheduler step. Returns the previous sample."""
        if self.num_inference_steps is None:
            raise RuntimeError("call set_timesteps first")
        if self._step_index is None:
            idx = np.nonzero(self.timesteps == int(timestep))[0]
            self._step_index = int(idx[0]) if len(idx) else 0

        n = len(self.timesteps)
        lower_final = (self._step_index == n - 1) and (
            self.euler_at_final or (self.lower_order_final and n < 15)
            or self.final_sigmas_type == "zero")
        lower_second = (self._step_index == n - 2) and self.lower_order_final and n < 15

        m = sample - self._sigma(0) * model_output
        self.model_outputs = self.model_outputs[1:] + [m]

        if self.solver_order == 1 or self.lower_order_nums < 1 or lower_final:
            prev = self._first_order(m, sample)
        elif self.solver_order == 2 or self.lower_order_nums < 2 or lower_second:
            prev = self._second_order(sample)
        else:
            prev = self._third_order(sample)

        if self.lower_order_nums < self.solver_order:
            self.lower_order_nums += 1
        self._step_index += 1
        return prev
