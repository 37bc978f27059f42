"""Flow-matching UniPC multistep scheduler, predictor-corrector
(counterpart of wanq_tpu/solvers/unipc.py).

The scalar coefficient math (lambdas, R/b systems, rhos) runs on the host
in float64 exactly as in the JAX package; tensor updates are PyTorch
expressions on the latents' device. Flow matching: alpha_t = 1 - sigma,
sigma_t = sigma, x0-prediction x0 = sample - sigma_t * model_output.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def _alpha_sigma(sigma: float) -> Tuple[float, float]:
    return 1.0 - sigma, sigma


def _lambda(sigma: float) -> float:
    alpha, s = _alpha_sigma(sigma)
    s = max(s, 1e-12)
    return float(np.log(alpha) - np.log(s))


@dataclasses.dataclass
class FlowUniPCMultistepScheduler:
    """Host-side scheduler driving tensor updates."""

    num_train_timesteps: int = 1000
    solver_order: int = 2
    shift: float = 1.0
    use_dynamic_shifting: bool = False
    predict_x0: bool = True
    solver_type: str = "bh2"
    lower_order_final: bool = True
    disable_corrector: Sequence[int] = ()

    def __post_init__(self):
        if self.solver_type not in ("bh1", "bh2"):
            raise ValueError(f"unknown solver_type {self.solver_type!r}")
        alphas = np.linspace(1, 1 / self.num_train_timesteps,
                             self.num_train_timesteps)[::-1].copy()
        sigmas = 1.0 - alphas
        if not self.use_dynamic_shifting:
            sigmas = self.shift * sigmas / (1 + (self.shift - 1) * sigmas)
        self.sigma_min = float(sigmas[-1])
        self.sigma_max = float(sigmas[0])
        self.timesteps = sigmas * self.num_train_timesteps
        self.sigmas = sigmas
        self._reset_state()

    def _reset_state(self):
        self.model_outputs: List[Optional[torch.Tensor]] = [None] * self.solver_order
        self.lower_order_nums = 0
        self.last_sample = None
        self.this_order = None
        self._step_index: Optional[int] = None
        self.num_inference_steps: Optional[int] = None

    def set_timesteps(self, num_inference_steps: int, shift: Optional[float] = None,
                      sigmas: Optional[np.ndarray] = None, mu: Optional[float] = None):
        if self.use_dynamic_shifting and mu is None:
            raise ValueError("pass `mu` when use_dynamic_shifting is True")
        if sigmas is None:
            sigmas = np.linspace(self.sigma_max, self.sigma_min,
                                 num_inference_steps + 1).copy()[:-1]
        if self.use_dynamic_shifting:
            sigmas = np.exp(mu) / (np.exp(mu) + (1 / sigmas - 1) ** 1.0)
        else:
            if shift is None:
                shift = self.shift
            sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
        timesteps = sigmas * self.num_train_timesteps
        self.sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float64)
        self.timesteps = timesteps.astype(np.int64)
        self._reset_state()
        self.num_inference_steps = len(timesteps)

    def _convert_model_output(self, model_output, sample):
        sigma_t = float(self.sigmas[self._step_index])
        if self.predict_x0:
            return sample - sigma_t * model_output
        return sample - (1 - sigma_t) * model_output

    def _coeffs(self, order: int, h: float, lambda_s0: float, rel: str):
        rks = []
        for i in range(1, order):
            si = self._step_index - i if rel == "p" else self._step_index - (i + 1)
            rks.append((_lambda(float(self.sigmas[si])) - lambda_s0) / h)
        rks.append(1.0)
        rks = np.asarray(rks, dtype=np.float64)

        hh = -h if self.predict_x0 else h
        h_phi_1 = np.expm1(hh)
        h_phi_k = h_phi_1 / hh - 1
        factorial_i = 1.0
        B_h = hh if self.solver_type == "bh1" else np.expm1(hh)

        R, b = [], []
        for i in range(1, order + 1):
            R.append(np.power(rks, i - 1))
            b.append(h_phi_k * factorial_i / B_h)
            factorial_i *= i + 1
            h_phi_k = h_phi_k / hh - 1 / factorial_i
        return np.stack(R), float(h_phi_1), float(B_h), np.asarray(b)

    def _uni_p(self, sample, order: int):
        """Predictor."""
        m0 = self.model_outputs[-1]
        sigma_t = float(self.sigmas[self._step_index + 1])
        sigma_s0 = float(self.sigmas[self._step_index])
        alpha_t, sig_t = _alpha_sigma(sigma_t)
        alpha_s0, sig_s0 = _alpha_sigma(sigma_s0)
        h = _lambda(sigma_t) - _lambda(sigma_s0)
        R, h_phi_1, B_h, b = self._coeffs(order, h, _lambda(sigma_s0), "p")

        D1s = []
        for i in range(1, order):
            mi = self.model_outputs[-(i + 1)]
            rk = (_lambda(float(self.sigmas[self._step_index - i])) - _lambda(sigma_s0)) / h
            D1s.append((mi - m0) / rk)
        if D1s:
            rhos_p = np.asarray([0.5]) if order == 2 else np.linalg.solve(R[:-1, :-1], b[:-1])
            pred_res = sum(float(r) * d for r, d in zip(rhos_p, D1s))
        else:
            pred_res = 0.0

        if self.predict_x0:
            x_t = (sig_t / sig_s0) * sample - (alpha_t * h_phi_1) * m0
            return x_t - alpha_t * B_h * pred_res
        x_t = (alpha_t / alpha_s0) * sample - (sig_t * h_phi_1) * m0
        return x_t - sig_t * B_h * pred_res

    def _uni_c(self, this_model_output, last_sample, order: int):
        """Corrector."""
        m0 = self.model_outputs[-1]
        sigma_t = float(self.sigmas[self._step_index])
        sigma_s0 = float(self.sigmas[self._step_index - 1])
        alpha_t, sig_t = _alpha_sigma(sigma_t)
        alpha_s0, sig_s0 = _alpha_sigma(sigma_s0)
        h = _lambda(sigma_t) - _lambda(sigma_s0)
        R, h_phi_1, B_h, b = self._coeffs(order, h, _lambda(sigma_s0), "c")

        D1s = []
        for i in range(1, order):
            mi = self.model_outputs[-(i + 1)]
            rk = (_lambda(float(self.sigmas[self._step_index - (i + 1)]))
                  - _lambda(sigma_s0)) / h
            D1s.append((mi - m0) / rk)
        rhos_c = np.asarray([0.5]) if order == 1 else np.linalg.solve(R, b)
        corr_res = sum(float(r) * d for r, d in zip(rhos_c[:-1], D1s)) if D1s else 0.0
        D1_t = this_model_output - m0

        if self.predict_x0:
            x_t = (sig_t / sig_s0) * last_sample - (alpha_t * h_phi_1) * m0
            return x_t - alpha_t * B_h * (corr_res + float(rhos_c[-1]) * D1_t)
        x_t = (alpha_t / alpha_s0) * last_sample - (sig_t * h_phi_1) * m0
        return x_t - sig_t * B_h * (corr_res + float(rhos_c[-1]) * D1_t)

    def step(self, model_output, timestep, sample):
        """One scheduler step. Returns the previous sample."""
        if self.num_inference_steps is None:
            raise RuntimeError("call set_timesteps first")
        if self._step_index is None:
            idx = np.nonzero(self.timesteps == int(timestep))[0]
            self._step_index = int(idx[0]) if len(idx) else 0

        use_corrector = (
            self._step_index > 0
            and (self._step_index - 1) not in self.disable_corrector
            and self.last_sample is not None
        )
        model_output_convert = self._convert_model_output(model_output, sample)
        if use_corrector:
            sample = self._uni_c(model_output_convert, self.last_sample, self.this_order)

        self.model_outputs = self.model_outputs[1:] + [model_output_convert]

        if self.lower_order_final:
            this_order = min(self.solver_order, len(self.timesteps) - self._step_index)
        else:
            this_order = self.solver_order
        self.this_order = min(this_order, self.lower_order_nums + 1)

        self.last_sample = sample
        prev_sample = self._uni_p(sample, order=self.this_order)
        if self.lower_order_nums < self.solver_order:
            self.lower_order_nums += 1
        self._step_index += 1
        return prev_sample
