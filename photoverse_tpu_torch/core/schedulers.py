"""Diffusion schedules, main-path part: the SD-1.5 DDPM table (with the
training forward process, `add_noise`) and the DPM-Solver++(2M) sampler.
Port of photoverse_tpu/core/schedulers.py.

All per-step solver quantities are host numpy scalars computed once, so a
step is the static linear combination

    m      = (x - eps_coef[i] * eps) * x0_scale[i]      (x0-prediction)
    x_next = a[i] * x + b[i] * m + c[i] * m_prev

The coefficient math is the JAX package's, unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["DDPMSchedule", "DPMSolverMultistep", "make_sd15_schedule"]


def _solver_grid(schedule: "DDPMSchedule", num_inference_steps: int) -> Tuple[np.ndarray, np.ndarray]:
    """Integer timesteps (linspace over N+1 points, last dropped, descending)
    and their sigmas with a trailing 0 (final sigma zero)."""
    T = schedule.num_train_timesteps
    abar = schedule.alphas_cumprod
    sigmas_full = np.sqrt((1.0 - abar) / abar)
    timesteps = (
        np.linspace(0, T - 1, num_inference_steps + 1).round()[::-1][:-1].astype(np.int64)
    )
    sigmas = np.interp(timesteps.astype(np.float64), np.arange(T), sigmas_full)
    return timesteps, np.concatenate([sigmas, [0.0]])


def _vp_split(sig: float) -> Tuple[float, float]:
    """VE sigma -> (alpha_t, sigma_t) with alpha^2 + sigma^2 = 1."""
    alpha_t = 1.0 / np.sqrt(sig**2 + 1.0)
    return alpha_t, sig * alpha_t


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    """Closed-form forward-diffusion schedule (the alpha-bar table)."""

    num_train_timesteps: int
    alphas_cumprod: np.ndarray  # (T,) float64
    beta_start: float
    beta_end: float
    beta_schedule: str
    prediction_type: str = "epsilon"
    steps_offset: int = 1

    @staticmethod
    def create(
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: str = "scaled_linear",
        prediction_type: str = "epsilon",
        steps_offset: int = 1,
    ) -> "DDPMSchedule":
        if beta_schedule == "scaled_linear":
            betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64) ** 2
        elif beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
        elif beta_schedule == "squaredcos_cap_v2":
            t = np.arange(num_train_timesteps + 1, dtype=np.float64) / num_train_timesteps

            def f(x):
                return np.cos((x + 0.008) / 1.008 * np.pi / 2) ** 2

            betas = np.clip(1.0 - f(t[1:]) / f(t[:-1]), 0.0, 0.999)
        else:
            raise ValueError(f"unknown beta_schedule: {beta_schedule}")
        return DDPMSchedule(
            num_train_timesteps=num_train_timesteps,
            alphas_cumprod=np.cumprod(1.0 - betas),
            beta_start=beta_start,
            beta_end=beta_end,
            beta_schedule=beta_schedule,
            prediction_type=prediction_type,
            steps_offset=steps_offset,
        )

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        """noisy = sqrt(abar_t) x0 + sqrt(1 - abar_t) eps, per batch row."""
        t = torch.as_tensor(timesteps, device=sample.device).long()
        abar = torch.as_tensor(self.alphas_cumprod, device=sample.device)
        a = abar.sqrt().float()[t].to(sample.dtype)
        s = (1.0 - abar).sqrt().float()[t].to(sample.dtype)
        shape = a.shape + (1,) * (sample.dim() - a.dim())
        return a.reshape(shape) * sample + s.reshape(shape) * noise


@dataclasses.dataclass(frozen=True)
class DPMSolverMultistep:
    """DPM-Solver++(2M): order 2, midpoint, lower-order final steps,
    linspace spacing, final sigma zero. The carry is (x, m_prev)."""

    timesteps: np.ndarray  # (N,) descending integer train timesteps
    sigmas: np.ndarray  # (N+1,), last entry 0
    a: np.ndarray  # (N,) coefficient on x
    b: np.ndarray  # (N,) coefficient on the current x0-prediction
    c: np.ndarray  # (N,) coefficient on the previous x0-prediction
    eps_coef: np.ndarray  # (N,) sigma_t of the x0 conversion
    x0_scale: np.ndarray  # (N,) 1/alpha_t of the x0 conversion
    init_noise_sigma: float = 1.0

    @staticmethod
    def create(
        schedule: DDPMSchedule,
        num_inference_steps: int,
        solver_order: int = 2,
        lower_order_final: bool = True,
    ) -> "DPMSolverMultistep":
        timesteps, sigmas = _solver_grid(schedule, num_inference_steps)
        N = num_inference_steps
        a, b, c = np.zeros(N), np.zeros(N), np.zeros(N)
        eps_coef, x0_scale = np.zeros(N), np.zeros(N)
        lower_order_nums = 0
        for i in range(N):
            alpha_s0, sig_s0 = _vp_split(sigmas[i])
            alpha_t, sig_t = _vp_split(sigmas[i + 1])
            eps_coef[i] = sig_s0
            x0_scale[i] = 1.0 / alpha_s0
            # first order on the warmup step, the final step (final sigma
            # is zero) and the last two steps of short schedules
            use_first_order = (
                solver_order == 1
                or lower_order_nums < 1
                or i == N - 1
                or (lower_order_final and i == N - 2 and N < 15)
            )
            if sigmas[i + 1] == 0.0:
                # exact limit: x_t is the x0-prediction
                a[i], b[i], c[i] = 0.0, 1.0, 0.0
            else:
                lam_t = np.log(alpha_t / sig_t)
                lam_s0 = np.log(alpha_s0 / sig_s0)
                h = lam_t - lam_s0
                em1 = np.expm1(-h)
                a[i] = sig_t / sig_s0
                if use_first_order:
                    b[i] = -alpha_t * em1
                else:
                    alpha_s1, sig_s1 = _vp_split(sigmas[i - 1])
                    r0 = (lam_s0 - np.log(alpha_s1 / sig_s1)) / h
                    b[i] = -alpha_t * em1 * (1.0 + 0.5 / r0)
                    c[i] = alpha_t * em1 * 0.5 / r0
            lower_order_nums = min(lower_order_nums + 1, solver_order - 1)
        return DPMSolverMultistep(timesteps, sigmas, a, b, c, eps_coef, x0_scale)

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    def step_inputs(self, device="cuda") -> Dict[str, torch.Tensor]:
        """Per-step tables on `device`: `t` int64, the coefficients f32."""
        out = {"t": torch.as_tensor(np.asarray(self.timesteps, np.int64), device=device)}
        for k in ("a", "b", "c", "eps_coef", "x0_scale"):
            out[k] = torch.as_tensor(np.asarray(getattr(self, k), np.float32), device=device)
        return out

    def init_carry(self, latents: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return (latents, torch.zeros_like(latents))

    @staticmethod
    def latent(carry: tuple) -> torch.Tensor:
        return carry[0]

    def advance(self, step: Dict[str, torch.Tensor], carry: tuple, eps: torch.Tensor) -> tuple:
        lat, m_prev = carry
        return self.step(step, lat, eps, m_prev)

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor, step_index: int) -> torch.Tensor:
        """Noise a clean sample to solver step `step_index` (0 = most noise)."""
        sigma = float(self.sigmas[step_index])
        alpha_t = 1.0 / np.sqrt(sigma**2 + 1.0)
        return (alpha_t * sample + sigma * alpha_t * noise).to(sample.dtype)

    def step(self, step, latents, eps, m_prev) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update given this step's slice of `step_inputs`; returns
        (new latents, x0-prediction to carry)."""
        dt = latents.dtype
        g = lambda k: step[k].to(dt)  # noqa: E731
        m = (latents - g("eps_coef") * eps) * g("x0_scale")
        return g("a") * latents + g("b") * m + g("c") * m_prev, m


def make_sd15_schedule() -> DDPMSchedule:
    """The Stable Diffusion 1.5 training schedule (scaled_linear, 1000 steps)."""
    return DDPMSchedule.create()
