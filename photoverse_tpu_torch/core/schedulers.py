"""Diffusion schedules: the SD-1.5 DDPM table (with the training forward
process, `add_noise`) and every inference sampler, each as a table of static
per-step coefficients. Port of photoverse_tpu/core/schedulers.py.

All per-step solver quantities are host numpy scalars computed once, so a
step is a static linear combination of the carry and the model's eps:

    m      = (x - eps_coef[i] * eps) * x0_scale[i]      (x0-prediction)
    x_next = a[i] * x + b[i] * m + c[i] * m_prev

for the DPM-Solver++ / DDIM / Euler / Heun / DPM++ 2S family, with a
corrector in front for UniPC and a history of raw eps for LMS and PNDM.
The coefficient math is the JAX package's, unchanged (float64 numpy); only
`step_inputs` and the carry functions (`init_carry`, `latent`,
`replace_latent`, `advance`) speak torch. `engine/inference.py:denoise` is
written against those four, so every sampler rides the same loop with one
model evaluation per entry of `timesteps`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "DDPMSchedule",
    "DPMSolverMultistep",
    "make_sd15_schedule",
    "make_solver",
    "SCHEDULER_NAMES",
]


def _karras_sigmas(
    sigma_min: float, sigma_max: float, n: int, rho: float = 7.0
) -> np.ndarray:
    """Karras et al. (2022) rho-7 sigma grid, descending sigma_max..sigma_min.

    Matches diffusers' `_convert_to_karras` (the `use_karras_sigmas=True`
    quality knob of DPMSolverMultistepScheduler/EulerDiscreteScheduler)."""
    ramp = np.linspace(0.0, 1.0, n)
    min_inv = sigma_min ** (1.0 / rho)
    max_inv = sigma_max ** (1.0 / rho)
    return (max_inv + ramp * (min_inv - max_inv)) ** rho


def _sigma_to_t(sigma: np.ndarray, log_sigmas: np.ndarray) -> np.ndarray:
    """Fractional train-timestep for each sigma by log-sigma interpolation
    (vectorized equivalent of diffusers' `_sigma_to_t`)."""
    log_sigma = np.log(np.maximum(sigma, 1e-10))
    dists = log_sigma[None, :] - log_sigmas[:, None]  # (T, N)
    low_idx = np.clip(
        np.cumsum(dists >= 0, axis=0).argmax(axis=0), 0, log_sigmas.shape[0] - 2
    )
    high_idx = low_idx + 1
    low, high = log_sigmas[low_idx], log_sigmas[high_idx]
    w = np.clip((low - log_sigma) / (low - high), 0.0, 1.0)
    return (1.0 - w) * low_idx + w * high_idx


def _solver_grid(
    schedule: "DDPMSchedule",
    num_inference_steps: int,
    use_karras_sigmas: bool,
    integer_timesteps: bool,
) -> Tuple[np.ndarray, np.ndarray]:
    """Shared inference timestep + sigma grid for every sampler family.

    Returns ``(timesteps, sigmas)`` with ``sigmas`` carrying the trailing 0.0
    (diffusers ``final_sigmas_type="zero"``).  ``use_karras_sigmas`` selects
    the Karras rho-7 grid over the full table's sigma range with timesteps
    recovered by log-sigma interpolation; otherwise linspace spacing.
    ``integer_timesteps`` matches the sampler family's convention: the
    multistep solvers (DPM++/UniPC) round to integer train timesteps
    (linspace over N+1 points, drop the last), while the Euler family keeps
    fractional float timesteps (linspace over N points) — both exactly as
    diffusers sets them up.
    """
    T = schedule.num_train_timesteps
    abar = schedule.alphas_cumprod
    sigmas_full = np.sqrt((1.0 - abar) / abar)
    if use_karras_sigmas:
        sigmas = _karras_sigmas(
            float(sigmas_full[0]), float(sigmas_full[-1]), num_inference_steps
        )
        timesteps = _sigma_to_t(sigmas, np.log(sigmas_full))
        if integer_timesteps:
            timesteps = timesteps.round().astype(np.int64)
    else:
        if integer_timesteps:
            timesteps = (
                np.linspace(0, T - 1, num_inference_steps + 1)
                .round()[::-1][:-1]
                .astype(np.int64)
            )
        else:
            timesteps = np.linspace(
                0, T - 1, num_inference_steps, dtype=np.float64
            )[::-1].copy()
        sigmas = np.interp(
            timesteps.astype(np.float64), np.arange(T), sigmas_full
        )
    sigmas = np.concatenate([sigmas, [0.0]])
    return timesteps, sigmas


def _vp_split(sig: float) -> Tuple[float, float]:
    """VE sigma -> (alpha_t, sigma_t) in VP parametrization:
    alpha_t = 1/sqrt(sig^2+1), sigma_t = sig*alpha_t (so alpha^2+sigma^2=1)."""
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
    """A sampler as static per-step tables. `create` builds
    DPM-Solver++(2M) (order 2, midpoint, lower-order final steps, linspace
    spacing, final sigma zero; `sde=True` the 2M SDE variant); the other
    `create_*` factories build DDIM, Euler / Euler-ancestral, DPM++ 2S
    ancestral, PNDM, LMS, Heun and UniPC in the same form.

    Per entry i the update is  x <- a[i]*x + b[i]*m + c[i]*m_prev,  where
    m = (x - eps_coef[i]*eps) * x0_scale[i] is the x0-prediction; the
    optional tables below extend it.
    """

    timesteps: np.ndarray  # (N,) descending train timesteps (int, or
    #                        fractional float for Euler / Karras grids)
    sigmas: np.ndarray  # (N+1,), last entry 0
    a: np.ndarray  # (N,) coefficient on x
    b: np.ndarray  # (N,) coefficient on the current x0-prediction
    c: np.ndarray  # (N,) coefficient on the previous x0-prediction
    eps_coef: np.ndarray  # (N,) sigma_t of the x0 conversion
    x0_scale: np.ndarray  # (N,) 1/alpha_t of the x0 conversion
    init_noise_sigma: float = 1.0
    # per-step ancestral noise std (VP space); None or zeros: deterministic.
    # Ancestral solvers add noise_sigma[i] * z after the affine update; the
    # engine draws z per batch row, so a row of a coalesced batch depends
    # only on its own request's seed.
    noise_sigma: Optional[np.ndarray] = None
    # UniPC corrector: before the predictor the current latent is corrected
    # with this step's x0-prediction,
    #   x_corr = ci*x + ca*x_prev + cb_this*m + cb_prev*m_prev + cb_pp*m_pp;
    # the carry grows to (x, x_prev_corrected, m_prev, m_pp).
    corr_ci: Optional[np.ndarray] = None
    corr_a: Optional[np.ndarray] = None
    corr_b_this: Optional[np.ndarray] = None
    corr_b_prev: Optional[np.ndarray] = None
    corr_b_pp: Optional[np.ndarray] = None
    # LMS: (N, 4) integrated Adams-Bashforth coefficients on
    # [d_this, d_prev, d_pp, d_ppp] (VE derivatives = the model's eps),
    # folded by alpha_{i+1}; carry (x, d_prev, d_pp, d_ppp).
    lms_c: Optional[np.ndarray] = None
    # PNDM/PLMS: (N, 5) coefficients on [e_this, e_prev, e_pp, e_ppp,
    # e_pppp] (raw eps). The fifth slot exists because diffusers' warmup at
    # counter 1 appends nothing to its history, so counter 4 reaches four
    # evaluations back. Carry (x, e1, e2, e3, e4).
    pndm_c: Optional[np.ndarray] = None
    # per-device copies of the step tables (`step_inputs`), made once so the
    # step loop uploads nothing
    _tables: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @staticmethod
    def create(
        schedule: DDPMSchedule,
        num_inference_steps: int,
        solver_order: int = 2,
        lower_order_final: bool = True,
        use_karras_sigmas: bool = False,
        sde: bool = False,
    ) -> "DPMSolverMultistep":
        # Karras: integer timesteps recovered by log-sigma interpolation +
        # round — the exact `use_karras_sigmas=True` semantics of diffusers'
        # DPMSolverMultistepScheduler (a.k.a. "DPM++ 2M Karras").
        # Otherwise linspace spacing, matching the reference sampler's grid.
        timesteps, sigmas = _solver_grid(
            schedule, num_inference_steps, use_karras_sigmas,
            integer_timesteps=True,
        )
        split = _vp_split

        N = num_inference_steps
        a = np.zeros(N)
        b = np.zeros(N)
        c = np.zeros(N)
        eps_coef = np.zeros(N)
        x0_scale = np.zeros(N)
        noise_sig = np.zeros(N)

        lower_order_nums = 0
        for i in range(N):
            sigma_s0 = sigmas[i]
            sigma_t = sigmas[i + 1]
            alpha_s0, sig_s0 = split(sigma_s0)
            alpha_t, sig_t = split(sigma_t)
            # x0 conversion coefficients at the *current* step
            eps_coef[i] = sig_s0
            x0_scale[i] = 1.0 / alpha_s0

            # first-order fallbacks, matching the reference sampler: warmup
            # step, final step whenever the final sigma is zero, and the last
            # two steps of short (<15) schedules under lower_order_final.
            use_first_order = (
                solver_order == 1
                or lower_order_nums < 1
                or (i == N - 1)  # final sigma is always zero here
                or (lower_order_final and i == N - 2 and N < 15)
            )

            if sigma_t == 0.0:
                # exact limit: lambda_t -> inf, exp(-h) -> 0 (ODE) and
                # exp(-2h) -> 0 (SDE), first order forced above, so
                # x_t = x0-prediction exactly and the SDE noise term is 0.
                a[i], b[i], c[i] = 0.0, 1.0, 0.0
            else:
                lam_t = np.log(alpha_t / sig_t)
                lam_s0 = np.log(alpha_s0 / sig_s0)
                h = lam_t - lam_s0
                em1 = np.expm1(-h)  # exp(-h) - 1
                if sde:
                    # sde-dpmsolver++ (midpoint): the "DPM++ 2M SDE" sampler.
                    # x_t = (sig_t/sig_s0) e^{-h} x + alpha_t(1 - e^{-2h})
                    #       [D0 + 0.5 D1] + sig_t sqrt(1 - e^{-2h}) z,
                    # D0 = m0, D1 = (m0 - m1)/r0
                    e_h = np.exp(-h)
                    e_2h = -np.expm1(-2.0 * h)  # 1 - exp(-2h)
                    a[i] = (sig_t / sig_s0) * e_h
                    noise_sig[i] = sig_t * np.sqrt(e_2h)
                    if use_first_order:
                        b[i] = alpha_t * e_2h
                    else:
                        sigma_s1 = sigmas[i - 1]
                        alpha_s1, sig_s1 = split(sigma_s1)
                        lam_s1 = np.log(alpha_s1 / sig_s1)
                        r0 = (lam_s0 - lam_s1) / h
                        b[i] = alpha_t * e_2h * (1.0 + 0.5 / r0)
                        c[i] = -alpha_t * e_2h * 0.5 / r0
                elif use_first_order:
                    a[i] = sig_t / sig_s0
                    b[i] = -alpha_t * em1
                    c[i] = 0.0
                else:
                    sigma_s1 = sigmas[i - 1]
                    alpha_s1, sig_s1 = split(sigma_s1)
                    lam_s1 = np.log(alpha_s1 / sig_s1)
                    h0 = lam_s0 - lam_s1
                    r0 = h0 / h
                    a[i] = sig_t / sig_s0
                    b[i] = -alpha_t * em1 * (1.0 + 0.5 / r0)
                    c[i] = alpha_t * em1 * 0.5 / r0
            lower_order_nums = min(lower_order_nums + 1, solver_order - 1)

        return DPMSolverMultistep(
            timesteps=timesteps,
            sigmas=sigmas,
            a=a,
            b=b,
            c=c,
            eps_coef=eps_coef,
            x0_scale=x0_scale,
            noise_sigma=noise_sig if sde else None,
        )

    @staticmethod
    def create_ddim(
        schedule: DDPMSchedule,
        num_inference_steps: int,
    ) -> "DPMSolverMultistep":
        """DDIM (eta=0) expressed in the same static-affine step form.

        With epsilon prediction and eta=0, the DDIM update
            x0 = (x - sqrt(1-abar_t) eps) / sqrt(abar_t)
            x' = sqrt(abar_prev) x0 + sqrt(1-abar_prev) eps
        is the affine map  x' = a*x + b*m  (m = x0-prediction) with
            a = sqrt((1-abar_prev)/(1-abar_t))
            b = sqrt(abar_prev) - a * sqrt(abar_t)
        so DDIM rides the identical step loop as DPM-Solver++ with the
        multistep coefficient c == 0. Semantics match diffusers
        DDIMScheduler as SD-1.5 configures it ("leading" spacing,
        steps_offset=1, set_alpha_to_one=True, no clipping/thresholding).
        """
        T = schedule.num_train_timesteps
        step_ratio = T // num_inference_steps
        last_t = (num_inference_steps - 1) * step_ratio + schedule.steps_offset
        if step_ratio < 1 or last_t >= T:
            # same constraint diffusers hits: "leading" spacing with
            # steps_offset pushes the top timestep to (N-1)*(T//N)+offset,
            # which must stay below T (N == T with offset 1 lands on T)
            raise ValueError(
                f"num_inference_steps={num_inference_steps} with "
                f"steps_offset={schedule.steps_offset} exceeds the "
                f"{T}-step training schedule (max timestep {last_t})"
            )
        timesteps = (
            (np.arange(0, num_inference_steps) * step_ratio)
            .round()[::-1]
            .astype(np.int64)
            + schedule.steps_offset
        )
        abar = schedule.alphas_cumprod
        N = num_inference_steps
        a = np.zeros(N)
        b = np.zeros(N)
        eps_coef = np.zeros(N)
        x0_scale = np.zeros(N)
        for i, t in enumerate(timesteps):
            prev_t = t - step_ratio
            abar_t = abar[t]
            abar_prev = abar[prev_t] if prev_t >= 0 else 1.0  # set_alpha_to_one
            eps_coef[i] = np.sqrt(1.0 - abar_t)
            x0_scale[i] = 1.0 / np.sqrt(abar_t)
            a[i] = np.sqrt((1.0 - abar_prev) / (1.0 - abar_t))
            b[i] = np.sqrt(abar_prev) - a[i] * np.sqrt(abar_t)
        sigmas = np.sqrt((1.0 - abar[timesteps]) / abar[timesteps])
        sigmas = np.concatenate([sigmas, [0.0]])
        return DPMSolverMultistep(
            timesteps=timesteps,
            sigmas=sigmas,
            a=a,
            b=b,
            c=np.zeros(N),
            eps_coef=eps_coef,
            x0_scale=x0_scale,
        )

    @staticmethod
    def create_euler(
        schedule: DDPMSchedule,
        num_inference_steps: int,
        ancestral: bool = False,
        use_karras_sigmas: bool = False,
    ) -> "DPMSolverMultistep":
        """Euler / Euler-Ancestral in the same static-affine step form.

        diffusers' EulerDiscreteScheduler works in VE ("sigma") space where
        X = x0 + sig*eps and the model input is X / sqrt(sig^2 + 1). Our
        engine's latent IS that scaled model input (the VP latent
        x = alpha*X, alpha = 1/sqrt(sig^2+1)), so the Euler update
            X' = X + (sig_down - sig) * eps   [+ sig_up * z  if ancestral]
        transforms exactly into the affine map
            x' = a*x + b*m  [+ alpha' * sig_up * z]
        with  a = (alpha'/alpha) * (sig_down/sig),
              b = alpha' * (sig - sig_down)/sig   (m = x0-prediction),
        and sig_down = sig_next (plain Euler) or the ancestral split
        sig_up^2 = sig_next^2 (sig^2 - sig_next^2)/sig^2,
        sig_down^2 = sig_next^2 - sig_up^2 (EulerAncestralDiscreteScheduler).
        Timestep grid: "linspace" N points (fractional floats, like
        diffusers), or the Karras rho-7 sigma grid with fractional
        log-sigma-interpolated timesteps when use_karras_sigmas.
        init_noise_sigma is sigma_max expressed in VP space
        (alpha_max * sigma_max), matching diffusers' VE-space sigma_max.
        """
        timesteps, sigmas = _solver_grid(
            schedule, num_inference_steps, use_karras_sigmas,
            integer_timesteps=False,
        )

        N = num_inference_steps
        a = np.zeros(N)
        b = np.zeros(N)
        eps_coef = np.zeros(N)
        x0_scale = np.zeros(N)
        noise_sigma = np.zeros(N)
        for i in range(N):
            sig_f = sigmas[i]
            sig_n = sigmas[i + 1]
            alpha_f = 1.0 / np.sqrt(sig_f**2 + 1.0)
            alpha_n = 1.0 / np.sqrt(sig_n**2 + 1.0)
            eps_coef[i] = sig_f * alpha_f
            x0_scale[i] = 1.0 / alpha_f
            if ancestral and sig_n > 0.0:
                sig_up = np.sqrt(sig_n**2 * (sig_f**2 - sig_n**2) / sig_f**2)
                sig_down = np.sqrt(sig_n**2 - sig_up**2)
            else:
                sig_up, sig_down = 0.0, sig_n
            a[i] = (alpha_n / alpha_f) * (sig_down / sig_f)
            b[i] = alpha_n * (sig_f - sig_down) / sig_f
            noise_sigma[i] = alpha_n * sig_up
        sig0 = float(sigmas[0])
        return DPMSolverMultistep(
            timesteps=timesteps,
            sigmas=sigmas,
            a=a,
            b=b,
            c=np.zeros(N),
            eps_coef=eps_coef,
            x0_scale=x0_scale,
            init_noise_sigma=sig0 / np.sqrt(sig0**2 + 1.0),
            noise_sigma=noise_sigma if ancestral else None,
        )

    @staticmethod
    def create_dpm_2s_ancestral(
        schedule: DDPMSchedule,
        num_inference_steps: int,
        use_karras_sigmas: bool = False,
    ) -> "DPMSolverMultistep":
        """DPM++ 2S ancestral ("DPM++ 2S a") as 2N-1 static-affine substeps.

        k-diffusion ``sample_dpmpp_2s_ancestral`` (eta=1) semantics, the
        sampler A1111 exposes as "DPM++ 2S a (Karras)". Per grid step, with
        the Euler-ancestral sigma split (sig_up, sig_down) and
        lambda = -log sigma, h = log(sig_s/sig_down):
          substep A (eval at sig_s):  midpoint sig_mid = sqrt(sig_s*sig_down)
              X_2 = (sig_mid/sig_s) X - expm1(-h/2) m
          substep B (eval at sig_mid):
              X' = (sig_down/sig_s) X - expm1(-h) m_2 + sig_up z
        Substep B references the PRE-substep-A latent X, but along A's line
        X = (X_2 + expm1(-h/2) m) * (sig_s/sig_mid), so B is affine in
        (X_2, m_2, m_prev) — the exact (a, b, c) + noise carry the step
        loop already holds. The final step (sig_down == 0) is the first-order
        limit X' = m in one substep, so N steps cost 2N-1 UNet evals.
        Substep B's model eval runs at the OFF-GRID sigma sig_mid with its
        fractional log-interpolated train timestep (the engine feeds
        fractional t to the sinusoidal embedding, like diffusers does for
        Karras grids).
        """
        timesteps, sigmas = _solver_grid(
            schedule, num_inference_steps, use_karras_sigmas,
            integer_timesteps=False,
        )
        abar = schedule.alphas_cumprod
        log_table = np.log(np.sqrt((1.0 - abar) / abar))

        N = num_inference_steps
        sub_t, sub_sig = [], []
        a, b, c, eps_coef, x0_scale, noise_sig = [], [], [], [], [], []
        for i in range(N):
            sig_s = sigmas[i]
            sig_n = sigmas[i + 1]
            alpha_s = 1.0 / np.sqrt(sig_s**2 + 1.0)
            alpha_n = 1.0 / np.sqrt(sig_n**2 + 1.0)
            if sig_n > 0.0:
                sig_up = np.sqrt(sig_n**2 * (sig_s**2 - sig_n**2) / sig_s**2)
                sig_down = np.sqrt(sig_n**2 - sig_up**2)
            else:
                sig_up, sig_down = 0.0, 0.0
            if sig_down == 0.0:
                # first-order limit: X' = m (+ sig_up z, zero here)
                sub_t.append(timesteps[i])
                sub_sig.append(sig_s)
                eps_coef.append(sig_s * alpha_s)
                x0_scale.append(1.0 / alpha_s)
                a.append(0.0)
                b.append(alpha_n)
                c.append(0.0)
                noise_sig.append(alpha_n * sig_up)
                continue
            h = np.log(sig_s / sig_down)
            sig_mid = np.sqrt(sig_s * sig_down)
            alpha_mid = 1.0 / np.sqrt(sig_mid**2 + 1.0)
            em_half = np.expm1(-h / 2.0)
            em_full = np.expm1(-h)
            # substep A: input at sig_s, eval at t_i, output at sig_mid
            sub_t.append(timesteps[i])
            sub_sig.append(sig_s)
            eps_coef.append(sig_s * alpha_s)
            x0_scale.append(1.0 / alpha_s)
            a.append((alpha_mid / alpha_s) * (sig_mid / sig_s))
            b.append(-alpha_mid * em_half)
            c.append(0.0)
            noise_sig.append(0.0)
            # substep B: input x_2 at sig_mid, eval at t(sig_mid), output
            # at sig_n (deterministic part at sig_down + sig_up noise)
            sub_t.append(float(_sigma_to_t(np.asarray([sig_mid]), log_table)[0]))
            sub_sig.append(sig_mid)
            eps_coef.append(sig_mid * alpha_mid)
            x0_scale.append(1.0 / alpha_mid)
            ratio = sig_down / sig_mid  # == (sig_down/sig_s)*(sig_s/sig_mid)
            a.append(alpha_n * ratio / alpha_mid)
            b.append(-alpha_n * em_full)
            c.append(alpha_n * ratio * em_half)
            noise_sig.append(alpha_n * sig_up)
        sub_sig.append(0.0)
        sig0 = float(sub_sig[0])
        return DPMSolverMultistep(
            timesteps=np.asarray(sub_t, np.float64),
            sigmas=np.asarray(sub_sig, np.float64),
            a=np.asarray(a),
            b=np.asarray(b),
            c=np.asarray(c),
            eps_coef=np.asarray(eps_coef),
            x0_scale=np.asarray(x0_scale),
            init_noise_sigma=sig0 / np.sqrt(sig0**2 + 1.0),
            noise_sigma=np.asarray(noise_sig),
        )

    @staticmethod
    def create_pndm(
        schedule: DDPMSchedule,
        num_inference_steps: int,
    ) -> "DPMSolverMultistep":
        """PNDM/PLMS (the historical SD-1.5 default) as N+1 static substeps.

        Semantics match diffusers' PNDMScheduler as SD-1.5 configures it
        (skip_prk_steps=True -> pure PLMS, "leading" spacing,
        steps_offset=1, set_alpha_to_one=False): 4th-order Adams-Bashforth
        on the RAW eps history over the DDIM-form transfer
            x' = A x - (abar' - abar)/denom * e_combo,
            A = sqrt(abar'/abar),
            denom = abar*sqrt(1-abar') + sqrt(abar*(1-abar)*abar'),
        with diffusers' warmup quirk reproduced exactly: the first grid
        step gets TWO evals (plain step with e0, then a trapezoidal redo
        of the SAME transition from the pre-step latent with (e0+e1)/2 —
        affine in the carry because x_prev = (x - B e0)/A along the first
        substep), and e1 is never appended to the history, so the
        counter==4 combo reaches 4 evals back — hence the 5-slot
        (x, e1..e4) carry. Timestep walk [T0, T1, T1, T2, ..., T_{N-1}]
        (N+1 UNet evals for N steps), diffusers' plms_timesteps exactly.
        Like DDIM, the leading grid has no Karras variant.
        """
        T = schedule.num_train_timesteps
        step_ratio = T // num_inference_steps
        last_t = (
            (num_inference_steps - 1) * step_ratio + schedule.steps_offset
        )
        if step_ratio < 1 or last_t >= T:
            raise ValueError(
                f"num_inference_steps={num_inference_steps} with "
                f"steps_offset={schedule.steps_offset} exceeds the "
                f"{T}-step training schedule (max timestep {last_t})"
            )
        Ts = (
            (np.arange(0, num_inference_steps) * step_ratio)
            .round()[::-1]
            .astype(np.int64)
            + schedule.steps_offset
        )
        abar = schedule.alphas_cumprod
        final_abar = abar[0]  # set_alpha_to_one=False (the SD PNDM config)

        def transfer(t: int):
            a_t = abar[t]
            t_prev = t - step_ratio
            a_p = abar[t_prev] if t_prev >= 0 else final_abar
            A = np.sqrt(a_p / a_t)
            denom = a_t * np.sqrt(1.0 - a_p) + np.sqrt(
                a_t * (1.0 - a_t) * a_p
            )
            return A, -(a_p - a_t) / denom

        n = num_inference_steps
        N = n + 1 if n > 1 else 1
        sub_t = np.zeros(N, np.int64)
        a = np.zeros(N)
        pndm_c = np.zeros((N, 5))
        eps_coef = np.zeros(N)
        x0_scale = np.zeros(N)
        A0, B0 = transfer(int(Ts[0]))
        sub_t[0] = Ts[0]
        a[0] = A0
        pndm_c[0, 0] = B0
        if n > 1:
            # counter==1: trapezoidal redo of the T0 transition from the
            # recovered pre-step latent; eval at T1
            sub_t[1] = Ts[1]
            a[1] = 1.0
            pndm_c[1, 0] = B0 / 2.0
            pndm_c[1, 1] = -B0 / 2.0
            combos = {
                2: np.array([3.0, 0.0, -1.0, 0.0, 0.0]) / 2.0,
                3: np.array([23.0, -16.0, 0.0, 5.0, 0.0]) / 12.0,
                4: np.array([55.0, -59.0, 37.0, 0.0, -9.0]) / 24.0,
            }
            steady = np.array([55.0, -59.0, 37.0, -9.0, 0.0]) / 24.0
            for k in range(2, n + 1):
                t_eval = int(Ts[k - 1])
                A, B = transfer(t_eval)
                sub_t[k] = t_eval
                a[k] = A
                pndm_c[k] = B * combos.get(k, steady)
        for k in range(N):
            ab = abar[sub_t[k]]
            eps_coef[k] = np.sqrt(1.0 - ab)
            x0_scale[k] = 1.0 / np.sqrt(ab)
        sigmas = np.sqrt((1.0 - abar[sub_t]) / abar[sub_t])
        sigmas = np.concatenate([sigmas, [0.0]])
        return DPMSolverMultistep(
            timesteps=sub_t,
            sigmas=sigmas,
            a=a,
            b=np.zeros(N),
            c=np.zeros(N),
            eps_coef=eps_coef,
            x0_scale=x0_scale,
            pndm_c=pndm_c,
        )

    @staticmethod
    def create_lms(
        schedule: DDPMSchedule,
        num_inference_steps: int,
        order: int = 4,
        use_karras_sigmas: bool = False,
    ) -> "DPMSolverMultistep":
        """LMS (k-lms: 4th-order Adams-Bashforth over sigma) as static maps.

        Semantics match diffusers' LMSDiscreteScheduler defaults (linspace
        fractional timesteps, order ramping 1..4 over the warmup steps,
        final integration segment ending at sigma 0). In VE space
            X' = X + sum_j C[i,j] * d_{i-j},   d = eps (epsilon prediction),
        where C[i,j] integrates the j-th Lagrange basis over
        [sigma_i, sigma_{i+1}] — diffusers computes it with integrate.quad;
        here the basis product is expanded with poly1d and integrated
        EXACTLY (antiderivative evaluation), then folded into VP space:
            x' = (alpha_{i+1}/alpha_i) x + alpha_{i+1} * sum_j C[i,j] d_{i-j}.
        The carry holds the last three derivatives (x, d1, d2, d3);
        advance() returns the model's eps as this step's derivative — for
        epsilon prediction the VE derivative IS eps, evaluated on the
        scaled input our VP latent already equals.
        """
        timesteps, sigmas = _solver_grid(
            schedule, num_inference_steps, use_karras_sigmas,
            integer_timesteps=False,
        )
        N = num_inference_steps
        a = np.zeros(N)
        eps_coef = np.zeros(N)
        x0_scale = np.zeros(N)
        lms_c = np.zeros((N, 4))
        for i in range(N):
            sig_s = sigmas[i]
            sig_t = sigmas[i + 1]
            alpha_s = 1.0 / np.sqrt(sig_s**2 + 1.0)
            alpha_t = 1.0 / np.sqrt(sig_t**2 + 1.0)
            eps_coef[i] = sig_s * alpha_s
            x0_scale[i] = 1.0 / alpha_s
            a[i] = alpha_t / alpha_s
            cur_order = min(i + 1, order)
            for j in range(cur_order):
                # Lagrange basis L_j over nodes sigma_{i-k}, k=0..cur_order-1
                poly = np.poly1d([1.0])
                for k in range(cur_order):
                    if k == j:
                        continue
                    denom = sigmas[i - j] - sigmas[i - k]
                    poly = poly * np.poly1d([1.0 / denom, -sigmas[i - k] / denom])
                anti = poly.integ()
                lms_c[i, j] = alpha_t * (anti(sig_t) - anti(sig_s))
        sig0 = float(sigmas[0])
        return DPMSolverMultistep(
            timesteps=timesteps,
            sigmas=sigmas,
            a=a,
            b=np.zeros(N),
            c=np.zeros(N),
            eps_coef=eps_coef,
            x0_scale=x0_scale,
            init_noise_sigma=sig0 / np.sqrt(sig0**2 + 1.0),
            lms_c=lms_c,
        )

    @staticmethod
    def create_heun(
        schedule: DDPMSchedule,
        num_inference_steps: int,
        use_karras_sigmas: bool = False,
    ) -> "DPMSolverMultistep":
        """Heun (trapezoidal 2nd-order) as 2N-1 static-affine substeps.

        Karras et al. (2022) Algorithm 1 / k-diffusion ``sample_heun``
        (s_churn=0), the sampler diffusers exposes as HeunDiscreteScheduler:
        each grid step does an Euler predictor to sigma_next followed by a
        trapezoidal correction with a second model eval at sigma_next; the
        final step (sigma_next == 0) is the plain Euler predictor, per the
        algorithm's ``if sigma_next != 0`` guard. Both substeps are affine in
        the carry the denoise loop already holds:

          predictor (eval at t_i, input at sig_s):  the Euler map
              x' = (alpha_t/alpha_s)(sig_t/sig_s) x + alpha_t (sig_s-sig_t)/sig_s m
          corrector (eval at t_{i+1}, input x_pred at sig_t): in VE space
              X' = X + dt/2 (d + d')  with  d = (X_pred - m_prev)/sig_t
              (since X_pred - m_prev = sig_t d along the predictor line) and
              d' = (X_pred - m')/sig_t, which collapses to
              X' = X_pred + dt/(2 sig_t) (m_prev - m')  — the X_pred terms
              cancel — i.e.  a=1, b=-alpha_t dt/(2 sig_t), c=+alpha_t dt/(2 sig_t).

        So Heun rides the SAME one-model-eval-per-iteration loop as
        every other sampler here, with ``timesteps`` interleaved
        [t_0, t_1, t_1, t_2, t_2, ...] exactly like diffusers'
        repeat_interleave grid. N inference steps cost 2N-1 UNet evals.
        """
        timesteps, sigmas = _solver_grid(
            schedule, num_inference_steps, use_karras_sigmas,
            integer_timesteps=False,
        )

        N = num_inference_steps
        sub_t, sub_sig = [], []
        a, b, c, eps_coef, x0_scale = [], [], [], [], []
        for i in range(N):
            sig_s = sigmas[i]
            sig_t = sigmas[i + 1]
            alpha_s = 1.0 / np.sqrt(sig_s**2 + 1.0)
            alpha_t = 1.0 / np.sqrt(sig_t**2 + 1.0)
            # Euler predictor substep: input at sig_s, model eval at t_i
            sub_t.append(timesteps[i])
            sub_sig.append(sig_s)
            eps_coef.append(sig_s * alpha_s)
            x0_scale.append(1.0 / alpha_s)
            a.append((alpha_t / alpha_s) * (sig_t / sig_s))
            b.append(alpha_t * (sig_s - sig_t) / sig_s)
            c.append(0.0)
            if sig_t == 0.0:
                continue  # final step: first order only (Karras alg. 1)
            # trapezoidal corrector substep: input x_pred at sig_t, model
            # eval at t_{i+1}; dt = sig_t - sig_s < 0
            dt = sig_t - sig_s
            sub_t.append(timesteps[i + 1])
            sub_sig.append(sig_t)
            eps_coef.append(sig_t * alpha_t)
            x0_scale.append(1.0 / alpha_t)
            a.append(1.0)
            b.append(-alpha_t * dt / (2.0 * sig_t))
            c.append(alpha_t * dt / (2.0 * sig_t))
        sub_sig.append(0.0)
        sig0 = float(sub_sig[0])
        return DPMSolverMultistep(
            timesteps=np.asarray(sub_t, np.float64),
            sigmas=np.asarray(sub_sig, np.float64),
            a=np.asarray(a),
            b=np.asarray(b),
            c=np.asarray(c),
            eps_coef=np.asarray(eps_coef),
            x0_scale=np.asarray(x0_scale),
            init_noise_sigma=sig0 / np.sqrt(sig0**2 + 1.0),
        )

    @staticmethod
    def create_unipc(
        schedule: DDPMSchedule,
        num_inference_steps: int,
        solver_order: int = 2,
        lower_order_final: bool = True,
        use_karras_sigmas: bool = False,
    ) -> "DPMSolverMultistep":
        """UniPC (bh2, data prediction) as static predictor+corrector maps.

        Semantics match diffusers' UniPCMultistepScheduler defaults
        (predict_x0, solver_type="bh2", solver_order=2, lower_order_final,
        linspace spacing, final_sigmas_type="zero", corrector enabled on
        every step after the first). Two structural facts make the static
        form possible:
          * the bh2 order-2 PREDICTOR uses the fixed midpoint weight
            rhos_p=[0.5], which with B(h)=e^h-1 reduces exactly to the
            DPM-Solver++(2M) midpoint update — same (a, b, c) family;
          * the CORRECTOR re-derives the i-1 -> i transition with THIS
            step's x0-prediction appended (rhos_c from the 2x2 Vandermonde
            solve), which is affine in (x_{i-1}, m_i, m_{i-1}, m_{i-2})
            with host-computable weights.
        The corrector at step i runs at the order the predictor used at
        step i-1 (diffusers carries self.this_order across the boundary).
        m_i is converted from the UNCORRECTED x_i, like diffusers
        (convert_model_output runs before multistep_uni_c_bh_update).
        """
        timesteps, sigmas = _solver_grid(
            schedule, num_inference_steps, use_karras_sigmas,
            integer_timesteps=True,
        )
        split = _vp_split

        def lam(sig):
            a_t, s_t = split(sig)
            return np.log(a_t / s_t)

        N = num_inference_steps
        a = np.zeros(N)
        b = np.zeros(N)
        c = np.zeros(N)
        eps_coef = np.zeros(N)
        x0_scale = np.zeros(N)
        ci = np.zeros(N)
        ca = np.zeros(N)
        cb_this = np.zeros(N)
        cb_prev = np.zeros(N)
        cb_pp = np.zeros(N)

        orders = []
        lower_order_nums = 0
        for i in range(N):
            sigma_s0 = sigmas[i]
            sigma_t = sigmas[i + 1]
            alpha_s0, sig_s0 = split(sigma_s0)
            eps_coef[i] = sig_s0
            x0_scale[i] = 1.0 / alpha_s0

            # ---- corrector for the (i-1 -> i) transition, at the order the
            # step-(i-1) predictor ran (diffusers: self.this_order)
            if i == 0:
                ci[i] = 1.0  # no corrector on the first step
            else:
                corder = orders[i - 1]
                s_prev = sigmas[i - 1]
                alpha_c, sig_c = split(sigma_s0)  # correction target: sigma_i
                alpha_p, sig_p = split(s_prev)
                h_c = lam(sigma_s0) - lam(s_prev)
                hh = -h_c  # predict_x0
                h_phi_1 = np.expm1(hh)
                B_h = h_phi_1  # bh2
                b1 = (h_phi_1 / hh - 1.0) / B_h
                ca[i] = sig_c / sig_p
                if corder == 1:
                    rho = 0.5
                    cb_prev[i] = -alpha_c * h_phi_1 + alpha_c * B_h * rho
                    cb_this[i] = -alpha_c * B_h * rho
                else:
                    # rk for the history point m_{i-2}
                    rk0 = (lam(sigmas[i - 2]) - lam(s_prev)) / h_c
                    b2 = 2.0 * ((h_phi_1 / hh - 1.0) / hh - 0.5) / B_h
                    R = np.array([[1.0, 1.0], [rk0, 1.0]])
                    rhos = np.linalg.solve(R, np.array([b1, b2]))
                    cb_prev[i] = -alpha_c * h_phi_1 + alpha_c * B_h * (
                        rhos[0] / rk0 + rhos[1]
                    )
                    cb_pp[i] = -alpha_c * B_h * rhos[0] / rk0
                    cb_this[i] = -alpha_c * B_h * rhos[1]

            # ---- predictor order bookkeeping (diffusers step())
            this_order = (
                min(solver_order, N - i) if lower_order_final else solver_order
            )
            this_order = min(this_order, lower_order_nums + 1)
            orders.append(this_order)
            if lower_order_nums < solver_order:
                lower_order_nums += 1

            # ---- predictor (bh2; order 2 == DPM++(2M) midpoint)
            if sigma_t == 0.0:
                a[i], b[i], c[i] = 0.0, 1.0, 0.0
                continue
            alpha_t, sig_t = split(sigma_t)
            h = lam(sigma_t) - lam(sigma_s0)
            em1 = np.expm1(-h)
            a[i] = sig_t / sig_s0
            if this_order == 1:
                b[i] = -alpha_t * em1
            else:
                r0 = (lam(sigmas[i - 1]) - lam(sigma_s0)) / h
                B_h = em1  # bh2
                b[i] = -alpha_t * em1 + alpha_t * B_h * 0.5 / r0
                c[i] = -alpha_t * B_h * 0.5 / r0

        return DPMSolverMultistep(
            timesteps=timesteps,
            sigmas=sigmas,
            a=a,
            b=b,
            c=c,
            eps_coef=eps_coef,
            x0_scale=x0_scale,
            corr_ci=ci,
            corr_a=ca,
            corr_b_this=cb_this,
            corr_b_prev=cb_prev,
            corr_b_pp=cb_pp,
        )

    @property
    def num_steps(self) -> int:
        """Model evaluations of one trajectory (2N-1 for Heun and DPM++ 2S a,
        N+1 for PNDM)."""
        return len(self.timesteps)

    @property
    def has_corrector(self) -> bool:
        """True for UniPC (predictor-corrector carry)."""
        return self.corr_ci is not None

    @property
    def has_lms(self) -> bool:
        """True for LMS (derivative-history carry)."""
        return self.lms_c is not None

    @property
    def has_pndm(self) -> bool:
        """True for PNDM/PLMS (5-slot eps-history carry)."""
        return self.pndm_c is not None

    @property
    def is_ancestral(self) -> bool:
        """True when any step injects fresh noise (the engine then needs
        noise per batch row)."""
        return self.noise_sigma is not None and bool(np.any(self.noise_sigma != 0))

    def step_inputs(self, device="cuda") -> Dict[str, torch.Tensor]:
        """Per-step tables on `device` (the card unless the caller asks for
        the CPU), cached per device. `t` is int64 for integer grids and
        float32 for fractional ones (Euler linspace, Karras
        log-sigma-interpolated), which feed fractional timesteps to the
        sinusoidal embedding as diffusers does; the coefficients are f32."""
        key = str(torch.device(device))
        if key in self._tables:
            return self._tables[key]
        t_np = np.asarray(self.timesteps)
        integral = np.all(t_np == np.round(t_np))
        t_np = t_np.astype(np.int64) if integral else t_np.astype(np.float32)
        out = {"t": torch.as_tensor(t_np, device=device)}
        names = ["a", "b", "c", "eps_coef", "x0_scale"]
        if self.is_ancestral:
            names.append("noise_sigma")
        if self.has_corrector:
            names += ["corr_ci", "corr_a", "corr_b_this", "corr_b_prev", "corr_b_pp"]
        if self.has_lms:
            names.append("lms_c")
        if self.has_pndm:
            names.append("pndm_c")
        for k in names:
            out[k] = torch.as_tensor(np.asarray(getattr(self, k), np.float32), device=device)
        self._tables[key] = out
        return out

    # the carry: denoise is written against these four functions

    def init_carry(self, latents: torch.Tensor) -> tuple:
        z = torch.zeros_like(latents)
        if self.has_corrector:
            return (latents, z, z, z)  # (x, x_prev_corrected, m_prev, m_pp)
        if self.has_lms:
            return (latents, z, z, z)  # (x, d_prev, d_pp, d_ppp)
        if self.has_pndm:
            return (latents, z, z, z, z)  # (x, e1, e2, e3, e4)
        return (latents, z)  # (x, m_prev)

    @staticmethod
    def latent(carry: tuple) -> torch.Tensor:
        """The latent the model is evaluated on this step."""
        return carry[0]

    @staticmethod
    def replace_latent(carry: tuple, lat: torch.Tensor) -> tuple:
        return (lat,) + tuple(carry[1:])

    def advance(self, step: Dict[str, torch.Tensor], carry: tuple, eps: torch.Tensor) -> tuple:
        """One solver update, the corrector (if any) then the predictor.
        `eps` is the model output at `latent(carry)`, the uncorrected
        sample, as diffusers converts before it corrects."""
        dt = carry[0].dtype
        g = lambda k: step[k].to(dt)  # noqa: E731
        if self.has_lms:
            lat, d1, d2, d3 = carry
            lc = g("lms_c")  # (4,)
            nxt = g("a") * lat + lc[0] * eps + lc[1] * d1 + lc[2] * d2 + lc[3] * d3
            return (nxt, eps, d1, d2)
        if self.has_pndm:
            lat, e1, e2, e3, e4 = carry
            pc = g("pndm_c")  # (5,)
            nxt = g("a") * lat + pc[0] * eps + pc[1] * e1 + pc[2] * e2 + pc[3] * e3 + pc[4] * e4
            return (nxt, eps, e1, e2, e3)
        if not self.has_corrector:
            lat, m_prev = carry
            return self.step(step, lat, eps, m_prev)
        lat, x_prev, m_prev, m_pp = carry
        m = (lat - g("eps_coef") * eps) * g("x0_scale")
        lat_c = (
            g("corr_ci") * lat
            + g("corr_a") * x_prev
            + g("corr_b_this") * m
            + g("corr_b_prev") * m_prev
            + g("corr_b_pp") * m_pp
        )
        nxt = g("a") * lat_c + g("b") * m + g("c") * m_prev
        return (nxt, lat_c, m, m_prev)

    def step(self, step, latents, eps, m_prev) -> Tuple[torch.Tensor, torch.Tensor]:
        """One (x, m_prev) update given this step's slice of `step_inputs`;
        returns (new latents, x0-prediction to carry)."""
        dt = latents.dtype
        g = lambda k: step[k].to(dt)  # noqa: E731
        m = (latents - g("eps_coef") * eps) * g("x0_scale")
        return g("a") * latents + g("b") * m + g("c") * m_prev, m

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor, step_index: int) -> torch.Tensor:
        """Noise a clean sample to solver step `step_index` (0 = most noise)."""
        sigma = float(self.sigmas[step_index])
        alpha_t = 1.0 / np.sqrt(sigma**2 + 1.0)
        return (alpha_t * sample + sigma * alpha_t * noise).to(sample.dtype)


# Public sampler names accepted by the CLIs (generate --scheduler,
# serve request "scheduler"): base samplers plus "_karras"-suffixed
# Karras-sigma variants (DDIM's grid is defined by its leading spacing —
# no karras variant, like diffusers).
SCHEDULER_NAMES = (
    "dpm",
    "ddim",
    "euler",
    "euler_a",
    "unipc",
    "dpm_sde",
    "dpm_karras",
    "euler_karras",
    "euler_a_karras",
    "unipc_karras",
    "dpm_sde_karras",
    "heun",
    "heun_karras",
    "lms",
    "lms_karras",
    "dpm_2s_a",
    "dpm_2s_a_karras",
    "pndm",
)


def make_solver(
    schedule: DDPMSchedule,
    name: str,
    num_inference_steps: int,
    use_karras_sigmas: bool = False,
) -> DPMSolverMultistep:
    """Solver factory shared by generate/serve.

    `name` is one of SCHEDULER_NAMES; a "_karras" suffix (or
    use_karras_sigmas=True) selects the Karras rho-7 sigma grid."""
    if name.endswith("_karras"):
        name = name[: -len("_karras")]
        use_karras_sigmas = True
    if name == "dpm":
        return DPMSolverMultistep.create(
            schedule, num_inference_steps, use_karras_sigmas=use_karras_sigmas
        )
    if name == "dpm_sde":
        return DPMSolverMultistep.create(
            schedule, num_inference_steps,
            use_karras_sigmas=use_karras_sigmas, sde=True,
        )
    if name == "ddim":
        if use_karras_sigmas:
            raise ValueError("ddim has no karras-sigma variant")
        return DPMSolverMultistep.create_ddim(schedule, num_inference_steps)
    if name == "pndm":
        if use_karras_sigmas:
            raise ValueError("pndm has no karras-sigma variant")
        return DPMSolverMultistep.create_pndm(schedule, num_inference_steps)
    if name in ("euler", "euler_a"):
        return DPMSolverMultistep.create_euler(
            schedule,
            num_inference_steps,
            ancestral=name == "euler_a",
            use_karras_sigmas=use_karras_sigmas,
        )
    if name == "unipc":
        return DPMSolverMultistep.create_unipc(
            schedule, num_inference_steps, use_karras_sigmas=use_karras_sigmas
        )
    if name == "heun":
        return DPMSolverMultistep.create_heun(
            schedule, num_inference_steps, use_karras_sigmas=use_karras_sigmas
        )
    if name == "lms":
        return DPMSolverMultistep.create_lms(
            schedule, num_inference_steps, use_karras_sigmas=use_karras_sigmas
        )
    if name == "dpm_2s_a":
        return DPMSolverMultistep.create_dpm_2s_ancestral(
            schedule, num_inference_steps, use_karras_sigmas=use_karras_sigmas
        )
    raise ValueError(
        f"unknown scheduler: {name!r} (expected one of {SCHEDULER_NAMES})"
    )


def make_sd15_schedule() -> DDPMSchedule:
    """The Stable Diffusion 1.5 training schedule (scaled_linear, 1000 steps)."""
    return DDPMSchedule.create()
