"""Multistep flow-matching solvers: DPM-Solver++ and UniPC (port of
`stableavatar_tpu/schedulers/fm_solvers.py`).

Rectified-flow parameterisation: x_t = (1 - sigma) x0 + sigma eps, velocity
v -> data prediction x0 = x - sigma v.  The per-step structure of each
solver (first / last step, warm-up order, lower-order final) is folded on
the host into a handful of scalar coefficients (`dpm_coeffs`,
`unipc_coeffs`: float64 numpy, rounded to float32 at the boundary, copied
from the JAX package); `dpm_apply` / `unipc_apply` are the fp32 tensor
updates.  The solver history (previous x0 predictions) is explicit state
carried by the caller.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from stableavatar_tpu_torch.schedulers.flow_match import (
    FlowMatchEulerSchedule,
    flow_match_timesteps,
)


def get_sampling_sigmas(sampling_steps: int, shift: float):
    """Shifted sigma ladder of the reference entry points."""
    sigma = np.linspace(1, 0, sampling_steps + 1)[:sampling_steps]
    return shift * sigma / (1 + (shift - 1) * sigma)


def _make_sched(num_steps: int, shift: float, sigmas=None) -> FlowMatchEulerSchedule:
    """The default shifted ladder, or `sigmas` (S + 1 values with the
    terminal one)."""
    if sigmas is None:
        return flow_match_timesteps(num_steps, shift=shift)
    sig = np.asarray(sigmas, np.float32)
    return FlowMatchEulerSchedule(sigmas=sig, timesteps=sig[:-1] * np.float32(1000.0))


def _f32(x) -> float:
    """A host coefficient rounded to float32 (the JAX package's jnp.float32)."""
    return float(np.float32(x))


@dataclasses.dataclass
class MultistepState:
    """Solver history: previous x0 predictions, and (UniPC) the sample the
    last predictor started from and the order it used."""

    x0_prev: Optional[torch.Tensor] = None
    x0_prev2: Optional[torch.Tensor] = None
    x0_prev3: Optional[torch.Tensor] = None
    last_sample: Optional[torch.Tensor] = None
    prev_order: int = 1


def dpm_effective_order(i: int, num_steps: int, order: int,
                        lower_order_final: bool = True,
                        euler_at_final: bool = False) -> int:
    """The order the reference DPM++ step uses at step i: order 1 at the
    first and last step, at most 2 at step 1, and 2 at the second-to-last
    step of runs shorter than 15 steps with `lower_order_final`
    (`euler_at_final` is a no-op on the zero terminal sigma)."""
    del euler_at_final
    if i == 0 or i == num_steps - 1 or order == 1:
        return 1
    if order == 2 or i == 1 or (i == num_steps - 2 and num_steps < 15 and lower_order_final):
        return 2
    return 3


def dpm_coeffs(sched: FlowMatchEulerSchedule, i: int, order: int,
               solver_type: str = "midpoint", lower_order_final: bool = True,
               euler_at_final: bool = False):
    """Per-step scalars of the DPM-Solver++ update, linear in the x0
    history:  x0 = sample - sigma_i v;
    x_next = A sample + b0 x0 + b1 x0_prev + b2 x0_prev2."""
    if solver_type not in ("midpoint", "heun"):
        raise ValueError(f"unknown solver_type {solver_type!r}")

    def out(A=0.0, b0=0.0, b1=0.0, b2=0.0):
        return {k: _f32(v) for k, v in dict(A=A, b0=b0, b1=b1, b2=b2).items()}

    eff = dpm_effective_order(i, sched.num_steps, order, lower_order_final, euler_at_final)
    if i == sched.num_steps - 1:
        return out(b0=1.0)  # the final step to sigma = 0 lands on x0
    sig = np.asarray(sched.sigmas, np.float64)

    def lam(s):
        return float(np.log(max(1.0 - s, 1e-6)) - np.log(max(s, 1e-6)))

    s_i, s_n = sig[i], sig[i + 1]
    h = lam(s_n) - lam(s_i)
    a_n = 1.0 - s_n
    A = s_n / s_i
    B = -a_n * np.expm1(-h)
    if eff == 1:
        return out(A=A, b0=B)
    r0 = (lam(s_i) - lam(sig[i - 1])) / h
    if eff == 2:
        if solver_type == "heun":
            G1 = a_n * (np.expm1(-h) / h + 1.0)
            return out(A=A, b0=B + G1 / r0, b1=-G1 / r0)
        c = 1.0 / (2.0 * r0)
        return out(A=A, b0=B * (1.0 + c), b1=-B * c)
    r1 = (lam(sig[i - 1]) - lam(sig[i - 2])) / h
    G1 = a_n * (np.expm1(-h) / h + 1.0)
    G2 = -a_n * ((np.expm1(-h) + h) / (h * h) - 0.5)
    w = r0 / (r0 + r1)
    b0 = B + G1 * (1.0 + w) / r0 + G2 / (r0 * (r0 + r1))
    b1 = (-G1 * ((1.0 + w) / r0 + w / r1)
          - G2 * (1.0 / r0 + 1.0 / r1) / (r0 + r1))
    b2 = G1 * w / r1 + G2 / (r1 * (r0 + r1))
    return out(A=A, b0=b0, b1=b1, b2=b2)


def dpm_apply(sample, v, sigma_i, x0_prev, x0_prev2, *, A, b0, b1, b2):
    """DPM++ update of any order in fp32; returns (x_next, x0)."""
    sample = sample.float()
    v = v.float()
    x0 = sample - float(sigma_i) * v
    return A * sample + b0 * x0 + b1 * x0_prev + b2 * x0_prev2, x0


def _unipc_rhos(hh: float, b_h: float, rks, order: int, corrector: bool):
    """rho weights of the D1 differences (the reference's R/b system)."""
    rks = np.asarray(list(rks) + [1.0], np.float64)
    R, b = [], []
    h_phi_k = np.expm1(hh) / hh - 1.0
    factorial_i = 1.0
    for k in range(1, order + 1):
        R.append(rks ** (k - 1))
        b.append(h_phi_k * factorial_i / b_h)
        factorial_i *= k + 1
        h_phi_k = h_phi_k / hh - 1.0 / factorial_i
    R = np.stack(R)
    b = np.asarray(b, np.float64)
    if corrector:
        if order == 1:
            return np.asarray([0.5])
        return np.linalg.solve(R, b)
    if order == 2:
        return np.asarray([0.5])
    return np.linalg.solve(R[:-1, :-1], b[:-1])


def unipc_coeffs(sched: FlowMatchEulerSchedule, i: int, order: int, prev_order: int,
                 solver_type: str = "bh2", use_corrector: bool = True):
    """Per-step scalars of the UniPC update (corrector, then predictor,
    orders 1-3, bh1 / bh2), linear as

        x0        = sample - sigma_i v
        corrected = Cs sample + Cx last_sample + Cm x0_prev
                    + Cd1 (x0 - x0_prev) + Cd1s (x0_prev2 - x0_prev)
                    + Cd1s2 (x0_prev3 - x0_prev)
        x_next    = Px corrected + P0 x0 + Pd (x0_prev - x0) + Pd2 (x0_prev2 - x0)

    Returns (coefficients, the order this step's predictor used)."""
    if solver_type not in ("bh1", "bh2"):
        raise ValueError(f"unknown solver_type {solver_type!r}")
    if order > 3:
        raise ValueError("UniPC orders 1-3 supported (reference default 2)")
    sig = np.asarray(sched.sigmas, np.float64)

    def lam(s):
        return float(np.log(max(1.0 - s, 1e-10)) - np.log(max(s, 1e-10)))

    z, one = 0.0, 1.0
    this_order = min(order, sched.num_steps - i, i + 1)
    zc = {"Cs": z, "Cx": z, "Cm": z, "Cd1": z, "Cd1s": z, "Cd1s2": z}
    if i == 0 or not use_corrector:
        cc = dict(zc, Cs=one)
    else:
        s_t, s_s0 = sig[i], sig[i - 1]
        a_t = 1.0 - s_t
        h = lam(s_t) - lam(s_s0)
        hh = -h
        h_phi_1 = np.expm1(hh)
        b_h = hh if solver_type == "bh1" else h_phi_1
        p = prev_order  # the corrector runs at the last predictor's order
        rks = [(lam(sig[i - 1 - k]) - lam(s_s0)) / h for k in range(1, p)]
        rhos = _unipc_rhos(hh, b_h, rks, p, corrector=True)
        cc = dict(zc, Cx=_f32(s_t / s_s0), Cm=_f32(-a_t * h_phi_1),
                  Cd1=_f32(-a_t * b_h * rhos[-1]))
        for k, key in zip(range(1, p), ("Cd1s", "Cd1s2")):
            cc[key] = _f32(-a_t * b_h * rhos[k - 1] / rks[k - 1])
    if i == sched.num_steps - 1:
        cc.update({"Px": z, "P0": one, "Pd": z, "Pd2": z})
    else:
        s_i, s_n = sig[i], sig[i + 1]
        a_n = 1.0 - s_n
        h = lam(s_n) - lam(s_i)
        hh = -h
        h_phi_1 = np.expm1(hh)
        b_h = hh if solver_type == "bh1" else h_phi_1
        cc.update({"Px": _f32(s_n / s_i), "P0": _f32(-a_n * h_phi_1), "Pd": z, "Pd2": z})
        if this_order >= 2:
            rks = [(lam(sig[i - k]) - lam(s_i)) / h for k in range(1, this_order)]
            rhos = _unipc_rhos(hh, b_h, rks, this_order, corrector=False)
            for k, key in zip(range(1, this_order), ("Pd", "Pd2")):
                cc[key] = _f32(-a_n * b_h * rhos[k - 1] / rks[k - 1])
    return cc, this_order


def unipc_apply(sample, v, sigma_i, x0_prev, x0_prev2, last_sample, *,
                Cs, Cx, Cm, Cd1, Px, P0, Pd,
                x0_prev3=None, Cd1s=None, Cd1s2=None, Pd2=None):
    """UniPC update in fp32; returns (x_next, x0, corrected sample).  x0
    comes from the incoming (uncorrected) sample and enters the history."""
    sample = sample.float()
    v = v.float()
    x0 = sample - float(sigma_i) * v
    corrected = Cs * sample + Cx * last_sample + Cm * x0_prev + Cd1 * (x0 - x0_prev)
    if Cd1s is not None:
        corrected = corrected + Cd1s * (x0_prev2 - x0_prev)
    if Cd1s2 is not None and x0_prev3 is not None:
        corrected = corrected + Cd1s2 * (x0_prev3 - x0_prev)
    x_t = Px * corrected + P0 * x0 + Pd * (x0_prev - x0)
    if Pd2 is not None:
        x_t = x_t + Pd2 * (x0_prev2 - x0)
    return x_t, x0, corrected


class FlowDPMSolverMultistep:
    """DPM-Solver++ multistep (orders 1-3) on the flow-matching ladder."""

    def __init__(self, num_steps: int, shift: float = 5.0, order: int = 2, sigmas=None,
                 solver_type: str = "midpoint", lower_order_final: bool = True,
                 euler_at_final: bool = False):
        self.sched = _make_sched(num_steps, shift, sigmas)
        self.order = order
        self.solver_type = solver_type
        self.lower_order_final = lower_order_final
        self.euler_at_final = euler_at_final

    @property
    def timesteps(self):
        return self.sched.timesteps

    @property
    def sigmas(self):
        return self.sched.sigmas

    def step(self, v: torch.Tensor, i: int, sample: torch.Tensor,
             state: MultistepState) -> Tuple[torch.Tensor, MultistepState]:
        sample = sample.float()
        zeros = torch.zeros_like(sample)
        co = dpm_coeffs(self.sched, i, self.order, self.solver_type,
                        self.lower_order_final, self.euler_at_final)
        out, x0 = dpm_apply(
            sample, v, self.sched.sigmas[i],
            state.x0_prev if state.x0_prev is not None else zeros,
            state.x0_prev2 if state.x0_prev2 is not None else zeros, **co)
        return out, MultistepState(x0, state.x0_prev)


class FlowUniPCMultistep:
    """UniPC (predictor + corrector, x0 prediction) on the flow-matching
    ladder: each step first corrects the previous prediction with the fresh
    model evaluation, then predicts from the corrected sample."""

    def __init__(self, num_steps: int, shift: float = 5.0, order: int = 2, sigmas=None,
                 solver_type: str = "bh2", disable_corrector=()):
        self.sched = _make_sched(num_steps, shift, sigmas)
        self.order = order
        self.solver_type = solver_type
        # step i's corrector is skipped when i - 1 is listed (the reference's rule)
        self.disable_corrector = tuple(disable_corrector)

    @property
    def timesteps(self):
        return self.sched.timesteps

    @property
    def sigmas(self):
        return self.sched.sigmas

    def step(self, v: torch.Tensor, i: int, sample: torch.Tensor,
             state: MultistepState) -> Tuple[torch.Tensor, MultistepState]:
        sample = sample.float()
        zeros = torch.zeros_like(sample)
        co, this_order = unipc_coeffs(self.sched, i, self.order, state.prev_order,
                                      self.solver_type,
                                      use_corrector=(i - 1) not in self.disable_corrector)
        x_t, x0, corrected = unipc_apply(
            sample, v, self.sched.sigmas[i],
            state.x0_prev if state.x0_prev is not None else zeros,
            state.x0_prev2 if state.x0_prev2 is not None else zeros,
            state.last_sample if state.last_sample is not None else zeros,
            x0_prev3=state.x0_prev3 if state.x0_prev3 is not None else zeros, **co)
        return x_t, MultistepState(x0_prev=x0, x0_prev2=state.x0_prev,
                                   x0_prev3=state.x0_prev2, last_sample=corrected,
                                   prev_order=this_order)
