"""Content-aware Performance Estimator (paper §IV-D, Table II); port of
``repro.offload.estimator``.

Three estimator families for compressed size S(c) and inference accuracy
A(c):
  * MLPEstimator      — the paper's choice: 3-layer MLP (128, 64, 1), a
                        torch module trained with the port's AdamW
                        (``optim.adam``) on offline profiling data
  * LinearEstimator   — least-squares baseline on the same features
  * OfflineMean       — static mean of the profiling data

plus the delay models of Eq. (2): profiled T_enc(N_d, lambda), mean
T_dec, per-beta linear inference-delay models LM^inf_beta(N_d), and the
short-window throughput/RTT estimator.  Everything but the MLP is numpy,
as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.optim import adam

# feature vector: (tau_d, N_d, m_d, m_f, lambda, mu_rho, sigma_rho, beta)
N_FEATURES = 8


def feature_vector(tau_d: int, n_d: int, m_d: float, m_f: float,
                   quality: int, mu_rho: float, sigma_rho: float,
                   beta: int) -> np.ndarray:
    return np.array([tau_d, n_d, m_d, m_f, quality / 100.0,
                     mu_rho, sigma_rho, beta], np.float32)


# ---------------------------------------------------------------------------
# MLP (the paper's estimator; Optuna-tuned architecture 128-64-1)


def _init_mlp(generator: torch.Generator,
              sizes=(N_FEATURES, 128, 64, 1)) -> List[Dict[str, torch.Tensor]]:
    """Normal weights scaled by 1 / sqrt(fan_in), zero biases, drawn on
    ``generator.device``."""
    params = []
    for i in range(len(sizes) - 1):
        w = torch.randn((sizes[i], sizes[i + 1]), generator=generator,
                        device=generator.device) / np.sqrt(sizes[i])
        params.append({"w": w, "b": torch.zeros((sizes[i + 1],),
                                                device=generator.device)})
    return params


class MLPEstimator(nn.Module):
    """Predicts a scalar target from config+content features.

    The weights are drawn from a CPU ``torch.Generator`` seeded with
    ``seed`` and then moved to ``device``, so one seed gives the same
    start on every device."""

    def __init__(self, seed: int = 0, device: str = "cuda"):
        super().__init__()
        self.device = torch.device(device)
        params = _init_mlp(torch.Generator().manual_seed(seed))
        self.w = nn.ParameterList([nn.Parameter(p["w"]) for p in params])
        self.b = nn.ParameterList([nn.Parameter(p["b"]) for p in params])
        self.to(self.device)
        self.x_mean = np.zeros(N_FEATURES, np.float32)
        self.x_std = np.ones(N_FEATURES, np.float32)
        self.y_mean, self.y_std = 0.0, 1.0

    def load_params(self, params: Sequence[Dict[str, torch.Tensor]]) -> None:
        """Take the layers' {w (in, out), b (out,)} (e.g. from
        ``convert.mlp_params_from_jax``)."""
        with torch.no_grad():
            for w, b, p in zip(self.w, self.b, params):
                w.copy_(p["w"])
                b.copy_(p["b"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = x @ w + b
            if i < len(self.w) - 1:
                x = torch.relu(x)
        return x[..., 0]

    def fit(self, X: np.ndarray, y: np.ndarray, steps: int = 2000,
            lr: float = 3e-3, batch: int = 256, seed: int = 0) -> None:
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32)
        self.x_mean = X.mean(0)
        self.x_std = X.std(0) + 1e-6
        self.y_mean, self.y_std = float(y.mean()), float(y.std() + 1e-6)
        Xn = torch.as_tensor((X - self.x_mean) / self.x_std,
                             device=self.device)
        yn = torch.as_tensor((y - self.y_mean) / self.y_std,
                             device=self.device)

        params = dict(self.named_parameters())
        state = adam.init_adam(params)
        rng = np.random.default_rng(seed)
        for s in range(steps):
            idx = torch.as_tensor(
                rng.integers(0, len(Xn), min(batch, len(Xn))),
                device=self.device)
            loss = torch.mean(torch.square(self(Xn[idx]) - yn[idx]))
            grads = torch.autograd.grad(loss, list(params.values()))
            _, state, _ = adam.adam_update(       # in place
                dict(zip(params, grads)), state,
                {k: p.detach() for k, p in params.items()},
                lr=lr * (0.1 ** (s / steps)))

    def predict(self, X: np.ndarray) -> np.ndarray:
        Xn = (np.asarray(X, np.float32) - self.x_mean) / self.x_std
        with torch.no_grad():
            out = self(torch.as_tensor(Xn, device=self.device))
        return out.cpu().numpy() * self.y_std + self.y_mean


class LinearEstimator:
    """Closed-form least squares on the same features (Table II row 1)."""

    def __init__(self):
        self.w: Optional[np.ndarray] = None

    def fit(self, X, y, **kw):
        X = np.asarray(X, np.float64)
        A = np.concatenate([X, np.ones((len(X), 1))], axis=1)
        self.w, *_ = np.linalg.lstsq(A, np.asarray(y, np.float64),
                                     rcond=None)

    def predict(self, X):
        X = np.asarray(X, np.float64)
        A = np.concatenate([X, np.ones((len(X), 1))], axis=1)
        return A @ self.w


class OfflineMean:
    """Static profiling mean (Table II row 2)."""

    def __init__(self):
        self.mean = 0.0

    def fit(self, X, y, **kw):
        self.mean = float(np.mean(y))

    def predict(self, X):
        return np.full((len(X),), self.mean)


def regression_metrics(y_true, y_pred) -> Dict[str, float]:
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    err = y_pred - y_true
    mae = float(np.mean(np.abs(err)))
    rmse = float(np.sqrt(np.mean(err ** 2)))
    # floor the denominator at 5% of the target scale: near-zero targets
    # (empty-frame F1) otherwise make MAPE meaningless
    scale = max(float(np.abs(y_true).mean()), 1e-9)
    denom = np.maximum(np.abs(y_true), 0.05 * scale)
    mape = float(np.mean(np.abs(err) / denom) * 100.0)
    ss_res = float(np.sum(err ** 2))
    ss_tot = float(np.sum((y_true - y_true.mean()) ** 2) + 1e-12)
    return {"MAE": mae, "RMSE": rmse, "MAPE": mape,
            "R2": 1.0 - ss_res / ss_tot}


# ---------------------------------------------------------------------------
# delay models (Eq. 2)


@dataclass
class InferenceDelayModel:
    """LM^inf_beta(N_d, N_r): per-beta linear models
    ``a_beta * N_d + r_beta * N_r + b_beta``.

    Parameterised from the ViTDet FLOP model calibrated to the paper's
    measured full-res delay (fit_from_flops) or from profiling samples.
    ``N_r`` is the number of temporally REUSED regions (zero tokens
    before the restoration point); a model fitted without the reuse term
    (2-tuple coefs) treats it as free — callers that never reuse are
    unaffected."""
    coefs: Dict[int, Tuple[float, ...]] = field(default_factory=dict)

    def __call__(self, beta: int, n_d: int, n_reuse: int = 0) -> float:
        c = self.coefs[int(beta)]
        if len(c) == 2:
            a, b = c
            return a * n_d + b
        a, r, b = c
        return a * n_d + r * n_reuse + b

    @classmethod
    def fit_from_flops(cls, flops_fn: Callable[..., float],
                       n_regions: int, betas: Sequence[int],
                       full_res_delay_s: float) -> "InferenceDelayModel":
        """flops_fn(n_low, beta[, n_reuse]) -> FLOPs; anchored so that
        n_low=0 costs ``full_res_delay_s`` (the paper's 1080p ViTDet-L
        measurement).  A 3-argument flops_fn fits the reuse plane; a
        2-argument one falls back to the legacy N_d-only line."""
        try:
            flops_fn(0, int(betas[0]), 0)
            with_reuse = True
        except TypeError:
            with_reuse = False
        f_full = flops_fn(0, 0, 0) if with_reuse else flops_fn(0, 0)
        scale = full_res_delay_s / f_full
        coefs: Dict[int, Tuple[float, ...]] = {}
        for b in betas:
            if with_reuse and b >= 1:
                feats, ys = [], []
                for n in range(0, n_regions + 1):
                    for r in range(0, n_regions + 1 - n):
                        feats.append((n, r, 1.0))
                        ys.append(flops_fn(n, b, r) * scale)
                sol, *_ = np.linalg.lstsq(np.array(feats, np.float64),
                                          np.array(ys, np.float64),
                                          rcond=None)
                coefs[int(b)] = tuple(float(v) for v in sol)
            else:
                xs = np.arange(0, n_regions + 1)
                ys = np.array([(flops_fn(int(n), b, 0) if with_reuse
                                else flops_fn(int(n), b)) * scale
                               for n in xs])
                a, c = np.polyfit(xs, ys, 1)
                coefs[int(b)] = (float(a), float(c))
        return cls(coefs)


@dataclass
class ThroughputEstimator:
    """Short-window mean of recent observations (paper: last two).

    Hardened for the failure model: ``min_tput_bps`` floors the estimate
    (a blackout-era near-zero sample would otherwise drive Eq. (2)'s
    transmission-delay terms toward infinity and wedge config
    selection), and observations older than ``max_age_s`` relative to
    the newest are expired rather than averaged — after a blackout the
    first fresh sample speaks alone instead of being blended with the
    pre-blackout world.  Callers that pass no ``t`` keep the legacy
    pure-window behaviour (each observation ages the horizon by 1 s).
    """
    window: int = 2
    min_tput_bps: float = 5e4
    max_age_s: float = 30.0
    obs_tput: List[float] = field(default_factory=list)
    obs_rtt: List[float] = field(default_factory=list)
    obs_t: List[float] = field(default_factory=list)

    def observe(self, tput_bps: float, rtt_s: float,
                t: Optional[float] = None) -> None:
        if t is None:
            t = (self.obs_t[-1] + 1.0) if self.obs_t else 0.0
        # expire stale observations BEFORE the window trim so a lone
        # fresh post-gap sample is not averaged with a pre-gap one
        while self.obs_t and t - self.obs_t[0] > self.max_age_s:
            del self.obs_tput[0], self.obs_rtt[0], self.obs_t[0]
        self.obs_tput.append(tput_bps)
        self.obs_rtt.append(rtt_s)
        self.obs_t.append(t)
        # only the last ``window`` observations are ever read — trim so
        # long-running clients don't grow the lists without bound
        if len(self.obs_tput) > self.window:
            del self.obs_tput[:-self.window]
            del self.obs_rtt[:-self.window]
            del self.obs_t[:-self.window]

    @property
    def throughput(self) -> float:
        if not self.obs_tput:
            return 10e6
        return max(self.min_tput_bps,
                   float(np.mean(self.obs_tput[-self.window:])))

    @property
    def rtt(self) -> float:
        if not self.obs_rtt:
            return 0.04
        return float(np.mean(self.obs_rtt[-self.window:]))
