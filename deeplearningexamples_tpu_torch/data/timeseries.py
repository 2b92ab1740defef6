"""Copy of ``deeplearningexamples_tpu/data/timeseries.py``: windowed
time-series datasets and the forecast metrics.

The equivalent of the reference TimeSeriesPredictionPlatform
(``Tools/PyTorch/TimeSeriesPredictionPlatform/``): the dataset abstraction
(``data/datasets.py`` — feature-spec-driven sliding windows over per-series
CSV columns with temporal train/valid/test splits and train-fit
standardization) and the evaluator metric suite
(``evaluators/evaluation_metrics.py``: MAE, RMSE, SMAPE, ND, normalized
P50/P90 quantile losses). Hydra config layering is replaced by the
framework's own dataclass+YAML config system; the model zoo entry is the
shared TFT (``models/tft.py``). numpy only, as in the JAX package.

Static-shape batches: {"observed" (B, enc, n_obs), "known" (B, enc+hor,
n_known), "target" (B, hor)} — exactly the TFTTask contract.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

__all__ = ["TimeSeriesSpec", "WindowedTimeSeriesDataset",
           "forecast_metrics", "make_synthetic_series"]


@dataclass(frozen=True)
class TimeSeriesSpec:
    """Feature-spec role declaration (reference TSPP conf/dataset yaml)."""

    observed: tuple[int, ...]  # column indices observed only in the past
    known: tuple[int, ...]  # columns known into the future (calendar etc.)
    target: int  # column forecast (must also be in observed)
    encoder_length: int = 168
    horizon: int = 24


class WindowedTimeSeriesDataset:
    """Sliding windows over (n_series, n_steps, n_cols) arrays.

    Temporal split: first ``train_frac`` of every series is train, next
    ``valid_frac`` valid, rest test (the reference splits on date
    boundaries per dataset config — same structure). Standardization is
    fit on the train range only and applied everywhere.
    """

    def __init__(self, data: np.ndarray, spec: TimeSeriesSpec,
                 batch_size: int, *, split: str = "train",
                 train_frac: float = 0.7, valid_frac: float = 0.15,
                 stride: int = 1, seed: int = 0, shuffle: bool | None = None):
        assert data.ndim == 3, "expect (n_series, n_steps, n_cols)"
        self.spec = spec
        self.batch_size = batch_size
        self.split = split
        self.shuffle = shuffle if shuffle is not None else (split == "train")
        self.seed = seed
        n_steps = data.shape[1]
        t_end = int(n_steps * train_frac)
        v_end = int(n_steps * (train_frac + valid_frac))
        # standardize with train statistics
        train_part = data[:, :t_end].reshape(-1, data.shape[-1])
        self.mean = train_part.mean(axis=0)
        self.std = train_part.std(axis=0) + 1e-6
        data = (data - self.mean) / self.std
        lo, hi = {
            "train": (0, t_end),
            "valid": (max(t_end - spec.encoder_length, 0), v_end),
            "test": (max(v_end - spec.encoder_length, 0), n_steps),
        }[split]
        window = spec.encoder_length + spec.horizon
        self.windows = []  # (series, start)
        for s in range(data.shape[0]):
            for start in range(lo, hi - window + 1, stride):
                self.windows.append((s, start))
        self.data = data

    def unscale_target(self, y: np.ndarray) -> np.ndarray:
        t = self.spec.target
        return y * self.std[t] + self.mean[t]

    def __len__(self) -> int:
        return len(self.windows) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        spec = self.spec
        order = np.arange(len(self.windows))
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(order)
        enc, hor = spec.encoder_length, spec.horizon
        bs = self.batch_size
        for i in range(len(self)):
            obs = np.empty((bs, enc, len(spec.observed)), np.float32)
            known = np.empty((bs, enc + hor, len(spec.known)), np.float32)
            target = np.empty((bs, hor), np.float32)
            for j, w in enumerate(order[i * bs:(i + 1) * bs]):
                s, start = self.windows[w]
                win = self.data[s, start:start + enc + hor]
                obs[j] = win[:enc, list(spec.observed)]
                known[j] = win[:, list(spec.known)]
                target[j] = win[enc:, spec.target]
            yield {"observed": obs, "known": known, "target": target}


def forecast_metrics(pred: np.ndarray, target: np.ndarray,
                     quantiles: tuple[float, ...] = (0.1, 0.5, 0.9)) -> dict:
    """Evaluator metric suite (reference ``evaluation_metrics.py``).

    pred (N, horizon, n_quantiles) quantile forecasts; target (N, horizon).
    P50/P90 use the reference's *normalized* quantile loss
    (2 * pinball_sum / |y|_1, ``normalised_quantile_loss``).
    """
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    med = pred[..., list(quantiles).index(0.5)] if 0.5 in quantiles \
        else pred[..., pred.shape[-1] // 2]
    err = med - target
    denom = np.abs(target).sum()

    def nql(q):
        qi = list(quantiles).index(q)
        e = target - pred[..., qi]
        pinball = np.maximum(q * e, (q - 1.0) * e).sum()
        return 2.0 * pinball / max(denom, 1e-9)

    out = {
        "MAE": float(np.abs(err).mean()),
        "RMSE": float(np.sqrt((err ** 2).mean())),
        "SMAPE": float(200.0 * np.mean(
            np.abs(err) / np.maximum(np.abs(med) + np.abs(target), 1e-9))),
        "ND": float(np.abs(err).sum() / max(denom, 1e-9)),
    }
    if 0.5 in quantiles:
        out["P50"] = float(nql(0.5))
    if 0.9 in quantiles:
        out["P90"] = float(nql(0.9))
    return out


def make_synthetic_series(n_series: int = 4, n_steps: int = 600,
                          seed: int = 0) -> np.ndarray:
    """Electricity-shaped synthetic panel: daily+weekly seasonality +
    trend + noise. Columns: [target, covariate, hour-of-day, day-of-week]
    (observed: 0-1, known: 2-3)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_steps)
    cols = []
    for s in range(n_series):
        phase = rng.uniform(0, 2 * np.pi)
        daily = np.sin(2 * np.pi * t / 24 + phase)
        weekly = 0.5 * np.sin(2 * np.pi * t / 168 + phase / 2)
        trend = 0.001 * t * rng.uniform(0.5, 1.5)
        noise = 0.1 * rng.standard_normal(n_steps)
        target = daily + weekly + trend + noise
        covar = np.roll(daily, 3) + 0.05 * rng.standard_normal(n_steps)
        hod = (t % 24) / 23.0
        dow = ((t // 24) % 7) / 6.0
        cols.append(np.stack([target, covar, hod, dow], axis=1))
    return np.stack(cols).astype(np.float32)
