"""SVM: RBF / linear classification, eps-SVR, Platt probabilities,
one-vs-rest multiclass, JSON and libsvm model files (mirror of
``compv_tpu/ml/svm.py``; reference CompVMachineLearningSVM, a wrapper of
libsvm, base/include/compv/base/ml/compv_base_ml_svm.h:78-104).

Training is the reference's: projected gradient ascent on the box-only dual
(max sum(a) - a^T Q a / 2, 0 <= a <= C) for a fixed number of steps of size
1 / max_i sum_j |Q_ij|, the bias from the margin support vectors; the
decision function is f(x) = sum_i alpha_i y_i K(x_i, x) + b. The reference
runs its loop jitted (XLA may fuse a step's multiply-add), so decisions
agree within a tolerance, not bit for bit. Fold permutations are numpy's,
equal in both packages.

Two deliberate differences:
* ``svr_train`` takes the median of an even count as the mean of the two
  middle values, as ``jnp.median`` does (``torch.median`` returns the lower
  one).
* ``platt_fit`` minimizes the regularized NLL of libsvm's sigmoid_train:
  its gradient uses the residual t - p. The reference's loop uses
  t - (1 - p) (``compv_tpu/ml/svm.py:241``) and runs away; the port is held
  to scipy's minimum instead, so the probabilities of
  ``svm_train_probabilistic`` differ from the reference's while its
  decision part matches.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from compv_tpu_torch.device import require_cuda
from compv_tpu_torch.math.distance import squared_l2

__all__ = ["SvmConfig", "SvmModel", "svm_train", "svm_predict",
           "svm_decision", "svm_cross_validate", "MultiClassSvm",
           "svm_train_multiclass", "svm_predict_multiclass",
           "svm_save_json", "svm_load_json", "svr_train", "svr_predict",
           "platt_fit", "platt_probability", "ProbSvmModel",
           "svm_train_probabilistic", "svm_predict_proba",
           "svm_save_libsvm", "svm_load_libsvm"]


@dataclass(frozen=True)
class SvmConfig:
    kernel: str = "rbf"       # rbf | linear (the reference defaults to RBF)
    gamma: float = 0.1        # RBF gamma
    c: float = 1.0            # box constraint
    iterations: int = 300     # projected-gradient iterations
    lr: float | None = None   # step; None -> 1 / ||Q||_inf


class SvmModel(NamedTuple):
    support: torch.Tensor     # (N, D) training vectors
    alpha_y: torch.Tensor     # (N,) alpha_i * y_i
    bias: torch.Tensor        # ()
    gamma: torch.Tensor       # ()
    kernel_linear: bool


def _kernel(a: torch.Tensor, b: torch.Tensor, gamma, linear: bool
            ) -> torch.Tensor:
    if linear:
        return a @ b.T
    return torch.exp(-gamma * squared_l2(a, b))


def svm_train(x: torch.Tensor, y: torch.Tensor,
              config: SvmConfig = SvmConfig()) -> SvmModel:
    """Binary SVM, y in {-1, +1}."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    linear = config.kernel == "linear"
    k = _kernel(x, x, config.gamma, linear)
    q = k * (y[:, None] * y[None, :])
    lr = config.lr or 1.0 / (q.abs().sum(dim=1).max() + 1e-9)
    a = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for _ in range(config.iterations):
        a = torch.clamp(a + lr * (1.0 - q @ a), 0.0, config.c)

    # bias from the margin SVs (0 < a < C): mean of y_i - sum_j a_j y_j K_ij
    on_margin = (a > 1e-6 * config.c) & (a < (1 - 1e-6) * config.c)
    sel = torch.where(on_margin.any(), on_margin, a > 1e-6 * config.c)
    f_no_b = k @ (a * y)
    b = (torch.where(sel, y - f_no_b, 0.0).sum()
         / torch.clamp_min(sel.sum(), 1))
    return SvmModel(support=x, alpha_y=a * y, bias=b,
                    gamma=torch.tensor(config.gamma, dtype=torch.float32,
                                       device=x.device),
                    kernel_linear=linear)


def svm_decision(model: SvmModel, x: torch.Tensor) -> torch.Tensor:
    """(M, D) -> (M,) decision values."""
    k = _kernel(x.to(torch.float32), model.support, model.gamma,
                model.kernel_linear)
    return k @ model.alpha_y + model.bias


def svm_predict(model: SvmModel, x: torch.Tensor) -> torch.Tensor:
    """(M, D) -> (M,) labels in {-1, +1} (float32)."""
    return torch.where(svm_decision(model, x) >= 0, 1.0, -1.0)


def _take(t: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return t[torch.from_numpy(idx).to(t.device)]


def svm_cross_validate(x: torch.Tensor, y: torch.Tensor, config: SvmConfig,
                       folds: int = 5, seed: int = 0) -> float:
    """K-fold accuracy; the folds come from numpy's permutation, as in the
    reference."""
    n = x.shape[0]
    order = np.random.default_rng(seed).permutation(n)
    fold_sz = n // folds
    accs = []
    for k in range(folds):
        val_idx = order[k * fold_sz:(k + 1) * fold_sz]
        tr_idx = np.setdiff1d(order, val_idx)
        m = svm_train(_take(x, tr_idx), _take(y, tr_idx), config)
        pred = svm_predict(m, _take(x, val_idx))
        accs.append(float((pred == _take(y, val_idx)).to(torch.float64)
                          .mean()))
    return float(np.mean(accs))


class MultiClassSvm(NamedTuple):
    """One-vs-rest multiclass: all decisions in one stack."""
    models: list              # per-class SvmModel
    classes: torch.Tensor     # (C,)


def svm_train_multiclass(x: torch.Tensor, y: torch.Tensor,
                         config: SvmConfig = SvmConfig()) -> MultiClassSvm:
    classes = torch.unique(y)             # sorted, as np.unique
    models = [svm_train(x, torch.where(y == c, 1.0, -1.0), config)
              for c in classes]
    return MultiClassSvm(models=models, classes=classes)


def svm_predict_multiclass(mc: MultiClassSvm, x: torch.Tensor
                           ) -> torch.Tensor:
    scores = torch.stack([svm_decision(m, x) for m in mc.models])  # (C, M)
    return mc.classes[torch.argmax(scores, dim=0)]


def svm_save_json(model: SvmModel, path: str) -> None:
    """The reference's JSON model file."""
    obj = {"support": model.support.detach().cpu().tolist(),
           "alpha_y": model.alpha_y.detach().cpu().tolist(),
           "bias": float(model.bias), "gamma": float(model.gamma),
           "kernel_linear": bool(model.kernel_linear)}
    with open(path, "w") as f:
        json.dump(obj, f)


def svm_load_json(path: str, device=None) -> SvmModel:
    """A JSON model file of either package, on ``device`` (the card when
    none is given)."""
    with open(path) as f:
        obj = json.load(f)
    dev = device if device is not None else require_cuda()

    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    return SvmModel(support=t(obj["support"]), alpha_y=t(obj["alpha_y"]),
                    bias=t(obj["bias"]), gamma=t(obj["gamma"]),
                    kernel_linear=obj["kernel_linear"])


# ------------------------------------------------------------- eps-SVR

def _median(v: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: the middle value, or the mean of the two middle
    values of an even count."""
    s = torch.sort(v).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return 0.5 * s[n // 2 - 1] + 0.5 * s[n // 2]


def svr_train(x: torch.Tensor, y: torch.Tensor,
              config: SvmConfig = SvmConfig(), epsilon: float = 0.1
              ) -> SvmModel:
    """epsilon-insensitive support vector regression: proximal projected
    gradient on the dual over beta in [-C, C]^N,
    max -beta^T K beta / 2 + y^T beta - epsilon ||beta||_1, with the
    targets' mean moved into the bias. Returns an SvmModel whose decision
    function is the regressor (alpha_y holds beta)."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    y_mean = y.mean()
    y = y - y_mean
    linear = config.kernel == "linear"
    k = _kernel(x, x, config.gamma, linear)
    lr = config.lr or 1.0 / (float(k.abs().sum(dim=1).max()) + 1e-9)
    eps = torch.tensor(epsilon, dtype=torch.float32, device=x.device)
    beta = torch.zeros(y.shape[0], dtype=torch.float32, device=x.device)
    for _ in range(config.iterations):
        z = beta + lr * (y - k @ beta)
        z = torch.sign(z) * torch.clamp_min(z.abs() - lr * eps, 0.0)
        beta = torch.clamp(z, -config.c, config.c)
    # the bias: median over all points of y - f_no_b - eps sign(beta)
    b = _median(y - k @ beta - eps * torch.sign(beta)) + y_mean
    return SvmModel(support=x, alpha_y=beta, bias=b,
                    gamma=torch.tensor(config.gamma, dtype=torch.float32,
                                       device=x.device),
                    kernel_linear=linear)


def svr_predict(model: SvmModel, x: torch.Tensor) -> torch.Tensor:
    """(M, D) -> (M,) regressed values."""
    return svm_decision(model, x)


# ------------------------------------------------- Platt probabilities

# step lengths the line search tries at once: 1, 1/2, ..., 2^-29
_STEPS = 2.0 ** -np.arange(30)


def _platt_nll(ab: torch.Tensor, f: torch.Tensor, t: torch.Tensor
               ) -> torch.Tensor:
    """NLL of P(y=+1 | f) = 1 / (1 + exp(A f + B)) against targets t, for
    each row of ``ab`` (S, 2): sum log(1 + e^z) - (1 - t) z, z = A f + B."""
    z = ab[:, :1] * f[None, :] + ab[:, 1:]
    return (torch.logaddexp(torch.zeros_like(z), z)
            - (1.0 - t)[None, :] * z).sum(dim=1)


def platt_fit(decision: torch.Tensor, y: torch.Tensor, iterations: int = 64):
    """Fit P(y=+1 | f) = 1 / (1 + exp(A f + B)) by minimizing the NLL with
    Platt's smoothed targets t+ = (N+ + 1) / (N+ + 2), t- = 1 / (N- + 2)
    (libsvm sigmoid_train): Newton steps on the gradient
    (sum (t - p) f, sum (t - p)) and Hessian sum p (1 - p) [f^2, f; f, 1]
    (diagonal + 1e-12), each backtracked to the longest of 1, 1/2, ...
    that decreases the NLL enough (Armijo, 1e-4), all step lengths tried at
    once, so the loop never waits for the card. float64 inside. Returns
    (A, B) as float32 scalars."""
    f = decision.to(torch.float64)
    yy = y.to(torch.float64)
    n_pos = (yy > 0).sum().to(torch.float64)
    n_neg = (yy <= 0).sum().to(torch.float64)
    t = torch.where(yy > 0, (n_pos + 1.0) / (n_pos + 2.0),
                    1.0 / (n_neg + 2.0))
    steps = torch.as_tensor(_STEPS, device=f.device)[:, None]
    ab = torch.stack([torch.zeros_like(n_pos),
                      torch.log((n_neg + 1.0) / (n_pos + 1.0))])
    for _ in range(iterations):
        z = ab[0] * f + ab[1]
        p = torch.sigmoid(-z)                # P(y=+1)
        d = t - p                            # dNLL / dz
        g = torch.stack([(d * f).sum(), d.sum()])
        w = p * (1.0 - p)
        h11 = (w * f * f).sum() + 1e-12
        h12 = (w * f).sum()
        h22 = w.sum() + 1e-12
        det = h11 * h22 - h12 * h12
        direction = -torch.stack([h22 * g[0] - h12 * g[1],
                                  h11 * g[1] - h12 * g[0]]) / det
        cand = ab[None, :] + steps * direction[None, :]
        f0 = _platt_nll(ab[None, :], f, t)[0]
        slope = g @ direction
        ok = _platt_nll(cand, f, t) <= f0 + 1e-4 * steps[:, 0] * slope
        # the longest step that passes; none passing leaves ab where it is
        first = torch.argmax(ok.to(torch.int8))
        ab = torch.where(ok.any(), cand[first], ab)
    ab = ab.to(torch.float32)
    return ab[0], ab[1]


def platt_probability(a, b, decision: torch.Tensor) -> torch.Tensor:
    """Decision values -> P(y=+1)."""
    return torch.sigmoid(-(a * decision + b))


class ProbSvmModel(NamedTuple):
    model: SvmModel
    a: torch.Tensor
    b: torch.Tensor


def svm_train_probabilistic(x: torch.Tensor, y: torch.Tensor,
                            config: SvmConfig = SvmConfig(), folds: int = 3,
                            seed: int = 0) -> ProbSvmModel:
    """svm_train, plus the sigmoid fitted on cross-validated decision values
    (libsvm fits it out of fold, against the optimism of in-sample
    margins)."""
    n = x.shape[0]
    order = np.random.default_rng(seed).permutation(n)
    fold_sz = max(n // folds, 1)
    dec = torch.zeros(n, dtype=torch.float32, device=x.device)
    for k in range(folds):
        val = (order[k * fold_sz:(k + 1) * fold_sz] if k < folds - 1
               else order[k * fold_sz:])
        tr = np.setdiff1d(order, val)
        m = svm_train(_take(x, tr), _take(y, tr), config)
        dec[torch.from_numpy(val).to(x.device)] = svm_decision(
            m, _take(x, val))
    a, b = platt_fit(dec, y)
    return ProbSvmModel(model=svm_train(x, y, config), a=a, b=b)


def svm_predict_proba(pm: ProbSvmModel, x: torch.Tensor) -> torch.Tensor:
    """(M, D) -> (M,) P(y=+1)."""
    return platt_probability(pm.a, pm.b, svm_decision(pm.model, x))


# --------------------------------------------- libsvm model-file format
# (the text format of libsvm-322's svm_save_model, which the reference's
# wrapper reads and writes, compv_base_ml_svm.h:96)

def svm_save_libsvm(model: SvmModel, path: str,
                    svm_type: str = "c_svc") -> None:
    """Write a libsvm text model: a 2-class model (labels +1 / -1) whose SV
    coefficients are alpha_y (c_svc) or beta (epsilon_svr), rho = -bias."""
    sup = model.support.detach().cpu().numpy()
    coef = model.alpha_y.detach().cpu().numpy()
    keep = np.abs(coef) > 1e-8
    sup, coef = sup[keep], coef[keep]
    lines = [f"svm_type {svm_type}",
             f"kernel_type {'linear' if model.kernel_linear else 'rbf'}"]
    if not model.kernel_linear:
        lines.append(f"gamma {float(model.gamma):.17g}")
    lines.append("nr_class 2")
    lines.append(f"total_sv {len(sup)}")
    lines.append(f"rho {-float(model.bias):.17g}")
    if svm_type == "c_svc":
        lines.append("label 1 -1")
        n_pos = int((coef > 0).sum())
        lines.append(f"nr_sv {n_pos} {len(sup) - n_pos}")
    lines.append("SV")
    for c, row in zip(coef, sup):
        feats = " ".join(f"{j + 1}:{v:.17g}" for j, v in enumerate(row))
        lines.append(f"{c:.17g} {feats}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def svm_load_libsvm(path: str, device=None) -> SvmModel:
    """Read a libsvm text model (c_svc 2-class or epsilon_svr, rbf or
    linear kernel), on ``device`` (the card when none is given)."""
    header, sv_lines, in_sv = {}, [], False
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            if in_sv:
                sv_lines.append(line)
            elif line == "SV":
                in_sv = True
            else:
                key, *rest = line.split()
                header[key] = rest
    if header.get("svm_type", ["c_svc"])[0] not in ("c_svc", "epsilon_svr"):
        raise ValueError(f"unsupported svm_type {header['svm_type'][0]}")
    if header.get("nr_class", ["2"])[0] != "2":
        raise ValueError("only 2-class libsvm models are supported")
    kernel = header.get("kernel_type", ["rbf"])[0]
    if kernel not in ("rbf", "linear"):
        raise ValueError(f"unsupported kernel_type {kernel}")
    dim, parsed = 0, []
    for line in sv_lines:
        toks = line.split()
        feats = {}
        for tok in toks[1:]:
            j, v = tok.split(":")
            feats[int(j) - 1] = float(v)
            dim = max(dim, int(j))
        parsed.append((float(toks[0]), feats))
    sup = np.zeros((len(parsed), dim), np.float32)
    coefs = np.zeros(len(parsed), np.float32)
    for i, (c, feats) in enumerate(parsed):
        coefs[i] = c
        for j, v in feats.items():
            sup[i, j] = v
    labels = header.get("label")
    if labels is not None and [int(v) for v in labels] == [-1, 1]:
        coefs = -coefs      # libsvm coefs are for label[0]-vs-label[1]
    dev = device if device is not None else require_cuda()
    return SvmModel(
        support=torch.from_numpy(sup).to(dev),
        alpha_y=torch.from_numpy(coefs).to(dev),
        bias=torch.tensor(-float(header["rho"][0]), dtype=torch.float32,
                          device=dev),
        gamma=torch.tensor(float(header.get("gamma", ["0.1"])[0]),
                           dtype=torch.float32, device=dev),
        kernel_linear=kernel == "linear")
