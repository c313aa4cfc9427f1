"""Wood / leaf classification (counterpart of
``pyqsm_tpu/models/segmentation.py``): a small MLP on the eigenfeatures,
trained full-batch with Adam on the device and applied to the whole cloud.

The initial weights come from ``weight_draws``, the one draw source: a CPU
``torch.Generator`` seeded with the training seed, so the card and the CPU
start alike. The JAX package draws them with ``jax.random.normal``, which
torch cannot reproduce; the parity tests replace ``weight_draws`` with the
JAX package's draws.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from pyqsm_tpu_torch.device import DEFAULT_DEVICE, as_tensor, resolve_device
from pyqsm_tpu_torch.ops.features import FEATURE_NAMES, compute_features


class Classifier(NamedTuple):
    mlp: nn.Sequential  # Linear + ReLU layers, widths (d_in,) + hidden + (n_classes,)
    feat_mean: torch.Tensor  # [D]
    feat_std: torch.Tensor  # [D]
    n_classes: int


def weight_draws(seed: int, shapes: list[tuple[int, int]]) -> list[torch.Tensor]:
    """Standard-normal [a, b] matrices, one a layer, from a CPU generator
    seeded ``seed`` (float32, on the CPU)."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g, dtype=torch.float32) for shape in shapes]


def _init_mlp(seed: int, d_in: int, hidden: tuple[int, ...], n_classes: int,
              device: torch.device) -> nn.Sequential:
    """He-normal weights (draws × sqrt(2 / fan_in)), zero biases."""
    dims = (d_in,) + tuple(hidden) + (n_classes,)
    shapes = list(zip(dims[:-1], dims[1:]))
    layers: list[nn.Module] = []
    for i, ((a, b), w) in enumerate(zip(shapes, weight_draws(seed, shapes))):
        lin = nn.Linear(a, b, device=device)
        with torch.no_grad():
            scale = torch.sqrt(torch.tensor(2.0 / a, dtype=torch.float32))
            lin.weight.copy_((w * scale).T)
            lin.bias.zero_()
        layers.append(lin)
        if i < len(shapes) - 1:
            layers.append(nn.ReLU())
    return nn.Sequential(*layers)


def stack_features(features: dict) -> torch.Tensor:
    """The eigenfeature dict stacked into [N, D] in ``FEATURE_NAMES`` order."""
    return torch.stack([features[name] for name in FEATURE_NAMES], dim=1)


def _nan_moments(x: torch.Tensor, mask: torch.Tensor):
    """NaN-ignoring mean and (population) standard deviation of the masked
    rows of each column, in float64, rounded once."""
    xm = torch.where(mask[:, None], x, float("nan")).double()
    ok = ~torch.isnan(xm)
    cnt = ok.sum(dim=0)
    mean = torch.where(ok, xm, 0.0).sum(dim=0) / cnt
    var = torch.where(ok, (xm - mean) ** 2, 0.0).sum(dim=0) / cnt
    return mean.float(), torch.clamp(var.sqrt().float(), min=1e-6)


def train_classifier(x, y, mask, n_classes: int = 2, hidden: tuple[int, ...] = (64, 32),
                     epochs: int = 300, lr: float = 1e-3, val_fraction: float = 0.2,
                     seed: int = 0, device: str | torch.device = DEFAULT_DEVICE):
    """Train on a seeded 80/20 split of the masked rows (numpy's shuffle,
    as the JAX package splits): full-batch softmax cross-entropy, Adam.
    Returns ``(Classifier, {'train_acc', 'val_acc', 'loss'})``; the loss is
    read once, after the last step."""
    dev = resolve_device(device)
    x = as_tensor(x, dev, torch.float32)
    y = as_tensor(y, dev, torch.int64)
    mask = as_tensor(mask, dev, torch.bool)
    live = np.flatnonzero(mask.cpu().numpy())
    rng = np.random.default_rng(seed)
    rng.shuffle(live)
    n_val = max(int(len(live) * val_fraction), 1)
    val_rows = torch.as_tensor(live[:n_val], device=dev)
    train_rows = torch.as_tensor(live[n_val:], device=dev)

    mean, std = _nan_moments(x, mask)
    xt = (x[train_rows] - mean) / std
    yt = y[train_rows]
    xv = (x[val_rows] - mean) / std
    yv = y[val_rows]

    mlp = _init_mlp(seed, x.shape[1], hidden, n_classes, dev)
    opt = torch.optim.Adam(mlp.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    loss = torch.zeros((), device=dev)
    for _ in range(epochs):
        opt.zero_grad(set_to_none=True)
        loss = nn.functional.cross_entropy(mlp(xt), yt)
        loss.backward()
        opt.step()
    with torch.no_grad():
        train_acc = float((mlp(xt).argmax(-1) == yt).float().mean())
        val_acc = float((mlp(xv).argmax(-1) == yv).float().mean())
    clf = Classifier(mlp, mean, std, n_classes)
    return clf, {"train_acc": train_acc, "val_acc": val_acc, "loss": float(loss.detach())}


def _logits(clf: Classifier, x: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return clf.mlp((x - clf.feat_mean) / clf.feat_std)


def predict(clf: Classifier, x: torch.Tensor) -> torch.Tensor:
    """Predicted class a row (i32); equal logits go to the lower class."""
    return _logits(clf, x).argmax(dim=-1).to(torch.int32)


def predict_proba(clf: Classifier, x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(_logits(clf, x), dim=-1)


def classify_wood_leaf(points, mask, labeled_rows, labels, k: int = 25,
                       device: str | torch.device = DEFAULT_DEVICE, **train_kw):
    """Eigenfeatures → train on the labelled rows → predict every row.
    Returns ``(predictions [N] i32, -1 on dead rows; Classifier; metrics)``.
    The class count is read from ``labels`` on the host."""
    dev = resolve_device(device)
    points = as_tensor(points, dev, torch.float32)
    mask = as_tensor(mask, dev, torch.bool)
    labeled_rows = as_tensor(labeled_rows, dev, torch.int64)
    labels = as_tensor(labels, dev, torch.int32)
    x = stack_features(compute_features(points, mask, k=k))
    n = points.shape[0]
    y_full = torch.zeros(n, dtype=torch.int32, device=dev).index_put_((labeled_rows,), labels)
    label_mask = torch.zeros(n, dtype=torch.bool, device=dev).index_fill_(0, labeled_rows, True)
    n_classes = int(labels.max()) + 1
    clf, metrics = train_classifier(x, y_full, label_mask & mask, n_classes=n_classes,
                                    device=dev, **train_kw)
    preds = torch.where(mask, predict(clf, x), -1)
    return preds, clf, metrics
