"""Color-space segmentation math (counterpart of ``pyqsm_tpu/ops/color.py``):
RGB↔HSV, the named hue conditions, sequential hue peel-off, saturation
correction, green-surface extraction, white-bloom neighbour repair and
the percentile split, as mask transforms over the columnar cloud."""

from __future__ import annotations

import torch

from pyqsm_tpu_torch.ops.geometry import masked_percentile
from pyqsm_tpu_torch.ops.neighbors import knn


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """Matplotlib-compatible RGB→HSV over [..., 3] in [0, 1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = rgb.amax(dim=-1)
    mn = rgb.amin(dim=-1)
    diff = mx - mn
    safe = torch.where(diff > 0, diff, 1.0)
    h = torch.where(mx == r, (g - b) / safe,
                    torch.where(mx == g, 2.0 + (b - r) / safe, 4.0 + (r - g) / safe))
    # XLA turns h / 6 into h · f32(1/6)
    h = torch.where(diff > 0, torch.remainder(h * (1.0 / 6.0), 1.0), 0.0)
    s = torch.where(mx > 0, diff / torch.where(mx > 0, mx, 1.0), 0.0)
    return torch.stack([h, s, mx], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """HSV→RGB over [..., 3]."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    # 1 − s·f and 1 − s·(1 − f) are fused multiply-adds in XLA, emulated
    # in float64 (the product exact, one rounding to float32)
    q = v * (1.0 - s.double() * f.double()).float()
    t = v * (1.0 - s.double() * (1.0 - f).double()).float()
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):  # jnp.select over i == 0..5, default 0
        out = torch.zeros_like(v)
        for c in range(5, -1, -1):
            out = torch.where(i == c, vals[c], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


# the reference's named hue conditions (h, s, v in [0, 1])
def _white(h, s, v):
    return (h > 0.5) & (h < 5.0 / 6.0) & (v > 0.5)


def _pink(h, s, v):
    return (h >= 0.7) & (v > 0.3)


def _blues(h, s, v):
    return (h < 0.7) & (h > 0.4) & (v > 0.4)


def _greens(h, s, v):
    return (h <= 0.5) & (h > 2.0 / 9.0) & (v > 0.2)


def _light_greens(h, s, v):
    return (h <= 0.5) & (h > 2.0 / 9.0) & (v > 0.5)


def _red_yellow(h, s, v):
    return (h <= 2.0 / 9.0) & (v > 0.3)


HUE_CONDITIONS = {
    "white": _white,
    "pink": _pink,
    "blues": _blues,
    "greens": _greens,
    "light_greens": _light_greens,
    "red_yellow": _red_yellow,
}


def saturate_colors(rgb: torch.Tensor) -> torch.Tensor:
    """Saturation correction s ← s + (1−s)/3."""
    hsv = rgb_to_hsv(rgb)
    s = hsv[..., 1]
    # XLA computes s + (1 − s) / 3 as fma(1 − s, f32(1/3), s), emulated in
    # float64
    third = torch.tensor(1.0 / 3.0, dtype=torch.float32).double()
    s_new = ((1.0 - s).double() * third + s.double()).float()
    hsv = torch.stack([hsv[..., 0], s_new, hsv[..., 2]], dim=-1)
    return hsv_to_rgb(hsv)


def segment_hues(colors: torch.Tensor, mask: torch.Tensor,
                 hues: tuple[str, ...] = ("white", "blues", "pink", "red_yellow", "greens"),
                 saturate: bool = True) -> dict[str, torch.Tensor]:
    """Sequential hue peel-off: each named hue claims the matching
    *remaining* points, in order. Returns hue → bool mask, plus
    'remainder'."""
    rgb = saturate_colors(colors) if saturate else colors
    hsv = rgb_to_hsv(rgb)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    remaining = mask
    out: dict[str, torch.Tensor] = {}
    for hue in hues:
        claimed = remaining & HUE_CONDITIONS[hue](h, s, v)
        out[hue] = claimed
        remaining = remaining & ~claimed
    out["remainder"] = remaining
    return out


def green_surface_mask(colors: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """RGB green-dominance test: g > r, g > b, 0.5 < r/b < 2."""
    r, g, b = colors[..., 0], colors[..., 1], colors[..., 2]
    ratio = r / torch.where(b > 0, b, 1e-6)
    return mask & (g > r) & (g > b) & (ratio > 0.5) & (ratio < 2.0)


def homogenize_white_bloom(points: torch.Tensor, colors: torch.Tensor, mask: torch.Tensor,
                           white_threshold: float = 2.7, k: int = 30) -> torch.Tensor:
    """Replace over-bright (bloomed) points' colors by the mean color of
    their k nearest non-white neighbours."""
    white = mask & (colors.sum(dim=-1) > white_threshold)
    nonwhite = mask & ~white
    _, idx = knn(points, points, k, query_mask=white, point_mask=nonwhite)
    valid = idx >= 0
    nbr_col = colors[torch.clamp(idx, min=0).long()]
    num = torch.where(valid[..., None], nbr_col, 0.0).sum(dim=1)
    den = torch.clamp(valid.sum(dim=1, dtype=torch.int32), min=1)[:, None]
    return torch.where((white & (den[:, 0] > 0))[:, None], num / den, colors)


def split_on_percentile(values: torch.Tensor, mask: torch.Tensor, pctile: float,
                        constant_q: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) split of live points at the given percentile of the live
    values (``>`` is high); ``constant_q`` as in ``masked_percentile``."""
    high = mask & (values > masked_percentile(values, mask, pctile, constant_q))
    return high, mask & ~high
