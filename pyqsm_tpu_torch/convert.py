"""Carry configuration and state across from the JAX package.

What crosses over is configuration, state, grid indexes and the wood/leaf
classifier's weights. The JAX package's containers arrive as dicts of
numpy arrays (e.g. ``{f: np.asarray(getattr(L, f)) for f in L._fields}``),
so this module needs nothing of that package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pyqsm_tpu_torch.config import _SECTION_TYPES, Config
from pyqsm_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from pyqsm_tpu_torch.ops.mesh import TriMesh
from pyqsm_tpu_torch.ops.sparse import ELLLaplacian, transpose_ell_sorted
from pyqsm_tpu_torch.state import Cylinders, PointCloud

_KINDS = {"laplacian": ELLLaplacian, "point_cloud": PointCloud, "cylinders": Cylinders}
# ELLLaplacian fields that are scalars per tree in the JAX package
_SCALAR_FIELDS = {"t_overflow", "s_overflow"}


def config_from_reference(raw: dict) -> Config:
    """A port ``Config`` from the JAX package's config as a dict (e.g.
    ``dataclasses.asdict(cfg)``): section name -> field dict."""
    sections = {}
    for name, cls in _SECTION_TYPES.items():
        if name in raw:
            known = {f.name for f in dataclasses.fields(cls)}
            sections[name] = cls(**{k: v for k, v in raw[name].items() if k in known})
    return Config(**sections)


def state_from_numpy(kind: str, arrays: dict, batched: bool = False,
                     device: str | torch.device = DEFAULT_DEVICE):
    """The port's container of ``kind`` ("laplacian", "point_cloud",
    "cylinders") from a dict of numpy arrays keyed by field name (absent or
    None fields stay None). A laplacian gains the port's leading trees axis
    unless ``batched`` says it already has one (a vmapped JAX Laplacian)."""
    if kind not in _KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of {sorted(_KINDS)}")
    dev = resolve_device(device)
    cls = _KINDS[kind]
    out = {}
    for f in cls._fields:
        v = arrays.get(f)
        if v is None:
            continue
        t = torch.as_tensor(np.array(v), device=dev)
        if kind == "laplacian" and not batched:
            t = t[None]
        elif kind == "laplacian" and f in _SCALAR_FIELDS and t.dim() == 0:
            t = t[None]
        out[f] = t
    if kind == "laplacian" and "t_idx" in out:
        # the JAX package keeps no sort of the edges by destination: derive
        # the exact scatter's order, and read the overflow flag once, here
        kt = out["t_idx"].shape[-1]
        _, _, over, src, dst, sw = transpose_ell_sorted(out["nbr_idx"], out["w"], kt)
        out.update(tx_src=src, tx_dst=dst, tx_w=sw)
        out["t_overflow_any"] = bool(out.get("t_overflow", over).any())
    return cls(**out)


def mesh_from_numpy(vertices, triangles, device: str | torch.device = DEFAULT_DEVICE) -> TriMesh:
    """The port's ``TriMesh`` from the JAX package's (its ``vertices`` and
    ``triangles`` as numpy arrays): float32 [V, 3] and int32 [T, 3]."""
    dev = resolve_device(device)
    return TriMesh(torch.as_tensor(np.asarray(vertices, np.float32), device=dev),
                   torch.as_tensor(np.asarray(triangles, np.int32), device=dev))


def grid_index_from_jax(fields: dict, device: str | torch.device = DEFAULT_DEVICE):
    """The port's ``ops.neighbors.GridIndex`` from the JAX package's (its
    fields as a dict of numpy arrays, e.g. ``{f.name: np.asarray(
    getattr(index, f.name)) for f in dataclasses.fields(index)}``), on
    ``device``; ``cell_size`` a Python float."""
    from pyqsm_tpu_torch.ops.neighbors import GridIndex

    dev = resolve_device(device)
    dtypes = dict(sorted_points=np.float32, sorted_idx=np.int32, sorted_cell=np.int32,
                  origin=np.float32, dims=np.int32)
    return GridIndex(**{f: torch.as_tensor(np.array(fields[f], t), device=dev)
                        for f, t in dtypes.items()}, cell_size=float(fields["cell_size"]))


def hits_to_numpy(hits) -> dict:
    """The port's ``Hits`` or ``HitList`` as a dict of numpy arrays keyed by
    field name, the form the JAX package's containers compare against."""
    return {f: getattr(hits, f).cpu().numpy() for f in hits._fields}


def seed_block(rows, block_size: int) -> tuple[np.ndarray, np.ndarray]:
    """A walk's seed front as numpy, the form both packages take: the first
    ``block_size`` of ``rows`` (int32, -1 padded) and its validity."""
    rows = np.asarray(rows, np.int32)
    idx = np.full(block_size, -1, np.int32)
    idx[:min(len(rows), block_size)] = rows[:block_size]
    return idx, idx >= 0


def front_from_numpy(front: dict, device: str | torch.device = DEFAULT_DEVICE):
    """The port's ``models.qsm.Front`` from the JAX package's (its fields as
    a dict, e.g. ``{f: np.asarray(v) for f, v in front._asdict().items()}``):
    the row block and its validity on ``device``, the scalars as Python
    numbers."""
    from pyqsm_tpu_torch.models.qsm import Front

    dev = resolve_device(device)
    return Front(torch.as_tensor(np.array(front["idx"], np.int32), device=dev),
                 torch.as_tensor(np.array(front["valid"], bool), device=dev),
                 float(front["last_radius"]), int(front["branch_order"]), int(front["parent"]))


def qsm_result_to_numpy(res) -> dict:
    """The port's ``QSMResult`` as numpy: each cylinder field under its name,
    ``found``, ``branch_order`` (per point; the cylinders' orders are under
    ``cylinder_branch_order``) and ``n_steps``."""
    out = {f: getattr(res.cylinders, f).cpu().numpy() for f in res.cylinders._fields}
    out["cylinder_branch_order"] = out.pop("branch_order")
    out.update(found=res.found.cpu().numpy(), branch_order=res.branch_order.cpu().numpy(),
               n_steps=int(res.n_steps))
    return out



def classifier_from_numpy(params: dict, feat_mean, feat_std, n_classes: int,
                          device: str | torch.device = DEFAULT_DEVICE):
    """The port's ``models.segmentation.Classifier`` from the JAX package's
    (its ``{w0, b0, w1, b1, …}`` params as numpy, ``w_i`` [fan_in,
    fan_out], and the feature mean and std): ``nn.Linear`` layers holding
    ``w_iᵀ`` and ``b_i``, ReLU between them."""
    from torch import nn

    from pyqsm_tpu_torch.models.segmentation import Classifier

    dev = resolve_device(device)
    n_layers = len(params) // 2
    layers: list[nn.Module] = []
    for i in range(n_layers):
        w = np.asarray(params[f"w{i}"], np.float32)
        lin = nn.Linear(w.shape[0], w.shape[1], device=dev)
        with torch.no_grad():
            lin.weight.copy_(torch.as_tensor(w.T.copy(), device=dev))
            lin.bias.copy_(torch.as_tensor(np.asarray(params[f"b{i}"], np.float32), device=dev))
        layers.append(lin)
        if i < n_layers - 1:
            layers.append(nn.ReLU())
    return Classifier(nn.Sequential(*layers),
                      torch.as_tensor(np.asarray(feat_mean, np.float32), device=dev),
                      torch.as_tensor(np.asarray(feat_std, np.float32), device=dev),
                      int(n_classes))


def classifier_to_numpy(clf) -> dict:
    """The port's ``Classifier`` in the JAX package's form: ``params``
    (``{w0, b0, …}``, ``w_i`` [fan_in, fan_out]), ``feat_mean``,
    ``feat_std`` and ``n_classes``."""
    from torch import nn

    lins = [m for m in clf.mlp if isinstance(m, nn.Linear)]
    params = {}
    for i, lin in enumerate(lins):
        params[f"w{i}"] = lin.weight.detach().cpu().numpy().T.copy()
        params[f"b{i}"] = lin.bias.detach().cpu().numpy().copy()
    return {"params": params, "feat_mean": clf.feat_mean.cpu().numpy(),
            "feat_std": clf.feat_std.cpu().numpy(), "n_classes": clf.n_classes}
