"""Segment sums that give the same bits on every run.

``index_add_`` on a CUDA tensor adds with atomics, in an order that changes
from run to run, so a float sum over a segment moves in its last bits and
the contraction downstream of it drifts (2230 against 2156 cylinders on one
plot in two runs on an H100). ``segment_sum`` sums each segment in index
order on either device:

- destinations that ascend (``sorted_index=True``: the voxel segments, the
  row- or column-sorted spill lists) go through ``torch.segment_reduce``,
  which sums each segment serially and sorts nothing — on the CPU it gives
  ``index_add_``'s bits exactly. Entries past the last destination (the
  spill lists' dead tail) lie outside every segment and are never read;
- other destinations take ``index_add_``: plain on the CPU, which sums in
  index order, and on CUDA with ``torch.use_deterministic_algorithms(True)``
  set for the call, which makes PyTorch take its sort-based deterministic
  ``index_add_`` (a sort per call: for sums made once per solve or less).
"""

from __future__ import annotations

import torch


def segment_sum(values: torch.Tensor, index: torch.Tensor, n: int,
                sorted_index: bool = False) -> torch.Tensor:
    """Σ of ``values`` [*B, E, *F] over each destination of ``index``
    [*B, E] (int64; entries ≥ n are dropped), per leading batch entry:
    ``[*B, n, *F]`` in ``values``' dtype. ``sorted_index``: the caller's
    promise that ``index`` ascends along its last axis."""
    lead = index.shape[:-1]
    if sorted_index:
        q = torch.arange(n + 1, device=index.device).expand(*lead, n + 1).contiguous()
        offsets = torch.searchsorted(index.contiguous(), q)
        return torch.segment_reduce(values, "sum", offsets=offsets, axis=len(lead), unsafe=True)
    b, e = lead.numel(), index.shape[-1]
    feat = tuple(values.shape[len(lead) + 1:])
    off = torch.arange(b, device=index.device)[:, None] * (n + 1)
    dst = (torch.clamp(index.reshape(b, e), max=n) + off).reshape(-1)
    out = torch.zeros((b * (n + 1),) + feat, dtype=values.dtype, device=values.device)
    vals = values.reshape((b * e,) + feat)
    if out.is_cuda:
        prev = torch.are_deterministic_algorithms_enabled()
        warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            out.index_add_(0, dst, vals)
        finally:
            torch.use_deterministic_algorithms(prev, warn_only=warn_only)
    else:
        out.index_add_(0, dst, vals)
    return out.reshape(tuple(lead) + (n + 1,) + feat).narrow(len(lead), 0, n)
