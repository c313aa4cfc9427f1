"""Seconds of the single-tree contraction (``skeletonize``) of the
checkout in the current directory, on the largest tree of the main path's
plot.

    cd CHECKOUT && python3 /path/to/tools/single_tree_times.py LABEL

It imports ``pyqsm_tpu_torch`` from the current directory, and the inputs
from the ``chip_smoke.py`` of the checkout that holds this file: the main
path's plot (2 000 000 points, seed 0, the bench's settings), through
``process_plot`` once to record the batch it hands to the contraction,
then ``skeletonize`` on the largest tree's batch row (chip_smoke.py phase
13b): a first call, then three calls with their Laplacian builds, PCG
solves and topology timed (each part synchronised). It prints one JSON
line: the seconds of each call, the parts' seconds, the iterations and,
per Laplacian build, whether the transpose ELL overflowed. Run it in turns
(parent, change, change, parent), one process each, from two unpacked
``git archive`` trees, to compare two commits on one card.
"""

import importlib.util
import json
import os
import sys
import time


def main() -> None:
    import torch

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        sys.exit("usage: python3 single_tree_times.py LABEL, on a machine with a CUDA card")
    sys.path.insert(0, os.getcwd())
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from pyqsm_tpu_torch.config import Config, IsolationConfig
    from pyqsm_tpu_torch.models import plot_pipeline as pp
    from pyqsm_tpu_torch.models import skeleton as sk

    pts = cs.synthetic_plot(2_000_000, cs.N_TREES, 0, "cuda")
    mask = torch.ones(pts.shape[0], dtype=torch.bool, device="cuda")
    iso = IsolationConfig(base_min_points=200, low_pctile=4.0, max_dist=0.2, cycles=400,
                          min_frontier=3)
    batch = {}
    extract = pp.extract_skeleton_batch

    def recording(points, masks, cfg, **kw):
        batch.update(points=points, masks=masks)
        return extract(points, masks, cfg, **kw)

    pp.extract_skeleton_batch = recording
    try:
        pp.process_plot(pts, mask, Config(), iso, skeleton_voxel=0.03, max_skeleton_points=40_000,
                        min_tree_points=2000, device="cuda")
    finally:
        pp.extract_skeleton_batch = extract
    live = batch["masks"].sum(dim=1)
    i = int(torch.argmax(live))
    p, m = batch["points"][i], batch["masks"][i]
    cfg = Config().skeletonize
    out = dict(label=sys.argv[1], package=os.path.abspath(os.path.dirname(sk.__file__)),
               rows=int(p.shape[0]), live=int(live[i]))
    torch.cuda.synchronize()
    t = time.perf_counter()
    skel, _, _ = sk.skeletonize(p, m, cfg, device="cuda")
    torch.cuda.synchronize()
    out.update(first_s=time.perf_counter() - t, iterations=int(skel.iterations), calls=[])
    parts = {"laplacian": "point_cloud_laplacian", "pcg": "pcg", "topology": "extract_topology"}
    for _ in range(3):
        with cs.timing(sk, parts) as times:
            t = time.perf_counter()
            sk.skeletonize(p, m, cfg, device="cuda")
            torch.cuda.synchronize()
            total = time.perf_counter() - t
        out["calls"].append(dict(
            s=total, **{k: sum(sec for sec, _ in v) for k, v in times.items()},
            t_overflow=[bool(L.t_overflow.any()) for _, L in times["laplacian"]]))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
