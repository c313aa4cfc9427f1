"""Card time of the ``mt_raycast`` kernel of the checkout in the current
directory, at the raycast path's three shapes on its mesh.

    cd CHECKOUT && python3 /path/to/tools/mt_raycast_times.py LABEL

It imports ``pyqsm_tpu_torch`` from the current directory, and the inputs
from the ``chip_smoke.py`` of the checkout that holds this file: the main
path's plot (2 000 000 points, seed 0), its canopy mesh (1113 triangles)
and phase 8's shapes (cast_scene's 307 200 pinhole rays, a sun bundle of
65 536 rays, ``occupancy``'s 4096 points of one ``mri_slices`` slab). It
prints one JSON line: for each shape, the process's first
``mt_raycast_cuda`` call at that shape on the host's clock, then one call
as a CUDA-graph replay (the card's time alone) and between CUDA events (as
a caller sees it); then six ``mri_slices`` calls (8 slabs of 64², one
``occupancy`` launch a slab) on the host's clock. Run it in turns
(parent, change, change, parent), one process each, from two unpacked
``git archive`` trees, to compare two commits' kernels on one card and
the same inputs.
"""

import importlib.util
import json
import os
import sys
import time


def main() -> None:
    import torch

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        sys.exit("usage: python3 mt_raycast_times.py LABEL, on a machine with a CUDA card")
    sys.path.insert(0, os.getcwd())
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from pyqsm_tpu_torch.config import RaycastConfig
    from pyqsm_tpu_torch.models import raycast as tmr
    from pyqsm_tpu_torch.ops import mt_raycast as mt
    from pyqsm_tpu_torch.ops import raytrace as tr
    from pyqsm_tpu_torch.ops import voxelmesh as vm

    pts = cs.synthetic_plot(2_000_000, cs.N_TREES, 0, "cuda")
    raw = vm.poisson_like_mesh(pts[pts[:, 2] > 6.0], voxel=0.12, blur_iters=1)
    mesh = vm.simplify_mesh(raw, target_triangles=2000)
    out = dict(label=sys.argv[1], package=os.path.abspath(os.path.dirname(mt.__file__)),
               triangles=int(mesh.triangles.shape[0]))
    for name, (o, d) in cs.mt_shapes(tr, tmr, mesh, RaycastConfig()).items():
        def call():
            return mt.mt_raycast_cuda(o, d, mesh.vertices, mesh.triangles)
        first = host_ms(call)
        out[name] = dict(rays=o.shape[0], first_ms=first, graph_ms=cs.graph_ms(call),
                         call_ms=cs.time_ms(call))
    out["mri_slices_ms"] = [host_ms(lambda: tmr.mri_slices(mesh, n_slices=8, resolution=64,
                                                           device="cuda"))
                            for _ in range(6)]
    print(json.dumps(out), flush=True)


def host_ms(fn) -> float:
    """Host-clock milliseconds of one call of ``fn``, the card's work
    included."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


if __name__ == "__main__":
    main()
