"""Time the f32 decoder kernels of a checkout of this repository at the
keyframe stage's four row counts, for comparing two versions on one card.

    python3 dsp_slam_rgbd_tpu_torch/tools/time_f32_kernels.py [--root DIR] [--tag T]

Imports `dsp_slam_rgbd_tpu_torch` from DIR (default: this checkout),
builds its kernels, and times each f32 kernel (CUDA events, 20 launches
after a warm-up) on random cars_64 weights at the rows of
`chip_smoke.py`'s phase 10: the value kernel at 7 x 8,192 (render) and
7 x 24^3 (`sdf_bbox`) rows, the Jacobian at 7 x 2,048 (render) and
8 x 256 (refinement) rows, 7 or 8 object codes over points near their
ellipsoid surfaces.  A checkout whose f32 kernels read host-packed weight
streams (`DeepSDFDecoder.tiles`) gets them; an older one takes none.
Prints one JSON line: the card, the tag and the ms per shape.
"""
import argparse
import json
import os
import subprocess
import sys

SHAPES = (("value", 7 * 8192, 7), ("value", 7 * 24 ** 3, 7),
          ("jacobian", 7 * 2048, 7), ("jacobian", 8 * 256, 8))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    ap.add_argument("--tag", default="")
    opts = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(opts.root))
    import numpy as np
    import torch

    from dsp_slam_rgbd_tpu_torch.models import deepsdf
    from dsp_slam_rgbd_tpu_torch.ops.cuda import build, mlp_sdf

    if not torch.cuda.is_available():
        print("time_f32_kernels: CUDA is not available", file=sys.stderr)
        return 1
    build.load()
    f32 = torch.float32
    dec = deepsdf.init_decoder(deepsdf.DecoderSpec(), seed=0, device="cuda")
    wb = dec.packed(f32)
    streams = hasattr(dec, "tiles")
    out = {}
    for kind, rows, n_obj in SHAPES:
        g = np.random.default_rng(rows)
        code = torch.tensor(g.standard_normal((n_obj, 64)) * 0.2, dtype=f32, device="cuda")
        dirs = g.standard_normal((n_obj, rows // n_obj, 3))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        xyz = torch.tensor(dirs * 0.5, dtype=f32, device="cuda")
        jac = kind == "jacobian"
        kw = {"tiles": dec.tiles(f32, jacobian=jac)} if streams else {}
        fn = mlp_sdf.sdf_and_input_jacobian_fused if jac else mlp_sdf.sdf_value_fused
        fn(wb, code, xyz, f32, **kw)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn(wb, code, xyz, f32, **kw)
        end.record()
        torch.cuda.synchronize()
        out[f"{kind}_{rows}"] = start.elapsed_time(end) / 20
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"tag": opts.tag, "card": card, "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
