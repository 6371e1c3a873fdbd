"""Map-state checkpoint and resume.

Counterpart of `dsp_slam_rgbd_tpu/utils/checkpoint.py`: the whole
`MapState` goes to one npz under the JAX package's keys and dtypes (one
array per field, descriptor words as uint32; `extra_{key}` for caller
data), so a checkpoint written by either package loads in the other.
Fields missing from an older file take `map_state.empty`'s defaults.
"""
from __future__ import annotations

import numpy as np

from dsp_slam_rgbd_tpu_torch.mapping import map_state as ms
from dsp_slam_rgbd_tpu_torch.weights import map_state_from_numpy, map_state_to_numpy


def save_state(path: str, state: ms.MapState, extra: dict | None = None) -> None:
    flat = map_state_to_numpy(state)
    for k, v in (extra or {}).items():
        flat[f"extra_{k}"] = np.asarray(v)
    np.savez_compressed(path, **flat)


def load_state(path: str, device="cuda"):
    """-> (MapState on `device`, {extra key: numpy array})."""
    with np.load(path) as z:
        files = set(z.files)
        defaults = None
        if not files.issuperset(ms.MapState._fields):
            defaults = map_state_to_numpy(ms.empty(
                max_kf=int(z["kf_pose"].shape[0]), max_feat=int(z["kf_xy"].shape[1]),
                max_pts=int(z["pt_pos"].shape[0]), max_obj=int(z["obj_pose"].shape[0]),
                code_len=int(z["obj_code"].shape[1]), max_oobs=int(z["oobs_kf"].shape[0]),
                device="cpu"))
        fields = {f: z[f] if f in files else defaults[f] for f in ms.MapState._fields}
        extra = {k[len("extra_"):]: z[k] for k in files if k.startswith("extra_")}
    return map_state_from_numpy(fields, device=device), extra
