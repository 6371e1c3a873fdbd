"""Carry decoder weights and tracking state across from the JAX package.

The JAX package keeps a decoder as `params["layers"] = [(W_i, b_i), ...]`
with W_i (in, out).  `decoder_from_numpy` takes those pairs as numpy
arrays (callers apply `np.asarray` on their side) and builds the port's
module with the same layout, so both packages compute the same function.

`map_state_from_numpy`/`map_state_to_numpy` (and the `Features`/`Frame`
pairs) convert the JAX package's map and frames, given as numpy arrays
field by field, into the port's tensors and back, so both trackers start
from the same state.  Descriptor words are uint32 there and int32 here:
they cross as a bit view (`.view(np.int32)`), never a value cast, so the
round trip is exact, bit 31 included.

`ba_problem_from_numpy`/`ba_problem_to_numpy` and `ba_result_to_numpy` do
the same for bundle-adjustment problems and results, so one problem can
be solved by both packages, or on the card and on the CPU.

`vocabulary_from_numpy` and `bow_database_from_numpy` take the JAX
package's `Vocabulary` (centroid levels of uint32 words, bit-viewed as
int32) and `BowDatabase`, so both packages score one vocabulary and one
database.
"""
from __future__ import annotations

import numpy as np
import torch

from dsp_slam_rgbd_tpu_torch import device as device_mod
from dsp_slam_rgbd_tpu_torch.frontend.orb import Features
from dsp_slam_rgbd_tpu_torch.loop.keyframe_db import BowDatabase
from dsp_slam_rgbd_tpu_torch.loop.vocabulary import Vocabulary
from dsp_slam_rgbd_tpu_torch.mapping.ba import BAProblem, BAResult
from dsp_slam_rgbd_tpu_torch.mapping.map_state import MapState
from dsp_slam_rgbd_tpu_torch.models.deepsdf import (AnalyticSdfDecoder, DecoderSpec,
                                                     DeepSDFDecoder)
from dsp_slam_rgbd_tpu_torch.tracking.tracker import Frame

_WORD_FIELDS = ("desc", "kf_desc", "pt_desc")


def decoder_from_numpy(layers, spec, device="cuda", fn=None):
    """[(W (in, out), b (out,)) numpy pairs] -> DeepSDFDecoder on `device`.

    A JAX `AnalyticSdfSpec` (a spec with `fn` and no `dims`) has no layers:
    it maps to `AnalyticSdfDecoder` of its code length over `fn`, the
    caller's torch callable fn(code, xyz) of the same function."""
    dev = device_mod.resolve(device)
    if not hasattr(spec, "dims"):
        if fn is None:
            raise ValueError("an analytic spec needs the torch callable `fn`")
        return AnalyticSdfDecoder(fn, int(spec.latent_size)).to(dev)
    pairs = [(np.array(W, np.float32), np.array(b, np.float32))
             for W, b in layers]
    return DeepSDFDecoder(DecoderSpec(*spec), pairs).to(dev)


def _to_tensor(a, dev) -> torch.Tensor:
    a = np.array(a)  # a copy: arrays from JAX are read-only
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(dev)


def _to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if name in _WORD_FIELDS else a


def map_state_from_numpy(fields, device="cuda") -> MapState:
    """{field: numpy array} of a JAX `MapState` -> the port's `MapState` on
    `device`."""
    dev = device_mod.resolve(device)
    return MapState(*[_to_tensor(fields[n], dev) for n in MapState._fields])


def map_state_to_numpy(state: MapState) -> dict:
    """The port's `MapState` -> {field: numpy array} in the JAX package's
    dtypes (descriptor words as uint32)."""
    return {n: _to_numpy(n, getattr(state, n)) for n in MapState._fields}


def features_from_numpy(fields, device="cuda") -> Features:
    dev = device_mod.resolve(device)
    return Features(*[_to_tensor(fields[n], dev) for n in Features._fields])


def features_to_numpy(feats: Features) -> dict:
    return {n: _to_numpy(n, getattr(feats, n)) for n in Features._fields}


def frame_from_numpy(frame, device="cuda") -> Frame:
    """{"feats": {field: array}, "ur", "depth", "t_cw", "pt_idx": arrays,
    "timestamp"} of a JAX tracker `Frame` -> the port's `Frame` on `device`."""
    dev = device_mod.resolve(device)
    return Frame(features_from_numpy(frame["feats"], dev),
                 *[_to_tensor(frame[n], dev) for n in ("ur", "depth", "t_cw", "pt_idx")],
                 float(frame["timestamp"]))


def frame_to_numpy(frame: Frame) -> dict:
    return {"feats": features_to_numpy(frame.feats),
            **{n: _to_numpy(n, getattr(frame, n))
               for n in ("ur", "depth", "t_cw", "pt_idx")},
            "timestamp": frame.timestamp}


def ba_problem_from_numpy(fields, device="cuda") -> BAProblem:
    """{field: numpy array} of a JAX `BAProblem` -> the port's on `device`."""
    dev = device_mod.resolve(device)
    return BAProblem(*[_to_tensor(fields[n], dev) for n in BAProblem._fields])


def ba_problem_to_numpy(prob: BAProblem) -> dict:
    return {n: _to_numpy(n, getattr(prob, n)) for n in BAProblem._fields}


def ba_result_to_numpy(res: BAResult) -> dict:
    return {n: _to_numpy(n, getattr(res, n)) for n in BAResult._fields}


def vocabulary_from_numpy(fields, device="cuda") -> Vocabulary:
    """{"centroids": [(K^l, K, 8) uint32 numpy per level], "branching",
    "depth"} of a JAX `Vocabulary` -> the port's on `device`."""
    dev = device_mod.resolve(device)
    return Vocabulary(tuple(_to_tensor(c, dev) for c in fields["centroids"]),
                      int(fields["branching"]), int(fields["depth"]))


def bow_database_from_numpy(fields, device="cuda") -> BowDatabase:
    """{"bow": (K, W), "kf_valid": (K,)} numpy of a JAX `BowDatabase` -> the
    port's on `device`."""
    dev = device_mod.resolve(device)
    return BowDatabase(*[_to_tensor(fields[n], dev) for n in BowDatabase._fields])
