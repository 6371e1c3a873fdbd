"""Visual vocabulary: binary k-medians tree as dense tensors.

Counterpart of `dsp_slam_rgbd_tpu/loop/vocabulary.py` (the role of DBoW2's
`TemplatedVocabulary<FORB>`, loaded at `System.cc:80`): descriptor→word
quantization, tf-idf BoW vectors, and L1 similarity scoring for place
recognition.  The vocabulary is trained in-framework (`train`, Hamming
k-medians on the host in numpy: the same seed gives the same tree, bit for
bit, as the JAX package's `train`); quantization is a batched tree walk
over centroid tensors (levels of (n_nodes, K, 8) int32 words, XOR and the
SWAR popcount of `frontend/matcher.py`).  Descriptor words are uint32 in
numpy and in the JAX package, int32 here: they cross as a bit view.
`save_npz`/`load_npz` keep the JAX package's format (uint32 levels), so a
vocabulary saved by either package loads in the other.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dsp_slam_rgbd_tpu_torch import device as device_mod
from dsp_slam_rgbd_tpu_torch.frontend.matcher import popcount32


class Vocabulary(NamedTuple):
    centroids: tuple          # per level l: (K^l, K, 8) int32 words
    branching: int
    depth: int

    @property
    def n_words(self) -> int:
        return self.branching ** self.depth


def _popcount_np(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _kmedians(desc: np.ndarray, k: int, rng, iters: int = 8) -> np.ndarray:
    """Binary k-medians: (N, 8) uint32 -> (k, 8) uint32 centroids."""
    n = len(desc)
    if n == 0:
        return np.zeros((k, 8), np.uint32)
    centroids = desc[rng.choice(n, size=min(k, n), replace=False)]
    if len(centroids) < k:
        centroids = np.concatenate(
            [centroids, np.zeros((k - len(centroids), 8), np.uint32)])
    bits = np.unpackbits(desc.view(np.uint8), axis=-1)  # (N, 256)
    for _ in range(iters):
        d = _popcount_np(desc[:, None, :] ^ centroids[None, :, :])  # (N, k)
        assign = d.argmin(-1)
        for c in range(k):
            sel = bits[assign == c]
            if len(sel):
                maj = (sel.mean(0) > 0.5).astype(np.uint8)
                centroids[c] = np.packbits(maj).view(np.uint32)
    return centroids.astype(np.uint32)


def _levels_to_device(levels, dev) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(c, np.uint32).view(np.int32)).to(dev)
                 for c in levels)


def train(descriptors: np.ndarray, branching: int = 10, depth: int = 3,
          seed: int = 0, max_per_node: int = 20000, device="cuda") -> Vocabulary:
    """Hierarchical k-medians over (N, 8) descriptors (uint32 or int32 words;
    host-side, one-off — the DBoW2 `create` role); the tree goes to
    `device`."""
    dev = device_mod.resolve(device)
    rng = np.random.default_rng(seed)
    desc = np.ascontiguousarray(descriptors)
    desc = desc.view(np.uint32) if desc.dtype == np.int32 else desc.astype(np.uint32)
    levels = []
    node_data = [desc]  # descriptors assigned to each node of current level
    for _ in range(depth):
        cents = []
        next_data = []
        for data in node_data:
            if len(data) > max_per_node:
                data = data[rng.choice(len(data), max_per_node, replace=False)]
            c = _kmedians(data, branching, rng)
            cents.append(c)
            if len(data):
                assign = _popcount_np(data[:, None, :] ^ c[None, :, :]).argmin(-1)
            else:
                assign = np.zeros(0, np.int64)
            for child in range(branching):
                next_data.append(data[assign == child])
        levels.append(np.stack(cents))  # (nodes, K, 8)
        node_data = next_data
    return Vocabulary(centroids=_levels_to_device(levels, dev), branching=branching,
                      depth=depth)


def quantize(vocab: Vocabulary, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 words -> (N,) int32 word ids (−1 for invalid slots)."""
    node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    for level in range(vocab.depth):
        c = vocab.centroids[level][node]                     # (N, K, 8)
        d = torch.sum(popcount32(desc[:, None, :] ^ c), dim=-1)  # (N, K)
        node = node * vocab.branching + torch.argmin(d, dim=-1)
    return torch.where(valid, node, -1).to(torch.int32)


def bow_vector(word_ids: torch.Tensor, n_words: int, idf=None) -> torch.Tensor:
    """(N,) word ids -> L1-normalized (W,) BoW vector (tf or tf-idf)."""
    ok = word_ids >= 0
    w_safe = torch.where(ok, word_ids.long(), n_words)
    # counted in int32 (exact in any order), then made float: small integers
    v = torch.zeros(n_words + 1, dtype=torch.int32, device=word_ids.device)
    v = v.index_add(0, w_safe, ok.to(torch.int32))[:-1].float()
    if idf is not None:
        v = v * idf
    return v / torch.clamp_min(torch.sum(v), 1e-9)


def l1_score(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity: 1 − ½‖v1 − v2‖₁ ∈ [0, 1].  Broadcasts."""
    return 1.0 - 0.5 * torch.sum(torch.abs(v1 - v2), dim=-1)


def save_npz(path: str, vocab: Vocabulary):
    """Persist a trained vocabulary in the JAX package's format (uint32
    levels; the role of the reference's ORBvoc.bin artifact)."""
    flat = {"branching": np.asarray(vocab.branching), "depth": np.asarray(vocab.depth)}
    for i, c in enumerate(vocab.centroids):
        flat[f"level{i}"] = c.cpu().numpy().view(np.uint32)
    np.savez_compressed(path, **flat)


def load_npz(path: str, device="cuda") -> Vocabulary:
    z = np.load(path)
    depth = int(z["depth"])
    return Vocabulary(
        centroids=_levels_to_device([z[f"level{i}"] for i in range(depth)],
                                    device_mod.resolve(device)),
        branching=int(z["branching"]), depth=depth)


def compute_idf(bow_counts: torch.Tensor, kf_valid: torch.Tensor) -> torch.Tensor:
    """Smoothed idf over a (K, W) per-KF word count/presence matrix:
    1 + log((1 + K) / (1 + df)).  A live-database idf hits df = K for
    stop-word texture, where the raw log(K/df) would zero those words
    outright; the smoothed form keeps all-present words at weight 1 and
    bounds the rare-word boost."""
    present = (bow_counts > 0) & kf_valid[:, None]
    n_kf = torch.clamp_min(torch.sum(kf_valid), 1)
    df = torch.sum(present, dim=0)
    return 1.0 + torch.log((1.0 + n_kf) / (1.0 + df))
