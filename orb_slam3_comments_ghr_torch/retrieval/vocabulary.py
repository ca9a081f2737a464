"""Binary visual vocabulary: k-ary tree of 256-bit centroids.

Port of `orb_slam3_comments_ghr_tpu/retrieval/vocabulary.py`
(DBoW2::TemplatedVocabulary, reference Thirdparty/DBoW2/DBoW2/
TemplatedVocabulary.h: k=10, L levels, binary k-medians, `transform`
descends by min Hamming, :136-163). The tree is dense arrays, one
(nodes, k, 8) uint32 centroid table per level, and the BoW vector is a dense
(n_words,) tf-idf vector.

Training, persistence (`save` writes the JAX package's file format), the
host descent and the scoring functions are the JAX package's numpy code.
`transform_on_device` descends all descriptors of a frame at once in
PyTorch, on the device of the descriptors it is given (or the vocabulary's
`device` for numpy input), with the port's SWAR popcount.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..ops.matching import popcount32
from ..utils.device import resolve_device

_TABLES_LOCK = threading.Lock()

_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,8) x (M,8) -> (N,M) int Hamming via byte-LUT popcount."""
    x = a[:, None, :] ^ b[None, :, :]
    return _POPCNT8[x.view(np.uint8).reshape(x.shape[0], x.shape[1], 32)].sum(
        -1, dtype=np.int32
    )


def _majority(descs: np.ndarray) -> np.ndarray:
    """Bitwise majority vote (FORB::meanValue, DBoW2/FORB.cpp:40)."""
    bits = np.unpackbits(descs.view(np.uint8), axis=1)  # (N, 256)
    maj = (bits.sum(0) * 2 >= len(descs)).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def _kmedians(descs: np.ndarray, k: int, rng, iters: int = 8):
    """Binary k-medians; returns (k, 8) centroids."""
    n = len(descs)
    if n <= k:
        out = np.zeros((k, 8), np.uint32)
        out[:n] = descs
        if n:
            out[n:] = descs[rng.integers(0, n, k - n)]
        return out
    cent = descs[rng.choice(n, k, replace=False)]
    for _ in range(iters):
        d = _hamming_np(descs, cent)
        assign = d.argmin(1)
        for j in range(k):
            sel = descs[assign == j]
            if len(sel):
                cent[j] = _majority(sel)
            else:
                cent[j] = descs[rng.integers(0, n)]
    return cent


class Vocabulary:
    """levels: list of (n_nodes_l, k, 8) uint32 arrays; words = k**L leaves.
    idf: (n_words,) per-word inverse document frequency (DBoW2 TF_IDF
    weighting) — ones when trained without image grouping. `device` (the
    card unless the caller passes `device="cpu"`) is where
    `transform_on_device` descends numpy input."""

    def __init__(self, levels: list[np.ndarray], k: int, idf: np.ndarray | None = None,
                 device=None):
        self.levels = levels
        self.k = k
        self.L = len(levels)
        self.n_words = k ** self.L
        self.idf = (np.ones(self.n_words, np.float32)
                    if idf is None else idf.astype(np.float32))
        self.device = resolve_device(device)
        self._tables: dict[torch.device, list[torch.Tensor]] = {}

    # ------------------------------------------------------------- training
    @staticmethod
    def train(descs: np.ndarray, k: int = 10, L: int = 3, seed: int = 0,
              image_ids: np.ndarray | None = None, device=None) -> "Vocabulary":
        """Build the tree level by level; with `image_ids` labelling each
        corpus descriptor's image, idf = log(N_images / N_images_with_word)."""
        rng = np.random.default_rng(seed)
        levels = []
        assign = np.zeros(len(descs), np.int64)
        n_nodes = 1
        for _ in range(L):
            cents = np.zeros((n_nodes, k, 8), np.uint32)
            new_assign = np.zeros_like(assign)
            for node in range(n_nodes):
                sel = np.nonzero(assign == node)[0]
                sub = descs[sel] if len(sel) else descs[rng.integers(0, len(descs), k)]
                cents[node] = _kmedians(sub, k, rng)
                if len(sel):
                    d = _hamming_np(descs[sel], cents[node])
                    new_assign[sel] = node * k + d.argmin(1)
            levels.append(cents)
            assign = new_assign
            n_nodes *= k
        idf = None
        if image_ids is not None:
            image_ids = np.asarray(image_ids)
            n_img = len(np.unique(image_ids))
            pair = np.unique(np.stack([assign, image_ids]), axis=1)
            ni = np.bincount(pair[0], minlength=k ** L).astype(np.float64)
            idf = np.log(n_img / np.maximum(ni, 1.0)).astype(np.float32)
            idf[ni == 0] = float(np.log(n_img))  # unseen words: max weight
        return Vocabulary(levels, k, idf, device)

    @staticmethod
    def random(k: int = 10, L: int = 3, seed: int = 0, n_train: int = 20000,
               device=None) -> "Vocabulary":
        """Train on uniform random descriptors."""
        rng = np.random.default_rng(seed)
        descs = rng.integers(0, 2**32, (n_train, 8), dtype=np.uint32)
        return Vocabulary.train(descs, k, L, seed, device=device)

    # ----------------------------------------------------------- persistence
    def save(self, path: str):
        """The JAX package's file: `k`, `L`, `idf` and one `level_i` per
        level, compressed; either package loads the other's bit for bit."""
        np.savez_compressed(
            path, k=self.k, L=self.L, idf=self.idf,
            **{f"level_{i}": lv for i, lv in enumerate(self.levels)},
        )

    @staticmethod
    def load(path: str, device=None) -> "Vocabulary":
        z = np.load(path)
        L = int(z["L"])
        idf = z["idf"] if "idf" in z.files else None
        return Vocabulary([z[f"level_{i}"] for i in range(L)], int(z["k"]), idf, device)

    # ------------------------------------------------------------ transform
    @property
    def mid_level(self) -> int:
        """Level whose node ids give the ~k^2 groups of BoW-guided matching
        (the reference's FeatureVector at nid_level, Frame.cc:995-1010)."""
        return min(1, self.L - 1)

    def transform(self, descs: np.ndarray, valid: np.ndarray):
        """Host numpy descent of all descriptors at once. Returns (word_id
        (N,), node_id (N,) at `mid_level`), -1 where not valid."""
        n = len(descs)
        node = np.zeros(n, np.int64)
        mid = np.zeros(n, np.int64)
        for lvl in range(self.L):
            cents = self.levels[lvl][node]          # (N, k, 8)
            x = (descs[:, None, :] ^ cents).view(np.uint8)
            d = _POPCNT8[x.reshape(n, self.k, 32)].sum(-1, dtype=np.int32)
            node = node * self.k + d.argmin(1)
            if lvl == self.mid_level:
                mid = node.copy()
        return np.where(valid, node, -1), np.where(valid, mid, -1)

    def _device_tables(self, device: torch.device) -> list[torch.Tensor]:
        """The levels as int32 tables on `device`, built once. Built on one
        thread's stream and read from others' (asynchronous mapping): the
        build finishes before any reader can see them."""
        with _TABLES_LOCK:
            if device not in self._tables:
                tables = [torch.from_numpy(np.ascontiguousarray(lv).view(np.int32)).to(device)
                          for lv in self.levels]
                if device.type == "cuda":
                    torch.cuda.current_stream(device).synchronize()
                self._tables[device] = tables
        return self._tables[device]

    def transform_on_device(self, descs, valid):
        """The descent as tensor ops: per level one gathered XOR-popcount
        argmin over the k children (argmin takes the first of ties, as
        numpy's). `descs` is (N,8) uint32 numpy (run on `self.device`) or
        int32 tensor (run where it lies); `valid` (N,) bool. Returns (word,
        mid) as int64 numpy, from one host fetch."""
        if isinstance(descs, np.ndarray):
            descs = torch.from_numpy(np.ascontiguousarray(descs, np.uint32).view(np.int32))
            descs = descs.to(self.device)
        valid = torch.as_tensor(valid, device=descs.device)
        tables = self._device_tables(descs.device)
        node = torch.zeros(descs.shape[0], dtype=torch.int64, device=descs.device)
        mid = node
        for lvl in range(self.L):
            cents = tables[lvl][node]                                  # (N, k, 8)
            d = popcount32(descs[:, None, :] ^ cents).sum(-1)          # (N, k)
            node = node * self.k + torch.argmin(d, dim=1)
            if lvl == self.mid_level:
                mid = node
        out = torch.stack([torch.where(valid, node, -1), torch.where(valid, mid, -1)]).cpu().numpy()
        return out[0], out[1]

    def bow_vector(self, word_id: np.ndarray) -> np.ndarray:
        """L1-normalized dense tf-idf vector (n_words,) float32."""
        v = np.zeros(self.n_words, np.float32)
        np.add.at(v, word_id[word_id >= 0], 1.0)
        v *= self.idf
        s = v.sum()
        return v / s if s > 0 else v


def score_l1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """DBoW2 L1 score for L1-normalized vectors: sum_i min(a_i, b_i)."""
    return np.minimum(a, b).sum(-1)


def score_l2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """DBoW2 L2 score: dot of the unit vectors."""
    an = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
    bn = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    return (an * bn).sum(-1)


def score_bhattacharyya(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """DBoW2 Bhattacharyya coefficient: sum_i sqrt(a_i b_i)."""
    return np.sqrt(np.maximum(a * b, 0.0)).sum(-1)


def score_dot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """DBoW2 dot-product scoring."""
    return (a * b).sum(-1)


SCORING = {
    "l1": score_l1,
    "l2": score_l2,
    "bhattacharyya": score_bhattacharyya,
    "dot": score_dot,
}
