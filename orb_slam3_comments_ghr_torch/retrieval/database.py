"""Keyframe database: place-recognition queries over keyframe BoW vectors.

Replaces KeyFrameDatabase (reference: src/KeyFrameDatabase.cc — inverted file
mvInvertedFile[wordId], DetectNBestCandidates :669, DetectRelocalization-
Candidates :920). Storage is SPARSE — per-keyframe (word-id, tf-idf weight)
arrays plus a word→keyframe inverted file — so the same code scales from the
1k-word test vocabularies to the 100k-word production tree (a dense
(n_kf, n_words) matrix at 100k words would cost ~400 KB/KF and make every
common-word pass O(n_kf·n_words)). The vocabulary descent itself runs as one
jitted device program (`Vocabulary.transform_on_device`); queries take the
dense (n_words,) vector the tracker/loop-closer already hold and touch only
the inverted-file lists, exactly like the reference.

Copied from `orb_slam3_comments_ghr_tpu/retrieval/database.py`; it imports
the port's vocabulary, whose descent runs on the vocabulary's device. The
tables are host numpy; with asynchronous mapping the tracker adds and
queries while the mapper erases and the loop closer queries, so every
change and query holds the database's lock (the descent itself runs
outside it).
"""

from __future__ import annotations

import threading

import numpy as np

from .vocabulary import Vocabulary


class KeyFrameDatabase:
    def __init__(self, voc: Vocabulary, max_kf: int):
        self.voc = voc
        self.n_words = voc.n_words
        self.present = np.zeros(max_kf, bool)
        # sparse BoW per keyframe: sorted unique word ids + L1-normalized
        # tf-idf weights (what a BowVector is, DBoW2/BowVector.h)
        self.kf_words: dict[int, np.ndarray] = {}
        self.kf_weights: dict[int, np.ndarray] = {}
        # inverted file: word id -> list of keyframes containing it
        # (mvInvertedFile, KeyFrameDatabase.h:87). Lists are append-only;
        # erased KFs are masked out by `present` at query time and purged
        # lazily on the next add() of the same KF id.
        self.inv: dict[int, list[int]] = {}
        # per-feature word/node ids for BoW-guided matching
        self.kf_word: dict[int, np.ndarray] = {}
        self.kf_node: dict[int, np.ndarray] = {}
        self.lock = threading.RLock()

    def _ensure_capacity(self, kf: int):
        n = len(self.present)
        if kf < n:
            return
        while n <= kf:
            n *= 2
        self.present = np.concatenate(
            [self.present, np.zeros(n - len(self.present), bool)]
        )

    def add(self, kf: int, descs: np.ndarray, valid: np.ndarray):
        # on-device tree descent (TemplatedVocabulary::transform, :136-163)
        word, node = self.voc.transform_on_device(descs, valid)
        with self.lock:
            return self._add(kf, word, node)

    def _add(self, kf: int, word: np.ndarray, node: np.ndarray):
        self._ensure_capacity(kf)
        if kf in self.kf_words:  # re-add after erase: purge stale postings
            for w in self.kf_words[kf]:
                lst = self.inv.get(int(w))
                if lst is not None and kf in lst:
                    lst.remove(kf)
        w = word[word >= 0]
        uw, counts = (np.unique(w, return_counts=True) if len(w)
                      else (np.zeros(0, np.int64), np.zeros(0, np.int64)))
        wt = counts.astype(np.float32) * self.voc.idf[uw]
        s = wt.sum()
        if s > 0:
            wt /= s
        keep = wt > 0
        uw, wt = uw[keep], wt[keep]
        self.kf_words[kf] = uw
        self.kf_weights[kf] = wt
        for u in uw:
            self.inv.setdefault(int(u), []).append(kf)
        self.present[kf] = True
        self.kf_word[kf] = word
        self.kf_node[kf] = node
        return word, node

    def erase(self, kf: int):
        with self.lock:
            if kf < len(self.present):
                self.present[kf] = False

    # ----------------------------------------------------------------- query
    def query_vector(self, kf: int) -> np.ndarray:
        """Dense (n_words,) tf-idf vector of a stored keyframe (query side
        of DetectNBestCandidates — the query is always one vector, so dense
        is fine; the database side stays sparse)."""
        v = np.zeros(self.n_words, np.float32)
        with self.lock:
            if kf in self.kf_words:
                v[self.kf_words[kf]] = self.kf_weights[kf]
        return v

    def _sparse_score(self, kf: int, query_bow: np.ndarray) -> float:
        """DBoW2 L1 score Σ_i min(a_i, b_i) over the stored KF's support
        (min is 0 outside the intersection; ScoringObject.cpp L1Scoring)."""
        w = self.kf_words.get(kf)
        if w is None or not len(w):
            return 0.0
        return float(np.minimum(self.kf_weights[kf], query_bow[w]).sum())

    def _common_words(self, query_words: np.ndarray) -> np.ndarray:
        """Per-KF count of shared words via the inverted file
        (KeyFrameDatabase.cc:703-721)."""
        lists = [
            np.asarray(self.inv[int(w)], np.int64)
            for w in query_words
            if self.inv.get(int(w))
        ]
        if not lists:
            return np.zeros(len(self.present), np.int64)
        return np.bincount(np.concatenate(lists), minlength=len(self.present))

    def detect_candidates(
        self,
        query_bow: np.ndarray,
        exclude: set[int],
        map_state,
        n_best: int = 3,
        min_score_cut: float = 0.8,
        final_acc_cut: float | None = None,
    ) -> list[int]:
        """DetectNBestCandidates: common-word count -> 0.8*max cutoff ->
        accumulated covisibility-group score -> top-N group champions.
        final_acc_cut, when set, keeps every group above cut*bestAccScore
        (the DetectRelocalizationCandidates 0.75 rule,
        KeyFrameDatabase.cc:920)."""
        with self.lock:
            return self._detect_candidates(query_bow, exclude, map_state, n_best,
                                           min_score_cut, final_acc_cut)

    def _detect_candidates(self, query_bow, exclude, map_state, n_best, min_score_cut,
                           final_acc_cut):
        qwords = np.nonzero(query_bow > 0)[0]
        common = self._common_words(qwords)
        common[~self.present] = 0
        for k in exclude:
            if 0 <= k < len(common):
                common[k] = 0
        if common.max() == 0:
            return []
        th = max(min_score_cut * common.max(), 1)
        cands = np.nonzero(common >= th)[0]

        # accumulate over each candidate's 10 best covisible neighbors; the
        # group's champion is its best-scoring member (pBestScoreKF)
        acc = []
        for c in cands:
            group = [int(c)] + map_state.covisible_kfs(int(c), k=10, min_weight=5)
            g_scores = [
                (self._sparse_score(int(g), query_bow), int(g))
                for g in group
                if g < len(self.present) and self.present[g]
                and g not in exclude
            ]
            if not g_scores:
                continue
            best_s, best_kf = max(g_scores)
            acc.append((sum(gs for gs, _ in g_scores), best_s, best_kf))
        if not acc:
            return []
        acc.sort(key=lambda x: -x[0])
        if final_acc_cut is not None:
            best_acc = acc[0][0]
            acc = [a for a in acc if a[0] >= final_acc_cut * best_acc]
        out = []
        for _, _, kf in acc:
            if kf not in out:
                out.append(kf)
            if n_best is not None and len(out) >= n_best:
                break
        return out

    def detect_relocalization_candidates(
        self, query_bow: np.ndarray, map_state, n_best: int = 5
    ) -> list[int]:
        """DetectRelocalizationCandidates (:920): same shape, 0.75 final
        accumulated-score cut, no exclusion set."""
        return self.detect_candidates(
            query_bow, set(), map_state, n_best=n_best, min_score_cut=0.8,
            final_acc_cut=0.75,
        )
