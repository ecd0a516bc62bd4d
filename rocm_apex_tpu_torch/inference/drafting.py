"""N-gram self-drafting for speculative decoding.

Port of ``rocm_apex_tpu/inference/drafting.py`` in numpy. The engine
packs each decoding slot's history on the host every tick, so the
drafter runs there on that host data: it adds no device work and no
device sync. `NGramDrafter` suffix-matches the slot's own history
(prompt + generated tokens): if the final n-gram occurred earlier, the
tokens that followed the earlier occurrence are proposed as the
continuation (the "prompt lookup" scheme). It is deterministic and
model-free, and proposes the JAX drafter's tokens bit for bit.

The engine treats the drafter as a pluggable hook with the protocol

    drafts, counts = drafter(histories, lengths)

where ``histories`` is ``(num_slots, window)`` int32, LEFT-padded with
``-1`` (each row right-aligned so the suffix, the match anchor, sits at
a fixed offset), ``lengths`` is ``(num_slots,)`` int32 live-token
counts, and the result is ``(num_slots, k)`` int32 proposals with
``(num_slots,)`` valid counts. A learned draft model can be dropped in
by wrapping its own propose step in the same signature.
"""

from typing import Sequence, Tuple

import numpy as np

__all__ = ["NGramDrafter"]


class NGramDrafter:
    """Propose up to ``k`` continuation tokens by suffix n-gram match.

    For each ``n`` in ``ngrams`` (tried longest-first), the final ``n``
    tokens of the history are searched for an earlier occurrence inside
    the last ``window`` tokens. On a hit, the tokens FOLLOWING the
    matched occurrence are proposed. Among candidate occurrences the
    drafter prefers ones with at least ``k`` following tokens, breaking
    ties by recency, so repetitive tails lock onto the most recent
    period.
    """

    def __init__(
        self,
        k: int,
        *,
        window: int = 64,
        ngrams: Sequence[int] = (3, 2),
    ):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if window < max(ngrams) + k:
            raise ValueError(
                f"window={window} too small for ngrams={tuple(ngrams)} "
                f"with k={k}"
            )
        if any(n < 1 for n in ngrams):
            raise ValueError(f"ngrams must be >= 1, got {tuple(ngrams)}")
        self.k = int(k)
        self.window = int(window)
        self.ngrams = tuple(int(n) for n in ngrams)

    def _match_n(self, hist: np.ndarray, lengths: np.ndarray, n: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One cascade rung: match the final ``n``-gram. Returns
        ``(found (S,) bool, drafts (S, k), counts (S,))``."""
        S, W = hist.shape
        k = self.k
        m = W - n  # candidate starts [0, m); start m is the suffix itself
        pattern = hist[:, W - n:]
        eq = np.ones((S, m), dtype=bool)
        for j in range(n):
            eq &= hist[:, j:j + m] == pattern[:, j:j + 1]
        starts = np.arange(m)[None, :]
        # a candidate's whole n-gram must lie in the live region: the -1
        # left pad (or stale bytes) would false-match short histories
        valid = eq & (starts >= (W - lengths)[:, None])
        # prefer occurrences with >= k following tokens, then recency
        follow = m - starts
        score = np.where(valid, starts + np.where(follow >= k, W, 0), -1)
        best = np.argmax(score, axis=1)
        found = valid.any(axis=1)
        start = best + n  # the first proposed token
        count = np.minimum(k, W - start)
        idx = np.clip(start[:, None] + np.arange(k)[None, :], 0, W - 1)
        drafts = np.take_along_axis(hist, idx, axis=1)
        keep = np.arange(k)[None, :] < count[:, None]
        return (found, np.where(keep & found[:, None], drafts, 0),
                np.where(found, count, 0))

    def propose(self, histories: np.ndarray, lengths: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        """``(S, window)`` histories -> ``(S, k)`` int32 drafts and
        ``(S,)`` int32 counts. The longest n-gram in the cascade wins."""
        hist = np.asarray(histories).astype(np.int32)
        lengths = np.minimum(np.asarray(lengths).astype(np.int32),
                             self.window)
        S = hist.shape[0]
        drafts = np.zeros((S, self.k), np.int32)
        counts = np.zeros((S,), np.int32)
        done = np.zeros((S,), bool)
        for n in self.ngrams:
            found, d_n, c_n = self._match_n(hist, lengths, n)
            take = found & ~done
            drafts = np.where(take[:, None], d_n, drafts).astype(np.int32)
            counts = np.where(take, c_n, counts).astype(np.int32)
            done |= found
        return drafts, counts

    __call__ = propose
