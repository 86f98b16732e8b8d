"""Python twin of the native quantile sketch (QuantileSketch.h).

DDSketch-style log-bucketed histogram: value v lands in bucket
ceil(log_gamma(v)) with gamma = (1+alpha)/(1-alpha), so every bucket's
midpoint estimate is within relative error alpha of any value it holds.
Merging two same-alpha sketches adds bucket counts — exactly — which is
what lets a flat fleet sweep (or a parity test) reduce the same true
distribution the relay tree reduces natively.

Same bucket math, same wire format ({"a","c","s","mn","mx","z","pi",
"pc","ni","nc","v"}), same quantile definition (numpy-style fractional
rank over bucket midpoints, clamped to the exact min/max): a stream fed
to both implementations yields quantiles within the documented bound of
each other, and a sketch serialized by either side deserializes in the
other. Kept dependency-free (math only) like the rest of the fleet
tooling.
"""

from __future__ import annotations

import math

ALPHA = 0.01
MAX_BUCKETS = 2048
# The documented end-to-end bound (bucket error + rank interpolation
# headroom) every consumer states; mirrors kDocumentedRelativeError.
RELATIVE_ERROR_BOUND = 0.02
ZERO_EPSILON = 1e-12


class QuantileSketch:
    """Mergeable quantile sketch with exact count/sum/min/max."""

    __slots__ = ("alpha", "gamma", "log_gamma", "max_buckets",
                 "count", "sum", "min", "max", "zero", "pos", "neg")

    def __init__(self, alpha: float = ALPHA,
                 max_buckets: int = MAX_BUCKETS):
        self.alpha = alpha
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self.log_gamma = math.log(self.gamma)
        self.max_buckets = max(2, max_buckets)
        self.count = 0
        self.sum = 0.0
        self.min = 0.0
        self.max = 0.0
        self.zero = 0
        self.pos: dict[int, int] = {}
        self.neg: dict[int, int] = {}

    # ------------------------------------------------------------ feed

    def _bucket_index(self, v: float) -> int:
        return math.ceil(math.log(v) / self.log_gamma)

    def _bucket_value(self, idx: int) -> float:
        return 2.0 * self.gamma ** idx / (self.gamma + 1.0)

    def _collapse(self, store: dict[int, int]) -> None:
        # Fold the lowest-index buckets upward (DDSketch's collapse
        # rule): accuracy degrades only at the smallest magnitudes.
        while len(store) > self.max_buckets:
            low, second, *_ = sorted(store)[:2]
            store[second] += store.pop(low)

    def add(self, value: float, times: int = 1) -> None:
        if times <= 0 or not math.isfinite(value):
            return
        if self.count == 0:
            self.min = self.max = value
        else:
            self.min = min(self.min, value)
            self.max = max(self.max, value)
        self.count += times
        self.sum += value * times
        if abs(value) <= ZERO_EPSILON:
            self.zero += times
        elif value > 0:
            idx = self._bucket_index(value)
            self.pos[idx] = self.pos.get(idx, 0) + times
            self._collapse(self.pos)
        else:
            idx = self._bucket_index(-value)
            self.neg[idx] = self.neg.get(idx, 0) + times
            self._collapse(self.neg)

    def merge(self, other: "QuantileSketch") -> bool:
        """Adds other's buckets into self; exact, but requires matching
        alpha (returns False and leaves self untouched otherwise)."""
        if other.count == 0:
            return True
        if abs(self.alpha - other.alpha) > 1e-12:
            return False
        if self.count == 0:
            self.min = other.min
            self.max = other.max
        else:
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
        self.count += other.count
        self.sum += other.sum
        self.zero += other.zero
        for idx, cnt in other.pos.items():
            self.pos[idx] = self.pos.get(idx, 0) + cnt
        for idx, cnt in other.neg.items():
            self.neg[idx] = self.neg.get(idx, 0) + cnt
        self._collapse(self.pos)
        self._collapse(self.neg)
        return True

    # ----------------------------------------------------------- query

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def bucket_count(self) -> int:
        return len(self.pos) + len(self.neg) + (1 if self.zero else 0)

    def _value_at_rank(self, rank: int) -> float:
        if rank <= 0:
            return self.min
        if rank >= self.count - 1:
            return self.max
        clamp = lambda v: max(self.min, min(self.max, v))  # noqa: E731
        cum = 0
        # Ascending value order: most-negative first, zeros, positives.
        for idx in sorted(self.neg, reverse=True):
            cum += self.neg[idx]
            if rank < cum:
                return clamp(-self._bucket_value(idx))
        cum += self.zero
        if rank < cum:
            return clamp(0.0)
        for idx in sorted(self.pos):
            cum += self.pos[idx]
            if rank < cum:
                return clamp(self._bucket_value(idx))
        return self.max

    def quantile(self, q: float) -> float:
        """numpy-style interpolated quantile at rank q*(count-1) over
        bucket midpoints, clamped to the exact min/max. 0 when empty."""
        if self.count == 0:
            return 0.0
        if self.count == 1:
            return self.min
        q = max(0.0, min(1.0, q))
        rank = q * (self.count - 1)
        lo = math.floor(rank)
        hi = math.ceil(rank)
        v_lo = self._value_at_rank(lo)
        v_hi = v_lo if hi == lo else self._value_at_rank(hi)
        return v_lo + (v_hi - v_lo) * (rank - lo)

    # ------------------------------------------------------------ wire

    def to_json(self) -> dict:
        out: dict = {"v": 1, "a": self.alpha, "c": self.count,
                     "s": self.sum}
        if self.count > 0:
            out["mn"] = self.min
            out["mx"] = self.max
        if self.zero:
            out["z"] = self.zero
        if self.pos:
            idxs = sorted(self.pos)
            out["pi"] = idxs
            out["pc"] = [self.pos[i] for i in idxs]
        if self.neg:
            idxs = sorted(self.neg)
            out["ni"] = idxs
            out["nc"] = [self.neg[i] for i in idxs]
        return out

    @classmethod
    def from_json(cls, payload: dict) -> "QuantileSketch | None":
        """None on a malformed payload; accepts any declared alpha."""
        if not isinstance(payload, dict):
            return None
        alpha = payload.get("a")
        count = payload.get("c")
        if not isinstance(alpha, (int, float)) or not 0 < alpha < 1:
            return None
        if not isinstance(count, int) or count < 0:
            return None
        sk = cls(alpha=float(alpha))
        sk.count = count
        sk.sum = float(payload.get("s", 0.0))
        if count > 0:
            mn, mx = payload.get("mn"), payload.get("mx")
            if not isinstance(mn, (int, float)) or \
                    not isinstance(mx, (int, float)):
                return None
            sk.min, sk.max = float(mn), float(mx)
        sk.zero = int(payload.get("z", 0))
        for idx_key, cnt_key, store in (("pi", "pc", sk.pos),
                                        ("ni", "nc", sk.neg)):
            idxs = payload.get(idx_key, [])
            cnts = payload.get(cnt_key, [])
            if len(idxs) != len(cnts):
                return None
            for idx, cnt in zip(idxs, cnts):
                if cnt <= 0:
                    return None
                store[idx] = store.get(idx, 0) + cnt
        return sk


def merge_all(payloads) -> "QuantileSketch | None":
    """Merges an iterable of wire payloads (dicts) into one sketch;
    malformed or alpha-mismatched entries are skipped. None when
    nothing merged."""
    merged: QuantileSketch | None = None
    for payload in payloads:
        sk = QuantileSketch.from_json(payload)
        if sk is None or sk.count == 0:
            continue
        if merged is None:
            merged = sk
        else:
            merged.merge(sk)
    return merged
