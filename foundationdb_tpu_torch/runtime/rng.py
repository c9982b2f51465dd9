"""Deterministic seeded RNG so simulation replays bit-for-bit.

Reference: REF:flow/IRandom.h, REF:flow/DeterministicRandom.h/.cpp —
every source of randomness in simulation flows through one seeded
generator; a seed reproduces a whole cluster run exactly.

We implement xoshiro256** ourselves (rather than wrapping random.Random)
so the C++ side (native/) can share the identical stream if it ever needs
randomness, keeping cross-language determinism on the table.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1


def _rotl(x: int, k: int) -> int:
    return ((x << k) | (x >> (64 - k))) & _MASK


def _splitmix64(seed: int):
    state = seed & _MASK
    while True:
        state = (state + 0x9E3779B97F4A7C15) & _MASK
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        yield z ^ (z >> 31)


class DeterministicRandom:
    def __init__(self, seed: int):
        sm = _splitmix64(seed)
        self._s = [next(sm) for _ in range(4)]
        self.seed = seed

    def next_u64(self) -> int:
        s = self._s
        result = (_rotl((s[1] * 5) & _MASK, 7) * 9) & _MASK
        t = (s[1] << 17) & _MASK
        s[2] ^= s[0]
        s[3] ^= s[1]
        s[1] ^= s[2]
        s[0] ^= s[3]
        s[2] ^= t
        s[3] = _rotl(s[3], 45)
        return result

    def random(self) -> float:
        """Uniform in [0, 1)."""
        return (self.next_u64() >> 11) * (1.0 / (1 << 53))

    def random_int(self, lo: int, hi: int) -> int:
        """Uniform integer in [lo, hi) — matches deterministicRandom()->randomInt."""
        if hi <= lo:
            raise ValueError("empty range")
        span = hi - lo
        return lo + self.next_u64() % span

    def random_unique_id(self) -> str:
        return f"{self.next_u64():016x}{self.next_u64():016x}"

    def coinflip(self, p: float = 0.5) -> bool:
        return self.random() < p

    def choice(self, seq):
        return seq[self.random_int(0, len(seq))]

    def shuffle(self, lst: list) -> None:
        for i in range(len(lst) - 1, 0, -1):
            j = self.random_int(0, i + 1)
            lst[i], lst[j] = lst[j], lst[i]

    def random_bytes(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            out += self.next_u64().to_bytes(8, "little")
        return bytes(out[:n])

    def split(self) -> "DeterministicRandom":
        """Derive an independent child stream deterministically."""
        return DeterministicRandom(self.next_u64())

    def random_exp(self, mean: float) -> float:
        """Exponential with given mean (for sim latencies)."""
        import math
        u = self.random()
        if u <= 0.0:
            u = 2.0 ** -53
        return -mean * math.log(u)


_global_rng: DeterministicRandom | None = None


def set_deterministic_random(rng: DeterministicRandom) -> None:
    global _global_rng
    _global_rng = rng


def deterministic_random() -> DeterministicRandom:
    global _global_rng
    if _global_rng is None:
        import os
        _global_rng = DeterministicRandom(int.from_bytes(os.urandom(8), "little"))
    return _global_rng
