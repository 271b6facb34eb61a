"""FFT-friendly length selection.

Mirrors the behaviour of the reference's ``next_fast_len``/``prev_fast_len``
(/root/reference/spectralRoutines.py:20,48): find the nearest length whose
prime factorization only contains primes <= maxPrime (default 7). The same
constraint suits XLA's FFT (cuFFT on a GPU) well (small mixed radices). Implemented with
plain trial division — no sympy dependency.

These are host-side (static-shape) helpers: they run at trace/plan time, never
inside jit.
"""

from __future__ import annotations


def prime_factors(n: int) -> list[int]:
    """Distinct prime factors of ``n`` by trial division."""
    if n < 2:
        return []
    factors = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            factors.append(d)
            while n % d == 0:
                n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        factors.append(n)
    return factors


def _is_smooth(n: int, max_prime: int) -> bool:
    for p in (2, 3, 5, 7, 11, 13):
        if p > max_prime:
            break
        while n % p == 0:
            n //= p
    return n == 1


def next_fast_len(length: int, max_prime: int = 7) -> int:
    """Smallest n >= length with all prime factors <= max_prime."""
    if length <= 1:
        return 1
    n = int(length)
    while not _is_smooth(n, max_prime):
        n += 1
    return n


def prev_fast_len(length: int, max_prime: int = 7) -> int:
    """Largest n <= length with all prime factors <= max_prime."""
    if length <= 1:
        return 1
    n = int(length)
    while not _is_smooth(n, max_prime):
        n -= 1
    return n
