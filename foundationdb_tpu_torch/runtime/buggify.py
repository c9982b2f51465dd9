"""BUGGIFY — sim-only random rare-path fault injection.

Reference: REF:flow/Buggify.h — ``BUGGIFY`` blocks are compiled in always
but fire only in simulation, each site independently enabled with 25%
probability per run and then firing with a per-site probability.  This is
how FDB forces rare paths (early buffer flushes, pathological knob values,
injected delays) to be exercised constantly in simulation.
"""

from __future__ import annotations

from .rng import deterministic_random

_enabled = False
_site_enabled: dict[str, bool] = {}
SITE_ACTIVATION_P = 0.25
FIRE_P = 0.05


def enable_buggify(on: bool = True) -> None:
    global _enabled
    _enabled = on
    _site_enabled.clear()


def reset_buggify_sites() -> None:
    """Clear per-run site activations (called by run_simulation so the same
    seed replays identically within one process)."""
    _site_enabled.clear()


def buggify_enabled() -> bool:
    return _enabled


def buggify(site: str, fire_p: float = FIRE_P) -> bool:
    """``if buggify("tlog_slow_commit"): await sleep(r.random())``"""
    if not _enabled:
        return False
    rng = deterministic_random()
    en = _site_enabled.get(site)
    if en is None:
        en = _site_enabled[site] = rng.coinflip(SITE_ACTIVATION_P)
    return en and rng.coinflip(fire_p)
