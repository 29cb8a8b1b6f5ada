"""Seed-stream derivation: every RNG stream in the project hashes
through ``np.random.SeedSequence``.

Ad-hoc arithmetic derivations (``seed * 100003 + t``, ``seed + 101``)
collide across (seed, index) pairs and couple neighbouring streams:
``seed*K + t`` maps run seed s, device t and run seed s+1, device t-K
onto the SAME generator, so two "independent" federations can share
device data. SeedSequence's hash mixing gives every (seed, path) tuple
an independent, collision-resistant stream, independent of iteration
order, bucket layout, or mesh shape.

Two derivation shapes cover the project:

  * ``derive_device_seed(seed, device_id)`` — the per-device stream
    used by every engine tier, scenario generator, and channel model;
  * ``derive_stream_seed(seed, purpose)`` — a NAMED substream for
    server-side draws (eval subsampling, degenerate-availability
    fallback, dataset namespaces). The purpose string hashes through
    ``zlib.crc32`` — deterministic and unsalted, unlike builtin
    ``hash()`` — into an entropy word disjoint from the device-id
    namespace, so a purpose stream can never alias a device stream.

A verbatim copy of ``repro.utils.seeds``: the port derives every
stream the same way, so its federations are byte-identical to the
reference's.
"""
from __future__ import annotations

import zlib

import numpy as np

# purpose words live above 2^32 so they cannot collide with device ids
_PURPOSE_BASE = 1 << 40


def derive_device_seed(seed: int, device_id: int) -> int:
    """Collision-free per-device seed, independent of iteration order.

    ``seed + device_id`` collides across (seed, id) pairs and couples
    neighbouring devices; hashing through SeedSequence gives every
    (run seed, device) pair an independent stream. The result depends
    ONLY on (seed, device_id) — never on bucket layout, group batching,
    or mesh shard count — so the same run seed reproduces the same
    federation on every engine tier and mesh shape (pinned by the
    snapshot + resharding regression tests).

    Negative / arbitrary-width run seeds fold into SeedSequence's
    uint64 entropy domain (two's complement); values already in
    [0, 2^64) hash exactly as before, keeping historic streams intact.
    """
    return int(
        np.random.SeedSequence([seed % 2**64, device_id % 2**64]).generate_state(1)[0]
    )


def derive_stream_seed(seed: int, purpose: str, index: int = 0) -> int:
    """Named substream seed for server-side draws.

    The purpose string is crc32-folded into an entropy word above the
    device-id namespace, so ``derive_stream_seed(s, p)`` can never
    equal ``derive_device_seed(s, i)`` for any device id i < 2^40 —
    purpose streams and device streams stay disjoint by construction.
    ``index`` splits one purpose into a family of streams (per trial,
    per round) without re-deriving from consumed generators.
    """
    word = _PURPOSE_BASE + zlib.crc32(purpose.encode("utf-8"))
    return int(
        np.random.SeedSequence(
            [seed % 2**64, word, index % 2**64]
        ).generate_state(1)[0]
    )


def stream_rng(seed: int, purpose: str, index: int = 0) -> np.random.Generator:
    """``default_rng`` over ``derive_stream_seed`` — the one-liner for
    named server-side draws."""
    return np.random.default_rng(derive_stream_seed(seed, purpose, index))
