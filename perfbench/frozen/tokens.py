"""The token generator.

Copied at commit 3ba40e6 from ``chip_smoke.py`` (``synthetic_tokens``),
which took it from ``examples/long_context_lm.py``. ``seed`` may be a list
of integers (numpy's ``SeedSequence`` entropy), so that a run's seed, a
rank and a batch index give one stream each.
"""

from __future__ import annotations

import numpy as np


def synthetic_tokens(n_seqs, seq_len, vocab, seed=0):
    """Arithmetic progressions mod vocab: something learnable at every
    context position."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab, size=(n_seqs, 1))
    step = rng.integers(1, 7, size=(n_seqs, 1))
    pos = np.arange(seq_len)[None, :]
    return ((start + step * pos) % vocab).astype(np.int64)
