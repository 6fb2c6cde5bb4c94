"""The anchored-stream seed derivation of `horovod_tpu.data.stream`: every
pass of every epoch of a shuffled stream is seeded by a pure function of
``(seed, epoch, pass)``, so any epoch's order is regenerable without
replaying the ones before it. Checkpoint manifests record the cursor
(`Trainer.stream_cursor`) in the JAX package's format; the `StreamCursor`
class that refuses an incompatible one on resume is not ported yet
(ROADMAP queue A item 13.3)."""

from __future__ import annotations

import numpy as np

# The JAX package's cursor record version (`data.stream.CURSOR_FORMAT`).
CURSOR_FORMAT = 1


def epoch_seed(seed: int, epoch: int, pass_: int = 0) -> int:
    """The RNG seed for pass ``pass_`` of epoch ``epoch`` of a stream seeded
    ``seed`` (`numpy.random.SeedSequence`, stable across numpy
    versions)."""
    return int(
        np.random.SeedSequence(
            [int(seed) & 0xFFFFFFFF, int(epoch), int(pass_)]
        ).generate_state(1)[0]
    )
