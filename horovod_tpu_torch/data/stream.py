"""The anchored-stream seed derivation of `horovod_tpu.data.stream`: every
pass of every epoch of a shuffled stream is seeded by a pure function of
``(seed, epoch, pass)``, so any epoch's order is regenerable without
replaying the ones before it. (The durable `StreamCursor` is not ported
yet.)"""

from __future__ import annotations

import numpy as np


def epoch_seed(seed: int, epoch: int, pass_: int = 0) -> int:
    """The RNG seed for pass ``pass_`` of epoch ``epoch`` of a stream seeded
    ``seed`` (`numpy.random.SeedSequence`, stable across numpy
    versions)."""
    return int(
        np.random.SeedSequence(
            [int(seed) & 0xFFFFFFFF, int(epoch), int(pass_)]
        ).generate_state(1)[0]
    )
