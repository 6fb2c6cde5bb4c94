"""The anchored-stream seed derivation and the stream cursor of
`horovod_tpu.data.stream`: every pass of every epoch of a shuffled stream
is seeded by a pure function of ``(seed, epoch, pass)``, so any epoch's
order is regenerable without replaying the ones before it, and a position
in a stream is a small record, the `StreamCursor` (``kind``, ``seed``,
``epoch``, ``step`` in batches within the epoch, the stream's geometry
under ``position``, and the record's ``format``), which refuses to resume
a stream of another kind, seed, geometry or format
(`data.packing.PackedLMStream.batches_from`). Checkpoint manifests record
the trainer's cursor (`Trainer.stream_cursor`) in the same format; the
file-backed feeders' retrying reads are not ported (ROADMAP queue A item
13.3)."""

from __future__ import annotations

import dataclasses

import numpy as np

# The JAX package's cursor record version (`data.stream.CURSOR_FORMAT`).
CURSOR_FORMAT = 1


class StreamCursorError(ValueError):
    """A stream cursor cannot be honoured byte-exactly (wrong format
    version, wrong engine kind, or mismatched stream geometry)."""


def epoch_seed(seed: int, epoch: int, pass_: int = 0) -> int:
    """The RNG seed for pass ``pass_`` of epoch ``epoch`` of a stream seeded
    ``seed`` (`numpy.random.SeedSequence`, stable across numpy
    versions)."""
    return int(
        np.random.SeedSequence(
            [int(seed) & 0xFFFFFFFF, int(epoch), int(pass_)]
        ).generate_state(1)[0]
    )


@dataclasses.dataclass
class StreamCursor:
    """One serializable stream position. See the module docstring."""

    kind: str
    seed: int
    epoch: int
    step: int               # batches consumed within `epoch`
    position: dict          # per-source geometry the stream depends on
    format: int = CURSOR_FORMAT

    def to_dict(self) -> dict:
        """JSON-ready form (what checkpoint manifests store)."""
        return {
            "format": int(self.format),
            "kind": self.kind,
            "seed": int(self.seed),
            "epoch": int(self.epoch),
            "step": int(self.step),
            "position": dict(self.position),
        }

    @classmethod
    def from_dict(cls, rec: dict) -> "StreamCursor":
        """Parse a stored cursor. REFUSES unknown/older format versions
        loudly — resuming a v(N) stream from a v(M) cursor would silently
        re-anchor the byte stream, the exact corruption cursors exist to
        prevent. Recover by resuming epoch-granular (``initial_epoch``
        from the progress manifest, ``initial_step=0``) instead."""
        if not isinstance(rec, dict) or "format" not in rec:
            raise StreamCursorError(
                "not a stream cursor record (missing 'format'); refusing "
                "to guess a stream position"
            )
        fmt = int(rec["format"])
        if fmt != CURSOR_FORMAT:
            raise StreamCursorError(
                f"stream cursor format {fmt} != this build's "
                f"{CURSOR_FORMAT}: the anchored-stream derivation changed "
                "and this cursor addresses a DIFFERENT byte stream. "
                "Refusing to silently re-anchor — resume epoch-granular "
                "(initial_epoch from the progress manifest, "
                "initial_step=0) or re-train from the last checkpoint "
                "written by this build."
            )
        return cls(
            kind=str(rec["kind"]),
            seed=int(rec["seed"]),
            epoch=int(rec["epoch"]),
            step=int(rec["step"]),
            position=dict(rec.get("position", {})),
            format=fmt,
        )

    def require(self, kind: str, **geometry) -> None:
        """Validate this cursor against the reconstructing stream: same
        engine kind, same seed, same geometry — byte-identity holds only
        then. Raises `StreamCursorError` naming the first mismatch."""
        if self.kind != kind:
            raise StreamCursorError(
                f"cursor was exported by a {self.kind!r} stream, cannot "
                f"resume a {kind!r} stream byte-exactly"
            )
        want_seed = geometry.pop("seed", None)
        if want_seed is not None and int(want_seed) != self.seed:
            raise StreamCursorError(
                f"cursor seed {self.seed} != stream seed {int(want_seed)} "
                "— different shuffle streams"
            )
        for key, want in geometry.items():
            got = self.position.get(key)
            # JSON round-trips tuples as lists; compare canonicalized.
            def canon(v):
                return list(v) if isinstance(v, (tuple, list)) else v
            if canon(got) != canon(want):
                raise StreamCursorError(
                    f"cursor geometry mismatch at {key!r}: cursor has "
                    f"{got!r}, the stream has {want!r} — the data or its "
                    "sharding changed since the cursor was written"
                )
