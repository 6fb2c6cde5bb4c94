"""TensorBoard event-file writer — the port's own copy of
`horovod_tpu.tbevents` (pure Python, no TensorFlow): the real tfevents
format, so ``tensorboard --logdir`` plots a run.

* **TFRecord framing** — each record is
  ``uint64 length · uint32 masked_crc(length) · bytes · uint32 masked_crc(bytes)``
  where the checksum is CRC-32C (Castagnoli) with TensorFlow's rotation mask
  ``((crc >> 15 | crc << 17) + 0xa282ead8)``.
* **Event protobuf** — hand-encoded wire format (varint tags; no generated
  code): ``Event{wall_time=1:double, step=2:int64, file_version=3:string,
  summary=5:Summary}``; ``Summary{value=1:repeated Value}``;
  ``Value{tag=1:string, simple_value=2:float}``.
* First record of every file is the ``brain.Event:2`` version sentinel, as
  TensorBoard's loader expects; filenames follow the
  ``events.out.tfevents.<unix-time>.<hostname>`` convention.
"""

from __future__ import annotations

import os
import socket
import struct
import time

# --- CRC-32C (Castagnoli), table-driven ------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 * (_c & 1))
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- minimal protobuf wire encoding ----------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3 | 0) + _varint(value)


def _field_fixed64(num: int, value: float) -> bytes:
    return _varint(num << 3 | 1) + struct.pack("<d", value)


def _field_fixed32(num: int, value: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", value)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def encode_event(
    wall_time: float,
    step: int | None = None,
    file_version: str | None = None,
    scalars: dict[str, float] | None = None,
) -> bytes:
    """Serialize one tensorboard ``Event`` message."""
    msg = _field_fixed64(1, wall_time)
    if step is not None:
        msg += _field_varint(2, int(step) & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _field_bytes(
                1,
                _field_bytes(1, tag.encode()) + _field_fixed32(2, float(v)),
            )
            for tag, v in scalars.items()
        )
        msg += _field_bytes(5, summary)
    return msg


def encode_record(payload: bytes) -> bytes:
    """Wrap a serialized message in TFRecord framing."""
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


_writer_seq = 0


class TBEventWriter:
    """Scalar event writer for one run directory; each writer owns a fresh
    uniquely-named file (time + hostname + pid + sequence — two writers in
    the same second must not interleave streams in one file)."""

    def __init__(self, log_dir: str):
        global _writer_seq
        os.makedirs(log_dir, exist_ok=True)
        _writer_seq += 1
        name = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}.{_writer_seq}"
        )
        self.path = os.path.join(log_dir, name)
        self._fh = open(self.path, "wb")
        self._write(
            encode_event(time.time(), file_version="brain.Event:2")
        )

    def _write(self, payload: bytes) -> None:
        self._fh.write(encode_record(payload))

    def scalars(
        self, values: dict[str, float], step: int, wall_time: float | None = None
    ) -> None:
        self._write(
            encode_event(
                wall_time if wall_time is not None else time.time(),
                step=step,
                scalars=values,
            )
        )

    def scalar(self, tag: str, value: float, step: int, wall_time=None) -> None:
        self.scalars({tag: value}, step, wall_time)

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


def read_records(path: str):
    """Parse a tfevents file back into raw message payloads, verifying both
    CRCs — the test-side inverse of the writer (and a debugging aid)."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return out
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != _masked_crc(header):
                raise ValueError("corrupt length crc")
            (length,) = struct.unpack("<Q", header)
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            if pcrc != _masked_crc(payload):
                raise ValueError("corrupt payload crc")
            out.append(payload)
