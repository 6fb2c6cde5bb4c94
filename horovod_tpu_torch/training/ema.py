"""Exponential moving average of the parameters — port of
`horovod_tpu.training.ema` (`ExponentialMovingAverage`, re-exported from
`training.callbacks`).

After every train-step execution: ``ema ← decay·ema + (1−decay)·params``,
one fused ``torch._foreach_lerp_`` over the shadow on the device. The
cadence follows the fit path, as in JAX: per step on the streamed path,
per ``steps_per_execution`` chunk, per epoch (or ``HVT_EPOCH_CHUNK_STEPS``
chunk) on ``cache="device"``.

``zero_debias=True`` starts the shadow at zero and reads it through the
Adam-style correction ``ema / (1 − decay^t)``; the default starts it at
the parameters. Read with `ema_params`, or swap the averaged weights into
the model for a block with ``averaged(trainer)``; the swap copies in
place, so the trainer's captured CUDA graphs stay valid.

Durability: with ``checkpoint_dir`` the primary rank writes the shadow at
every epoch end, in the port's checkpoint format (``ema.pt``: a
``torch.save`` payload ``{"shadow": {name: tensor}, "count"}``, atomic,
with a ``.sha256`` sidecar), and the next fit resumes it (the primary
reads, every rank adopts). `models.convert.ema_from_flax` carries a JAX
shadow across.
"""

from __future__ import annotations

import contextlib
import io
import os

import torch

from horovod_tpu_torch import runtime
from horovod_tpu_torch.parallel import collectives
from horovod_tpu_torch.training.callbacks import Callback

EMA_FILE = "ema.pt"


def save_payload(checkpoint_dir: str, payload: dict) -> str:
    """Write ``{"shadow": {name: tensor}, "count": int}`` as the EMA file
    of ``checkpoint_dir`` (atomic, with its digest sidecar)."""
    from horovod_tpu_torch import checkpoint

    os.makedirs(checkpoint_dir, exist_ok=True)
    buf = io.BytesIO()
    torch.save({"shadow": {k: v.detach().cpu()
                           for k, v in payload["shadow"].items()},
                "count": int(payload["count"])}, buf)
    path = os.path.join(checkpoint_dir, EMA_FILE)
    checkpoint._atomic_write(path, buf.getvalue(), digest=True)
    return path


def load_payload(path: str) -> dict:
    """The payload `save_payload` wrote, verified against its sidecar."""
    from horovod_tpu_torch import checkpoint

    return torch.load(io.BytesIO(checkpoint._read_verified(path)),
                      map_location="cpu", weights_only=True)


class ExponentialMovingAverage(Callback):
    """Polyak/EMA weight averaging; see the module docstring."""

    def __init__(self, decay: float = 0.999, zero_debias: bool = False,
                 checkpoint_dir: str | None = None):
        if not 0.0 < decay < 1.0:
            raise ValueError(f"decay must be in (0, 1), got {decay}")
        self.decay = decay
        self.zero_debias = zero_debias
        self.checkpoint_dir = checkpoint_dir
        self._names: list[str] = []
        self._ema: list[torch.Tensor] | None = None
        self._count = 0

    def _params(self, trainer=None):
        module = (trainer or self.trainer).module
        return [p for _, p in module.named_parameters()]

    def _restore(self) -> bool:
        """Adopt the shadow under ``checkpoint_dir``, if any: the primary's
        view of the directory decides, and its outcome travels to every
        rank before the tensors, so a failed read raises everywhere."""
        path = os.path.join(self.checkpoint_dir, EMA_FILE)
        payload, err = None, None
        if runtime.is_primary() and os.path.exists(path):
            try:
                payload = load_payload(path)
                if sorted(payload["shadow"]) != sorted(self._names):
                    raise ValueError("its parameters are not the model's")
            except Exception as e:  # noqa: BLE001 — reported on every rank
                err = f"{type(e).__name__}: {e}"
        found = payload is not None or err is not None
        if runtime.size() > 1:
            found, err = collectives.broadcast_object((found, err))
        if err is not None:
            raise RuntimeError(f"EMA shadow restore failed ({path}): {err} "
                               "— delete the file to restart the average")
        if not found:
            return False
        if runtime.size() > 1:
            payload = collectives.broadcast_object(payload)
        with torch.no_grad():
            for e, name in zip(self._ema, self._names):
                e.copy_(payload["shadow"][name])
        self._count = int(payload["count"])
        return True

    def on_train_begin(self, logs=None):
        if self._ema is not None:
            return
        params = self._params()
        self._names = [n for n, _ in self.trainer.module.named_parameters()]
        with torch.no_grad():
            self._ema = [torch.zeros_like(p) if self.zero_debias
                         else p.detach().clone() for p in params]
        self._count = 0
        if self.checkpoint_dir is not None:
            self._restore()

    @torch.no_grad()
    def on_batch_end(self, batch: int, logs=None):
        torch._foreach_lerp_(self._ema, [p.detach() for p in self._params()],
                             1.0 - self.decay)
        self._count += 1

    def on_epoch_end(self, epoch: int, logs=None):
        if self.checkpoint_dir is not None and runtime.is_primary():
            save_payload(self.checkpoint_dir,
                         {"shadow": dict(zip(self._names, self._ema)),
                          "count": self._count})

    @property
    def ema_params(self) -> dict:
        """``{name: tensor}`` of the averaged parameters (debiased under
        ``zero_debias``): fresh tensors, never the live shadow."""
        if self._ema is None:
            raise RuntimeError("EMA not initialized — runs at fit()")
        corr = (1.0 - self.decay ** self._count
                if self.zero_debias and self._count > 0 else 1.0)
        return {n: e / corr if corr != 1.0 else e.clone()
                for n, e in zip(self._names, self._ema)}

    def averaged(self, trainer=None):
        """Context manager: the model holds the averaged weights inside the
        block and its live weights after (both copied in place)."""
        trainer = trainer or self.trainer

        @contextlib.contextmanager
        def swap():
            params = self._params(trainer)
            averaged = self.ema_params
            with torch.no_grad():
                live = [p.detach().clone() for p in params]
                for p, n in zip(params, self._names):
                    p.copy_(averaged[n])
            try:
                yield
            finally:
                with torch.no_grad():
                    for p, v in zip(params, live):
                        p.copy_(v)

        return swap()
