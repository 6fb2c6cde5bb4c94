"""Deterministic fault injection — port of `horovod_tpu.testing.faults`:
the reproducible chaos knob the reference stack lacks (SURVEY.md §5.3).

Contract: ``HVT_FAULT=rank:epoch[.step]:kind`` makes exactly one rank
misbehave at a chosen point in training, via a callback `fit()`
auto-installs (`callbacks.env_callbacks`), so any entry script is
injectable unmodified. `parse_plan` accepts every kind the JAX package
does, with the same plans and the same error texts; these fire:

* ``kill`` — SIGKILL self: the hard crash / node-loss shape.
* ``exitN`` — ``os._exit(N)`` (``exit1``, ``exit143``): a crash with a
  chosen exit code, bypassing teardown the way a real abort does.
* ``hang`` — stay alive, make no progress, touch no heartbeat: the
  wedged-collective failure only a stale-heartbeat supervisor can see.
* ``slow:MS`` — sleep MS ms at every batch end from the target epoch on,
  on the target rank (recurring: a straggler is a rate; stamps don't
  apply).
* ``leave`` — a SIGTERM to self (the port has no elastic mode): with
  `PreemptionCheckpointCallback` installed that is the graceful
  save-and-stop, without it the process dies of SIGTERM and the
  supervisor classifies a preemption.
* ``hostdown`` — SIGKILL every rank registered in this host's pid
  registry (``HVT_FAULT_HOST_PIDS``; peers first, self last); without the
  registry, a self-SIGKILL.
* ``corrupt`` / ``corrupt@epochN`` — damage the newest (or epoch N's)
  checkpoint payload under ``PS_MODEL_PATH`` without touching its
  ``.sha256`` or ``.meta.json``, then SIGKILL self: the relaunch must
  resume from the previous intact checkpoint.

These parse, and `FaultInjectionCallback.from_env` refuses them, naming
their ROADMAP item: ``reorder`` (the flight recorder, queue A item 13.5),
``netdrop:MS`` / ``dataslow:MS`` (the data service, 13.7),
``corrupt@shardN`` (sharded checkpoints, 13.3).

The fault fires at the first ``on_batch_end`` of the target epoch, or at
optimizer step ``step`` with ``rank:epoch.step:kind`` (``>=``, so a
``steps_per_execution`` chunk striding past it still fires; a fit
resumed at or past that step does not re-fire). ``HVT_FAULT_STAMP=<path>``
makes it one-shot across relaunches: the stamp is touched just before
firing and the fault never fires while it exists.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time

from horovod_tpu_torch import runtime
from horovod_tpu_torch.analysis import registry
from horovod_tpu_torch.training.callbacks import Callback

ENV_FAULT = "HVT_FAULT"
ENV_FAULT_STAMP = "HVT_FAULT_STAMP"
ENV_FAULT_HOST_PIDS = "HVT_FAULT_HOST_PIDS"

KINDS = ("kill", "hang", "leave", "corrupt", "reorder", "hostdown")
# plus exitN, corrupt@<target> (corrupt_target), slow:MS, netdrop:MS and
# dataslow:MS


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One planned fault: ``rank`` fires ``kind`` mid-epoch ``epoch`` —
    at its first batch end, or at optimizer step ``step`` (1-based count
    of completed steps) when the ``epoch.step`` form was used."""

    rank: int
    epoch: int
    kind: str
    step: int | None = None

    @property
    def exit_code(self) -> int | None:
        if self.kind.startswith("exit"):
            return int(self.kind[4:])
        return None

    def _ms(self, prefix: str) -> float | None:
        if self.kind.startswith(prefix + ":"):
            return float(self.kind[len(prefix) + 1:])
        return None

    @property
    def slow_ms(self) -> float | None:
        """The per-step sleep of a ``slow:MS`` plan, or None."""
        return self._ms("slow")

    @property
    def netdrop_ms(self) -> float | None:
        return self._ms("netdrop")

    @property
    def dataslow_ms(self) -> float | None:
        return self._ms("dataslow")


def parse_plan(spec: str) -> FaultPlan:
    """Parse ``rank:epoch[.step]:kind`` (the kind field is everything past
    the second separator, so ``slow:MS`` keeps its own colon)."""
    parts = spec.split(":", 2)
    if len(parts) != 3 or not parts[2]:
        raise ValueError(
            f"HVT_FAULT must be rank:epoch[.step]:kind, got {spec!r}"
        )
    rank_s, epoch_s, kind = parts
    step = None
    if "." in epoch_s:
        epoch_s, step_s = epoch_s.split(".", 1)
        try:
            step = int(step_s)
        except ValueError:
            raise ValueError(
                f"HVT_FAULT step must be an integer, got {spec!r}"
            ) from None
        if step < 1:
            raise ValueError(
                f"HVT_FAULT step is a 1-based completed-step count, "
                f"got {spec!r}"
            )
    try:
        rank, epoch = int(rank_s), int(epoch_s)
    except ValueError:
        raise ValueError(
            f"HVT_FAULT rank/epoch must be integers, got {spec!r}"
        ) from None
    if kind not in KINDS:
        if kind.startswith("exit"):
            try:
                int(kind[4:])
            except ValueError:
                raise ValueError(
                    f"HVT_FAULT exit kind needs an integer code "
                    f"(exit1, exit143, ...), got {kind!r}"
                ) from None
        elif kind.startswith("corrupt@"):
            corrupt_target(kind)  # validates; raises on a bad target
        elif kind.startswith(("slow:", "netdrop:", "dataslow:")):
            prefix, ms_s = kind.split(":", 1)
            try:
                ms = float(ms_s)
            except ValueError:
                raise ValueError(
                    f"HVT_FAULT {prefix} kind needs a millisecond count "
                    f"({prefix}:50), got {kind!r}"
                ) from None
            if ms <= 0:
                raise ValueError(
                    f"HVT_FAULT {prefix}:MS needs MS > 0, got {kind!r}"
                )
        else:
            raise ValueError(
                f"HVT_FAULT kind must be kill, hang, leave, reorder, "
                f"hostdown, corrupt[@epochN][/shardM], slow:MS, "
                f"netdrop:MS, dataslow:MS or exitN, got {kind!r}"
            )
    return FaultPlan(rank=rank, epoch=epoch, kind=kind, step=step)


def corrupt_target(kind: str) -> tuple:
    """Parse a ``corrupt`` kind's optional target: ``corrupt`` →
    ``(None, None)``, ``corrupt@epoch3`` → ``(3, None)``, ``corrupt@shard1``
    → ``(None, 1)``, ``corrupt@epoch3/shard1`` → ``(3, 1)``."""
    if kind == "corrupt":
        return None, None
    target = kind[len("corrupt@"):]
    epoch = shard = None
    for part in target.split("/"):
        if part.startswith("epoch") and part[5:].isdigit():
            epoch = int(part[5:])
        elif part.startswith("shard") and part[5:].isdigit():
            shard = int(part[5:])
        else:
            raise ValueError(
                f"HVT_FAULT corrupt target must be epochN, shardM or "
                f"epochN/shardM, got {target!r}"
            )
    return epoch, shard


def unported_kind(plan: FaultPlan) -> str | None:
    """The ROADMAP item a parsed plan's kind waits for, None when the
    port fires it."""
    if plan.kind == "reorder":
        return "ROADMAP queue A item 13.5 (the flight recorder)"
    if plan.netdrop_ms is not None or plan.dataslow_ms is not None:
        return "ROADMAP queue A item 13.7 (the data service)"
    if plan.kind.startswith("corrupt@") and corrupt_target(plan.kind)[1] \
            is not None:
        return "ROADMAP queue A item 13.3 (sharded checkpoints)"
    return None


def register_host_pid(pid_dir: str, pid: int | None = None) -> str:
    """Record ``pid`` (default: this process) as resident on the host
    ``pid_dir`` stands for — an empty file named after the pid. Sweeps
    entries whose processes are gone (pid-reuse hygiene)."""
    pid = os.getpid() if pid is None else pid
    os.makedirs(pid_dir, exist_ok=True)
    for name in os.listdir(pid_dir):
        if not name.isdigit():
            continue
        try:
            os.kill(int(name), 0)
        except ProcessLookupError:
            try:
                os.remove(os.path.join(pid_dir, name))
            except OSError:
                pass
        except PermissionError:
            pass  # alive, not ours to probe — keep it
    path = os.path.join(pid_dir, str(pid))
    open(path, "w").close()
    return path


def host_pids(pid_dir: str) -> list[int]:
    """Every pid registered in a host's pid directory, sorted."""
    try:
        names = os.listdir(pid_dir)
    except OSError:
        return []
    return sorted(int(n) for n in names if n.isdigit())


def newest_checkpoint_file(model_dir: str,
                           epoch: int | None = None) -> str | None:
    """Newest checkpoint payload under ``model_dir`` (recursive), by mtime;
    ``epoch`` restricts it to that epoch's file. Sidecars (``.sha256``,
    ``.meta.json``) and atomic-write temp files never match: the fault
    damages payloads, not the record of what they should have been."""
    from horovod_tpu_torch import checkpoint

    newest = None
    for root, _, files in os.walk(model_dir):
        for name in files:
            m = checkpoint.CHECKPOINT_RE.search(name)
            if not m or ".tmp." in name:
                continue
            if epoch is not None and int(m.group(1)) != epoch:
                continue
            full = os.path.join(root, name)
            try:
                key = (os.stat(full).st_mtime_ns, full)
            except OSError:
                continue
            if newest is None or key > newest[0]:
                newest = (key, full)
    return newest[1] if newest else None


def corrupt_file(path: str) -> None:
    """Deterministically damage a file in place: truncate to half its size,
    then flip every bit of the first remaining byte. Its ``.sha256``
    sidecar is left untouched, so integrity verification must now fail."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(size // 2, 1))
        f.seek(0)
        first = f.read(1) or b"\0"
        f.seek(0)
        f.write(bytes([first[0] ^ 0xFF]))


class FaultInjectionCallback(Callback):
    """Fires the planned fault at the first batch end of the target epoch on
    the target rank. Installed by ``fit()`` when ``HVT_FAULT`` is set
    (`callbacks.env_callbacks`); constructible directly for tests."""

    def __init__(self, plan: FaultPlan, stamp: str | None = None):
        self.plan = plan
        self.stamp = stamp
        self._epoch: int | None = None

    @classmethod
    def from_env(cls) -> "FaultInjectionCallback":
        spec = registry.get_str(ENV_FAULT)
        if spec is None:
            raise ValueError(
                f"{ENV_FAULT} is not set — from_env() needs a "
                "rank:epoch[.step]:kind fault plan"
            )
        plan = parse_plan(spec)
        item = unported_kind(plan)
        if item is not None:
            raise NotImplementedError(
                f"{ENV_FAULT} kind {plan.kind!r} is not ported yet — {item}")
        return cls(plan, stamp=registry.get_str(ENV_FAULT_STAMP))

    def on_epoch_begin(self, epoch: int, logs=None):
        self._epoch = epoch
        pid_dir = registry.get_str(ENV_FAULT_HOST_PIDS)
        if pid_dir:
            # EVERY rank keeps its host residency registered, for the
            # `hostdown` stroke.
            try:
                register_host_pid(pid_dir)
            except OSError:
                pass  # chaos bookkeeping must never fail training

    def on_batch_end(self, batch: int, logs=None):
        if self.plan.slow_ms is not None:
            if (self._epoch is not None and self._epoch >= self.plan.epoch
                    and runtime.rank() == self.plan.rank):
                time.sleep(self.plan.slow_ms / 1e3)
            return
        if self._epoch != self.plan.epoch:
            return
        if runtime.rank() != self.plan.rank:
            return
        if self.plan.step is not None:
            if batch + 1 < self.plan.step:
                return
            if (self.trainer is not None
                    and getattr(self.trainer, "_resume_epoch", 0)
                    == self.plan.epoch
                    and getattr(self.trainer, "_resume_step", 0)
                    >= self.plan.step):
                # Resumed at or past the target step: the fault already
                # fired in the run being resumed.
                return
        if self.stamp and os.path.exists(self.stamp):
            return  # already fired in a previous launch — one-shot spent
        if self.stamp:
            d = os.path.dirname(self.stamp)
            if d:
                os.makedirs(d, exist_ok=True)
            open(self.stamp, "w").close()
        self._fire()

    def _fire(self):  # pragma: no cover — ends or wedges the process
        at = f"epoch {self.plan.epoch}" + (
            f" step {self.plan.step}" if self.plan.step is not None else "")
        print(f"FaultInjection: rank {self.plan.rank} firing "
              f"{self.plan.kind!r} at {at}", flush=True)
        if self.plan.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        elif self.plan.kind == "hostdown":
            pid_dir = registry.get_str(ENV_FAULT_HOST_PIDS)
            me = os.getpid()
            for pid in (host_pids(pid_dir) if pid_dir else []):
                if pid == me:
                    continue
                try:
                    os.kill(pid, signal.SIGKILL)
                    print(f"FaultInjection: hostdown killed co-resident pid "
                          f"{pid}", flush=True)
                except (ProcessLookupError, PermissionError):
                    continue  # stale registration — already gone
            os.kill(me, signal.SIGKILL)
        elif self.plan.kind == "hang":
            self._wedge()
        elif self.plan.kind == "leave":
            os.kill(os.getpid(), signal.SIGTERM)
        elif self.plan.kind.startswith("corrupt"):
            epoch, _ = corrupt_target(self.plan.kind)
            target = newest_checkpoint_file(
                os.environ.get("PS_MODEL_PATH", "./models"), epoch=epoch)
            if target is not None:
                print(f"FaultInjection: corrupting {target}", flush=True)
                corrupt_file(target)
            os.kill(os.getpid(), signal.SIGKILL)
        else:
            os._exit(self.plan.exit_code)

    @staticmethod
    def _wedge():  # pragma: no cover — never returns
        """Stay alive, make no progress, touch no heartbeat — only a
        stale-heartbeat supervisor can reap this."""
        while True:
            time.sleep(3600)
