"""Checkpoint / resume / serving export — port of `horovod_tpu.checkpoint`
(the single-file format).

The payload is the port's own: ``torch.save`` of ``{"model": state_dict,
"optimizer": state_dict, "step", "rng"}`` with every tensor on the CPU
(the JAX package writes flax msgpack). The file contract is the JAX
package's, unchanged:

* ``checkpoint-{epoch}.<ext>`` (any extension is discovered on resume),
  written atomically (temp file + rename);
* a ``.sha256`` sidecar with the payload's digest, checked on discovery
  and on restore, so a file corrupted after landing is skipped in favour
  of the previous one;
* a ``.meta.json`` progress manifest ``{"epoch", "step",
  "payload_sha256"}`` (and the stream ``cursor`` a checkpoint callback
  stamps, `Trainer.stream_cursor`: the supervisor reads its epoch
  geometry for ``hvt_committed_step``); a manifest whose digest no longer
  matches the payload falls back to ``(filename epoch, 0)``;
* resume is decided by the primary rank (its view of the directory),
  which discards checkpoints newer than the one it resumes, loads it and
  broadcasts the state to every rank.

The serving export is a timestamped directory holding a ``torch.export``
program of ``input → softmax(logits)`` (``model.pt2``) and
``signature.json``; ``python -m horovod_tpu_torch.launch.serve`` serves
it. Not ported yet: sharded checkpoints, asynchronous saves and checking
a manifest's cursor on resume (ROADMAP queue A item 13.3). The JAX
package's export formats (``stablehlo``, ``savedmodel``) stay refused:
writing them needs jax or TensorFlow.
"""

from __future__ import annotations

import hashlib
import io
import itertools
import json
import os
import re
import time

import numpy as np
import torch

from horovod_tpu_torch import runtime
from horovod_tpu_torch.analysis import registry
from horovod_tpu_torch.parallel import collectives
from horovod_tpu_torch.runtime import resolve_device

# Any extension, so user templates ('checkpoint-{epoch}.h5') are discovered;
# never matches the '.sha256' / '.meta.json' sidecars.
CHECKPOINT_RE = re.compile(r"checkpoint-(\d+)\.\w+$")
META_SUFFIX = ".meta.json"
DIGEST_SUFFIX = ".sha256"


class CheckpointCorruptError(ValueError):
    """A checkpoint file's bytes do not match its recorded sha256 digest."""


_write_seq = itertools.count()


def _atomic_write(path: str, data: bytes, digest: bool = False) -> None:
    """Write through a temp file unique per write, then rename; with
    ``digest`` also the ``.sha256`` sidecar, after the payload."""
    tmp = f"{path}.tmp.{os.getpid()}.{next(_write_seq)}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    if digest:
        dtmp = f"{path}{DIGEST_SUFFIX}.tmp.{os.getpid()}.{next(_write_seq)}"
        with open(dtmp, "w") as f:
            f.write(hashlib.sha256(data).hexdigest() + "\n")
        os.replace(dtmp, path + DIGEST_SUFFIX)


def recorded_digest(path: str) -> str | None:
    """The sidecar-recorded sha256 of ``path``, or None without a sidecar
    (accepted unverified)."""
    try:
        with open(path + DIGEST_SUFFIX) as f:
            return f.read().strip() or None
    except OSError:
        return None


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def file_intact(path: str) -> bool:
    """True when ``path``'s bytes match its recorded digest (or none was
    recorded); False on a mismatch or an unreadable file."""
    want = recorded_digest(path)
    if want is None:
        return os.path.isfile(path)
    try:
        return _file_sha256(path) == want
    except OSError:
        return False


def _read_verified(path: str) -> bytes:
    with open(path, "rb") as f:
        data = f.read()
    want = recorded_digest(path)
    if want is not None and hashlib.sha256(data).hexdigest() != want:
        raise CheckpointCorruptError(
            f"checkpoint file {path} does not match its recorded sha256 "
            "digest — the file was corrupted after being written. Delete it "
            "to fall back to the previous complete checkpoint."
        )
    return data


def _payload(state) -> dict:
    """The state as CPU tensors and plain values; a sharded model's placed
    parameters whole (gathered over the mesh, or the epoch-end
    snapshot), as the JAX package's host-gathered checkpoint holds
    them."""
    model = {k: v.detach().cpu()
             for k, v in state.full_model_state().items()}
    leaves, treedef = collectives.tree_flatten(state.optimizer.state_dict())
    optimizer = collectives.tree_unflatten(treedef, [
        v.detach().cpu() if isinstance(v, torch.Tensor) else v
        for v in leaves])
    return {"model": model, "optimizer": optimizer,
            "step": int(state.step), "rng": int(state.rng)}


def _adopt(state, payload: dict):
    state.load_full_model_state(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    state.rng = int(payload["rng"])
    return state


def save(path: str, state, progress: tuple | None = None,
         cursor: dict | None = None) -> str:
    """Serialize a `TrainState` (its model, optimizer state, step and rng)
    to one file, atomically, with its digest sidecar. The caller gates the
    rank (the callbacks do). ``progress=(epoch, step)`` also writes the
    ``.meta.json`` manifest (step 0 = an epoch boundary), with ``cursor``
    (`Trainer.stream_cursor`) inside it when given."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    buf = io.BytesIO()
    torch.save(_payload(state), buf)
    data = buf.getvalue()
    _atomic_write(path, data, digest=True)
    if progress is not None:
        epoch, step = progress
        meta = {"epoch": int(epoch), "step": int(step),
                "payload_sha256": hashlib.sha256(data).hexdigest()}
        if cursor is not None:
            meta["cursor"] = dict(cursor)
        _atomic_write(path + META_SUFFIX, json.dumps(meta).encode())
    return path


def restore(path: str, template):
    """Load a checkpoint into ``template`` (a built `TrainState`, filled in
    place and returned). The file is verified against its sidecar
    (`CheckpointCorruptError` on a mismatch)."""
    return _adopt(template, _load_payload(path))


def _load_payload(path: str) -> dict:
    return torch.load(io.BytesIO(_read_verified(path)), map_location="cpu",
                      weights_only=True)


def save_checkpoint(directory: str, state, epoch: int, step: int = 0) -> str:
    """``checkpoint-{epoch}.pt`` in ``directory`` with an ``(epoch, step)``
    manifest; epochs are 1-based (0 means no checkpoint on resume)."""
    return save(os.path.join(directory, f"checkpoint-{epoch}.pt"), state,
                progress=(epoch, step))


def checkpoint_intact(path: str) -> bool:
    """Whether a discovered checkpoint is safe to restore (digest match, or
    no digest recorded)."""
    return file_intact(path)


def checkpoint_progress(path: str) -> tuple[int, int]:
    """The ``(epoch, step)`` resume point a checkpoint records: its
    manifest's, or ``(filename epoch, 0)`` without a manifest or when the
    manifest's payload digest no longer matches the payload."""
    m = CHECKPOINT_RE.search(os.path.basename(path))
    fallback = (int(m.group(1)) if m else 0, 0)
    try:
        with open(path + META_SUFFIX) as f:
            rec = json.load(f)
        want = rec.get("payload_sha256")
        if want is not None:
            actual = recorded_digest(path) or _file_sha256(path)
            if actual != want:
                return fallback
        return int(rec["epoch"]), int(rec["step"])
    except (OSError, ValueError, KeyError):
        return fallback


def latest_checkpoint(directory: str, *,
                      complete_only: bool = False) -> str | None:
    """The highest-epoch intact checkpoint in ``directory``, or None;
    candidates are checked newest first. ``complete_only`` skips mid-epoch
    saves (manifest step > 0), the choice of a resume that is not
    step-aware."""
    if not os.path.isdir(directory):
        return None
    candidates = []
    for name in os.listdir(directory):
        m = CHECKPOINT_RE.search(name)
        if m:
            candidates.append((int(m.group(1)), os.path.join(directory, name)))
    for _, full in sorted(candidates, reverse=True):
        if checkpoint_intact(full):
            if complete_only and checkpoint_progress(full)[1] > 0:
                continue
            return full
    return None


def _discard_future_checkpoints(directory: str, epoch: int) -> None:
    """Primary only, on resume: delete checkpoints newer than the resumed
    epoch (an abandoned trajectory the rerun will re-earn)."""
    if not os.path.isdir(directory):
        return
    for name in os.listdir(directory):
        m = CHECKPOINT_RE.search(name)
        if not m or int(m.group(1)) <= epoch:
            continue
        full = os.path.join(directory, name)
        for suffix in ("", DIGEST_SUFFIX, META_SUFFIX):
            try:
                os.remove(full + suffix)
            except FileNotFoundError:
                pass


def _per_rank_state(optimizer) -> bool:
    """Whether ``optimizer`` keeps state of its own on each rank (ZeRO-1
    shards, error-feedback residuals), so its `state_dict` is a
    collective."""
    return bool(getattr(optimizer, "state_is_collective", False))


def _broadcast_model(state, root_rank: int) -> None:
    """Every rank adopts the root's parameters and buffers, in place. A
    sharded model's placed parameters come instead from the first rank of
    the group of ranks that hold the same part, never across the axes it
    is placed on: an ``fsdp`` part within the shard gradient group (the
    ranks that differ on ``data`` or ``seq``), a ``model`` or expert part
    within the gradient group (``data``, ``fsdp``, ``seq``)."""
    sd = state.model.state_dict()
    placed = state.placements
    synced = collectives.broadcast_pytree(
        {k: v for k, v in sd.items() if k not in placed}, root=root_rank)
    with torch.no_grad():
        for k, v in sd.items():
            if k not in placed:
                v.copy_(synced[k])
                continue
            group = (state.mesh.shard_grad_group
                     if "fsdp" in placed[k].values()
                     else state.mesh.grad_group)
            v.copy_(collectives.broadcast_in_group(v.detach(), group))
    state.model_changed()


def broadcast_parameters(state, root_rank: int = 0):
    """``hvd.broadcast_global_variables(root)`` for a `TrainState`: every
    rank adopts the root's parameters and buffers (tensor broadcasts), its
    optimizer state, step and rng (one object broadcast). An optimizer
    with per-rank state (ZeRO-1 shards, error-feedback residuals) sends
    only what every rank holds alike (the tail parameters' state and the
    hyperparameters); each rank keeps its own shards and residual.
    Identity without a process group."""
    if not runtime.is_distributed():
        return state
    _broadcast_model(state, root_rank)
    opt = state.optimizer
    if state.model_is_sharded:
        # The optimizer's state gathered whole (a collective), the root's
        # sent, and each rank's part cut from it: rank (d, e) takes what
        # (0, e) of the root's batch coordinate holds.
        full = opt.state_dict()
        root = runtime.rank() == root_rank
        extra = collectives.broadcast_object(
            (full, int(state.step), int(state.rng)) if root else None,
            root=root_rank)
        if not root:
            opt.load_state_dict(extra[0])
            state.step, state.rng = extra[1], extra[2]
        return state
    per_rank = _per_rank_state(opt)
    root = runtime.rank() == root_rank
    extra = collectives.broadcast_object(
        ((opt.replicated_state_dict() if per_rank else opt.state_dict()),
         int(state.step), int(state.rng)) if root else None, root=root_rank)
    if not root:
        if per_rank:
            opt.load_replicated_state_dict(extra[0])
        else:
            opt.load_state_dict(extra[0])
        state.step, state.rng = extra[1], extra[2]
    return state


def state_digest(state) -> str:
    """sha256 over the model's tensors, the optimizer state's tensors and
    values, and the step — equal on two ranks only when their training
    states are bit-identical."""
    h = hashlib.sha256()
    leaves, _ = collectives.tree_flatten(
        [dict(state.model.state_dict()), state.optimizer.state_dict()])
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            h.update(leaf.detach().cpu().contiguous().view(-1)
                     .view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(leaf).encode())
    h.update(str(int(state.step)).encode())
    return h.hexdigest()


def restore_latest_and_broadcast(directory: str, template, *,
                                 with_step: bool = False):
    """The resume path: the primary picks the newest intact checkpoint
    (mid-epoch saves only ``with_step``), discards newer ones, loads it,
    and every rank adopts it. Returns ``(state, epoch)`` — epoch 0 when
    none was found — or ``(state, epoch, step)`` ``with_step``."""
    primary = runtime.is_primary()
    path = (latest_checkpoint(directory, complete_only=not with_step)
            if primary else None)
    epoch = int(CHECKPOINT_RE.search(path).group(1)) if path else 0
    step = checkpoint_progress(path)[1] if path else 0
    if primary:
        _discard_future_checkpoints(directory, epoch)
    epoch, step = collectives.broadcast_object((epoch, step), root=0)

    def ret(state, epoch, step):
        return (state, epoch, step) if with_step else (state, epoch)

    if epoch == 0 and step == 0:
        return ret(template, 0, 0)
    opt = template.optimizer
    if template.model_is_sharded:
        # Every rank takes the root's whole payload and cuts its parts
        # (the model's placed parameters, their optimizer state).
        payload = _load_payload(path) if primary else None
        payload = collectives.broadcast_object(payload, root=0)
        return ret(_adopt(template, payload), epoch, step)
    if _per_rank_state(opt):
        # The root loads the model and cuts every rank's part of the
        # optimizer state (its shards and residual row); each rank gets
        # only its own.
        parts = None
        if primary:
            payload = _load_payload(path)
            template.model.load_state_dict(payload["model"])
            parts = [(opt.cut_for_rank(payload["optimizer"], r),
                      int(payload["step"]), int(payload["rng"]))
                     for r in range(runtime.size())]
        _broadcast_model(template, 0)
        mine, template.step, template.rng = collectives.scatter_object(parts)
        opt.load_state_dict(mine)
        return ret(template, epoch, step)
    state = restore(path, template) if primary else template
    return ret(broadcast_parameters(state), epoch, step)


# --- Serving export ------------------------------------------------------------

SIGNATURE_FILE = "signature.json"
PROGRAM_FILE = "model.pt2"
# The one format the port writes: the registered default of
# ``HVT_EXPORT_FORMAT``, the examples' knob.
EXPORT_FORMAT = registry.knob("HVT_EXPORT_FORMAT").default


def gather_for_export(module, what: str, timestamp: str | None):
    """``(module, timestamp, writes)`` for an export. A module that holds
    parameter shards over a mesh (``pipe``/``model``/``fsdp`` parts,
    expert shards), whose forward runs collectives, is gathered into its
    `unsharded` clone — a collective, as JAX's ``gather_to_host``: every
    rank calls the export, the ranks agree on the primary's timestamp, and
    only the primary writes (``writes``). Any other module is exported as
    it is by whoever calls (the caller gates the rank). A sharded module
    with no ``unsharded`` raises `ValueError`."""
    stamp = timestamp or time.strftime("%Y%m%d-%H%M%S")
    if not any(getattr(m, "cuts", None) or getattr(m, "ep", 1) > 1
               for m in module.modules()):
        return module, stamp, True
    if not hasattr(module, "unsharded"):
        raise ValueError(
            f"{what}: the module holds parameter shards over a mesh and has "
            "no unsharded() to gather them whole")
    whole = module.unsharded()
    return (whole, collectives.broadcast_object(stamp, root=0),
            runtime.is_primary())


class _Predict(torch.nn.Module):
    """``x → softmax(module(x, train=False))``: the serving signature."""

    def __init__(self, module):
        super().__init__()
        self.module = module

    def forward(self, x):
        return torch.softmax(self.module(x, train=False).float(), dim=-1)


def export_serving(export_dir: str, module, input_shape: tuple,
                   input_dtype=np.float32, timestamp: str | None = None,
                   format: str = EXPORT_FORMAT) -> str:
    """Export ``module``'s ``input → prob`` function into
    ``export_dir/<YYYYmmdd-HHMMSS>/``: a ``torch.export`` program with a
    dynamic batch dimension, traced on the module's device, plus
    ``signature.json``. Primary-rank-only by convention (the caller gates,
    like the reference's ``if hvd.rank() == 0``). A model that holds
    parameter shards over a mesh is exported gathered: every rank calls,
    the primary writes (`gather_for_export`); every rank returns the
    bundle's directory. A module whose function depends on its batch size
    (``batch_polymorphic`` False: an MoE `PipelinedLM` cuts its dispatch
    groups from the batch's tokens) is exported at ``input_shape``'s
    batch."""
    if format != EXPORT_FORMAT:
        raise NotImplementedError(
            f"export format {format!r} is not ported — the port exports "
            f"{EXPORT_FORMAT!r} programs; the JAX package's stablehlo and "
            "savedmodel formats stay refused, since writing them needs jax "
            "or TensorFlow, which the port does not import"
        )
    module, stamp, writes = gather_for_export(module, "export_serving",
                                              timestamp)
    out_dir = os.path.join(export_dir, stamp)
    if not writes:
        return out_dir
    os.makedirs(out_dir, exist_ok=True)
    dev = next(module.parameters()).device
    dtype = getattr(torch, np.dtype(input_dtype).name)
    # Two example rows: torch.export specializes a dimension of size 1. A
    # module whose function depends on its batch size exports at
    # input_shape's (as the JAX package's StableHLO export always does).
    fixed = not getattr(module, "batch_polymorphic", True)
    rows = input_shape[0] if fixed else 2
    example = torch.zeros((rows,) + tuple(input_shape[1:]), dtype=dtype,
                          device=dev)
    dynamic = None if fixed else ({0: torch.export.Dim("batch")},)
    from horovod_tpu_torch.models.moe import whole_batches

    was_training = module.training
    module.eval()
    try:
        with whole_batches(module):  # the program groups what it is given
            program = torch.export.export(
                _Predict(module), (example,), dynamic_shapes=dynamic)
    finally:
        module.train(was_training)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    _atomic_write(os.path.join(out_dir, PROGRAM_FILE), buf.getvalue(),
                  digest=True)
    signature = {
        "signature": {"inputs": {"input": {
            "shape": list(input_shape), "dtype": np.dtype(input_dtype).name}},
            "outputs": {"prob": {}}},
        "format": EXPORT_FORMAT, "device": dev.type, "created": stamp,
    }
    _atomic_write(os.path.join(out_dir, SIGNATURE_FILE),
                  json.dumps(signature, indent=2).encode(), digest=True)
    return out_dir


def load_serving(bundle_dir: str, device="cuda"):
    """Reload an exported bundle on ``device`` (default ``"cuda"``; raises
    without CUDA unless ``"cpu"``); returns ``fn(input) -> prob`` taking
    and returning numpy arrays."""
    dev = resolve_device(device)
    with open(os.path.join(bundle_dir, SIGNATURE_FILE)) as f:
        signature = json.load(f)
    if signature.get("format") != EXPORT_FORMAT:
        raise ValueError(f"{bundle_dir} is not a {EXPORT_FORMAT} bundle")
    if signature.get("device") != dev.type:
        raise ValueError(
            f"{bundle_dir} was exported on {signature.get('device')}; load it "
            f"with device={signature.get('device')!r}"
        )
    data = _read_verified(os.path.join(bundle_dir, PROGRAM_FILE))
    program = torch.export.load(io.BytesIO(data)).module()

    def predict(x):
        with torch.inference_mode():
            return program(torch.as_tensor(np.asarray(x), device=dev)).cpu().numpy()

    return predict
