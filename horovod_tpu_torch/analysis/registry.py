"""Central registry of every ``HVT_*`` environment knob the port reads —
port of `horovod_tpu.analysis.registry` (its own copy: the port imports
nothing of the JAX package).

* every knob is declared here with type, default, owning subsystem and a
  one-line description; where the JAX package declares the same name,
  type, default and text are its own (``tests/test_torch_registry.py``
  holds the shared rows together);
* code reads knobs through the typed accessors (`get_raw`/`get_str`/
  `get_int`/`get_float`/`get_flag`), which refuse undeclared names — a new
  knob cannot ship without a row;
* ``port`` marks a row that is the port's own: a knob the JAX package does
  not read (``HVT_BACKEND``, ``HVT_DEVICE``), or one whose default the
  port must differ on (``HVT_EXPORT_FORMAT``);
* `generate_doc` renders the table (``python -m
  horovod_tpu_torch.analysis.registry``).

Value contract, uniform across every accessor: an UNSET variable and a
variable set to the EMPTY STRING are both "unset" (the registered default
applies). Boolean knobs: unset/''/'0'/'false'/'no' (case-insensitive) are
off, anything else is on (`flag_like`; `runtime.env_flag` delegates to it).

`Tunable` rows are data only: the autotuner that reads them is not ported
(ROADMAP queue A item 13.9). Stdlib only.
"""

from __future__ import annotations

import dataclasses
import os

__all__ = [
    "Knob", "Tunable", "KNOBS", "UnknownKnobError", "knob", "is_registered",
    "tunable_knobs", "get_raw", "get_str", "get_int", "get_float",
    "get_flag", "flag_like", "generate_doc",
]


@dataclasses.dataclass(frozen=True)
class Tunable:
    """Search domain of a knob the autotuner may set (data only here).

    kind: ``int`` (range [lo, hi], walked ``log`` = powers of two or
    ``linear``), ``choice`` (``choices``) or ``flag`` (off/on)."""

    kind: str
    lo: int | None = None
    hi: int | None = None
    scale: str = "linear"
    choices: tuple = ()

    def __post_init__(self):
        if self.kind not in ("int", "choice", "flag"):
            raise ValueError(f"unknown tunable kind {self.kind!r}")
        if self.kind == "int":
            if self.lo is None or self.hi is None or self.lo > self.hi:
                raise ValueError(f"int tunable needs lo <= hi, got "
                                 f"[{self.lo}, {self.hi}]")
            if self.scale not in ("log", "linear"):
                raise ValueError(f"unknown tunable scale {self.scale!r}")
        if self.kind == "choice" and not self.choices:
            raise ValueError("choice tunable needs a non-empty choice set")

    def domain_str(self) -> str:
        if self.kind == "flag":
            return "off/on"
        if self.kind == "choice":
            return "/".join(str(c) for c in self.choices)
        return f"[{self.lo}, {self.hi}] ({self.scale})"


@dataclasses.dataclass(frozen=True)
class Knob:
    """One declared environment knob."""

    name: str
    type: str          # "str" | "int" | "float" | "flag" | "path" | "spec"
    default: object    # the value accessors return when unset ('' == unset)
    subsystem: str     # owning layer (the generated table's grouping)
    description: str
    tunable: Tunable | None = None
    port: str | None = None   # why the row is the port's own, if it is


_SUBSYSTEM_ORDER = (
    "runtime", "parallel", "training", "launch", "serving", "data",
    "observability", "testing", "examples",
)

_PORT_ONLY = "port-only: the JAX package has no such knob"


def _decl(knobs: list[Knob]) -> dict[str, Knob]:
    table: dict[str, Knob] = {}
    for k in knobs:
        if k.name in table:
            raise ValueError(f"duplicate knob declaration {k.name}")
        if k.subsystem not in _SUBSYSTEM_ORDER:
            raise ValueError(f"{k.name}: unknown subsystem {k.subsystem!r}")
        table[k.name] = k
    return table


KNOBS: dict[str, Knob] = _decl([
    # --- runtime bootstrap (runtime.init) ----------------------------------
    Knob("HVT_COORDINATOR_ADDRESS", "str", None, "runtime",
         "Process-group rendezvous `host:port`; unset = single-process "
         "(every collective degrades to a local op)."),
    Knob("HVT_NUM_PROCESSES", "int", None, "runtime",
         "Process count of the static (non-elastic) world."),
    Knob("HVT_PROCESS_ID", "int", None, "runtime",
         "This process's rank in the static world."),
    Knob("HVT_LOCAL_RANK", "int", 0, "runtime",
         "Ordinal among co-located processes on one host (launcher-set); "
         "the card a rank pins."),
    Knob("HVT_BACKEND", "str", None, "runtime",
         "Process-group backend, `nccl` or `gloo`; unset = NCCL on CUDA, "
         "gloo on the CPU. `gloo` lets ranks share cards.", port=_PORT_ONLY),
    # --- parallel ----------------------------------------------------------
    Knob("HVT_MESH", "spec", None, "parallel",
         "Mesh axis sizes, `axis=size` pairs (`data=2,seq=4`); "
         "unset/empty = pure data parallelism (`MeshSpec.from_string`)."),
    Knob("HVT_MESH_ORDER", "str", "auto", "parallel",
         "Rank layout of the mesh: `auto` or `flat`. Checked as in the JAX "
         "package; the port always lays the ranks out flat (row-major), "
         "since each rank is one process and there is no device torus to "
         "map."),
    Knob("HVT_DCN_FACTOR", "int", None, "parallel",
         "Override the derived multi-host factor of the ranks — the "
         "fake-topology knob for the two-hop reduction; must divide the "
         "world size."),
    Knob("HVT_BUCKET_BYTES", "int", None, "parallel",
         "Gradient-fusion bucket cap in bytes (default: "
         "collectives.DEFAULT_BUCKET_BYTES, 64 MB — Horovod's fusion "
         "threshold).",
         tunable=Tunable("int", lo=1 << 18, hi=1 << 28, scale="log")),
    Knob("HVT_OVERLAP_REDUCTION", "flag", True, "parallel",
         "Overlap the bucketed gradient reduction with the backward (grad "
         "hooks past one rank). Off = reduce after the backward "
         "(identical arithmetic).",
         tunable=Tunable("flag")),
    Knob("HVT_BUCKET_ORDER", "str", "reverse", "parallel",
         "Bucket issue order: `reverse` (last-produced gradients reduce "
         "first — Horovod's fusion order) or `forward`."),
    # --- training ----------------------------------------------------------
    Knob("HVT_SAVE_EVERY_STEPS", "int", 0, "training",
         "ModelCheckpoint mid-epoch save cadence in optimizer steps "
         "(0 = epoch cadence only). Single-file checkpoints only."),
    Knob("HVT_EPOCH_CHUNK_STEPS", "int", 0, "training",
         "fit(cache='device'): split each on-device epoch into chunks of "
         "this many optimizer steps (0 = whole epoch), so on_batch_end "
         "fires per chunk."),
    # --- launch / supervision ----------------------------------------------
    Knob("HVT_HEARTBEAT_DIR", "path", None, "launch",
         "Per-rank liveness dir (supervisor-set); fit() auto-installs "
         "HeartbeatCallback when present."),
    Knob("HVT_RESTART_LOG_MAX_LINES", "int", 100000, "launch",
         "Restart-journal rotation bound in lines (0 disables)."),
    Knob("HVT_RESTART_LOG_MAX_MB", "float", 64.0, "launch",
         "Restart-journal rotation bound in MB (0 disables)."),
    Knob("HVT_STATUS_HOST", "str", "127.0.0.1", "launch",
         "Bind host for the supervisor status endpoint (`--status-port`) "
         "and the servers' metrics; loopback by default — set 0.0.0.0 to "
         "expose off-host."),
    Knob("HVT_POLICY", "str", "off", "launch",
         "Supervisor policy engine mode: off | dry-run | on. Declared so "
         "that anything but `off` can be refused: the engine is not "
         "ported (ROADMAP queue A item 13.6)."),
    # --- serving -----------------------------------------------------------
    Knob("HVT_SERVE_MAX_SEQS", "int", 0, "serving",
         "Continuous batching: max concurrently scheduled sequences per "
         "replica (decode slots). 0 = the bundle's compiled batch size; "
         "values above it clamp to the compiled shape."),
    Knob("HVT_SERVE_BLOCK_TOKENS", "int", 16, "serving",
         "Paged-KV block granularity in tokens: admission reserves "
         "ceil((prompt+max_new)/block) blocks for a sequence's whole "
         "lifetime, so a running sequence can never hit OOM mid-decode."),
    Knob("HVT_SERVE_KV_BLOCKS", "int", 0, "serving",
         "Total paged-KV blocks in the admission budget. 0 = auto-size "
         "to max_seqs full-length sequences."),
    Knob("HVT_SERVE_QUEUE_DEPTH", "int", 64, "serving",
         "Admission wait-queue depth per replica; a full queue answers "
         "429 (AdmissionError) instead of stacking unbounded memory."),
    Knob("HVT_SERVE_DRAIN_TIMEOUT_S", "float", 30.0, "serving",
         "Drain budget in seconds: how long a replica waits for in-flight "
         "requests to finish on SIGTERM, and how long a weight reload "
         "waits for the engine to empty before refusing the swap."),
    # --- data --------------------------------------------------------------
    Knob("HVT_NO_NATIVE", "flag", False, "data",
         "Disable the native C++ loader; fall back to the pure-python "
         "feeding path."),
    Knob("HVT_PREFETCH_DEPTH", "int", 2, "data",
         "Device-prefetch queue depth for the streamed fit path (staged "
         "batches ahead of the consuming step; 2 = double buffering)."),
    Knob("HVT_DATA_DIR", "path", "~/.cache/horovod_tpu", "data",
         "Dataset cache directory (the keras-layout npz archives)."),
    # --- observability ------------------------------------------------------
    Knob("HVT_PROFILE", "path", None, "observability",
         "Landing dir of POST /profile captures when HVT_TRACE_DIR is "
         "unset."),
    Knob("HVT_METRICS_DIR", "path", None, "observability",
         "Metrics-stream directory (default: $PS_MODEL_PATH, else "
         "./models)."),
    Knob("HVT_METRICS_PORT", "int", None, "observability",
         "Trainer-side Prometheus exporters behind the supervisor's "
         "/fleet rollup. Declared so that it can be refused: not ported "
         "(ROADMAP queue A item 13.5)."),
    Knob("HVT_FLIGHT_RECORD", "path", None, "observability",
         "Collective flight recorder directory. Declared so that it can "
         "be refused: the recorder is not ported (ROADMAP queue A item "
         "13.5)."),
    Knob("HVT_TRACE_DIR", "path", None, "observability",
         "Structured trace-span directory: JSONL span records, one "
         "rank-tagged file per process (trace.span); also the landing "
         "dir for POST /profile captures. Unset = spans off."),
    # --- testing / chaos ----------------------------------------------------
    Knob("HVT_FAULT", "spec", None, "testing",
         "Deterministic fault injection, `rank:epoch[.step]:kind` (kinds "
         "kill/exitN/hang/leave/corrupt[@epochN]/slow:MS/hostdown fire; "
         "reorder, netdrop:MS, dataslow:MS and corrupt@shardN parse and "
         "are refused, naming their ROADMAP item)."),
    Knob("HVT_FAULT_STAMP", "path", None, "testing",
         "One-shot stamp file: the fault fires once, never while the "
         "stamp exists — across relaunches."),
    Knob("HVT_FAULT_HOST_PIDS", "path", None, "testing",
         "Per-host pid registry directory for the `hostdown` fault kind; "
         "each rank's fault callback registers its pid there at epoch "
         "begin, and a firing `hostdown` SIGKILLs every registered live "
         "pid — peers first, self last. Unset degrades hostdown to a "
         "self-SIGKILL."),
    # --- examples (read by the entry scripts) -------------------------------
    Knob("HVT_DEVICE", "str", "cuda", "examples",
         "The twins' device: `cuda` (one card a rank) or `cpu` (the plain "
         "PyTorch path, asked for by name).", port=_PORT_ONLY),
    Knob("HVT_BACKWARD_PASSES", "int", 1, "examples",
         "Gradient-accumulation factor K for the example entry scripts "
         "(DistributedOptimizer backward_passes_per_step).",
         tunable=Tunable("int", lo=1, hi=8, scale="log")),
    Knob("HVT_COMPRESSION", "str", "none", "examples",
         "Gradient wire compression for the example entry scripts "
         "(none/bf16/fp16/int8/fp8 — DistributedOptimizer(compression=); "
         "int8/fp8 carry error-feedback residuals by default).",
         tunable=Tunable("choice",
                         choices=("none", "bf16", "fp16", "int8", "fp8"))),
    Knob("HVT_COMPRESSION_ICI", "str", "none", "examples",
         "Intra-host hop's gradient wire of the two-hop reduction for the "
         "example entry scripts (none/bf16/fp16/int8/fp8 — "
         "DistributedOptimizer(compression_ici=)).",
         tunable=Tunable("choice",
                         choices=("none", "bf16", "fp16", "int8", "fp8"))),
    Knob("HVT_DEVICE_CACHE", "flag", False, "examples",
         "Examples: stage the dataset on the card once (`cache='device'`)."),
    Knob("HVT_EXPORT_FORMAT", "str", "torch.export", "examples",
         "Examples: serving-bundle export format.",
         port="the port exports torch.export programs; the JAX package's "
              "default, stablehlo, needs jax"),
])


class UnknownKnobError(KeyError):
    """An env knob was read that is not declared in this registry."""

    def __init__(self, name: str):
        super().__init__(
            f"{name} is not a declared HVT_* knob — add a Knob row to "
            "horovod_tpu_torch/analysis/registry.py (type, default, "
            "subsystem, description)"
        )


def knob(name: str) -> Knob:
    try:
        return KNOBS[name]
    except KeyError:
        raise UnknownKnobError(name) from None


def is_registered(name: str) -> bool:
    return name in KNOBS


def tunable_knobs() -> dict[str, Knob]:
    """The knobs carrying autotuner domain metadata, name-sorted."""
    return {name: k for name, k in sorted(KNOBS.items()) if k.tunable}


def flag_like(value: str | None) -> bool:
    """The shared boolean env contract (see module docstring)."""
    return (value or "").lower() not in ("", "0", "false", "no")


def get_raw(name: str, *, environ=None) -> str | None:
    """The raw string value, or None when unset/empty. The name must be
    registered."""
    k = knob(name)
    env = os.environ if environ is None else environ
    raw = env.get(k.name, "")
    return raw if raw != "" else None


def get_str(name: str, *, environ=None) -> str | None:
    raw = get_raw(name, environ=environ)
    return raw if raw is not None else knob(name).default


def get_int(name: str, *, environ=None) -> int | None:
    raw = get_raw(name, environ=environ)
    if raw is None:
        d = knob(name).default
        return None if d is None else int(d)
    return int(raw)


def get_float(name: str, *, environ=None) -> float | None:
    raw = get_raw(name, environ=environ)
    if raw is None:
        d = knob(name).default
        return None if d is None else float(d)
    return float(raw)


def get_flag(name: str, *, environ=None) -> bool:
    k = knob(name)
    raw = get_raw(name, environ=environ)
    return bool(k.default) if raw is None else flag_like(raw)


_DOC_HEADER = """\
# `HVT_*` environment variables of the PyTorch/CUDA port

Every knob `horovod_tpu_torch` reads, from its registry
(`horovod_tpu_torch/analysis/registry.py`; regenerate with
`python -m horovod_tpu_torch.analysis.registry`). Unset and empty-string
are equivalent (the default applies); `flag` knobs treat `''`/`0`/`false`/
`no` (case-insensitive) as off and anything else as on.
"""


def _fmt_default(k: Knob) -> str:
    if k.default is None:
        return "—"
    if k.type == "flag":
        return "on" if k.default else "off"
    return f"`{k.default}`"


def generate_doc() -> str:
    """Render the table. Deterministic: grouped by subsystem in
    `_SUBSYSTEM_ORDER`, name-sorted within a group."""
    parts = [_DOC_HEADER]
    for sub in _SUBSYSTEM_ORDER:
        group = sorted((k for k in KNOBS.values() if k.subsystem == sub),
                       key=lambda k: k.name)
        if not group:
            continue
        parts.append(f"\n## {sub}\n")
        parts.append("| name | type | default | description |")
        parts.append("|---|---|---|---|")
        for k in group:
            note = f" ({k.port})" if k.port else ""
            parts.append(f"| `{k.name}` | {k.type} | {_fmt_default(k)} "
                         f"| {k.description}{note} |")
    tunables = tunable_knobs()
    if tunables:
        parts.append("\n## autotuner domains (data only)\n")
        parts.append("| name | kind | domain |")
        parts.append("|---|---|---|")
        for name, k in tunables.items():
            parts.append(
                f"| `{name}` | {k.tunable.kind} | {k.tunable.domain_str()} |")
    return "\n".join(parts) + "\n"


if __name__ == "__main__":
    print(generate_doc(), end="")
