"""Launcher and cluster orchestration — port of `horovod_tpu.launch` (the
L5 + L6 replacement, SURVEY.md §1), plus the HTTP generation server.

* `launcher.run_local` — N ranks on this host (the "Docker-local mpirun"
  test mode), coordinator address auto-assigned.
* `launcher.run_hosts` — K ranks a host over ssh with env propagation
  (the ``mpirun -x`` role), coordinator = first host.
* `ci_gate` — aggregate a metric stream and assert a target range (the
  Gradient workflow's ``checks`` block).
* `job` — job specs binding the two together (the `.ps_project` role),
  read by `specfile` (no PyYAML).
* `supervisor` — fail-*restart* around either launcher: crash/preemption/
  hang classification, heartbeat hang detection, progress-aware restart
  budget, JSONL restart journal, status server.
* `serve` — the HTTP server for exported bundles.

CLI:  python -m horovod_tpu_torch.launch run --nprocs 4 -- python train.py
      python -m horovod_tpu_torch.launch run --nprocs 4 --max-restarts 3 \\
          --heartbeat-timeout 300 -- python train.py
      python -m horovod_tpu_torch.launch pod --hostfile hosts.txt \\
          --nprocs-per-host 8 -- python train.py
      python -m horovod_tpu_torch.launch gate --metrics m.jsonl \\
          --check loss=0.0..0.3
      python -m horovod_tpu_torch.launch job launch/jobs/mnist-ci.yaml
"""

from horovod_tpu_torch.launch.ci_gate import check_metrics, parse_target
from horovod_tpu_torch.launch.launcher import (
    Fleet,
    run_hosts,
    run_local,
    start_hosts,
    start_local,
)
from horovod_tpu_torch.launch.supervisor import (
    RestartPolicy,
    supervise,
    supervise_hosts,
    supervise_local,
)

__all__ = [
    "Fleet",
    "run_local",
    "run_hosts",
    "start_local",
    "start_hosts",
    "check_metrics",
    "parse_target",
    "RestartPolicy",
    "supervise",
    "supervise_local",
    "supervise_hosts",
]
