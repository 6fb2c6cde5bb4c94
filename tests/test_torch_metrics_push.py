"""`training.callbacks.MetricsPushCallback` against the JAX package's
(``horovod_tpu/training/callbacks.py:630-645``): the same epoch-end logs,
pushed through each side's `metrics` module into a `metrics.JsonlSink`,
give the same JSONL records (``name``, ``value``, ``step``; the wall time
aside) — every scalar at step ``epoch + 1``, in the logs' order, and what
``float()`` refuses (text, None, an array of several values) skipped.
"""

import json

import numpy as np
import pytest

from horovod_tpu import metrics as jmetrics
from horovod_tpu.training import callbacks as jcb
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch.training import callbacks as tcb

LOGS = {
    "scalars": [{"loss": 0.75, "accuracy": 0.5}, {"loss": 0.5,
                                                 "accuracy": 0.625}],
    "numpy_and_ints": [{"loss": np.float32(1.25), "epoch_time_s":
                        np.float64(3.5), "steps": 4, "val": np.array(2.0)}],
    "unpushable_skipped": [{"loss": 0.3, "note": "text", "none": None,
                            "vec": np.arange(3.0), "lr": 1e-3}],
    "empty_and_none": [{}, None, {"loss": 0.1}],
}


def _records(metrics_mod, cb, logs, path):
    sink = metrics_mod.JsonlSink(str(path))
    metrics_mod.set_sink(sink)
    try:
        for epoch, epoch_logs in enumerate(logs):
            cb.on_epoch_end(epoch, epoch_logs)
    finally:
        sink.close()
        metrics_mod.set_sink(metrics_mod.NullSink())
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k != "wall_time"} for line in f]


@pytest.mark.parametrize("case", list(LOGS))
def test_metrics_push_records_equal_jax(case, tmp_path):
    logs = LOGS[case]
    got = _records(tmetrics, tcb.MetricsPushCallback(), logs,
                   tmp_path / "port.jsonl")
    want = _records(jmetrics, jcb.MetricsPushCallback(), logs,
                    tmp_path / "jax.jsonl")
    assert got == want
    if case == "scalars":
        assert got == [{"name": "loss", "value": 0.75, "step": 1},
                       {"name": "accuracy", "value": 0.5, "step": 1},
                       {"name": "loss", "value": 0.5, "step": 2},
                       {"name": "accuracy", "value": 0.625, "step": 2}]
