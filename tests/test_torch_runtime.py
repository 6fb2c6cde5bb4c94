"""The port's runtime against the JAX package's: env resolution and the
`World` fields, an idempotent ``init``, single-process defaults, and the
world-size helpers (``scale_lr``/``shard_steps``/``shard_epochs``) equal to
JAX's for world sizes 1-8.

``init`` with a rendezvous starts a real gloo process group of one rank in
this process (on a free port) and the test tears it down.
"""

import sys
import time

import pytest
import torch

import horovod_tpu_torch as ht
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu_torch import runtime
from horovod_tpu_torch.launch import launcher
from horovod_tpu_torch.launch.launcher import pick_free_port
from horovod_tpu_torch.parallel import mesh as tmesh

ENV = ("HVT_COORDINATOR_ADDRESS", "HVT_NUM_PROCESSES", "HVT_PROCESS_ID",
       "HVT_LOCAL_RANK", "HVT_BACKEND")


@pytest.fixture
def clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    yield monkeypatch
    ht.shutdown()
    assert not torch.distributed.is_initialized()


def test_single_process_defaults(clean_env):
    assert not ht.is_initialized()
    assert (ht.rank(), ht.size(), ht.local_rank(), ht.local_size()) == (0, 1, 0, 1)
    assert ht.is_primary() and ht.process_count() == 1
    world = ht.init(device="cpu")
    assert ht.is_initialized() and not runtime.is_distributed()
    assert world == ht.World(
        process_rank=0, process_count=1, local_rank=0, device_count=1,
        local_device_count=1, hostname=world.hostname, platform="cpu",
        backend=None)
    assert not world.is_distributed
    assert runtime.device() == torch.device("cpu")
    assert ht.init(device="cpu") == world  # idempotent
    ht.shutdown()
    assert not ht.is_initialized()
    with pytest.raises(RuntimeError, match="init"):
        runtime.device()


def test_env_rendezvous_makes_a_process_group(clean_env):
    port = pick_free_port()
    clean_env.setenv("HVT_COORDINATOR_ADDRESS", f"127.0.0.1:{port}")
    clean_env.setenv("HVT_NUM_PROCESSES", "1")
    clean_env.setenv("HVT_PROCESS_ID", "0")
    clean_env.setenv("HVT_LOCAL_RANK", "0")
    world = ht.init(device="cpu")
    assert runtime.is_distributed() and runtime.backend() == "gloo"
    assert (world.process_rank, world.process_count, world.local_rank,
            world.platform, world.backend) == (0, 1, 0, "cpu", "gloo")
    # idempotent: a second init keeps the group (a new one would raise)
    assert ht.init(device="cpu") == world
    assert ht.size() == 1 and ht.rank() == 0


def test_explicit_arguments_win_over_env(clean_env):
    clean_env.setenv("HVT_COORDINATOR_ADDRESS", "127.0.0.1:1")  # unused
    clean_env.setenv("HVT_NUM_PROCESSES", "7")
    clean_env.setenv("HVT_PROCESS_ID", "3")
    clean_env.setenv("HVT_LOCAL_RANK", "2")
    assert ht.local_rank() == 2
    world = ht.init(f"127.0.0.1:{pick_free_port()}", 1, 0, device="cpu",
                    backend="gloo")
    assert (world.process_count, world.process_rank, world.local_rank) == (1, 0, 2)


@pytest.mark.parametrize("device_type,lrank,n_cards,named,want", [
    ("cuda", 0, 1, None, ("nccl", 0)),
    ("cuda", 3, 4, None, ("nccl", 3)),
    ("cuda", 1, 4, "gloo", ("gloo", 1)),
    ("cuda", 1, 1, "gloo", ("gloo", 0)),   # two gloo ranks share one card
    ("cuda", 5, 4, "gloo", ("gloo", 1)),
    ("cpu", 0, 0, None, ("gloo", None)),
    ("cpu", 3, 0, "gloo", ("gloo", None)),
], ids=["one-card", "card-3-of-4", "gloo-own-card", "gloo-shared",
        "gloo-wraps", "cpu", "cpu-named"])
def test_backend_is_nccl_on_cuda_and_gloo_on_the_cpu(device_type, lrank,
                                                     n_cards, named, want):
    assert runtime._place(device_type, lrank, n_cards, named) == want


@pytest.mark.parametrize("lrank,n_cards,named", [
    (1, 1, None), (4, 4, None), (1, 1, "nccl"),
], ids=["default", "default-4-cards", "named-nccl"])
def test_more_local_ranks_than_cards_needs_gloo_named(lrank, n_cards, named):
    """No silent move to the host: a rank without a card of its own is
    refused unless the caller names gloo."""
    with pytest.raises(RuntimeError, match="HVT_BACKEND=gloo"):
        runtime._place("cuda", lrank, n_cards, named)


def test_unknown_or_misplaced_backend_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        runtime._place("cuda", 0, 1, "mpi")
    with pytest.raises(ValueError, match="needs device='cuda'"):
        runtime._place("cpu", 0, 0, "nccl")


def test_env_backend_is_read(clean_env):
    clean_env.setenv("HVT_BACKEND", "nccl")
    with pytest.raises(ValueError, match="needs device='cuda'"):
        ht.init(device="cpu")
    assert not ht.is_initialized()


def test_coordinator_needs_world_size_and_id(clean_env):
    with pytest.raises(ValueError, match="HVT_NUM_PROCESSES"):
        ht.init("127.0.0.1:1", device="cpu")
    assert not ht.is_initialized()


@pytest.mark.parametrize("size", range(1, 9))
def test_world_size_helpers_match_jax(size):
    for lr in (0.001, 1.0):
        assert tmesh.scale_lr(lr, size) == jmesh.scale_lr(lr, size)
    for total in (1, 7, 500, 1000):
        assert tmesh.shard_steps(total, size) == jmesh.shard_steps(total, size)
    for total in (1, 3, 12, 12.5):
        assert tmesh.shard_epochs(total, size) == jmesh.shard_epochs(total, size)


def test_world_size_helpers_default_to_the_world(clean_env):
    assert tmesh.dp_size() == 1
    assert ht.scale_lr(0.001) == 0.001
    assert ht.shard_steps(500) == 500 and ht.shard_epochs(12) == 12
    from horovod_tpu_torch.training.optimizer import scale_lr
    assert scale_lr is tmesh.scale_lr  # the optimizer's re-export


def test_launcher_env_and_fail_stop(tmp_path):
    """Every child gets the rendezvous (a world of one included); the first
    nonzero exit stops the others after the grace period and is returned."""
    show = ("import os, sys; e = os.environ; sys.exit(0 if (e["
            "'HVT_NUM_PROCESSES'], e['HVT_PROCESS_ID'], e['HVT_LOCAL_RANK'])"
            " == ('1', '0', '0') and e['HVT_COORDINATOR_ADDRESS']"
            ".startswith('127.0.0.1:') else 5)")
    out = tmp_path / "out.txt"
    fleet = launcher.start_local(1, [sys.executable, "-c", show])
    assert fleet.wait(grace_seconds=5) == 0
    crash = ("import os, sys, time; r = int(os.environ['HVT_PROCESS_ID']); "
             f"open(r'{out}', 'a').write(f'{{r}}\\n'); "
             "sys.exit(3) if r == 1 else time.sleep(60)")
    t0 = time.monotonic()
    fleet = launcher.start_local(2, [sys.executable, "-c", crash])
    assert fleet.wait(grace_seconds=1) == 3
    assert time.monotonic() - t0 < 30
    assert not fleet.running()
    assert sorted(out.read_text().split()) == ["0", "1"]
    with pytest.raises(SystemExit):
        launcher.main(["run", "--nprocs", "2"])  # no command after --
    with pytest.raises(ValueError):
        launcher.start_local(0, [sys.executable, "-c", "pass"])
