"""Real elastic worlds of the port on gloo, held to the JAX package's
``loopback.elastic_run`` of the same function and schedule.

The port's side is ``python -m horovod_tpu_torch.runner.launch --min-np 1
--max-np 2`` of this file as a worker (``python
tests/test_torch_elastic_world.py <scenario>``), which trains the elastic
twin (``horovod_tpu_torch/examples/elastic_train.py``); the JAX side trains
the JAX example's model, data and optimizer as loopback rank threads under
the JAX package's driver. Three schedules, each change made at a fixed
commit (rank 0 waits there for the driver's notification, so the world
turns at the next commit on both sides):

* ``grow_shrink``: a discovery script grows the world 1 -> 2 and shrinks
  it back to 1 (a graceful departure: ``HVD_ELASTIC_GRACE``); the second
  re-form is back to a shape rank 0 ran at, so it takes its shelved plans
  warm;
* ``remove``: ``worker:remove`` takes rank 1's host abruptly; rank 0's
  next step fails on the dead peer, is rolled back to the commit (one step
  lost) and re-runs at world 1;
* ``preempt``: ``worker:preempt`` lets rank 1 finish the step in flight and
  leave at the next commit: no step lost.

Compared: each committed step's world size exactly, rank 0's per-step
losses to rtol 1e-4 (float32 gradients averaged in another order), the
steps lost, and the warm re-form's graft counter."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
EPOCHS, BATCH = 1, 8
GROW_AT, SHRINK_AT, REMOVE_AT, PREEMPT_AT = 3, 9, 4, 4
RTOL = 1e-4
# A dead peer is named within seconds; a live one is never silent this
# long, even on a loaded host. An idle negotiation cycle every 200 ms (20
# by default): each of its KV rounds opens connections, and their source
# ports, drawn from the kernel's ephemeral range, could take a port that
# a concurrent test picked for a server before it listens.
WORLD_ENV = {"HVD_HEALTH_INTERVAL": "0.5", "HVD_HEALTH_TIMEOUT": "6",
             "HVD_CYCLE_TIME": "200"}
SCHEDULES = {
    "grow_shrink": {"env": {"HVD_ELASTIC_GRACE": "30"}},
    "remove": {"env": {"HVD_FAULT_SPEC":
                       f"worker:remove:rank=1:at_step={REMOVE_AT}"}},
    "preempt": {"env": {"HVD_FAULT_SPEC":
                        f"worker:preempt:rank=1:at_step={PREEMPT_AT}:"
                        "grace=30"}},
}


def _wait_for_notification(state):
    deadline = time.monotonic() + 60
    while state._host_messages.empty():
        if time.monotonic() > deadline:
            raise TimeoutError("the driver's notification never came")
        time.sleep(0.02)


def make_hook(scenario, hvd, hosts_file, block):
    """The schedule's actions after each commit: ``block()`` is how a
    reclaimed rank stops taking part (it waits in a collective nobody
    else issues, until the driver ends it)."""
    def hook(state):
        rank, size, step = hvd.rank(), hvd.size(), state.step
        if scenario == "grow_shrink" and rank == 0:
            if (step, size) in ((GROW_AT, 1), (SHRINK_AT, 2)):
                with open(hosts_file, "w") as f:
                    f.write("localhost:1\n127.0.0.1:1\n" if size == 1
                            else "localhost:1\n")
                _wait_for_notification(state)
        elif scenario == "remove" and step == REMOVE_AT and size == 2:
            if rank == 1:
                block()
            else:
                _wait_for_notification(state)
        elif scenario == "preempt" and step == PREEMPT_AT and size == 2 \
                and rank == 0:
            _wait_for_notification(state)
    return hook


def _port_worker(scenario: str, hosts_file: str) -> None:
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.examples import elastic_train as et
    from horovod_tpu_torch.ops import dispatch_cache

    hvd.init(device="cpu")
    worlds = {}
    hook = make_hook(scenario, hvd, hosts_file, lambda: hvd.allreduce(
        torch.zeros(1), op=hvd.Sum, name="reclaimed"))

    def record(state):
        worlds[state.step] = hvd.size()
        hook(state)

    state = et.make_state(hvd.runtime.device())
    losses = et.make_train(EPOCHS, BATCH, et.make_data(), record)(state)
    if hvd.rank() == 0:
        print("RESULT " + json.dumps({
            "losses": losses, "worlds": worlds,
            "warm": dispatch_cache.stats()["warm_reuses"],
            "lost": metrics.ELASTIC_STEPS_LOST.value()}), flush=True)
    hvd.shutdown()


def _jax_body(scenario, hosts_file, box):
    """The JAX example's training (its data, zero-initialized ``w``, SGD at
    0.05 on the averaged gradient, the elastic sampler) as a loopback
    rank's script, with the same schedule hook."""
    import jax
    import jax.numpy as jnp

    import horovod_tpu as hvd
    from horovod_tpu import metrics
    from horovod_tpu.ops import dispatch_cache
    from horovod_tpu_torch.examples.elastic_train import (N_SAMPLES,
                                                          make_data)

    def body():
        hvd.init()
        data_x, data_y = make_data()
        sampler = hvd.elastic.ElasticSampler(N_SAMPLES, seed=1)
        state = hvd.elastic.JaxState(
            w=jnp.zeros((data_x.shape[1], 1), jnp.float32),
            sampler=sampler.state_dict(), epoch=0, step=0, losses=[])
        state.register_reset_callbacks(
            [lambda: sampler.load_state_dict(state.sampler)])
        worlds = {}
        hook = make_hook(scenario, hvd, hosts_file, lambda: hvd.allreduce(
            jnp.zeros(1), op=hvd.Sum, name="reclaimed"))

        @hvd.elastic.run
        def train(state):
            # the synced sampler state, as TorchState's sampler handler
            # loads it at every sync (a fresh worker runs no reset
            # callback)
            sampler.load_state_dict(state.sampler)
            for state.epoch in range(state.epoch, EPOCHS):
                idx_all = sampler.local_indices()
                for start in range(0, len(idx_all) - BATCH + 1, BATCH):
                    local = idx_all[start:start + BATCH]
                    x = jnp.asarray(data_x[local])
                    y = jnp.asarray(data_y[local])
                    loss, g = jax.value_and_grad(
                        lambda w: jnp.mean((x @ w - y) ** 2))(state.w)
                    g = hvd.allreduce(g, op=hvd.Average, name="grad")
                    state.w = state.w - 0.05 * g
                    sampler.record_batch(BATCH)
                    state.sampler = sampler.state_dict()
                    state.losses = state.losses + [float(loss)]
                    state.step += 1
                    state.commit()
                    worlds[state.step] = hvd.size()
                    hook(state)
                sampler.set_epoch(state.epoch + 1)
                state.sampler = sampler.state_dict()
            return state.losses

        losses = train(state)
        if hvd.rank() == 0:
            box.update(losses=losses, worlds=worlds,
                       warm=dispatch_cache.stats()["warm_reuses"],
                       lost=metrics.ELASTIC_STEPS_LOST.value())
        return 0

    return body


def _discovery(tmp_path: Path, side: str) -> tuple[Path, Path]:
    hosts = tmp_path / f"hosts_{side}.txt"
    hosts.write_text("localhost:1\n")
    script = tmp_path / f"discover_{side}.sh"
    script.write_text(f"#!/bin/sh\ncat {hosts}\n")
    script.chmod(0o755)
    return hosts, script


def _run_port(scenario: str, tmp_path: Path) -> dict:
    hosts, script = _discovery(tmp_path, "port")
    where = (["--host-discovery-script", str(script)]
             if scenario == "grow_shrink"
             else ["-H", "localhost:1,127.0.0.1:1"])
    np_ = 1 if scenario == "grow_shrink" else 2
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVD_", "HOROVOD_"))}
    env.update(WORLD_ENV, **SCHEDULES[scenario]["env"],
               PYTHONPATH=os.pathsep.join([str(REPO),
                                           env.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         str(np_), "--min-np", "1", "--max-np", "2", *where, "--",
         sys.executable, str(Path(__file__).resolve()), scenario,
         str(hosts)],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    out = [line.split("RESULT ", 1)[1] for line in proc.stdout.splitlines()
           if "RESULT " in line]
    assert proc.returncode == 0 and len(out) == 1, (
        proc.stdout[-6000:] + proc.stderr[-6000:])
    got = json.loads(out[0])
    got["worlds"] = {int(k): v for k, v in got["worlds"].items()}
    return got


def _run_jax(scenario: str, tmp_path: Path, monkeypatch) -> dict:
    from horovod_tpu.elastic import discovery as jdisc
    from horovod_tpu.elastic import driver as jdrv
    from horovod_tpu.loopback import elastic_run
    from horovod_tpu.utils import faults as jfaults

    hosts, script = _discovery(tmp_path, "jax")
    monkeypatch.setattr(jdrv, "DISCOVER_HOSTS_FREQUENCY_S", 0.2)
    for k, v in SCHEDULES[scenario]["env"].items():
        monkeypatch.setenv(k, v)
    jfaults.refresh()
    try:
        if scenario == "grow_shrink":
            disco, np_ = jdisc.HostDiscoveryScript(str(script)), 1
        else:
            disco = jdisc.FixedHosts({"localhost": 1, "127.0.0.1": 1})
            np_ = 2
        box = {}
        results, ok = elastic_run(
            _jax_body(scenario, str(hosts), box), np=np_, min_np=1,
            max_np=2, discovery=disco, timeout=120,
            extra_env={**WORLD_ENV, **SCHEDULES[scenario]["env"]})
        assert ok, results.error_message
    finally:
        monkeypatch.delenv("HVD_FAULT_SPEC", raising=False)
        jfaults.refresh()
        jfaults.clear_membership_handler()
    return box


@pytest.mark.parametrize("scenario", sorted(SCHEDULES))
def test_elastic_world_equals_loopback_elastic_run(scenario, tmp_path,
                                                   monkeypatch):
    port = _run_port(scenario, tmp_path)
    ref = _run_jax(scenario, tmp_path, monkeypatch)
    assert port["worlds"] == ref["worlds"]
    sizes = [port["worlds"][s] for s in sorted(port["worlds"])]
    assert sizes[0] == (1 if scenario == "grow_shrink" else 2)
    assert sizes[-1] == 1 and 2 in sizes
    if scenario == "grow_shrink":
        assert sizes.count(1) > sizes.index(2)  # back to 1 after the 2s
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=RTOL)
    assert port["losses"][-1] < port["losses"][0]
    assert port["lost"] == ref["lost"] == (1 if scenario == "remove" else 0)
    if scenario == "grow_shrink":
        assert port["warm"] > 0 and ref["warm"] > 0


if __name__ == "__main__":
    _port_worker(sys.argv[1], sys.argv[2])
