"""The port's launcher (``horovod_tpu_torch/runner``) against the JAX
package's (``horovod_tpu/runner``), on the cases of ``tests/test_runner.py``
and ``tests/test_lsf.py``: host strings, hostfiles, rank assignments,
config files to worker knobs, the command line's explicit options, the
worker environment (the JAX package's ``HVD_*`` keys exactly, plus
``torch.distributed``'s contract), LSF allocations and the schedulers'
rank variables. Then real launches on gloo: ``python -m
horovod_tpu_torch.runner.launch -np 2`` of a worker whose allreduce and
allgather give the numbers of the JAX package's ``--loopback`` launch of
the same worker, ``runner.run(fn, np=2)``, and the card pool that keeps
two aliases of one machine off one card."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from horovod_tpu import runtime as jruntime
from horovod_tpu.runner import config_parser as jcfg
from horovod_tpu.runner import hosts as jhosts
from horovod_tpu.runner import launch as jlaunch
from horovod_tpu.runner import lsf as jlsf
from horovod_tpu_torch import runtime as truntime
from horovod_tpu_torch.runner import config_parser as tcfg
from horovod_tpu_torch.runner import hosts as thosts
from horovod_tpu_torch.runner import launch as tlaunch
from horovod_tpu_torch.runner import lsf as tlsf

REPO = Path(__file__).resolve().parent.parent
SCHEDULER_VARS = (
    "LSB_JOBID", "LSB_DJOB_RANKFILE", "LSB_MCPU_HOSTS", "LSB_HOSTS",
    "JSM_NAMESPACE_RANK", "JSM_NAMESPACE_SIZE", "JSM_NAMESPACE_LOCAL_RANK",
    "JSM_NAMESPACE_LOCAL_SIZE", "SLURM_PROCID", "SLURM_NTASKS",
    "SLURM_LOCALID", "SLURM_NTASKS_PER_NODE", "SLURM_JOB_NODELIST",
    "SLURM_STEP_NODELIST", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
    "OMPI_COMM_WORLD_LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_SIZE", "PMI_RANK",
    "PMI_SIZE", "MPI_LOCALRANKID", "MPI_LOCALNRANKS")


@pytest.fixture
def no_scheduler(monkeypatch):
    """No scheduler's variables; the environment as it was afterwards
    (``_maybe_cluster_autodetect`` writes ``os.environ`` itself)."""
    saved = dict(os.environ)
    for var in SCHEDULER_VARS:
        monkeypatch.delenv(var, raising=False)
    yield monkeypatch
    os.environ.clear()
    os.environ.update(saved)


def _both(fn_j, fn_t, *args):
    """``(jax result, port result)``, or the two exceptions' types and
    messages where both raise."""
    out = []
    for fn in (fn_j, fn_t):
        try:
            out.append(("ok", fn(*args)))
        except Exception as e:  # compared below, type name and message
            out.append(("raise", type(e).__name__, str(e)))
    return out


def _specs(specs):
    return [(s.hostname, s.slots) for s in specs]


def _slots(slots):
    return [s.to_response_string() for s in slots]


# --- host strings, hostfiles, assignments ----------------------------------

@pytest.mark.parametrize("text", [
    "h1:4,h2:4,h3", "[::1]:2,h", " a , b:3 ", "", "h1:x", "h1:0", ",,",
    "localhost:2,127.0.0.1:2"])
def test_parse_hosts_equals_jax(text):
    j, t = _both(lambda s: _specs(jhosts.parse_hosts(s)),
                 lambda s: _specs(thosts.parse_hosts(s)), text)
    assert j == t


@pytest.mark.parametrize("body", [
    "# training pod\ntpu-a slots=4\ntpu-b slots=2\ntpu-c\n",
    "a slots=1  # trailing comment\n\n b slots=3\n",
    "a slots=2 gpus=4\n", "# nothing\n", "a slots=0\n"])
def test_parse_hostfile_equals_jax(tmp_path, body):
    path = tmp_path / "hostfile"
    path.write_text(body)
    j, t = _both(lambda p: _specs(jhosts.parse_hostfile(p)),
                 lambda p: _specs(thosts.parse_hostfile(p)), str(path))
    assert j == t


@pytest.mark.parametrize("hosts,np", [
    ("a:2,b:2", 4), ("a:3,b:1", 4), ("a:4,b:4", 5), ("a:2", 3), ("a:2", 0),
    ("a:1,b:3,c:2", 6), ("a:2,b:2,c:2", 3)])
def test_host_assignments_equal_jax(hosts, np):
    j, t = _both(
        lambda: _slots(jhosts.get_host_assignments(
            jhosts.parse_hosts(hosts), np)),
        lambda: _slots(thosts.get_host_assignments(
            thosts.parse_hosts(hosts), np)))
    assert j == t


@pytest.mark.parametrize("hosts,min_np,max_np", [
    ("a:2,b:2", 2, None), ("a:2,b:2", 2, 3), ("a:1", 2, 4),
    ("a:4,b:4", 1, 6)])
def test_elastic_assignments_equal_jax(hosts, min_np, max_np):
    j, t = _both(
        lambda: _slots(jhosts.elastic_host_assignments(
            jhosts.parse_hosts(hosts), min_np, max_np)),
        lambda: _slots(thosts.elastic_host_assignments(
            thosts.parse_hosts(hosts), min_np, max_np)))
    assert j == t


@pytest.mark.parametrize("ips", [["10.0.0.1", "10.0.0.2", "10.0.0.1"],
                                 ["h"] * 4, ["b", "a", "b", "c"]])
def test_slots_from_ips_equal_jax(ips):
    assert _slots(thosts.slots_from_ips(ips)) == _slots(
        jhosts.slots_from_ips(ips))


# --- the command line and config files --------------------------------------

ARG_FIELDS = ("np", "hosts", "hostfile", "min_np", "max_np",
              "host_discovery_script", "ssh_port", "start_timeout",
              "output_filename", "coordinator_port", "slots_per_host",
              "reset_limit", "blacklist_cooldown_range", "verbose",
              "command", "launcher", "env")


@pytest.mark.parametrize("argv", [
    ["-np", "4", "-H", "h1:2,h2:2", "python", "train.py"],
    ["-np", "2", "--min-np", "1", "--max-np", "4",
     "--host-discovery-script", "./d.sh", "--", "python", "t.py"],
    ["--blacklist-cooldown-range", "2", "9", "--reset-limit", "3", "--",
     "x"],
    ["--launcher", "local", "--env", "A=1", "--env", "B=2", "cmd",
     "--verbose"],
    ["--verbose", "--start-timeout", "30", "cmd"]])
def test_parse_args_equal_jax(argv):
    j, t = jlaunch.parse_args(list(argv)), tlaunch.parse_args(list(argv))
    assert [getattr(t, f) for f in ARG_FIELDS] == [
        getattr(j, f) for f in ARG_FIELDS]
    assert t._config_env == j._config_env


@pytest.mark.parametrize("argv", [
    ["-np", "2", "--config-file", "c.yaml", "cmd", "--verbose"],
    ["--np", "2", "--", "--verbose"], ["--host-disc", "x", "cmd"],
    ["--blacklist-cooldown-range", "1", "2", "-np", "3", "cmd"],
    ["cmd", "-np", "4"], ["--hosts=a:2", "--verbose", "cmd"]])
def test_explicit_dests_equal_jax(argv):
    j = jlaunch._explicit_dests(argv, _parser_of(jlaunch))
    t = tlaunch._explicit_dests(argv, _parser_of(tlaunch))
    assert t == j


def _parser_of(mod):
    """The launcher's own parser, captured from ``parse_args``."""
    import argparse
    captured = []
    real = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        captured.append(self)
        return real(self, *a, **k)

    argparse.ArgumentParser.parse_args = grab
    try:
        mod.parse_args(["x"])
    finally:
        argparse.ArgumentParser.parse_args = real
    return captured[0]


@pytest.mark.parametrize("yaml_body,argv", [
    ("np: 8\nhosts: \"x:4,y:4\"\nparams:\n  fusion-threshold-mb: 64\n"
     "  cycle-time-ms: 2.5\n  cache-capacity: 16\n  hierarchical-allreduce: "
     "true\ntimeline:\n  filename: /tmp/tl.json\n  mark-cycles: true\n"
     "autotune:\n  enabled: true\n  warmup-samples: 3\nstall-check:\n"
     "  check-time-seconds: 30\n", ["cmd"]),
    ("np: 8\nmin-np: 2\n", ["-np", "2", "cmd"]),
    ("params:\n  bogus: 1\n", ["cmd"]),
    ("timeline: 3\n", ["cmd"]),
    ("- a\n- b\n", ["cmd"])])
def test_config_file_equals_jax(tmp_path, yaml_body, argv):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml_body)
    full = ["--config-file", str(cfg)] + argv
    j, t = _both(lambda: jlaunch.parse_args(list(full)),
                 lambda: tlaunch.parse_args(list(full)))
    if j[0] == "raise":
        assert t == j
        return
    assert [getattr(t[1], f) for f in ARG_FIELDS] == [
        getattr(j[1], f) for f in ARG_FIELDS]
    assert t[1]._config_env == j[1]._config_env
    assert tcfg.config_to_env(tcfg.load_config(str(cfg))) == \
        jcfg.config_to_env(jcfg.load_config(str(cfg)))


def test_launcher_flags_to_worker_knobs():
    args = tlaunch.parse_args(
        ["--disable-cache", "--timeline-filename", "/tmp/t.json",
         "--metrics-port", "9100", "--autotune", "--env", "X=1", "cmd"])
    assert tlaunch.extra_env(args) == {
        "HVD_CACHE_CAPACITY": "0", "HVD_TIMELINE": "/tmp/t.json",
        "HVD_METRICS_PORT": "9100", "HVD_AUTOTUNE": "1", "X": "1"}


# --- the worker environment --------------------------------------------------

TORCH_CONTRACT = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                  "MASTER_ADDR", "MASTER_PORT")


@pytest.mark.parametrize("hosts,np,index", [
    ("a:2,b:2", 4, 2), ("a:1", 1, 0), ("a:3,b:1", 4, 3)])
def test_worker_env_equals_jax_plus_torch_contract(hosts, np, index):
    kw = dict(coordinator_addr="10.0.0.1", coordinator_port=9778,
              kv_addr="10.0.0.9", kv_port=8000, secret="s3cr3t",
              extra={"HVD_ELASTIC": "1", "FOO": "bar"})
    jslot = jhosts.get_host_assignments(jhosts.parse_hosts(hosts), np)[index]
    tslot = thosts.get_host_assignments(thosts.parse_hosts(hosts), np)[index]
    j = jlaunch.worker_env(jslot, **kw)
    t = tlaunch.worker_env(tslot, card=index, **kw)
    seeded = {k: v for k, v in j.items()
              if k.startswith("HVD_") and k not in os.environ}
    assert {k: t[k] for k in seeded} == seeded
    assert t["FOO"] == j["FOO"] == "bar"
    assert t["PYTHONPATH"].split(os.pathsep)[0] == str(REPO)
    assert {k: t[k] for k in TORCH_CONTRACT} == {
        "RANK": j["HVD_RANK"], "WORLD_SIZE": j["HVD_SIZE"],
        "LOCAL_RANK": j["HVD_LOCAL_RANK"],
        "LOCAL_WORLD_SIZE": j["HVD_LOCAL_SIZE"],
        "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "9778"}
    assert t["HVD_CUDA_DEVICE"] == str(index)
    assert "HVD_CUDA_DEVICE" not in tlaunch.worker_env(tslot, **kw)


def test_ssh_command_equals_jax():
    env = {"HVD_RANK": "1", "HVD_SECRET_KEY": "topsecret", "A": "x y"}
    args = ("remote-host", ["python", "train.py"], env, 2222, "/id")
    t = tlaunch._ssh_command(*args)
    assert t == jlaunch._ssh_command(*args)
    assert "topsecret" not in " ".join(t)


@pytest.mark.parametrize("name", ["localhost", "127.0.0.1",
                                  "no-such-host.invalid"])
def test_is_local_host_equals_jax(name):
    assert tlaunch.is_local_host(name) == jlaunch.is_local_host(name)


# --- LSF allocations and scheduler worlds -------------------------------------

@pytest.mark.parametrize("env,rankfile", [
    ({"LSB_JOBID": "1"}, "nodeA\nnodeA\nnodeB\nnodeB\nnodeA\n"),
    ({"LSB_JOBID": "1", "LSB_MCPU_HOSTS": "nodeY 8"}, "nodeX\nnodeX\n"),
    ({"LSB_JOBID": "1", "LSB_MCPU_HOSTS": "nodeA 4 nodeB 2"}, None),
    ({"LSB_JOBID": "1", "LSB_MCPU_HOSTS": "batch1 1 c1 4 c2 4"}, None),
    ({"LSB_JOBID": "1", "LSB_HOSTS": "nodeB nodeB nodeA"}, None),
    ({"LSB_JOBID": "1", "LSB_HOSTS": "login1 login1"}, None),
    ({"LSB_JOBID": "1"}, "batch2\nworker1\nworker2\n"),
    ({"LSB_JOBID": "1"}, None)])
def test_lsf_host_specs_equal_jax(no_scheduler, tmp_path, env, rankfile):
    for k, v in env.items():
        no_scheduler.setenv(k, v)
    if rankfile is not None:
        path = tmp_path / "rankfile"
        path.write_text(rankfile)
        no_scheduler.setenv("LSB_DJOB_RANKFILE", str(path))
    assert tlsf.using_lsf() == jlsf.using_lsf()
    j, t = _both(lambda: _specs(jlsf.lsf_host_specs()),
                 lambda: _specs(tlsf.lsf_host_specs()))
    assert j == t


@pytest.mark.parametrize("env,argv", [
    ({"LSB_JOBID": "1", "LSB_MCPU_HOSTS": "nodeA 4"},
     ["--launcher", "local", "-np", "2", "--", "python", "t.py"]),
    ({}, ["--launcher", "lsf", "--", "python", "t.py"]),
    ({"LSB_JOBID": "1", "LSB_MCPU_HOSTS": "nodeZ 8"},
     ["-H", "me:2", "--", "python", "t.py"]),
    ({"LSB_JOBID": "1", "LSB_MCPU_HOSTS": "nodeA 1 nodeB 1"},
     ["--", "python", "t.py"]),
    ({"LSB_JOBID": "1"}, ["-np", "3", "--", "python", "t.py"]),
    ({}, ["--slots-per-host", "4", "-H", "a,b", "--", "x"]),
    ({}, ["-H", "a:1", "--hostfile", "f", "--", "x"])])
def test_resolve_hosts_equals_jax(no_scheduler, env, argv):
    for k, v in env.items():
        no_scheduler.setenv(k, v)
    j, t = _both(
        lambda: _specs(jlaunch._resolve_hosts(jlaunch.parse_args(argv))),
        lambda: _specs(tlaunch._resolve_hosts(tlaunch.parse_args(argv))))
    assert j == t


@pytest.mark.parametrize("env", [
    {}, {"JSM_NAMESPACE_SIZE": "4"},
    {"JSM_NAMESPACE_SIZE": "4", "JSM_NAMESPACE_RANK": "2"},
    {"SLURM_NTASKS": "8"}, {"SLURM_NTASKS": "8", "SLURM_PROCID": "3"},
    {"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1"},
    {"PMI_SIZE": "x", "PMI_RANK": "0"}])
def test_cluster_world_hint_equals_jax(no_scheduler, env):
    for k, v in env.items():
        no_scheduler.setenv(k, v)
    assert truntime._cluster_world_hint() == jruntime._cluster_world_hint()


@pytest.mark.parametrize("env,want", [
    ({"SLURM_NTASKS": "8", "SLURM_PROCID": "3", "SLURM_LOCALID": "1",
      "SLURM_NTASKS_PER_NODE": "4", "SLURM_JOB_NODELIST": "gpu[07-08]"},
     ("3", "8", "1", "4", "gpu07", "29500")),
    ({"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1",
      "OMPI_COMM_WORLD_LOCAL_RANK": "1", "OMPI_COMM_WORLD_LOCAL_SIZE": "2",
      "HVD_COORDINATOR_PORT": "9778"},
     ("1", "2", "1", "2", "127.0.0.1", "9778")),
    ({"PMI_SIZE": "4", "PMI_RANK": "0", "MASTER_ADDR": "10.1.1.1",
      "MASTER_PORT": "1234"}, ("0", "4", "0", "1", "10.1.1.1", "1234"))])
def test_cluster_autodetect_sets_torch_contract(no_scheduler, env, want):
    for k in TORCH_CONTRACT:
        no_scheduler.delenv(k, raising=False)
    for k, v in env.items():
        no_scheduler.setenv(k, v)
    assert truntime._maybe_cluster_autodetect()
    assert tuple(os.environ[k] for k in TORCH_CONTRACT) == want


def test_cluster_autodetect_needs_rank_zero_host(no_scheduler):
    for k in TORCH_CONTRACT:
        no_scheduler.delenv(k, raising=False)
    no_scheduler.setenv("PMI_SIZE", "4")
    no_scheduler.setenv("PMI_RANK", "1")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        truntime._maybe_cluster_autodetect()
    no_scheduler.setenv("RANK", "0")  # a launcher's contract wins
    assert not truntime._maybe_cluster_autodetect()


def test_cluster_autodetect_jsm_takes_first_compute_host(no_scheduler,
                                                          tmp_path):
    """jsrun: rank 0 is on the first compute host of the allocation, as
    the JAX package's ``_jsm_init_kwargs`` derives its coordinator."""
    for k in TORCH_CONTRACT:
        no_scheduler.delenv(k, raising=False)
    rankfile = tmp_path / "rankfile"
    rankfile.write_text("batch2\nworker1\nworker2\n")
    for k, v in {"LSB_JOBID": "1", "LSB_DJOB_RANKFILE": str(rankfile),
                 "JSM_NAMESPACE_SIZE": "2", "JSM_NAMESPACE_RANK": "1"}.items():
        no_scheduler.setenv(k, v)
    want = jruntime._jsm_init_kwargs()["coordinator_address"].split(":")[0]
    assert truntime._maybe_cluster_autodetect()
    assert os.environ["MASTER_ADDR"] == want == "worker1"


# --- the card pool --------------------------------------------------------------

class _Proc:
    def __init__(self):
        self.code = None

    def poll(self):
        return self.code


def test_card_pool_aliases_share_a_machine():
    """Two aliases of one machine, two slots each (how the tests grow and
    shrink a world on one host): four workers, four cards, never two on
    one; a card is free again once its worker exited."""
    pool = tlaunch.CardPool()
    procs, cards = {}, {}
    for host in ("localhost", "127.0.0.1", "localhost", "127.0.0.1"):
        def start(card, host=host):
            cards.setdefault(host, []).append(card)
            procs[card] = _Proc()
            return procs[card]
        pool.spawn(host, start)
    assert sorted(cards["localhost"] + cards["127.0.0.1"]) == [0, 1, 2, 3]
    procs[1].code = 0  # that worker exited
    assert pool.spawn("127.0.0.1", lambda card: _Proc() if card == 1
                      else pytest.fail(f"took card {card}, not the free 1"))
    with pytest.raises(OSError):
        pool.spawn("localhost", lambda card: (_ for _ in ()).throw(
            OSError("spawn failed")))
    # the failed spawn's card 4 is free again
    assert pool.spawn("localhost", lambda card: card) == 4
    remote = tlaunch.CardPool()
    assert remote.spawn("remote-a.invalid", lambda card: card) == 0
    assert remote.spawn("remote-b.invalid", lambda card: card) == 0


# --- real launches on gloo ---------------------------------------------------------

WORKER = textwrap.dedent("""\
    import os
    import torch
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    out = hvd.allreduce(torch.ones(4) * (hvd.rank() + 1), op=hvd.Sum)
    gathered = hvd.allgather(torch.tensor([float(hvd.rank())]))
    print("RESULT %d %d %s %s" % (hvd.rank(), hvd.size(), float(out[0]),
          gathered.tolist()), flush=True)
    print("CARD %s" % os.environ["HVD_CUDA_DEVICE"], flush=True)
    hvd.shutdown()
""")

JAX_WORKER = textwrap.dedent("""\
    import sys
    import horovod_tpu as hvd
    import jax.numpy as jnp
    hvd.init()
    out = hvd.allreduce(jnp.ones(4) * (hvd.rank() + 1), op=hvd.Sum)
    gathered = hvd.allgather(jnp.array([float(hvd.rank())]))
    sys.stdout.write("RESULT %d %d %s %s\\n" % (
        hvd.rank(), hvd.size(), float(out[0]), gathered.tolist()))
    sys.stdout.flush()
""")


def _lines(stdout: str, tag: str) -> list:
    return sorted(line.split(tag, 1)[1].strip()
                  for line in stdout.splitlines() if tag in line)


def test_static_launch_np2_equals_jax_loopback_launch(tmp_path):
    (tmp_path / "w.py").write_text(WORKER)
    (tmp_path / "jw.py").write_text(JAX_WORKER)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    port = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np", "2",
         "--", sys.executable, str(tmp_path / "w.py")],
        capture_output=True, text=True, timeout=180, env=env, cwd=REPO)
    assert port.returncode == 0, port.stdout + port.stderr
    ref = subprocess.run(
        [sys.executable, "-m", "horovod_tpu.runner.launch", "--loopback",
         "-np", "2", "--", sys.executable, str(tmp_path / "jw.py")],
        capture_output=True, text=True, timeout=180, env=env, cwd=REPO)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    got, want = _lines(port.stdout, "RESULT "), _lines(ref.stdout, "RESULT ")
    assert len(got) == 2 and got == want
    # one machine, two workers: cards 0 and 1
    assert _lines(port.stdout, "CARD ") == ["0", "1"]


def test_static_launch_failure_exit_code():
    code = tlaunch.run_commandline(
        ["-np", "2", "--", sys.executable, "-c", "import sys; sys.exit(3)"])
    assert code == 3
    assert tlaunch.run_commandline([]) == 2  # no command


def _scaled_rank(scale):
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    try:
        import torch
        out = hvd.allreduce(torch.tensor([float(hvd.rank())]), op=hvd.Sum)
        return hvd.rank() * scale, float(out[0]), hvd.size()
    finally:
        hvd.shutdown()


def _failing():
    raise ValueError("boom")


def test_runner_run_np2():
    import cloudpickle
    from horovod_tpu_torch import runner
    # the workers cannot import this module: its functions go by value
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    try:
        assert runner.run(_scaled_rank, args=(10,), np=2) == [
            (0, 1.0, 2), (10, 1.0, 2)]
        with pytest.raises(RuntimeError, match="boom"):
            runner.run(_failing, np=2)
    finally:
        cloudpickle.unregister_pickle_by_value(sys.modules[__name__])


def test_runner_run_without_cloudpickle_says_so(monkeypatch):
    from horovod_tpu_torch import runner
    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    with pytest.raises(RuntimeError, match="cloudpickle"):
        runner.run(_failing, np=1)
