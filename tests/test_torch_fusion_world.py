"""The fusion cycle, the pipelined executor and step capture across real
worlds of processes (gloo, CPU). Each world is started once for the
module; its rank side is a function of this file, which imports nothing
of JAX (the card's ``tests/test_torch_cuda.py`` runs the same functions
over NCCL).

* **Issue order** (world 2): rank 1's executor sleeps 50 ms before every
  flush (``HVD_FAULT_SPEC`` ``exec.delay``) while both ranks' threads
  interleave bucket flushes with Ulysses all-to-alls on the same
  communicator. A collective issued outside the cycle waits for the
  batches submitted before it, so both ranks log the same issue order and
  nothing hangs; the results are exact.
* **The trainer under capture** (worlds 2 and 4): the small
  ``TransformerLM`` with Ulysses attention over the world and a bucketed
  ``DistributedOptimizer(Adam)``, trained with capture off and then on
  from the same seed: the first pass records, later ones replay, and the
  parameters are bitwise the capture-off run's.
* **Under the negotiation service** (world 2, a KV store): every replayed
  step takes exactly one ``negotiate_step`` round, and the parameters are
  again bitwise the eager run's.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_world2 import run_world

STEPS = 4
DELAY = "exec.delay:delay=0.05:rank=1"


def _issue_log():
    """Log every allreduce and all-to-all issue of this process, in
    order: ``(kind, numel)``."""
    import torch.distributed as dist
    log = []
    real_ar, real_a2a = dist.all_reduce, dist.all_to_all_single

    def all_reduce(t, *a, **kw):
        log.append(("ar", t.numel()))
        return real_ar(t, *a, **kw)

    def all_to_all_single(out, x, *a, **kw):
        log.append(("a2a", x.numel()))
        return real_a2a(out, x, *a, **kw)

    dist.all_reduce, dist.all_to_all_single = all_reduce, all_to_all_single
    return log


def train(hvd, steps: int, capture: bool, seed: int = 0,
          full: bool = False) -> dict:
    """The trainer, ``steps`` steps with its gradients kept in place: on
    the host the small ``TransformerLM`` with Ulysses attention over the
    world (float32); with ``full``, on the card, the full-width defaults
    (bf16, ulysses over a group of one) data-parallel on 8 x 2048 tokens a
    rank. Returns the parameters after the steps, the losses, the capture
    stats and the step (a callable that trains one more step)."""
    import torch.distributed as dist

    from horovod_tpu_torch.examples.long_context_lm import (
        MODELS, synthetic_tokens)
    from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                          lm_loss)
    from horovod_tpu_torch.ops import dispatch_cache, fusion_cycle

    os.environ["HVD_STEP_CAPTURE"] = "1" if capture else "0"
    fusion_cycle.reset()
    dispatch_cache.reset()
    n, rank, dev = hvd.size(), hvd.rank(), hvd.device()
    if full:
        cfg = TransformerConfig(attn_mode="ulysses")
        model = TransformerLM(cfg, device=dev)
        tokens = torch.from_numpy(np.random.default_rng(rank).integers(
            0, cfg.vocab_size, size=(8, 2048))).to(dev)
    else:
        seq = 16 * n
        widths, _ = MODELS["small"]
        cfg = TransformerConfig(**{**widths, "dtype": torch.float32},
                                max_seq_len=seq, attn_mode="ulysses")
        model = TransformerLM(cfg, device=dev, seq_group=dist.group.WORLD)
        block = seq // n
        tokens = torch.from_numpy(synthetic_tokens(2, seq, cfg.vocab_size)[
            :, rank * block:(rank + 1) * block])
    model.reset_parameters(torch.Generator().manual_seed(seed))
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3))

    def step() -> float:
        opt.zero_grad(set_to_none=False)
        loss = lm_loss(model(tokens), tokens)
        with torch.profiler.record_function("backward"):
            loss.backward()
        opt.step()
        return float(loss)

    losses = [step() for _ in range(steps)]
    params = torch.cat([p.detach().reshape(-1).float()
                        for p in model.parameters()])
    return {"params": params.cpu().numpy().copy(),
            "losses": np.asarray(losses),
            "capture": hvd.fusion_stats()["capture"],
            "buckets": len(opt.stats["bucket_bytes"]), "step": step}


def _order_rank(out_path: str) -> None:
    """Bucket flushes and all-to-alls interleaved on one communicator,
    under a delayed executor: the issue log, and the results."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.sequence import _all_to_all

    hvd.init(device="cpu")
    try:
        r, n = hvd.rank(), hvd.size()
        log = _issue_log()
        handles, outs = [], {}
        for k in range(6):
            h = hvd.grouped_allreduce_async(
                [torch.full((3 + k,), float(r + k)),
                 torch.full((2,), float(k))], op=hvd.Sum)
            h.flush()
            handles.append(h)
            buf = torch.arange(n * 4, dtype=torch.float32) + 100 * r + k
            outs[f"a2a{k}"] = _all_to_all(buf.reshape(n, 4), None).numpy()
        for k, h in enumerate(handles):
            a, b = h.synchronize()
            outs[f"ar{k}"] = torch.cat([a, b]).numpy()
        outs["log"] = np.asarray(repr(log))
        outs["flushes"] = hvd.fusion_stats()["flushes"]["bucket"]
        np.savez(out_path, **outs)
    finally:
        hvd.shutdown()


def _capture_rank(out_path: str) -> None:
    """The trainer with capture off, then on, from one seed."""
    import horovod_tpu_torch as hvd

    os.environ["HVD_BUCKET_BYTES"] = str(64 * 1024)  # several buckets
    hvd.init(device="cpu")
    try:
        off = train(hvd, STEPS, capture=False)
        on = train(hvd, STEPS, capture=True)
        st = on["capture"]
        np.savez(out_path, off=off["params"], on=on["params"],
                 off_losses=off["losses"], on_losses=on["losses"],
                 recorded=st["recorded_steps"], replayed=st["replayed_steps"],
                 fallbacks=st["fallbacks"], buckets=on["buckets"])
    finally:
        hvd.shutdown()


def _svc_capture_rank(out_path: str) -> None:
    """The trainer under the negotiation service, capture off then on:
    ``negotiate_step`` rounds and busy rounds a step."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import engine_service

    os.environ["HVD_BUCKET_BYTES"] = str(64 * 1024)
    hvd.init(device="cpu")
    try:
        svc = engine_service.get_service()
        off = train(hvd, STEPS, capture=False)
        steps0, rounds0 = svc.step_negotiations, svc.rounds
        on = train(hvd, STEPS, capture=True)
        st = on["capture"]
        np.savez(out_path, off=off["params"], on=on["params"],
                 replayed=st["replayed_steps"], fallbacks=st["fallbacks"],
                 step_rounds=svc.step_negotiations - steps0,
                 busy_rounds=svc.rounds - rounds0)
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def order_world(tmp_path_factory):
    return run_world("_order_rank", tmp_path_factory.mktemp("order"), 2,
                     module="test_torch_fusion_world",
                     env={"HVD_FAULT_SPEC": DELAY})


def test_issue_order_equal_under_a_delayed_executor(order_world):
    r0, r1 = order_world
    log = eval(str(r0["log"]))
    assert str(r0["log"]) == str(r1["log"])
    assert [k for k, _ in log].count("ar") == 6
    assert [k for k, _ in log].count("a2a") == 6
    assert int(r0["flushes"]) == int(r1["flushes"]) == 6


def test_interleaved_results_are_exact(order_world):
    for res in order_world:
        for k in range(6):
            want = np.concatenate([np.full(3 + k, 1.0 + 2 * k),
                                   np.full(2, 2.0 * k)])
            np.testing.assert_array_equal(res[f"ar{k}"], want)
    for r, res in enumerate(order_world):
        for k in range(6):
            got = res[f"a2a{k}"]
            want = np.stack([np.arange(r * 4, r * 4 + 4) + 100 * s + k
                             for s in range(2)]).astype(np.float32)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [2, 4])
def test_trainer_capture_bitwise_equal_to_eager(tmp_path, size):
    ranks = run_world("_capture_rank", tmp_path, size,
                      module="test_torch_fusion_world")
    for res in ranks:
        assert int(res["buckets"]) >= 2
        assert int(res["recorded"]) == 1
        assert int(res["replayed"]) == STEPS - 1
        assert int(res["fallbacks"]) == 0
        np.testing.assert_array_equal(res["on"], res["off"])
        np.testing.assert_array_equal(res["on_losses"], res["off_losses"])
    np.testing.assert_array_equal(ranks[0]["on"], ranks[-1]["on"])


def test_negotiated_capture_takes_one_step_round(tmp_path):
    ranks = run_world("_svc_capture_rank", tmp_path, 2,
                      module="test_torch_fusion_world", kv=True)
    for res in ranks:
        assert int(res["replayed"]) == STEPS - 1
        assert int(res["fallbacks"]) == 0
        assert int(res["step_rounds"]) == int(res["replayed"])
        np.testing.assert_array_equal(res["on"], res["off"])


# --------------------------------------------------------------------------
# the same over NCCL, four cards a world (tests/test_torch_cuda.py)
# --------------------------------------------------------------------------

CARD_TURNS = 3  # capture off/on pairs of timed steps


def _timed_turns(hvd, step, profile_rank0: bool) -> dict:
    """The step with capture off and on in turns (``CARD_TURNS`` pairs):
    each step's ms, and on rank 0 one profiled step of each mode with the
    backward pass's last kernel against the first NCCL kernel."""
    import tempfile
    import time

    from horovod_tpu_torch import testing
    out = {"off": [], "on": [], "overlap": {}}
    for turn in ["off", "on"] * CARD_TURNS:
        os.environ["HVD_STEP_CAPTURE"] = "1" if turn == "on" else "0"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        out[turn].append((time.perf_counter() - t0) * 1e3)
    if profile_rank0:
        from torch.profiler import ProfilerActivity, profile
        for turn in ("off", "on"):
            os.environ["HVD_STEP_CAPTURE"] = "1" if turn == "on" else "0"
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                out["overlap"][turn] = testing.backward_overlap(path)
    else:  # the same collectives on every rank
        for turn in ("off", "on"):
            os.environ["HVD_STEP_CAPTURE"] = "1" if turn == "on" else "0"
            step()
            torch.cuda.synchronize()
    return out


def _card_capture_rank(out_path: str) -> None:
    """The full-width trainer over NCCL, capture off twice (its own
    spread) and on, from one seed; then its step off and on in turns."""
    import json

    import horovod_tpu_torch as hvd

    hvd.init()
    try:
        off = train(hvd, STEPS, capture=False, full=True)
        again = train(hvd, STEPS, capture=False, full=True)
        on = train(hvd, STEPS, capture=True, full=True)
        turns = _timed_turns(hvd, on["step"], hvd.rank() == 0)
        st = hvd.fusion_stats()["capture"]
        np.savez(out_path, off=off["params"], again=again["params"],
                 on=on["params"], losses=on["losses"],
                 capture=json.dumps(on["capture"]),
                 turn_fallbacks=st["fallbacks"],
                 turns=json.dumps(turns))
    finally:
        hvd.shutdown()


def _card_svc_capture_rank(out_path: str) -> None:
    """The full-width trainer under the negotiation service: capture off
    (the flat negotiated step) and on, in turns; busy rounds and
    ``negotiate_step`` rounds a step of each mode."""
    import json
    import time

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import engine_service

    hvd.init()
    try:
        svc = engine_service.get_service()
        run = train(hvd, 2, capture=True, full=True)  # records, replays
        step = run["step"]
        out = {m: {"ms": [], "rounds": [], "step_rounds": []}
               for m in ("off", "on")}
        for turn in ["off", "on"] * CARD_TURNS:
            os.environ["HVD_STEP_CAPTURE"] = "1" if turn == "on" else "0"
            torch.cuda.synchronize()
            r0, s0 = svc.rounds, svc.step_negotiations
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            out[turn]["ms"].append((time.perf_counter() - t0) * 1e3)
            out[turn]["rounds"].append(svc.rounds - r0)
            out[turn]["step_rounds"].append(svc.step_negotiations - s0)
        np.savez(out_path, turns=json.dumps(out),
                 capture=json.dumps(hvd.fusion_stats()["capture"]),
                 losses=run["losses"])
    finally:
        hvd.shutdown()
