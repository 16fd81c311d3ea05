"""The frozen yardstick: FLOP counts and bounds against hand-worked
values, the trace reader on a hand-made trace."""

from __future__ import annotations

import json

import pytest

from perfbench import readers
from perfbench.families import resnet, transformer_lm
from perfbench.frozen import roofline, tokens, trace, weights

GPT2_XL = {"n_embd": 1600, "n_inner": 6400, "n_layer": 48, "n_head": 25,
           "vocab_size": 50257, "compute_dtype": "bfloat16"}
RESNET50 = {"num_filters": 64, "stage_sizes": [3, 4, 6, 3], "expansion": 4,
            "num_classes": 1000, "image_size": 224}


def test_gpt2_xl_flops():
    # per layer 4 d^2 + 2 d f = 30.72 M; x 48 + the 80.41 M head
    assert transformer_lm.matmul_params(GPT2_XL) == 1_554_971_200
    per_token = 6 * transformer_lm.matmul_params(GPT2_XL) / 1e9
    assert per_token == pytest.approx(9.33, abs=0.005)
    step = transformer_lm.flops_per_step(
        GPT2_XL, {"batch_per_rank": 4, "seq_len": 1024})
    attn = 12 * 1600 * (1024 * 1025 // 2) * 48 * 4
    assert step == pytest.approx(6 * 1_554_971_200 * 4096 + attn)


def test_resnet50_flops():
    # 4.09 G multiply-adds a 224x224 image, the dense layer included
    assert resnet._conv_flops(RESNET50) / 2 == pytest.approx(4.089e9,
                                                            rel=1e-3)
    assert resnet.flops_per_step(RESNET50, {"batch_per_rank": 256}) == \
        pytest.approx(3 * 256 * resnet._conv_flops(RESNET50))


def test_k1_bound_as_in_the_kernel_table():
    # PERF.md's K1 row: bh 64, s 2048, d 64, bf16, causal: 0.036 ms by
    # bytes (119.5 MB; 34.4 GFLOP)
    bh, s, d = 64, 2048, 64
    pairs = bh * roofline.unmasked_pairs(s, s, 0, 0, True)
    work = roofline.flash_work(bh, s, s, d, pairs, 2)
    flops, nbytes = work["flash_fwd"]
    assert flops == pytest.approx(34.4e9, rel=2e-3)
    assert nbytes == pytest.approx(119.5e6, rel=1e-3)
    ms, by = roofline.bound_ms(flops, nbytes)
    assert ms == pytest.approx(0.036, abs=5e-4) and by == "bytes"
    ms, by = roofline.bound_ms(*work["flash_bwd_dkv"])
    assert ms == pytest.approx(0.070, abs=5e-4) and by == "operations"


@pytest.mark.parametrize("sq,sk,q0,k0,causal", [
    (13, 11, 3, 0, True), (13, 11, 3, 0, False), (64, 64, 0, 0, True),
    (8, 16, 0, 8, True), (16, 8, 8, 0, True), (5, 5, 0, 10, True)])
def test_unmasked_pairs_by_brute_force(sq, sk, q0, k0, causal):
    want = sum(1 for i in range(sq) for j in range(sk)
               if not causal or k0 + j <= q0 + i)
    assert roofline.unmasked_pairs(sq, sk, q0, k0, causal) == want


def test_tokens_are_seeded_and_differ_by_stream():
    a = tokens.synthetic_tokens(4, 32, 100, [2**31 + 7, 0, 0])
    b = tokens.synthetic_tokens(4, 32, 100, [2**31 + 7, 0, 0])
    c = tokens.synthetic_tokens(4, 32, 100, [2**31 + 7, 1, 0])
    assert (a == b).all() and not (a == c).all()
    assert a.min() >= 0 and a.max() < 100


def _chrome(path, device, host):
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": s, "dur": e - s}
              for n, s, e in device]
    events += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": s,
                "dur": e - s} for n, s, e in host]
    events.append({"ph": "i", "cat": "kernel", "name": "instant", "ts": 1})
    path.write_text(json.dumps({"traceEvents": events}))


def test_trace_union_with_overlapping_nccl(tmp_path):
    # compute 0-10 and 12-20 on one stream; NCCL 5-15 on another;
    # idle 20-25 and 28-30
    device = [("gemm", 0, 10), ("gemm", 12, 20),
              ("ncclDevKernel_AllReduce", 5, 15), ("adam", 25, 28)]
    host = [("perfbench.step", 0, 30), ("perfbench.optimizer_step", 19, 27)]
    path = tmp_path / "t.json"
    _chrome(path, device, host)
    t = trace.load(str(path))
    assert len(t["device"]) == 4 and len(t["host"]) == 2
    dev = [(s, e) for _, s, e in t["device"]]
    assert trace.union(dev) == [(0, 20), (25, 28)]
    assert trace.measure(dev) == 23  # summing would give 31
    assert trace.gaps(dev, 0, 30) == [(20, 25), (28, 30)]
    assert trace.innermost(t["host"], [40, 22, 5]) == [
        "host idle", "perfbench.optimizer_step", "perfbench.step"]

    lead = {"rank": 0, "world": 1, "trace": t, "profiled": [3, 4, 5, 6],
            "steps": 10, "work": {"unit": "tokens", "flash": {}}}
    art = readers.Artefacts({}, {}, {}, [lead])
    busy, window = readers.busy_window_s(art)
    # the block ends with its last device operation
    assert busy == pytest.approx(23e-6) and window == pytest.approx(28e-6)
    assert readers.idle_pct(art) == pytest.approx(100 * 5 / 28)
    assert readers.roofline_pct(art, ("flash_fwd",)) is None
    bd = readers.breakdown(art)
    assert bd["device_ops"][0] == ["gemm", pytest.approx(18e-6)]
    assert bd["idle_gaps"] == [["perfbench.optimizer_step",
                                pytest.approx(5e-6)]]


def test_roofline_reads_flash_launches():
    work = {"flash_fwd": (4e9, 1e6)}  # 4.04 us bound by operations
    t = {"device": [("void hvdflash::flash_fwd_tc_kernel<64>", 0, 8.09),
                    ("void hvdflash::flash_fwd_tc_kernel<64>", 10, 18.09),
                    ("gemm", 20, 30)], "host": []}
    lead = {"rank": 0, "trace": t, "work": {"unit": "tokens",
                                            "flash": work,
                                            "dtype": "bfloat16"}}
    art = readers.Artefacts({}, {}, {}, [lead])
    assert readers.roofline_pct(art, ("flash_fwd",)) == pytest.approx(
        100 * 2 * (4e9 / 989e12 * 1e3) / (16.18e-3), rel=1e-6)


def test_weights_are_seeded_and_change_norms_regenerate():
    import torch
    spec = [("a", (3, 5), ("normal", 0.5)), ("b", (4,), ("ones",)),
            ("c", (2, 2), ("normal", 2.0))]
    p = {n: torch.empty(s) for n, s, _ in spec}
    q = {n: torch.empty(s) for n, s, _ in spec}
    weights.fill(p, spec, 2**31 + 3)
    weights.fill(q, spec, 2**31 + 3)
    assert all(torch.equal(p[n], q[n]) for n in p)
    assert torch.equal(p["b"], torch.ones(4))
    assert weights.change_norms(p, spec, 2**31 + 3) == {
        "a": 0.0, "b": 0.0, "c": 0.0}
    p["c"] += 1.0
    assert weights.change_norms(p, spec, 2**31 + 3)["c"] == pytest.approx(2)
