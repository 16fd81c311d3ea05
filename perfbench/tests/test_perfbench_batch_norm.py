"""The reader of ``batch_norm_ms.convnet`` on synthetic Chrome traces laid
out as ``torch.profiler`` writes them: the device milliseconds of the
``hvdbn`` launches a traced step, and None where there are none."""

from __future__ import annotations

import pytest

from perfbench import manifest, readers
from perfbench.frozen import trace
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_frozen import _chrome

MS = 1000.0  # the trace's microseconds a millisecond
STEPS = [("perfbench.step", 0, 15 * MS), ("perfbench.step", 15 * MS, 30 * MS)]
OTHER = [("sm90_xmma_fprop_implicit_gemm_bf16", 0, 6 * MS),
         ("elementwise_kernel", 12 * MS, 13 * MS)]
# 1.5 + 0.5 + 2 + 0.25 ms of BatchNorm kernels over the two steps
HVDBN = [("void hvdbn::stats_partial<__nv_bfloat16, 8>(...)", 6 * MS,
          7.5 * MS),
         ("void hvdbn::stats_final<float>(...)", 7.5 * MS, 8 * MS),
         ("void hvdbn::bwd_dx<__nv_bfloat16, __nv_bfloat16, 8>(...)",
          16 * MS, 18 * MS),
         ("void hvdbn::norm_kernel<__nv_bfloat16, __nv_bfloat16, 1>(...)",
          20 * MS, 20.25 * MS)]


def _read(tmp_path, device, traced=True):
    lead = {"rank": 0, "work": {}}
    if traced:
        path = tmp_path / "t.json"
        _chrome(path, device, STEPS)
        lead["trace"] = trace.load(str(path))
    art = readers.Artefacts({}, {}, {}, [lead])
    return manifest.Bench(tiny.REPO).reader("batch_norm_ms.convnet").read(art)


def test_batch_norm_ms_reads_hvdbn_launches_per_step(tmp_path):
    assert _read(tmp_path, OTHER + HVDBN) == pytest.approx(4.25 / 2)


def test_batch_norm_ms_is_silent_without_hvdbn_launches(tmp_path):
    assert _read(tmp_path, OTHER) is None  # the parent's trace
    assert _read(tmp_path, OTHER + HVDBN, traced=False) is None


def test_batch_norm_ms_is_listed_for_the_convnet_cell():
    entry = next(m for m in manifest.Bench(tiny.REPO).spec["per_layer"]
                 if m["name"] == "batch_norm_ms.convnet")
    assert entry["workloads"] == ["resnet50.b256"]
    assert entry["moves"] == "train_images_per_s"
    assert entry["source"] == "device_trace"
