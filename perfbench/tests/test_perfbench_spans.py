"""The readers of the program's spans (``perfbench/spans.py`` and the six
metric files over it) on synthetic Chrome traces laid out as
``torch.profiler`` writes them: each returns its known number where the
spans are there, and None where they are not."""

from __future__ import annotations

import pytest

from perfbench import manifest, readers
from perfbench.frozen import trace
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_frozen import _chrome

MS = 1000.0  # the trace's microseconds a millisecond
# two steps over 0-30 ms; the card busy 0-10, 12-20 and 25-28, so idle
# 10-12 and 20-25 (7 ms) up to the block's end at the last device end
DEVICE = [("gemm", 0, 10 * MS), ("gemm", 12 * MS, 20 * MS),
          ("adam", 25 * MS, 28 * MS)]
STEPS = [("perfbench.step", 0, 15 * MS), ("perfbench.step", 15 * MS, 30 * MS),
         ("perfbench.backward", 1 * MS, 14 * MS)]
SPANS = [("hvd.BUCKET_START.optimizer", 9 * MS, 11 * MS),
         ("hvd.BUCKET_START.optimizer", 13 * MS, 14 * MS),
         ("hvd.SYNC_WAIT.optimizer", 19 * MS, 22 * MS),
         ("hvd.SYNC_UNPACK.optimizer", 22 * MS, 23 * MS),
         ("hvd.OPTIMIZER_STEP.optimizer", 23.5 * MS, 26 * MS),
         ("hvd.PIPELINE_PACK.pipeline", 10 * MS, 12 * MS)]
# each metric's number: ms a step (two steps), or the share of the 7 ms
# idle in the union of the optimizer lane's spans (10-11, 20-23, 23.5-25)
WANT = {"bucket_handoff_ms.lm": 1.5, "sync_wait_ms.lm": 1.5,
        "sync_wait_ms.convnet": 1.5, "sync_unpack_ms.lm": 0.5,
        "optimizer_launch_ms.lm": 1.25,
        "idle_in_sync_pct.lm": 100.0 * 5.5 / 7.0}


def _art(tmp_path, host, traced=True):
    lead = {"rank": 0, "work": {}}
    if traced:
        path = tmp_path / "t.json"
        _chrome(path, DEVICE, host)
        lead["trace"] = trace.load(str(path))
    return readers.Artefacts({}, {}, {}, [lead])


@pytest.mark.parametrize("metric", sorted(WANT))
def test_span_reader_reads_its_number(tmp_path, metric):
    read = manifest.Bench(tiny.REPO).reader(metric).read
    assert read(_art(tmp_path, STEPS + SPANS)) == pytest.approx(WANT[metric])


@pytest.mark.parametrize("metric", sorted(WANT))
def test_span_reader_is_silent_without_its_spans(tmp_path, metric):
    read = manifest.Bench(tiny.REPO).reader(metric).read
    assert read(_art(tmp_path, STEPS)) is None  # the parent's trace
    assert read(_art(tmp_path, STEPS + SPANS, traced=False)) is None
