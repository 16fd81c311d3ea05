"""The spans of the port's gradient sync and optimizer (``timeline.span``
at the boundaries of ``optim/__init__.py`` and the fusion cycle), at a
gloo world of one on the CPU: under ``torch.profiler``, on the timeline,
and with both off, where no span may build a ``record_function``.

The model's gradients fill three buckets at ``HVD_BUCKET_BYTES=600``
(float32 leaves of 16, 256 and 64 bytes; 1024; 64 and 512, taken from
the last layer back)."""

import collections
import json

import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch import timeline

SYNC_SPANS = ("BUCKET_START", "SYNC_WAIT", "SYNC_UNPACK")


@pytest.fixture(scope="module")
def world1():
    thvd.init(device="cpu")
    yield
    thvd.shutdown()


@pytest.fixture()
def trainer(world1, monkeypatch):
    monkeypatch.setenv("HVD_BUCKET_BYTES", "600")
    torch.manual_seed(0)
    model = torch.nn.Sequential(
        torch.nn.Linear(8, 16), torch.nn.Tanh(), torch.nn.Linear(16, 16),
        torch.nn.Tanh(), torch.nn.Linear(16, 4))
    opt = thvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-2),
        named_parameters=model.named_parameters())
    assert len(opt.stats["bucket_bytes"]) == 3
    x = torch.linspace(-1, 1, 40).reshape(5, 8)

    def step():
        opt.zero_grad()
        model(x).pow(2).sum().backward()
        opt.step()

    return model, opt, step


def test_a_profiled_step_spans_each_bucket(trainer):
    _, opt, step = trainer
    step()  # the first step builds the dispatch plans
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step()
    spans = collections.defaultdict(list)
    for e in prof.events():
        if e.name.startswith("hvd.") and e.name.endswith(".optimizer"):
            spans[e.name].append((e.time_range.start, e.time_range.end))
    n = len(opt.stats["bucket_bytes"])
    assert {k: len(v) for k, v in spans.items()} == {
        **{f"hvd.{a}.optimizer": n for a in SYNC_SPANS},
        "hvd.OPTIMIZER_STEP.optimizer": 1}
    waits = sorted(spans["hvd.SYNC_WAIT.optimizer"])
    unpacks = sorted(spans["hvd.SYNC_UNPACK.optimizer"])
    for (_, wait_end), (unpack_start, _) in zip(waits, unpacks):
        assert unpack_start >= wait_end
    # a bucket's wait comes after every bucket has started
    starts = spans["hvd.BUCKET_START.optimizer"]
    assert waits[0][0] >= max(end for _, end in starts)


def test_spans_off_build_no_record_function(trainer, monkeypatch):
    model, _, step = trainer
    assert not timeline.timeline_active()

    def refuse(*args, **kwargs):
        raise AssertionError("a span built a record_function")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before = [p.detach().clone() for p in model.parameters()]
    step()
    step()
    assert all(not torch.equal(a, p) for a, p in zip(before,
                                                      model.parameters()))


def test_timeline_holds_the_sync_and_issue_ranges(trainer, tmp_path):
    _, opt, step = trainer
    path = tmp_path / "t.json"
    timeline.start_timeline(str(path))
    try:
        step()
    finally:
        timeline.stop_timeline()
    events = json.loads(path.read_text())
    lanes = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    got = collections.Counter((lanes[e["tid"]], e["name"], e["ph"])
                              for e in events if e["ph"] in ("B", "E"))
    n = len(opt.stats["bucket_bytes"])
    for activity in SYNC_SPANS:
        for ph in "BE":
            assert got[("optimizer", activity, ph)] == n
    assert got[("optimizer", "OPTIMIZER_STEP", "B")] == 1
    issues = got[("pipeline", "PIPELINE_ISSUE", "B")]
    assert issues >= n and got[("pipeline", "PIPELINE_ISSUE", "E")] == issues


def test_expert_layer_spans_and_row_counters():
    """The dropless expert layer under the profiler: its route, its
    grouped GEMMs and its combine as ``hvd.ROUTE.moe``, ``hvd.EXPERTS.moe``
    and ``hvd.COMBINE.moe`` (forward: one each; backward: the GEMMs run
    again and then their gradients, the combine's weights' gradient and
    then the tokens'), and its device tally in ``metrics_dump()``: each
    held expert's rows of a seeded routing, and the largest over the
    mean."""
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.parallel import moe
    g = torch.Generator().manual_seed(7)
    tokens, d, f = 30, 16, 8
    x = torch.randn((tokens, d), generator=g).requires_grad_()
    idx, w, _ = moe.route_sigmoid_top_k(torch.randn((tokens, 8), generator=g),
                                        torch.zeros(8), 2)
    gu = torch.randn((4, 2 * f, d), generator=g).requires_grad_()
    dn = torch.randn((4, d, f), generator=g).requires_grad_()
    metrics.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        moe.held_experts(x, idx, w, gu, dn, 4, layer="blocks.1").sum() \
            .backward()
    spans = collections.Counter(e.name for e in prof.events()
                                if e.name.endswith(".moe"))
    assert spans == {"hvd.ROUTE.moe": 1, "hvd.EXPERTS.moe": 3,
                     "hvd.COMBINE.moe": 3}
    dump = thvd.metrics_dump()
    rows = {s["labels"]["expert"]: s["value"]
            for s in dump["hvd_moe_expert_rows_total"]["series"]
            if s["labels"]["layer"] == "blocks.1"}
    want = {str(e): float((idx == e).sum()) for e in range(4, 8)}
    assert rows == want and sum(want.values()) > 0
    imb = [s["value"] for s in dump["hvd_moe_expert_imbalance"]["series"]
           if s["labels"]["layer"] == "blocks.1"]
    assert imb == [pytest.approx(max(want.values()) * 4
                                 / sum(want.values()))]
    metrics.reset()
