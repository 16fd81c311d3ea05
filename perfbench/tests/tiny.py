"""A checkout of the benchmark with tiny cells beside the real ones, for
the CPU tests: a copy of ``perfbench/`` and a ``BENCHMARK.json`` with
added entries, made under a test's temporary directory. Adding the tiny
cells edits no file of the copy: it only adds files and entries."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_CONFIGS = {
    "gpt2-tiny": {
        "family": "transformer_lm", "vocab_size": 256, "n_positions": 64,
        "n_embd": 128, "n_layer": 2, "n_head": 2, "n_inner": 512,
        "initializer_range": 0.02, "layer_norm_epsilon": 1e-6,
        "compute_dtype": "bfloat16", "attn_mode": "ulysses",
        "optimizer": {"kind": "adam", "lr": 2e-4, "betas": [0.9, 0.999],
                      "eps": 1e-8}},
    "resnet-tiny": {
        "family": "resnet", "stage_sizes": [1, 1], "num_filters": 8,
        "expansion": 4, "num_classes": 10, "image_size": 32,
        "batch_norm_epsilon": 1e-5, "compute_dtype": "float32",
        "optimizer": {"kind": "sgd", "lr": 0.1, "momentum": 0.9}},
}
TINY_TRAFFIC = {
    "lm_tiny": {"kind": "lm_tokens", "ranks": 1, "batch_per_rank": 2,
                "seq_len": 64},
    "lm_tiny_dp2": {"kind": "lm_tokens", "ranks": 2, "batch_per_rank": 2,
                    "seq_len": 64},
    "lm_tiny_dp4": {"kind": "lm_tokens", "ranks": 4, "batch_per_rank": 2,
                    "seq_len": 64},
    "images_tiny": {"kind": "images", "ranks": 1, "batch_per_rank": 8},
}
TINY_CELLS = [
    {"name": "tiny.lm", "config": "gpt2-tiny", "traffic": "lm_tiny",
     "chips": 1, "why": "tiny"},
    {"name": "tiny.lm.dp2", "config": "gpt2-tiny", "traffic": "lm_tiny_dp2",
     "chips": 2, "why": "tiny, two ranks"},
    {"name": "tiny.lm.dp4", "config": "gpt2-tiny", "traffic": "lm_tiny_dp4",
     "chips": 4, "why": "tiny, four ranks"},
    {"name": "tiny.convnet", "config": "resnet-tiny",
     "traffic": "images_tiny", "chips": 1, "why": "tiny"},
]
# limits for the tiny cells, set as the real cells' are: above what the
# program reads over seeds, below what the fp8 control reads. The tiny
# ResNet has two stages (its last at 4x4: BatchNorm over a channel's 128
# values; at 1x1 the 8 values of a channel amplify rounding past any
# useful limit) and computes in float32, so its program reads float32
# rounding.
TINY_LIMITS = {
    "tiny.lm": {"loss_gap": 1e-4, "grad_gap": 5e-3, "change_gap": 2e-3},
    "tiny.lm.dp2": {"loss_gap": 1e-4, "grad_gap": 5e-3, "change_gap": 2e-3},
    "tiny.lm.dp4": {"loss_gap": 1e-4, "grad_gap": 5e-3, "change_gap": 2e-3},
    "tiny.convnet": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3},
}


def make(tmp: Path) -> Path:
    """A checkout root under ``tmp`` holding the tiny cells."""
    root = Path(tmp) / "checkout"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec = copy.deepcopy(spec)
    for name, cfg in TINY_CONFIGS.items():
        path = f"perfbench/configs/{name}.json"
        (root / path).write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "test",
                                "file": path, "reduced": [], "why": "test"})
    for name, t in TINY_TRAFFIC.items():
        (root / "perfbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(t))
    for cell in TINY_CELLS:
        spec["workloads"].append(cell)
        (root / "perfbench" / "limits" / f"{cell['name']}.json").write_text(
            json.dumps({"limits": TINY_LIMITS[cell["name"]]}))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            lm = any(x.startswith("gpt2") for x in m["workloads"])
            m["workloads"] = m["workloads"] + [
                c["name"] for c in TINY_CELLS
                if (c["config"] == "gpt2-tiny") == lm]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
