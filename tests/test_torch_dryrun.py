"""The dry run (``python -m repro_torch.launch.dryrun``) at full size on
the CPU: meta tensors, one rank of pod1 (``data`` 16 x ``model`` 16).

``run_cell`` on qwen2.5-14b decode_32k, mixtral-8x22b train_4k (remat
"full") and zamba2-2.7b long_500k gives the reference's record keys with
the port's counts, and a skipped cell (long_500k on a full-attention
architecture) the reference's reason; ``main`` writes the records where
``--out`` says and exits 0, or 1 when a cell fails.
"""

import json

import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro_torch.configs import SHAPES, cell_applicable, get_config
from repro_torch.launch import dryrun

KEYS = {"arch", "shape", "mesh", "status", "n_chips", "rank", "rank_batch",
        "local_cfg", "remat", "trace_s", "memory", "fits", "collectives", "work", "roofline",
        "differences"}
ROOFLINE = {"flops", "hbm_bytes", "collective_bytes", "t_compute_s", "t_memory_s",
            "t_collective_s", "bottleneck", "model_flops", "useful_fraction",
            "roofline_fraction"}


def _check(rec, arch, shape):
    assert rec["status"] == "ok" and set(rec) == KEYS, rec.get("error")
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["n_chips"]) == (arch, shape, "pod1", 256)
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] >= 0
    assert mem["peak_bytes_per_device"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert rec["fits"] == (mem["peak_bytes_per_device"] <= 80e9)
    r = rec["roofline"]
    assert set(r) == ROOFLINE and r["bottleneck"] in ("compute", "memory", "collective")
    assert r["t_compute_s"] > 0 and r["t_memory_s"] > 0 and r["t_collective_s"] > 0
    assert rec["collectives"]["count_by_kind"]["all_reduce"] > 0
    assert "data_replicas" in rec["differences"]
    return rec


def test_decode_cell():
    rec = _check(dryrun.run_cell("qwen2.5-14b", "decode_32k", False), "qwen2.5-14b",
                 "decode_32k")
    cfg = get_config("qwen2.5-14b")
    assert rec["rank_batch"] == 128 // 16 and rec["remat"] == "none"
    assert rec["work"]["calls"] == {"decode_attention": cfg.n_layers, "fused_swiglu": cfg.n_layers}
    assert rec["work"]["flops"]["backward"] == 0
    assert rec["differences"] == ["data_replicas", "per_rank_kv"]
    assert rec["roofline"]["bottleneck"] == "memory"  # a decode step streams the weights


def test_train_cell_with_remat():
    rec = _check(dryrun.run_cell("mixtral-8x22b", "train_4k", False), "mixtral-8x22b",
                 "train_4k")
    n = get_config("mixtral-8x22b").n_layers
    assert rec["remat"] == "full" and rec["rank_batch"] == 256 // 16
    # forward, the backward's recompute of every unit, and the backward
    assert rec["work"]["calls"] == {"attention_full": 3 * n}
    assert rec["work"]["flops"]["backward"] > 2 * rec["work"]["flops"]["forward"]
    assert set(rec["collectives"]["by_axis"]) == {"model", "data"}
    assert rec["collectives"]["by_phase"]["backward"]["all_reduce"]["count"] > 0
    assert not rec["fits"]  # a rank's replica of 8.8 B parameters with AdamW's f32 state


def test_long_context_cell_and_a_skipped_one():
    rec = _check(dryrun.run_cell("zamba2-2.7b", "long_500k", False), "zamba2-2.7b", "long_500k")
    assert rec["fits"] and rec["rank_batch"] == 1
    skip = dryrun.run_cell("qwen2.5-14b", "long_500k", True)
    assert skip["status"] == "skipped" and skip["mesh"] == "pod2"
    assert skip["reason"] == cell_applicable(get_config("qwen2.5-14b"), SHAPES["long_500k"])[1]


def test_main_writes_records(tmp_path, capsys):
    argv = ["--arch", "zamba2-2.7b", "--shape", "long_500k", "--mesh", "pod1",
            "--out", str(tmp_path)]
    assert dryrun.main(argv) == 0
    rec = json.loads((tmp_path / "pod1" / "zamba2-2.7b__long_500k.json").read_text())
    _check(rec, "zamba2-2.7b", "long_500k")
    assert dryrun.main(argv + ["--skip-existing"]) == 0
    assert "cached" in capsys.readouterr().out
    assert dryrun.main(["--arch", "rwkv6-7b", "--shape", "long_500k", "--mesh", "pod2",
                        "--out", str(tmp_path)]) == 0
    assert json.loads((tmp_path / "pod2" / "rwkv6-7b__long_500k.json").read_text())[
        "status"] == "ok"


def test_main_records_a_failing_cell_and_exits_1(tmp_path, monkeypatch, capsys):
    def boom(*a, **k):
        raise RuntimeError("no such cell")

    monkeypatch.setattr(dryrun, "cell_specs", boom)
    assert dryrun.main(["--arch", "zamba2-2.7b", "--shape", "long_500k", "--mesh", "pod1",
                        "--out", str(tmp_path)]) == 1
    rec = json.loads((tmp_path / "pod1" / "zamba2-2.7b__long_500k.json").read_text())
    assert rec["status"] == "fail" and "no such cell" in rec["error"]
    assert "1 FAILURES" in capsys.readouterr().out
