"""The dry run (``python -m repro_torch.launch.dryrun``) at full size on
the CPU: meta tensors, one rank of pod1 (``data`` 16 x ``model`` 16).

``run_cell`` on qwen2.5-14b decode_32k, mixtral-8x22b train_4k (remat
"full") and zamba2-2.7b long_500k gives the reference's record keys with
the port's counts, and a skipped cell (long_500k on a full-attention
architecture) the reference's reason; ``main`` writes the records where
``--out`` says and exits 0, or 1 when a cell fails.  Train and prefill
cells split the residual stream by sequence (``seq_shard``): on a smoke
train step the residual each unit saves for the backward is 1/tp of the
whole-sequence form's, exactly, and ``--seq-shard off`` counts
musicgen-large prefill_32k as the tree before ``seq_shard`` did, byte for
byte.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro_torch.configs import SHAPES, cell_applicable, get_config
from repro_torch.launch import cost, dryrun
from repro_torch.launch.steps import make_train_step
from repro_torch.models.api import make_model
from repro_torch.optim import adamw_init
from repro_torch.parallel.group import CountingGroup

KEYS = {"arch", "shape", "mesh", "status", "n_chips", "rank", "rank_batch",
        "local_cfg", "remat", "seq_shard", "trace_s", "memory", "fits", "collectives", "work",
        "roofline", "differences"}
# musicgen-large prefill_32k on pod1 as the tree before seq_shard counted it (its dry run)
# a serving prefill's norms are the rms_norm kernel's (x read, the output written, no f32
# temporaries) since the kernel came in; the plain norm's ops counted 824264773672 bytes and
# a peak of 4967895040
WHOLE_SEQ_PREFILL = {
    "memory": {"argument_bytes": 672534528, "output_bytes": 1610612744,
               "temp_bytes": 2952921088, "peak_bytes_per_device": 3625455616},
    "collectives": {"all_reduce": {"count": 96, "bytes": 25769803776},
                    "all_gather": {"count": 1, "bytes": 16777216}},
    "flops": {"forward": 79199196938240, "backward": 0},
    "bytes": {"forward": 303345831976, "backward": 0}}
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
    # stream_matmul: q, k, v, o and the down projection of every layer, and the lm_head;
    # rms_norm: the two pre-norms of every layer, and the final norm
    assert rec["work"]["calls"] == {"decode_attention": cfg.n_layers, "fused_swiglu": cfg.n_layers,
                                    "stream_matmul": 5 * cfg.n_layers + 1,
                                    "rms_norm": 2 * cfg.n_layers + 1}
    assert rec["work"]["flops"]["backward"] == 0
    assert rec["differences"] == ["data_replicas", "per_rank_kv"] and not rec["seq_shard"]
    assert rec["roofline"]["bottleneck"] == "memory"  # a decode step streams the weights


def test_train_cell_with_remat():
    rec = _check(dryrun.run_cell("mixtral-8x22b", "train_4k", False), "mixtral-8x22b",
                 "train_4k")
    n = get_config("mixtral-8x22b").n_layers
    assert rec["remat"] == "full" and rec["rank_batch"] == 256 // 16 and rec["seq_shard"]
    assert "heads_tp_attention" in rec["differences"]
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


@pytest.mark.parametrize("tp", (2, 4))
def test_the_residual_saved_between_units_falls_to_one_over_tp(tp):
    """llama3-1b smoke, B 2 x S 64, remat "full" over a ``CountingGroup``
    of ``tp`` ranks: what a train step keeps for its backward grows by one
    residual [B, S, d] per unit whole, by [B, S/tp, d] sequence-sharded."""
    B, S = 2, 64
    per_unit = {}
    for seq in (False, True):
        saved = []
        for L in (2, 4):
            cfg = dataclasses.replace(get_config("llama3-1b", smoke=True), n_layers=L)
            model = make_model(cfg, "meta", CountingGroup(0, tp))
            params = model.init(0, trainable=True)
            c, _ = cost.count(make_train_step(cfg, model, remat="full", seq_shard=seq), params,
                              adamw_init(params),
                              {"tokens": torch.zeros((B, S + 1), dtype=torch.int32,
                                                     device="meta")})
            saved.append(c.live_at_backward - c.argument_bytes)
        per_unit[seq] = (saved[1] - saved[0]) // 2
    d = get_config("llama3-1b", smoke=True).d_model
    assert per_unit == {False: B * S * d * 4, True: B * S // tp * d * 4}


def test_seq_shard_off_counts_the_whole_sequence_form(tmp_path):
    """``--seq-shard off`` gives the whole-sequence count byte for byte; the
    default splits the prefill's residual: a reduce-scatter where each
    all-reduce was, at the same operand bytes, two all-gathers a block at
    1/16 of them, and a lower peak."""
    argv = ["--arch", "musicgen-large", "--shape", "prefill_32k", "--mesh", "pod1"]
    recs = {}
    for mode in ("off", "on"):
        out = tmp_path / mode
        assert dryrun.main(argv + ["--seq-shard", mode, "--out", str(out)]) == 0
        recs[mode] = json.loads((out / "pod1" / "musicgen-large__prefill_32k.json").read_text())
    off, on = recs["off"], recs["on"]
    assert not off["seq_shard"] and on["seq_shard"]
    assert off["memory"] == WHOLE_SEQ_PREFILL["memory"]
    assert {k: off["work"][k] for k in ("collectives", "flops", "bytes")} == \
        {k: WHOLE_SEQ_PREFILL[k] for k in ("collectives", "flops", "bytes")}
    assert off["differences"] == ["data_replicas", "per_rank_kv"]
    assert on["differences"] == ["data_replicas", "per_rank_kv", "heads_tp_attention"]
    L, whole = get_config("musicgen-large").n_layers, WHOLE_SEQ_PREFILL["collectives"]
    coll = on["work"]["collectives"]
    assert set(coll) == {"all_gather", "reduce_scatter"}
    assert coll["reduce_scatter"] == whole["all_reduce"]
    assert coll["all_gather"]["count"] == 2 * L + 2
    assert coll["all_gather"]["bytes"] == whole["all_reduce"]["bytes"] // 16 + \
        2 * whole["all_gather"]["bytes"]  # the blocks' rows, the final norm's and the logits'
    assert on["memory"]["peak_bytes_per_device"] < off["memory"]["peak_bytes_per_device"]
    assert on["work"]["flops"] == off["work"]["flops"]
