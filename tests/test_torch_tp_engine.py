"""The speculative engine with target and draft sharded over the same gloo
ranks on the CPU, against the JAX package's single-device ``SpecEngine``.

``dense_pair``'s configs (the independent draft, and the target drafting
for itself) at tp 2 and at tp 3, where ``resolve_for_tp`` pads the
target's 4 query heads over 2 KV heads to 6 and its d_ff to 129, the
draft's 2 heads to 3: lockstep and async rounds must emit the reference's
tokens with every ``SpecStats`` field equal, the same tokens as the
sharded target's own greedy decode, and the same on every rank.  The
serve CLI runs under torchrun at 2 ranks with ``--device cpu``.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.core.engine import SpecConfig as JSpecConfig
from repro.core.engine import SpecEngine as JSpecEngine
from repro_torch.configs import ModelConfig
from repro_torch.parallel.spawn import run_ranks
from test_torch_model import unbox

ROOT = pathlib.Path(__file__).resolve().parents[1]
S_MAX = 256
BASE = dict(bs=8, w=4, c=2, d=2, n_cap=64, max_new=24)
RUNS = {"lockstep": BASE, "async": dict(BASE, async_rounds=True)}
PAIRS = ("pair", "self")
STATS = ("rounds", "draft_steps", "emitted_rows", "accepted_rows", "spec_rounds", "spec_commits")
SPAWN_S = 120


def _prompts():
    return [((np.arange(8, dtype=np.int32).reshape(1, 8) * 3 + 1 + 7 * i) % 128).astype(np.int32)
            for i in range(2)]


@pytest.fixture(scope="module")
def reference(dense_pair):
    """pair -> run -> (tokens per prompt, stats per prompt) of the
    reference's engine."""
    T, D, tp, dp = dense_pair
    out = {}
    for pair in PAIRS:
        draft, dparams = (T, tp) if pair == "self" else (D, dp)
        for run, kw in RUNS.items():
            je = JSpecEngine(T, draft, JSpecConfig(**kw), S_max_t=S_MAX, S_max_d=S_MAX)
            sess = je.session(tp, dparams)
            res = [sess.generate(p) for p in _prompts()]
            out[pair, run] = ([o[0] for o, _ in res],
                              [{"rounds": s.rounds, "draft_steps": s.draft_steps,
                                "emitted_rows": s.emitted_rows.tolist(),
                                "accepted_rows": s.accepted_rows.tolist(),
                                "spec_rounds": s.spec_rounds, "spec_commits": s.spec_commits}
                               for _, s in res])
    return out


@pytest.fixture(scope="module", params=[2, 3], ids=["tp2", "tp3"])
def ranks(request, dense_pair, tmp_path_factory):
    """pair -> the per-rank results of ``workers.spec_engine`` at this tp."""
    T, D, tp, dp = dense_pair
    tcfg = ModelConfig(**dataclasses.asdict(T.cfg))
    dcfg = ModelConfig(**dataclasses.asdict(D.cfg))
    job = {"prompts": _prompts(), "runs": list(RUNS.items()), "S_max": S_MAX,
           "greedy_n": BASE["max_new"], "record_shapes": True}
    calls = [("spec_engine", (dict(job, tcfg=tcfg, dcfg=dcfg,
                                   weights=("numpy", unbox(tp), unbox(dp))),)),
             ("spec_engine", (dict(job, tcfg=tcfg, dcfg=None,
                                   weights=("numpy", unbox(tp), None)),))]
    res = run_ranks("repro_torch.parallel.workers:several", request.param, (calls,),
                    workdir=tmp_path_factory.mktemp(f"engine{request.param}"), device="cpu",
                    timeout_s=SPAWN_S)
    return request.param, {pair: [r[i] for r in res] for i, pair in enumerate(PAIRS)}


@pytest.mark.parametrize("run", sorted(RUNS))
@pytest.mark.parametrize("pair", PAIRS)
def test_tp_engine_emits_the_reference_tokens_and_stats(ranks, reference, pair, run):
    world, by_pair = ranks
    want_toks, want_stats = reference[pair, run]
    for res in by_pair[pair]:
        got = res["runs"][run]
        assert got["tokens"] == want_toks, f"tp {world} rank {res['rank']}"
        for g, w in zip(got["stats"], want_stats):
            assert {k: g[k] for k in STATS} == {k: w[k] for k in STATS}


@pytest.mark.parametrize("pair", PAIRS)
def test_tp_engine_equals_its_greedy_decode_on_every_rank(ranks, pair):
    world, by_pair = ranks
    first = by_pair[pair][0]
    for res in by_pair[pair]:
        assert res["greedy"] == first["greedy"]
        for run in RUNS:
            assert res["runs"][run]["tokens"] == first["runs"][run]["tokens"]
            for toks, greedy in zip(res["runs"][run]["tokens"], res["greedy"]):
                assert toks == greedy[:len(toks)] and len(toks) == BASE["max_new"]
    if pair == "self":  # drafting for itself the engine accepts: row moves run
        assert sum(sum(s["accepted_rows"]) for s in first["runs"]["lockstep"]["stats"]) > 0
    if world == 3:  # the padded layout: heads per rank, the middle rank reads both KV heads
        assert [r["heads"]["target"] for r in by_pair[pair]] == [(3, 1), (6, 2), (3, 1)]


def test_tp_engine_hands_back_the_shapes_each_rank_launched(ranks):
    """Each rank records the shapes of its kernel calls: the rank's heads
    and its dense-MLP width, a multiple of 8 (at tp 3 the target's share
    43 of the padded d_ff 129 is padded to 48)."""
    world, by_pair = ranks
    d_model, d_ff = 64, {2: 64, 3: 48}[world]
    for res in by_pair["self"]:
        seen = res["shapes"]
        assert {key[2] for key in seen["fused_swiglu"]} == {d_ff}
        assert all(key[1] == d_model for key in seen["fused_swiglu"])
        hq, hkv = res["heads"]["target"]
        assert {key[2] for key in seen["tree_attention"]} == {hq}
        assert {key[5] for key in seen["tree_attention"]} == {hkv}
        assert seen["kv_move_leaves"] or seen["kv_move_rows"]


def test_serve_cli_under_torchrun_on_two_ranks():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.serve", "--device", "cpu", "--continuous", "--d", "1",
         "--requests", "2", "--max-new", "16", "--async-rounds"],
        env=env, capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert "tensor parallel: 2 ranks (gloo)" in res.stdout
    assert "ranks: all 2 emitted the same tokens" in lines
    verify = [ln for ln in lines if ln.startswith("verify req")]
    assert verify == [f"verify req {i}: byte-identical to solo generate()" for i in range(2)]
