"""Router replicas on disjoint rank groups (``repro_torch.parallel.split``'s
``Fleet``, ``ShardedServingRuntime(fleet=)``) on gloo ranks on the CPU,
against the JAX package's single-controller ``ShardedServingRuntime`` over
the same engine twice, on the same ``dense_pair`` weights and trace.

A world of 4 ranks (2 replicas of 1 target + 1 draft rank), lockstep,
async and with adaptive depth, and one of 6 (2 replicas of a target
sharded over 2 ranks + 1 draft rank), lockstep: on every rank each
request's tokens, its replica, every replica's ``SpecStats`` and the
merged summary equal the reference's, each request equals its replica's
solo ``generate()``, a fleet round makes one exchange and a replica round
its split's broadcasts on its own group.  A failure in one replica's round
reaches every rank in that fleet round.  The serve CLI runs a fleet under
torchrun at 4 ranks.  ``make_serving_ranks`` carves replicas as
``make_serving_devices`` does, and a world of no whole number of replicas
raises (``tests/test_torch_split_serving.py``).
"""

import dataclasses
import math
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.core.engine import SpecConfig as JSpecConfig
from repro.core.engine import SpecEngine as JSpecEngine
from repro.serving import Request as JRequest
from repro.serving import SchedulerConfig as JSchedulerConfig
from repro.serving import ShardedServingRuntime as JSharded
from repro.serving import VirtualClock as JVirtualClock
from repro_torch.configs import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import SpecConfig, SpecEngine
from repro_torch.launch.mesh import make_serving_devices, make_serving_ranks
from repro_torch.models.api import make_model
from repro_torch.parallel.spawn import run_ranks
from repro_torch.serving import (
    EngineMirror,
    ShardedServingRuntime,
    VirtualClock,
    WallClock,
    fleet_engines,
)
from repro_torch.serving.runtime import pack_round, unpack_round
from test_torch_model import unbox

ROOT = pathlib.Path(__file__).resolve().parents[1]
S_MAX = 256
CFG = dict(bs=8, w=4, c=2, d=2, n_cap=64, max_new=24)
RUNS = {"lockstep": (False, None), "async": (True, None), "adaptive": (False, {})}
CASES = [("2x(1+1)", "lockstep"), ("2x(1+1)", "async"), ("2x(1+1)", "adaptive"),
         ("2x(2+1)", "lockstep")]
WORLDS = {"2x(1+1)": (1, 1), "2x(2+1)": (2, 1)}
FAIL = (1, 3)  # replica 1's dispatch raises in fleet round 3
STATS = ("rounds", "draft_steps", "emitted_rows", "accepted_rows", "spec_rounds", "spec_commits")
SPAWN_S = 120


def _prompt(k, P=8):
    return ((np.arange(1, P + 1) * k + 3) % 128).astype(np.int32)


def _requests():
    """Six staggered requests (prompts of 8 and 12) over 2 replicas x 2
    slots: both replicas serve, and admissions land mid-flight."""
    return [(i, _prompt(i + 2, P=8 + 4 * (i % 2)), 0.4 * i, 12) for i in range(6)]


def _cfgs(dense_pair):
    T, D, _, _ = dense_pair
    return ModelConfig(**dataclasses.asdict(T.cfg)), ModelConfig(**dataclasses.asdict(D.cfg))


def _stats(st) -> dict:
    return {"rounds": st.rounds, "draft_steps": st.draft_steps,
            "emitted_rows": st.emitted_rows.tolist(), "accepted_rows": st.accepted_rows.tolist(),
            "spec_rounds": st.spec_rounds, "spec_commits": st.spec_commits}


def _same_summary(s, js):
    assert s.keys() == js.keys()
    for k, v in js.items():
        if isinstance(v, float) and math.isnan(v):
            assert math.isnan(s[k]), k
        else:
            assert s[k] == v, k


@pytest.fixture(scope="module")
def reference(dense_pair):
    """run -> the reference fleet (one controller, the same engine twice)
    after serving the trace: its results, replicas, summary, report and
    each replica's SpecStats."""
    T, D, jtp, jdp = dense_pair
    out = {}
    for run, (asyn, sched) in RUNS.items():
        je = JSpecEngine(T, D, JSpecConfig(**CFG, async_rounds=asyn), S_max_t=S_MAX,
                         S_max_d=S_MAX)
        jrt = JSharded([je] * 2, jtp, jdp, n_slots=2, clock=JVirtualClock(),
                       scheduler=None if sched is None else JSchedulerConfig(**sched))
        jrt.submit_trace(JRequest(rid=rid, prompt=p, arrival_s=a, max_new=n)
                         for rid, p, a, n in _requests())
        res = jrt.run()
        out[run] = {"tokens": {rid: res[rid] for rid in sorted(res)},
                    "replica_of": {rid: jrt.replica_of(rid) for rid, *_ in _requests()},
                    "summary": jrt.summary(), "report": jrt.report(),
                    "spec_stats": [_stats(st.spec_stats) for st in jrt.steppers]}
    return out


def _job(dense_pair, n_target, n_draft, runs):
    _, _, jtp, jdp = dense_pair
    tcfg, dcfg = _cfgs(dense_pair)
    return {"n_target": n_target, "n_draft": n_draft, "replicas": 2, "tcfg": tcfg,
            "dcfg": dcfg, "weights": ("numpy", unbox(jtp), unbox(jdp)), "S_max": S_MAX,
            "runs": [(label, {"spec": dict(CFG, async_rounds=RUNS[run][0]), "slots": 2,
                              "requests": _requests(), "round_dt": 1.0,
                              "scheduler": RUNS[run][1], "solo": True, "fail": fail})
                     for label, run, fail in runs]}


@pytest.fixture(scope="module")
def served(dense_pair, tmp_path_factory):
    """world -> every rank's ``workers.fleet`` result: 2x(1+1) with the
    three runs and a failing one last, 2x(2+1) lockstep."""
    out = {}
    for world, (n_t, n_d) in WORLDS.items():
        runs = [(run, run, None) for run, _ in RUNS.items() if (world, run) in CASES]
        if world == "2x(1+1)":
            runs.append(("fail", "lockstep", FAIL))
        out[world] = run_ranks("repro_torch.parallel.workers:fleet", 2 * (n_t + n_d),
                               (_job(dense_pair, n_t, n_d, runs),),
                               workdir=tmp_path_factory.mktemp("fleet"), device="cpu",
                               timeout_s=SPAWN_S)
    return out


def _per_rank(served, world, run):
    return [r["runs"][run] for r in served[world]]


def test_the_ranks_are_carved_into_replicas_target_first(served):
    """Replica i owns ranks [i g, (i + 1) g), its target first; every rank
    holds its own role's weights only."""
    for world, (n_t, n_d) in WORLDS.items():
        g = n_t + n_d
        ranks = served[world]
        assert [r["replica"] for r in ranks] == [i // g for i in range(2 * g)]
        assert [r["role"] for r in ranks] == (["target"] * n_t + ["draft"] * n_d) * 2
        for r in ranks:
            base = r["replica"] * g
            assert r["replica_ranks"] == tuple(range(base, base + g))
            assert r["ranks"] == (tuple(range(base, base + n_t)) if r["role"] == "target"
                                  else tuple(range(base + n_t, base + g)))
            assert r["standin"] == {"is_standin": True, "tensors": 0}
        by_role = {role: {r["param_bytes"] for r in ranks if r["role"] == role}
                   for role in ("target", "draft")}
        assert all(len(v) == 1 for v in by_role.values())  # each replica holds the same shares


@pytest.mark.parametrize("world,run", CASES)
def test_fleet_serves_the_reference_tokens_on_its_replicas(served, reference, world, run):
    want = reference[run]
    assert set(want["replica_of"].values()) == {0, 1}  # both replicas serve
    for got in _per_rank(served, world, run):
        assert got["error"] is None
        assert got["tokens"] == want["tokens"]
        assert got["replica_of"] == want["replica_of"]


@pytest.mark.parametrize("world,run", CASES)
def test_every_rank_holds_every_replicas_reference_spec_stats(served, reference, world, run):
    """The own replica's counts and the mirrors' alike: the exchange carries
    each slot's emitted and accepted counts and the round's other counts."""
    for got in _per_rank(served, world, run):
        for st, jst in zip(got["spec_stats"], reference[run]["spec_stats"]):
            assert [st[k] for k in STATS] == [jst[k] for k in STATS]
    if run == "async":
        assert all(st["spec_rounds"] == st["rounds"] > 0 for st in got["spec_stats"])


@pytest.mark.parametrize("world,run", CASES)
def test_every_rank_holds_the_reference_summary_and_report(served, reference, world, run):
    for got in _per_rank(served, world, run):
        _same_summary(got["summary"], reference[run]["summary"])
        assert got["report"] == reference[run]["report"]
    assert reference[run]["summary"]["per_replica_finished"] == [
        sum(1 for v in reference[run]["replica_of"].values() if v == i) for i in (0, 1)]


@pytest.mark.parametrize("world,run", CASES)
def test_each_request_equals_its_replicas_solo_generate(served, world, run):
    ranks = served[world]
    for r in ranks:
        got = r["runs"][run]
        mine = sorted(rid for rid, i in got["replica_of"].items() if i == r["replica"])
        assert sorted(got["solo"]) == mine and mine
        for rid in mine:
            assert got["solo"][rid] == got["tokens"][rid], (r["rank"], rid)


@pytest.mark.parametrize("world,run", CASES)
def test_one_fleet_exchange_per_round_and_the_splits_broadcasts_on_their_group(
        served, world, run):
    """Every rank makes one exchange per fleet round; a replica's ranks make
    its split's 2 broadcasts per round (3 async) and no more: the other
    replica's rounds are not on their group."""
    per = 3 if run == "async" else 2
    for r in served[world]:
        got = r["runs"][run]
        assert got["exchanges"] == got["fleet_rounds"] > 0
        assert got["own_rounds"] == got["spec_stats"][r["replica"]]["rounds"]
        assert got["collectives"]["broadcast"] == per * got["own_rounds"]
        assert got["own_rounds"] < got["fleet_rounds"] + 1


def test_a_failure_in_one_replica_reaches_every_rank_in_that_fleet_round(served):
    """Replica 1's dispatch raises in fleet round 3 on both its ranks: they
    raise their error after that round's exchange, and replica 0's ranks a
    RuntimeError naming them, in the same round, well inside the spawn's
    limit (no rank waits at a next exchange)."""
    ranks = served["2x(1+1)"]
    for r in ranks:
        got = r["runs"]["fail"]
        assert got["fleet_rounds"] == FAIL[1] == got["exchanges"]
        if r["replica"] == FAIL[0]:
            assert got["error"] == f"a failure in replica {FAIL[0]}'s round {FAIL[1]}"
        else:
            assert got["error"] == (f"fleet round {FAIL[1]}: rank(s) [2, 3] failed in their "
                                    "replica's round; replica 0 stops with them")
        assert got["wall_s"] < SPAWN_S / 4


def test_serve_cli_runs_a_fleet_under_torchrun():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "repro_torch.launch.serve", "--device", "cpu", "--continuous", "--replicas", "2",
         "--n-target", "1", "--n-draft", "1", "--depth", "1", "--requests", "4", "--max-new",
         "16"],
        env=env, capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert "fleet: 2 replicas on disjoint rank groups, target / draft ranks [0] / [1], [2] / " \
           "[3] (gloo); one exchange on the host (gloo) per fleet round" in lines
    assert "ranks: all 4 emitted the same tokens" in lines
    verify = [ln for ln in lines if ln.startswith("verify req")]
    assert [ln.split(" (replica")[0] for ln in verify] == [
        f"verify req {i}: byte-identical to solo generate()" for i in range(4)]
    assert {ln.rsplit("replica ", 1)[1] for ln in verify} == {"0)", "1)"}


def test_the_nccl_fleet_tool_imports_neither_jax_nor_the_reference_and_needs_four_cards():
    """``tools/fleet_nccl.py`` runs on the card's machine, where there is no
    JAX: it imports none, and without four CUDA devices it exits 1 and
    prints no result."""
    import ast

    tool = ROOT / "tools" / "fleet_nccl.py"
    tree = ast.parse(tool.read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert "chip_smoke" in mods and not [m for m in mods if m.split(".")[0] in
                                         ("jax", "jaxlib", "repro")]
    if torch.cuda.device_count() >= 4:
        pytest.skip("four CUDA devices are present: the tool rightly runs on them")
    res = subprocess.run([sys.executable, str(tool)], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert res.returncode == 1 and res.stdout == ""
    assert "needs 4 CUDA devices" in res.stderr


@pytest.mark.parametrize("n_t,n_d,replicas", [(1, 1, 2), (2, 1, 2), (1, 2, 2), (1, 1, 4),
                                              (6, 2, 1), (2, 2, 3)])
def test_make_serving_ranks_carves_replicas_as_the_devices(n_t, n_d, replicas):
    n = replicas * (n_t + n_d)
    devs = make_serving_devices(n_t, n_d, replicas=replicas,
                                devices=[torch.device("cpu", i) for i in range(n)])
    got = make_serving_ranks(range(n), n_t, n_d, replicas=replicas)
    pairs = [devs] if replicas == 1 else devs
    want = [tuple(tuple(d.index for d in g) for g in pair) for pair in pairs]
    assert (got if replicas > 1 else [got]) == want


def test_the_packed_round_crosses_field_for_field():
    """A replica's row of the exchange: its flag, its round counts, and
    emitted / n_emitted / n_accepted for every slot."""
    from repro_torch.core.engine import StepResult

    rng = np.random.default_rng(0)
    res = StepResult(rng.integers(0, 128, (2, 9)).astype(np.int32),
                     np.array([3, 1], np.int32), np.array([2, 0], np.int32))
    row = pack_round(res, (4, 1, 1), 2, 8, failed=False)
    assert row.dtype == np.int32 and row.shape == (5 + 2 * 11,)
    got, counts = unpack_round(row, 2, 8)
    assert counts == (4, 1, 1) and row[:2].tolist() == [0, 1]
    for f in ("emitted", "n_emitted", "n_accepted"):
        assert np.array_equal(getattr(got, f), getattr(res, f)), f
    assert pack_round(None, (0, 0, 0), 2, 8, failed=True)[:2].tolist() == [1, 0]


@pytest.fixture(scope="module")
def port_engine(dense_pair):
    T, D, jtp, jdp = dense_pair
    tcfg, dcfg = _cfgs(dense_pair)
    eng = SpecEngine(make_model(tcfg, "cpu"), make_model(dcfg, "cpu"), SpecConfig(**CFG),
                     S_max_t=S_MAX, S_max_d=S_MAX)
    return eng, params_from_numpy(tcfg, unbox(jtp), "cpu"), params_from_numpy(dcfg, unbox(jdp),
                                                                               "cpu")


def _fake_fleet(replica, replicas=2):
    return types.SimpleNamespace(replica=replica, replicas=replicas)


@pytest.mark.parametrize("case", ["wall clock", "mirror without a fleet", "own engine elsewhere",
                                  "too few engines"])
def test_a_fleet_refuses_what_it_cannot_serve(port_engine, case):
    """A fleet serves on a virtual clock (on a wall clock its ranks would
    admit at different rounds); a mirror steps only in a fleet; the own
    engine sits at the own replica's index, a mirror at every other."""
    eng, tp, dp = port_engine
    fleet = _fake_fleet(0)
    engines, clock, match = fleet_engines(fleet, eng), VirtualClock(), "fleet_engines"
    if case == "wall clock":
        clock, match = WallClock(), "VirtualClock"
    elif case == "mirror without a fleet":
        fleet, match = None, "fleet="
    elif case == "own engine elsewhere":
        fleet = _fake_fleet(1)
    else:
        engines = engines[:1]
    with pytest.raises(ValueError, match=match):
        ShardedServingRuntime(engines, tp, dp, n_slots=2, clock=clock, fleet=fleet)


def test_a_mirror_reads_its_replicas_config_and_holds_no_session(port_engine):
    eng, tp, dp = port_engine
    engines = fleet_engines(_fake_fleet(1), eng)
    assert isinstance(engines[0], EngineMirror) and engines[1] is eng
    rt = ShardedServingRuntime(engines, tp, dp, n_slots=2, clock=VirtualClock(),
                               fleet=_fake_fleet(1))
    mirror, own = rt.steppers
    assert mirror.mirror and mirror.session is None and mirror.state is None
    assert not own.mirror and own.state is not None
    assert mirror.plen_limit == own.plen_limit == eng.plen_budget
    assert mirror.engine.cfg is eng.cfg and mirror.step() is None
    assert mirror.last_round_depth == CFG["d"]
