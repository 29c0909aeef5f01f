"""Serving and re-splitting the disaggregated engine on gloo ranks on the
CPU (``repro_torch.parallel.split``), against the JAX package.

Continuous batching on a world of 1 + 1, lockstep and async: a staggered
trace through two slots on a ``VirtualClock`` serves the reference
runtime's tokens with the same ``SpecStats`` on both ranks, and each
request its solo ``generate()``.  The serve CLI runs split under torchrun
at 2 ranks.  ``submeshes`` and ``replan_split`` equal the reference's on
the same inputs, ``make_serving_ranks`` carves as ``make_serving_devices``
does, and ``reshard_engine`` re-splits a world of 3 from 1:2 to 2:1 with the
tokens unchanged.  A world of no whole number of replicas raises, and so do
replicas on one split or group (``tests/test_torch_fleet.py`` runs whole
fleets).
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

from jax.sharding import Mesh  # noqa: F401  (the reference's submeshes build meshes)
from repro.core.engine import SpecConfig as JSpecConfig
from repro.core.engine import SpecEngine as JSpecEngine
from repro.runtime.elastic import replan_split as jreplan_split
from repro.runtime.elastic import submeshes as jsubmeshes
from repro.serving import ContinuousBatchingRuntime as JRuntime
from repro.serving import Request as JRequest
from repro.serving import VirtualClock as JVirtualClock
from repro_torch.configs import ModelConfig
from repro_torch.launch.mesh import make_serving_devices, make_serving_ranks
from repro_torch.parallel.spawn import run_ranks
from repro_torch.runtime.elastic import replan_split, submeshes
from test_torch_model import unbox

ROOT = pathlib.Path(__file__).resolve().parents[1]
S_MAX = 256
CFG = dict(bs=8, w=4, c=2, d=2, n_cap=64, max_new=24)
STATS = ("rounds", "draft_steps", "spec_rounds", "spec_commits")
SPAWN_S = 120


def _requests(n=4, max_new=16):
    return [(i, ((np.arange(1, 9 + 4 * (i % 2)) * (i + 1) + 3) % 128).astype(np.int32), 0.7 * i,
             max_new) for i in range(n)]


def _cfgs(dense_pair):
    T, D, _, _ = dense_pair
    return ModelConfig(**dataclasses.asdict(T.cfg)), ModelConfig(**dataclasses.asdict(D.cfg))


@pytest.fixture(scope="module")
def served(dense_pair, tmp_path_factory):
    """asyn -> (the reference runtime's results and stepper stats, the two
    ranks' results)."""
    T, D, jtp, jdp = dense_pair
    tcfg, dcfg = _cfgs(dense_pair)
    reqs = _requests()
    runs = [(f"async={asyn}", "continuous",
             {"spec": dict(CFG, async_rounds=asyn), "slots": 2, "requests": reqs,
              "round_dt": 1.0, "solo": True}) for asyn in (False, True)]
    job = {"n_target": 1, "tcfg": tcfg, "dcfg": dcfg, "weights": ("numpy", unbox(jtp), unbox(jdp)),
           "prompts": [], "runs": runs, "S_max": S_MAX}
    res = run_ranks("repro_torch.parallel.workers:split_engine", 2, (job,),
                    workdir=tmp_path_factory.mktemp("split_serve"), device="cpu",
                    timeout_s=SPAWN_S)
    out = {}
    for asyn in (False, True):
        je = JSpecEngine(T, D, JSpecConfig(**CFG, async_rounds=asyn), S_max_t=S_MAX,
                         S_max_d=S_MAX)
        jrt = JRuntime(je, jtp, jdp, n_slots=2, clock=JVirtualClock())
        jrt.submit_trace(JRequest(rid=rid, prompt=p, arrival_s=a, max_new=n)
                         for rid, p, a, n in reqs)
        out[asyn] = (jrt.run(), jrt.stepper.spec_stats, [r["runs"][f"async={asyn}"] for r in res])
    return out


@pytest.mark.parametrize("asyn", [False, True], ids=["lockstep", "async"])
def test_split_continuous_serves_the_reference_runtime_and_solo_tokens(served, asyn):
    jres, jst, per_rank = served[asyn]
    assert sorted(jres) == [0, 1, 2, 3]
    for got in per_rank:
        assert got["tokens"] == {rid: jres[rid] for rid in sorted(jres)}
        assert got["solo"] == got["tokens"]  # each request's solo generate() on the split
        assert [got["stats"][k] for k in STATS] == [getattr(jst, k) for k in STATS]
        assert got["stats"] == per_rank[0]["stats"]
        per_round = 3 if asyn else 2
        assert got["collectives"]["broadcast"] == per_round * got["rounds"]
    assert [g["holds"] for g in per_rank] == [
        {"tcache": True, "dcache": False, "tr": False, "plan": False},
        {"tcache": False, "dcache": True, "tr": True, "plan": True}]


def test_serve_cli_runs_split_under_torchrun():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.serve", "--device", "cpu", "--n-target", "1", "--n-draft",
         "1", "--continuous", "--depth", "1", "--requests", "2", "--max-new", "16"],
        env=env, capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert "split: target on ranks [0], draft on ranks [1] (gloo); the plan and the verdict " \
           "cross between them each round" in lines
    assert "ranks: all 2 emitted the same tokens" in lines
    verify = [ln for ln in lines if ln.startswith("verify req")]
    assert verify == [f"verify req {i}: byte-identical to solo generate()" for i in range(2)]


def test_the_nccl_split_tool_imports_neither_jax_nor_the_reference_and_needs_three_cards():
    """``tools/split_nccl.py`` runs on the card's machine, where there is no
    JAX: it imports none, and without three CUDA devices it exits 1 and
    prints no result."""
    import ast

    tool = ROOT / "tools" / "split_nccl.py"
    mods = [a.name for n in ast.walk(ast.parse(tool.read_text())) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(ast.parse(tool.read_text()))
             if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert "chip_smoke" in mods and not [m for m in mods if m.split(".")[0] in
                                         ("jax", "jaxlib", "repro")]
    if torch.cuda.device_count() >= 3:
        pytest.skip("three CUDA devices are present: the tool rightly runs on them")
    res = subprocess.run([sys.executable, str(tool)], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert res.returncode == 1 and res.stdout == ""
    assert "needs 3 CUDA devices" in res.stderr


class _Dev:
    """A device of the reference's mesh, known by its id."""

    def __init__(self, i):
        self.id = i


@pytest.mark.parametrize("n,n_target", [(1, 1), (2, 1), (4, 2), (8, 6), (3, 2)])
def test_submeshes_split_as_the_reference(n, n_target):
    tgt, drf = jsubmeshes([_Dev(i) for i in range(n)], n_target)
    want = (tuple(d.id for d in tgt.devices.flat), tuple(d.id for d in drf.devices.flat))
    assert submeshes(range(n), n_target) == want


@pytest.mark.parametrize("n,n_target", [(2, 0), (2, 2), (4, 5)])
def test_submeshes_refuse_what_the_reference_refuses(n, n_target):
    with pytest.raises(AssertionError):
        jsubmeshes([_Dev(i) for i in range(n)], n_target)
    with pytest.raises(ValueError):
        submeshes(range(n), n_target)


@pytest.mark.parametrize("n", [2, 3, 8])
def test_replan_split_sweeps_as_the_reference(n):
    def speed(nt, nd):
        return 10.0 * nt + nd * nt % 3

    assert dataclasses.astuple(replan_split(speed, n)) == \
        dataclasses.astuple(jreplan_split(speed, n))


def test_make_serving_ranks_carves_as_the_devices():
    """A split's rank groups are the device groups of one replica over the
    ranks 0 .. n_target + n_draft - 1; a split needs a rank for each role."""
    cpus = [torch.device("cpu", i) for i in range(8)]
    for n_t, n_d in ((1, 1), (2, 1), (1, 2), (6, 2)):
        devs = make_serving_devices(n_t, n_d, devices=cpus[:n_t + n_d])
        assert make_serving_ranks(range(n_t + n_d), n_t) == tuple(tuple(d.index for d in g) for g in devs)
    for n, n_t in ((1, 1), (2, 0), (2, 2)):
        with pytest.raises(ValueError, match="needs 1 <= n_target"):
            make_serving_ranks(range(n), n_t)


def test_reshard_engine_resplits_a_world_of_three(dense_pair, tmp_path):
    """1:2 -> 2:1 -> 1:2: every rank's role follows the split, and the
    tokens stay the reference's on every split and rank."""
    T, D, jtp, jdp = dense_pair
    tcfg, dcfg = _cfgs(dense_pair)
    prompts = [((np.arange(8, dtype=np.int32).reshape(1, 8) * 5 + 2) % 128).astype(np.int32)]
    job = {"splits": [1, 2, 1], "tcfg": tcfg, "dcfg": dcfg, "ttree": unbox(jtp),
           "dtree": unbox(jdp), "prompts": prompts, "spec": CFG, "S_max": S_MAX}
    res = run_ranks("repro_torch.parallel.workers:resplit", 3, (job,), workdir=tmp_path,
                    device="cpu", timeout_s=SPAWN_S)
    want = [JSpecEngine(T, D, JSpecConfig(**CFG), S_max_t=S_MAX, S_max_d=S_MAX)
            .session(jtp, jdp).generate(prompts[0])[0][0]]
    roles = [[r[i]["role"] for r in res] for i in range(3)]
    assert roles == [["target", "draft", "draft"], ["target", "target", "draft"],
                     ["target", "draft", "draft"]]
    assert [r[1]["ranks"] for r in res] == [(0, 1), (0, 1), (2,)]
    for per_rank in res:
        for step in per_rank:
            assert step["tokens"] == want


@pytest.mark.parametrize("n,n_t,n_d,replicas", [(4, 1, 1, 3), (5, 1, 1, 2), (6, 2, 1, 3),
                                                  (4, 1, 0, 4), (4, 0, 2, 2), (4, 1, 1, 0)])
def test_a_world_of_no_whole_number_of_replicas_raises(n, n_t, n_d, replicas):
    """Replicas on disjoint rank groups need R x (n_target + n_draft) ranks,
    each role at least one: any other world raises before a group is made,
    and no layout runs in its place."""
    from repro_torch.parallel.group import TPGroup
    from repro_torch.parallel.split import make_fleet

    with pytest.raises(ValueError, match="whole split|replicas must be"):
        make_serving_ranks(range(n), n_t, n_d, replicas=replicas)
    grp = TPGroup(pg=None, rank=0, world=n, device=torch.device("cpu"), backend="gloo",
                  ranks=tuple(range(n)))
    with pytest.raises(ValueError, match="whole split|replicas must be"):
        make_fleet(grp, n_t, n_d, replicas)


def test_router_replicas_on_one_group_raise_naming_the_fleet():
    """One split or one tensor-parallel group serves one replica: more
    replicas there raise and name the fleet of whole splits."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.parallel.group import TPGroup

    grp = TPGroup(pg=None, rank=0, world=2, device=torch.device("cpu"), backend="gloo",
                  ranks=(0, 1))
    with pytest.raises(ValueError, match="init_fleet"):
        build_engine("llama3-1b", "llama3-1b", replicas=2, group=grp)
