"""The engines on the other families with target and draft sharded over the
same gloo ranks on the CPU, against the JAX package's single-device
engines on the same weights.

``ChainSpecEngine`` on zamba2's and rwkv6's smoke configs (lm_head x4),
each drafting for itself and with an independent seed-7 draft, parallel
and serial, at tp 2 (the recurrent heads split) and tp 3 (whole on every
rank, the shared block and the channel-mix ff padded): the reference's
tokens with every ``ChainStats`` field but ``wall_s`` equal, the same
tokens as the sharded target's own greedy decode, on every rank.  The
tree engine on minicpm3 (MLA), drafting for itself, lockstep and async,
at tp 2 and 3: the reference's ``SpecEngine`` tokens and every
``SpecStats`` field.  A split of three ranks (``parallel.split``): zamba2's
chain target over ranks 0-1 and its draft on rank 2.  Parallel mode
refuses a draft on the target's process group.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.configs import get_config as jget_config
from repro.core.chain_engine import ChainConfig as JChainConfig
from repro.core.chain_engine import ChainSpecEngine as JChainSpecEngine
from repro.core.engine import SpecConfig as JSpecConfig
from repro.core.engine import SpecEngine as JSpecEngine
from repro.models.api import make_model as jmake_model
from repro_torch.configs import ModelConfig
from repro_torch.core.chain_engine import ChainConfig, ChainSpecEngine
from repro_torch.models.api import make_model
from repro_torch.parallel import TPGroup
from repro_torch.parallel.spawn import run_ranks
from test_torch_model import unbox

S_MAX = 256
K, MAX_NEW = 4, 16
MODES = ("parallel", "serial")
CHAIN_CASES = ("zamba2-self", "zamba2-seed7", "rwkv6-self", "rwkv6-seed7")
CHAIN_STATS = ("rounds", "emitted", "accepted", "reused_chains", "draft_chains")
TREE = dict(bs=8, w=4, c=2, d=2, n_cap=64, max_new=MAX_NEW)
TREE_RUNS = {"lockstep": TREE, "async": dict(TREE, async_rounds=True)}
TREE_STATS = ("rounds", "draft_steps", "emitted_rows", "accepted_rows", "spec_rounds",
              "spec_commits")
ARCH = {"zamba2": "zamba2-2.7b", "rwkv6": "rwkv6-7b"}
SPAWN_S = 120


def _model(arch, seed):
    jm = jmake_model(jget_config(arch, smoke=True))
    jp = jm.init(jax.random.PRNGKey(seed))
    jp["lm_head"].value = jp["lm_head"].value * 4.0  # peaked greedy chains
    return jm, jp


def _prompt(vocab):
    return (np.arange(2, 10, dtype=np.int32) * 5 % vocab).reshape(1, 8)


@pytest.fixture(scope="module")
def models():
    """name -> (JAX model, JAX target params, JAX draft params, port cfg,
    numpy trees (target, draft or None: the target drafts for itself))."""
    out = {}
    for fam, arch in ARCH.items():
        jm, jt = _model(arch, 0)
        _, jd = _model(arch, 7)
        cfg = ModelConfig(**dataclasses.asdict(jm.cfg))
        out[f"{fam}-self"] = (jm, jt, jt, cfg, (unbox(jt), None))
        out[f"{fam}-seed7"] = (jm, jt, jd, cfg, (unbox(jt), unbox(jd)))
    jm, jt = _model("minicpm3-4b", 0)
    out["minicpm3"] = (jm, jt, jt, ModelConfig(**dataclasses.asdict(jm.cfg)), (unbox(jt), None))
    return out


@pytest.fixture(scope="module")
def reference(models):
    """(case, run) -> (tokens, stats) of the reference's engines."""
    out, engines = {}, {}
    for name in CHAIN_CASES:
        jm, jt, jd, cfg, _ = models[name]
        for mode in MODES:  # one engine (its jitted programs) serves both drafts
            eng = engines.setdefault((cfg.name, mode), JChainSpecEngine(
                jm, jm, JChainConfig(k=K, mode=mode, max_new=MAX_NEW), S_MAX, S_MAX))
            toks, st = eng.session(jt, jd).generate(_prompt(cfg.vocab_size))
            out[name, mode] = (toks[0], {f: getattr(st, f) for f in CHAIN_STATS})
    jm, jt, _, cfg, _ = models["minicpm3"]
    for run, kw in TREE_RUNS.items():
        toks, st = JSpecEngine(jm, jm, JSpecConfig(**kw), S_max_t=S_MAX, S_max_d=S_MAX).session(
            jt, jt).generate(_prompt(cfg.vocab_size))
        out["minicpm3", run] = (toks[0], {"rounds": st.rounds, "draft_steps": st.draft_steps,
                                          "emitted_rows": st.emitted_rows.tolist(),
                                          "accepted_rows": st.accepted_rows.tolist(),
                                          "spec_rounds": st.spec_rounds,
                                          "spec_commits": st.spec_commits})
    return out


@pytest.fixture(scope="module", params=[2, 3], ids=["tp2", "tp3"])
def ranks(request, models, tmp_path_factory):
    """(world, {case: per-rank results}): one spawn per world size runs every
    chain case, the minicpm3 tree engine and, on three ranks, the split."""
    world = request.param
    calls = []
    for name in CHAIN_CASES:
        _, _, _, cfg, (ttree, dtree) = models[name]
        calls.append(("chain_engine", ({
            "tcfg": cfg, "dcfg": None if dtree is None else cfg,
            "weights": ("numpy", ttree, dtree), "prompts": [_prompt(cfg.vocab_size)],
            "runs": [(mode, dict(k=K, mode=mode, max_new=MAX_NEW)) for mode in MODES],
            "S_max": S_MAX, "greedy_n": MAX_NEW},)))
    _, _, _, cfg, (ttree, _) = models["minicpm3"]
    calls.append(("spec_engine", ({
        "tcfg": cfg, "dcfg": None, "weights": ("numpy", ttree, None),
        "prompts": [_prompt(cfg.vocab_size)], "runs": list(TREE_RUNS.items()), "S_max": S_MAX,
        "greedy_n": MAX_NEW},)))
    names = list(CHAIN_CASES) + ["minicpm3"]
    if world == 3:
        _, _, _, cfg, (ttree, _) = models["zamba2-self"]
        calls.append(("split_engine", ({
            "n_target": 2, "tcfg": cfg, "dcfg": None, "weights": ("numpy", ttree, None),
            "prompts": [_prompt(cfg.vocab_size)],
            "runs": [(mode, "chain", dict(k=K, mode=mode, max_new=MAX_NEW)) for mode in MODES],
            "S_max": S_MAX, "greedy_n": 0},)))
        names.append("zamba2-split")
    res = run_ranks("repro_torch.parallel.workers:several", world, (calls,),
                    workdir=tmp_path_factory.mktemp(f"tp_chain{world}"), device="cpu",
                    timeout_s=SPAWN_S)
    return world, {name: [r[i] for r in res] for i, name in enumerate(names)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CHAIN_CASES)
def test_tp_chain_engine_emits_the_reference_tokens_and_stats(ranks, reference, name, mode):
    world, by_case = ranks
    want, want_st = reference[name, mode]
    for res in by_case[name]:
        got = res["runs"][mode]
        assert got["tokens"] == [want], f"tp {world} rank {res['rank']}"
        assert {f: got["stats"][0][f] for f in CHAIN_STATS} == want_st
        greedy = res["greedy"][0]  # the sharded target's own greedy decode
        assert got["tokens"][0] == greedy[:len(got["tokens"][0])]
        assert res["greedy"] == by_case[name][0]["greedy"]
    if name.endswith("self"):  # drafting for itself every chain holds: reused in parallel
        st = by_case[name][0]["runs"][mode]["stats"][0]
        assert (st["reused_chains"] > 0) == (mode == "parallel")
    if name.endswith("seed7"):  # some chain rolled back
        st = by_case[name][0]["runs"][mode]["stats"][0]
        assert st["accepted"] < st["rounds"] * (K - 1)


@pytest.mark.parametrize("name", CHAIN_CASES)
def test_tp_chain_ranks_report_their_recurrent_heads(ranks, name):
    """zamba2's 8 mamba2 heads and rwkv6's 4 time-mix heads split at tp 2,
    whole on every rank at tp 3 (3 does not divide them)."""
    world, by_case = ranks
    heads = {"zamba2": 8, "rwkv6": 4}[name.split("-")[0]]
    for res in by_case[name]:
        for role in ("target", "draft"):
            assert res["layout"][role]["ssm_heads"] == (heads // 2 if world == 2 else 0)


@pytest.mark.parametrize("run", sorted(TREE_RUNS))
def test_tp_tree_engine_on_mla_emits_the_reference_tokens_and_stats(ranks, reference, run):
    world, by_case = ranks
    want, want_st = reference["minicpm3", run]
    for res in by_case["minicpm3"]:
        got = res["runs"][run]
        assert got["tokens"] == [want], f"tp {world} rank {res['rank']}"
        assert {k: got["stats"][0][k] for k in TREE_STATS} == want_st
        assert got["tokens"][0] == res["greedy"][0][:len(want)]
        assert res["heads"]["target"] == (2, 2)  # 4 heads, padded to 6 at tp 3


@pytest.mark.parametrize("mode", MODES)
def test_a_sharded_chain_target_on_two_ranks_and_its_draft_on_a_third(ranks, reference, mode):
    world, by_case = ranks
    if world != 3:
        assert "zamba2-split" not in by_case
        return
    want, want_st = reference["zamba2-self", mode]
    split = by_case["zamba2-split"]
    assert [(r["role"], r["ranks"]) for r in split] == [("target", (0, 1))] * 2 + \
        [("draft", (2,))]
    for res in split:
        got = res["runs"][mode]
        assert got["tokens"] == [want], f"rank {res['rank']}"
        assert {f: got["stats"][0][f] for f in CHAIN_STATS} == want_st
        assert res["standin"] == {"is_standin": True, "tensors": 0}


def _fake_group(rank, world, pg=None):
    return TPGroup(pg=pg, rank=rank, world=world, device=torch.device("cpu"), backend="gloo",
                   ranks=tuple(range(world)))


def test_parallel_chain_mode_refuses_a_draft_on_the_targets_process_group():
    cfg = ModelConfig(**dataclasses.asdict(jget_config("zamba2-2.7b", smoke=True)))
    T = make_model(cfg, "cpu", _fake_group(0, 2))
    with pytest.raises(ValueError, match="new_group"):
        ChainSpecEngine(T, T, ChainConfig(mode="parallel"), 64, 64)
    ChainSpecEngine(T, T, ChainConfig(mode="serial"), 64, 64)  # one stream: one group is fine
    D = make_model(cfg, "cpu", _fake_group(0, 2, pg=object()))
    ChainSpecEngine(T, D, ChainConfig(mode="parallel"), 64, 64)
