"""The disaggregated chain engine: target and draft on two gloo ranks on
the CPU (``repro_torch.parallel.split``), against the JAX package's
``ChainSpecEngine`` on the same weights.

The dense pair, zamba2's smoke config drafting for itself (a copy on the
draft's rank) and zamba2 with an independent seed-7 draft, world 1 + 1,
parallel and serial: tokens and every ``ChainStats`` field but ``wall_s``
must equal the reference's, and the same on both ranks.  A request
crosses its first token once, then two broadcasts a round (the chain, the
argmax); the draft's rank holds no target weights and the target's no
draft weights.
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
from repro.models.api import make_model as jmake_model
from repro_torch.configs import ModelConfig, get_config
from repro_torch.parallel.spawn import run_ranks
from test_torch_model import unbox

S_CHAIN = 256
K, MAX_NEW = 4, 20
MODES = ("parallel", "serial")
CASES = ("dense-pair", "zamba2-self", "zamba2-seed7")
STAT_FIELDS = ("rounds", "emitted", "accepted", "reused_chains", "draft_chains")
SPAWN_S = 120


def _zamba(seed):
    jm = jmake_model(jget_config("zamba2-2.7b", smoke=True))
    jp = jm.init(jax.random.PRNGKey(seed))
    jp["lm_head"].value = jp["lm_head"].value * 4.0
    return jm, jp


@pytest.fixture(scope="module")
def cases(dense_pair):
    """name -> (JAX target, JAX draft, JAX params (t, d), port target cfg,
    port draft cfg or None (self-draft), numpy trees (t, d or None))."""
    T, D, jtp, jdp = dense_pair
    jz, jz0 = _zamba(0)
    _, jz7 = _zamba(7)
    zcfg = get_config("zamba2-2.7b", smoke=True)
    return {
        "dense-pair": (T, D, (jtp, jdp), ModelConfig(**dataclasses.asdict(T.cfg)),
                       ModelConfig(**dataclasses.asdict(D.cfg)), (unbox(jtp), unbox(jdp))),
        "zamba2-self": (jz, jz, (jz0, jz0), zcfg, None, (unbox(jz0), None)),
        "zamba2-seed7": (jz, jz, (jz0, jz7), zcfg, zcfg, (unbox(jz0), unbox(jz7))),
    }


def _prompt(vocab):
    return (np.arange(2, 10, dtype=np.int32) % vocab).reshape(1, 8)


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    """name -> the two ranks' results of ``workers.split_engine``."""
    calls = []
    for name in CASES:
        _, _, _, tcfg, dcfg, (ttree, dtree) = cases[name]
        runs = [(mode, "chain", dict(k=K, mode=mode, max_new=MAX_NEW)) for mode in MODES]
        calls.append(("split_engine", ({"n_target": 1, "tcfg": tcfg, "dcfg": dcfg,
                                        "weights": ("numpy", ttree, dtree),
                                        "prompts": [_prompt(tcfg.vocab_size)], "runs": runs,
                                        "S_max": S_CHAIN, "greedy_n": MAX_NEW},)))
    res = run_ranks("repro_torch.parallel.workers:several", 2, (calls,),
                    workdir=tmp_path_factory.mktemp("split_chain"), device="cpu",
                    timeout_s=SPAWN_S)
    return {name: [r[i] for r in res] for i, name in enumerate(CASES)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CASES)
def test_split_chain_engine_matches_the_reference(cases, ranks, name, mode):
    jT, jD, jparams, tcfg, _, _ = cases[name]
    want, jst = JChainSpecEngine(jT, jD, JChainConfig(k=K, mode=mode, max_new=MAX_NEW), S_CHAIN,
                                 S_CHAIN).session(*jparams).generate(_prompt(tcfg.vocab_size))
    target, draft = ranks[name]
    assert (target["role"], draft["role"]) == ("target", "draft")
    assert target["greedy"][0][:len(want[0])] == want[0]  # the target's greedy decode
    for res in (target, draft):
        got = res["runs"][mode]
        assert got["tokens"] == want
        assert [got["stats"][0][f] for f in STAT_FIELDS] == [getattr(jst, f) for f in STAT_FIELDS]
        # the first token once, then the chain and the argmax each round
        assert got["collectives"] == {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
                                      "broadcast": 1 + 2 * got["rounds"]}
        assert res["standin"] == {"is_standin": True, "tensors": 0}
    if name == "zamba2-self":
        assert (target["runs"][mode]["stats"][0]["reused_chains"] > 0) == (mode == "parallel")
    if name == "zamba2-seed7":
        st = target["runs"][mode]["stats"][0]
        assert st["accepted"] < st["rounds"] * (K - 1)  # some chain rolled back
