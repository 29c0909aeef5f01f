"""The sharded forward over gloo ranks on the CPU against the JAX package's
single-device model on the same weights.

Ranks are spawned by ``repro_torch.parallel.spawn.run_ranks`` (a
``FileStore`` under ``tmp_path``, one thread each, a time limit per
spawn); every rank's work is a rank program of the port
(``repro_torch.parallel.workers``), fed the reference's numpy weights.
Dense: qwen2.5-14b smoke at tp 2 and at tp 3 (padded by ``resolve_for_tp``
to 6 query heads over 2 KV heads, which 3 ranks do not divide), and
``ModelConfig(n_heads=12, n_kv_heads=4)`` at tp 3 (uneven groups): prefill,
``spec_forward`` under a tree mask and ``decode_step`` at the reference's
2e-4, every rank's logits bit equal.  MoE: deepseek-moe-16b smoke at tp 2
in the "ep" form and at tp 3 (8 experts: "ep" falls back to "tp"),
mixtral-8x22b smoke at tp 2 in both forms, drop-free and with drops,
against the reference's ``moe_apply``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro.models.api import make_model as jmake_model
from repro_torch.configs import ModelConfig
from repro_torch.parallel.shard import Shard
from repro_torch.parallel.spawn import run_ranks
from test_torch_model import unbox

TOL = dict(atol=2e-4, rtol=2e-4)  # the reference's own (tests/test_sharding.py:65)
S_MAX = 64
SPAWN_S = 120
QWEN = jget_config("qwen2.5-14b", smoke=True)
UNEVEN = dataclasses.replace(QWEN, name="uneven", d_model=64, n_heads=12, n_kv_heads=4,
                             head_dim=16)
DENSE = {"qwen-tp2": (QWEN, 2), "qwen-tp3": (QWEN, 3), "uneven-tp3": (UNEVEN, 3)}
MOE = {  # id -> (config, world, form, capacity factor)
    "dsmoe-ep-tp2": ("deepseek-moe-16b", 2, "ep", 8.0),
    "dsmoe-ep-tp2-drops": ("deepseek-moe-16b", 2, "ep", 1.25),
    "dsmoe-tp3": ("deepseek-moe-16b", 3, "ep", 8.0),
    "dsmoe-tp3-drops": ("deepseek-moe-16b", 3, "tp", 1.25),
    "mixtral-tp-tp2": ("mixtral-8x22b", 2, "tp", 1.25),
    "mixtral-ep-tp2": ("mixtral-8x22b", 2, "ep", 1.25),
}
HOT = [0, 1, 3, 4, 6, 7, 9, 10, 12, 13, 14, 15]  # rows that pick row 0's experts: drops


def _dense_case(jcfg, seed):
    """The worker's case and the reference's logits (prefill, spec, decodes)."""
    jm = jmake_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    if jcfg.qkv_bias:  # biases drawn at random: not additions of zero
        (unit,) = jp["groups"][0]
        for name in ("bq", "bk", "bv"):
            unit["attn"][name].value = jnp.asarray(
                0.1 * rng.normal(size=unit["attn"][name].value.shape), jnp.float32)
    B, P, n = 2, 8, 5
    prompt = rng.integers(0, jcfg.vocab_size, size=(B, P)).astype(np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, n)).astype(np.int32)
    rows = np.array([[P - 1, P, -1, P + 2, P + 1], [P - 1, P + 1, P, P + 3, -1]], np.int32)
    positions = np.array([[P - 1, P, P, P + 1, P + 2], [P - 1, P, P, P + 1, P + 2]], np.int32)
    mask = np.zeros((B, n, S_MAX), bool)
    mask[:, :, :P - 1] = True
    for b in range(B):
        for i in range(n):
            if rows[b, i] >= 0:
                mask[b, i, rows[b, i]] = True
                mask[b, i, rows[b, :i][rows[b, :i] >= 0]] = \
                    rng.random(int((rows[b, :i] >= 0).sum())) < 0.6
    mask[1, 4] = False  # a query that sees nothing attends to nothing
    decode = [rng.integers(0, jcfg.vocab_size, size=(B, 1)).astype(np.int32) for _ in range(3)]
    jl, jc = jm.prefill(jp, tokens=jnp.asarray(prompt), S_max=S_MAX)
    js, jc = jm.spec_forward(jp, jc, *map(jnp.asarray, (tokens, positions, rows, mask)))
    jd = []
    for tok in decode:
        lg, jc = jm.decode_step(jp, jc, jnp.asarray(tok), S_MAX)
        jd.append(np.asarray(lg))
    case = {"cfg": ModelConfig(**dataclasses.asdict(jcfg)), "tree": unbox(jp), "prompt": prompt,
            "spec": (tokens, positions, rows, mask), "decode": decode, "S_max": S_MAX}
    return case, {"prefill": np.asarray(jl), "spec": np.asarray(js), "decode": jd}


def _moe_case(name, capacity_factor, seed=0):
    jcfg = dataclasses.replace(jget_config(name, smoke=True), capacity_factor=capacity_factor)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(seed))
    p = unbox(jp)
    shared = p.pop("shared", None)
    x = np.random.default_rng(seed).normal(size=(2, 8, jcfg.d_model)).astype(np.float32)
    x.reshape(16, -1)[HOT] = x[0, 0]
    want = np.asarray(jmoe.moe_apply(jcfg, jp, jnp.asarray(x)))
    return {"cfg": ModelConfig(**dataclasses.asdict(jcfg)), "routed": p, "shared": shared,
            "x": x}, want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn per world size: every dense and MoE case of that size.
    Returns {case id: (per-rank results, reference)}."""
    out = {}
    for world in (2, 3):
        dense = {k: _dense_case(c, seed) for seed, (k, (c, w)) in enumerate(DENSE.items())
                 if w == world}
        moe = {}
        for k, (name, w, form, cf) in MOE.items():
            if w == world:
                case, want = _moe_case(name, cf)
                moe[k] = (dict(case, moe_form=form), want)
        calls = [("forward", ([c for c, _ in dense.values()],)),
                 ("moe", ([c for c, _ in moe.values()],)), ("foreign_modules", ())]
        ranks = run_ranks("repro_torch.parallel.workers:several", world, (calls,),
                          workdir=tmp_path_factory.mktemp(f"tp{world}"), device="cpu",
                          timeout_s=SPAWN_S)
        for i, (k, (_, want)) in enumerate(dense.items()):
            out[k] = ([r[0][i] for r in ranks], want)
        for i, (k, (_, want)) in enumerate(moe.items()):
            out[k] = ([r[1][i] for r in ranks], want)
        out[f"modules-tp{world}"] = [r[2] for r in ranks]
    return out


def test_spawned_ranks_load_no_jax(runs):
    """A rank imports the port only, though its caller holds the reference."""
    assert runs["modules-tp2"] == [[], []] and runs["modules-tp3"] == [[], [], []]


@pytest.mark.parametrize("what", ["prefill", "spec", "decode"])
@pytest.mark.parametrize("case", sorted(DENSE))
def test_sharded_forward_matches_the_single_device_reference(runs, case, what):
    ranks, want = runs[case]
    for r, res in enumerate(ranks):
        got = res[what]
        if what == "decode":
            for step, (g, w) in enumerate(zip(got, want[what])):
                np.testing.assert_allclose(g, w, err_msg=f"rank {r} decode {step}", **TOL)
        else:
            np.testing.assert_allclose(got, want[what], err_msg=f"rank {r} {what}", **TOL)


@pytest.mark.parametrize("case", sorted(DENSE))
def test_every_rank_holds_the_same_logits_bit_for_bit(runs, case):
    ranks, _ = runs[case]
    for res in ranks[1:]:
        assert np.array_equal(res["prefill"], ranks[0]["prefill"])
        assert np.array_equal(res["spec"], ranks[0]["spec"])
        for a, b in zip(res["decode"], ranks[0]["decode"]):
            assert np.array_equal(a, b)


def test_per_rank_heads_and_caches():
    """(Hq, Hkv) per rank: qwen2.5 smoke at tp 2 splits evenly; at tp 3
    (6 heads over 2 KV heads) the middle rank reads both KV heads; the
    uneven 12/4 config keeps two KV heads and two groups of 3 on every
    rank.  Each cache holds the rank's KV heads only."""

    def heads(cfg, world):
        return [(Shard(cfg, r, world).local_cfg.n_heads, Shard(cfg, r, world).local_cfg.n_kv_heads)
                for r in range(world)]

    qwen = ModelConfig(**dataclasses.asdict(QWEN))
    assert heads(qwen, 2) == [(2, 1), (2, 1)]
    assert heads(qwen, 3) == [(3, 1), (6, 2), (3, 1)]
    assert heads(ModelConfig(**dataclasses.asdict(UNEVEN)), 3) == [(6, 2)] * 3


def test_ranks_report_their_layouts(runs):
    for case, (cfg, world) in DENSE.items():
        ranks, _ = runs[case]
        for r, res in enumerate(ranks):
            local = Shard(ModelConfig(**dataclasses.asdict(cfg)), r, world).local_cfg
            assert res["heads"] == (local.n_heads, local.n_kv_heads)
            assert res["cache"] == (cfg.n_layers, 2, S_MAX, local.n_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("case", sorted(MOE))
def test_moe_forms_match_the_reference(runs, case):
    ranks, want = runs[case]
    name, world, form, _ = MOE[case]
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["out"], want, err_msg=f"rank {r}", **TOL)
        assert np.array_equal(res["out"], ranks[0]["out"])
        n_experts = jget_config(name, smoke=True).n_experts
        assert res["ep"] == (form == "ep" and n_experts % world == 0)
