"""The sharded forward of the other families over gloo ranks on the CPU
against the JAX package's single-device model on the same weights.

minicpm3 (MLA), zamba2 (mamba2 + the shared attention block), rwkv6 and
llama-3.2-vision (with its cross block and the stub encoder states), smoke
configs at tp 2 and tp 3: the prefill, the second forward — a
``spec_forward`` under a tree mask for the attention families, a
``chain_forward`` committing 3 of 5 steps for the recurrent ones — and
three ``decode_step``s after it, at the reference's 2e-4
(``tests/test_sharding.py:65``), every rank's logits bit equal.  At tp 3
zamba2's 8 mamba2 heads and rwkv6's 4 time-mix heads are whole on every
rank (3 does not divide them: the reference's ``spec_for`` replicates
them too), zamba2's shared block is padded from 4 heads to 6 and rwkv6's
channel-mix ff from 128 to 129; the ranks report their heads and every
cache leaf's shape.  ``reshard_params`` takes each family's shards from 2
ranks to 3 and back to the whole model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.configs import get_config as jget_config
from repro.models.api import make_model as jmake_model
from repro_torch.configs import ModelConfig
from repro_torch.models.api import make_model
from repro_torch.parallel.shard import Shard, unshard_params
from repro_torch.parallel.spawn import run_ranks
from repro_torch.runtime import reshard_params
from test_torch_model import unbox

TOL = dict(atol=2e-4, rtol=2e-4)  # the reference's own (tests/test_sharding.py:65)
S_MAX = 64
SPAWN_S = 120
ARCHS = ("minicpm3-4b", "zamba2-2.7b", "rwkv6-7b", "llama-3.2-vision-90b")
CHAIN = ("zamba2-2.7b", "rwkv6-7b")  # the recurrent families: a chain forward, no tree
WORLDS = (2, 3)
N_COMMIT = 3


def _port(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _case(arch, seed):
    """The worker's case and the reference's logits (prefill, the second
    forward, decodes)."""
    jcfg = jget_config(arch, smoke=True)
    jm = jmake_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    B, P, n = 2, 8, 5
    prompt = rng.integers(0, jcfg.vocab_size, size=(B, P)).astype(np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, n)).astype(np.int32)
    enc = None
    if jcfg.n_enc_tokens and "cross" in jcfg.block_pattern:
        enc = rng.normal(size=(B, jcfg.n_enc_tokens, jcfg.d_model)).astype(np.float32)
    case = {"cfg": _port(jcfg), "tree": unbox(jp), "prompt": prompt, "enc": enc, "S_max": S_MAX}
    jl, jc = jm.prefill(jp, tokens=jnp.asarray(prompt),
                        enc=None if enc is None else jnp.asarray(enc), S_max=S_MAX)
    if arch in CHAIN:
        case["chain"] = (tokens, N_COMMIT)
        js, jc = jm.chain_forward(jp, jc, jnp.asarray(tokens), N_COMMIT, S_MAX)
    else:  # a tree of five nodes under the prompt, one query seeing nothing
        rows = np.array([[P, P + 1, -1, P + 2, P + 3], [P, P + 2, P + 1, P + 3, -1]], np.int32)
        positions = np.array([[P, P + 1, P + 1, P + 2, P + 3]] * 2, np.int32)
        mask = np.zeros((B, n, S_MAX), bool)
        mask[:, :, :P] = True
        for b in range(B):
            for i in range(n):
                if rows[b, i] >= 0:
                    mask[b, i, rows[b, i]] = True
                    mask[b, i, rows[b, :i][rows[b, :i] >= 0]] = \
                        rng.random(int((rows[b, :i] >= 0).sum())) < 0.6
        mask[1, 4] = False
        case["spec"] = (tokens, positions, rows, mask)
        js, jc = jm.spec_forward(jp, jc, *map(jnp.asarray, (tokens, positions, rows, mask)))
    case["decode"] = [rng.integers(0, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
                      for _ in range(3)]
    jd = []
    for tok in case["decode"]:
        lg, jc = jm.decode_step(jp, jc, jnp.asarray(tok), S_MAX)
        jd.append(np.asarray(lg))
    return case, {"prefill": np.asarray(jl), "second": np.asarray(js), "decode": jd}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(arch, world) -> (per-rank results, reference); one spawn per world
    size runs every family."""
    cases = {arch: _case(arch, seed) for seed, arch in enumerate(ARCHS)}
    out = {}
    for world in WORLDS:
        calls = [("forward", ([c for c, _ in cases.values()],)), ("foreign_modules", ())]
        ranks = run_ranks("repro_torch.parallel.workers:several", world, (calls,),
                          workdir=tmp_path_factory.mktemp(f"families{world}"), device="cpu",
                          timeout_s=SPAWN_S)
        for i, (arch, (_, want)) in enumerate(cases.items()):
            out[arch, world] = ([r[0][i] for r in ranks], want)
        out["modules", world] = [r[1] for r in ranks]
    return out


def _second(res):
    return res["chain"] if "chain" in res else res["spec"]


def test_spawned_ranks_load_no_jax(runs):
    assert runs["modules", 2] == [[], []] and runs["modules", 3] == [[], [], []]


@pytest.mark.parametrize("what", ["prefill", "second", "decode"])
@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_family_matches_the_single_device_reference(runs, arch, world, what):
    ranks, want = runs[arch, world]
    for r, res in enumerate(ranks):
        if what == "decode":
            for step, (g, w) in enumerate(zip(res["decode"], want["decode"])):
                np.testing.assert_allclose(g, w, err_msg=f"rank {r} decode {step}", **TOL)
        else:
            got = res["prefill"] if what == "prefill" else _second(res)
            np.testing.assert_allclose(got, want[what], err_msg=f"rank {r} {what}", **TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_every_rank_of_a_family_holds_the_same_logits_bit_for_bit(runs, arch, world):
    ranks, _ = runs[arch, world]
    for res in ranks[1:]:
        assert np.array_equal(res["prefill"], ranks[0]["prefill"])
        assert np.array_equal(_second(res), _second(ranks[0]))
        for a, b in zip(res["decode"], ranks[0]["decode"]):
            assert np.array_equal(a, b)


# (arch, world) -> per rank: (Hq, Hkv), recurrent heads, {leaf: shape without U, B}
LAYOUTS = {
    # MLA: 4 heads, 2 a rank; at tp 3 padded to 6, 2 a rank; the latents whole on every rank
    ("minicpm3-4b", 2): [((2, 2), 0, {"0.0.ckv": (S_MAX, 16), "0.0.krope": (S_MAX, 8)})] * 2,
    ("minicpm3-4b", 3): [((2, 2), 0, {"0.0.ckv": (S_MAX, 16), "0.0.krope": (S_MAX, 8)})] * 3,
    # zamba2: 8 mamba2 heads of 16 (d_in 128, conv 128 + 2·16 BC channels), 4 a rank at tp 2
    # (conv 64 + 32), whole at tp 3; the shared block's 4 heads 2 a rank, padded to 6 at tp 3
    ("zamba2-2.7b", 2): [((2, 2), 4, {"0.0.conv": (3, 96), "0.0.ssm": (4, 16, 16),
                                      "0.2.k": (S_MAX, 2, 16)})] * 2,
    ("zamba2-2.7b", 3): [((2, 2), 0, {"0.0.conv": (3, 160), "0.0.ssm": (8, 16, 16),
                                      "0.2.k": (S_MAX, 2, 16)})] * 3,
    # rwkv6: 4 time-mix heads of 16, 2 a rank at tp 2, whole at tp 3; token shifts whole
    ("rwkv6-7b", 2): [((0, 0), 2, {"0.0.sx_tm": (64,), "0.0.wkv": (2, 16, 16),
                                   "0.0.sx_cm": (64,)})] * 2,
    ("rwkv6-7b", 3): [((0, 0), 0, {"0.0.sx_tm": (64,), "0.0.wkv": (4, 16, 16),
                                   "0.0.sx_cm": (64,)})] * 3,
    # vision: 4 query heads over 2 KV heads; at tp 3 padded to 6 (G 3), the middle rank
    # reading both KV heads; the cross block's encoder K/V hold the rank's KV heads
    ("llama-3.2-vision-90b", 2): [((2, 1), 0, {"0.0.k": (S_MAX, 1, 16),
                                                "0.4.ek": (16, 1, 16)})] * 2,
    ("llama-3.2-vision-90b", 3): [((h, k), 0, {"0.0.k": (S_MAX, k, 16), "0.4.ek": (16, k, 16)})
                                  for h, k in ((3, 1), (6, 2), (3, 1))],
}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_ranks_report_their_heads_states_and_latents(runs, arch, world):
    ranks, _ = runs[arch, world]
    for r, (res, (heads, ssm, leaves)) in enumerate(zip(ranks, LAYOUTS[arch, world])):
        assert res["heads"] == heads and res["ssm_heads"] == ssm, r
        got = {k: v[2:] for k, v in res["leaves"].items() if k in leaves}  # [U, B, ...]
        assert got == leaves, r
        local = Shard(_port(jget_config(arch, smoke=True)), r, world).local_cfg
        assert (local.n_heads, local.n_kv_heads, local.ssm_heads) == heads + (ssm,)


@pytest.mark.parametrize("arch", ARCHS)
def test_reshard_params_of_a_family_from_two_ranks_to_three_and_back_to_whole(arch):
    """Two ranks' shards, cut again for three ranks, equal three ranks'
    shards of the whole model; joined, they are the whole model bit for
    bit."""
    cfg = _port(jget_config(arch, smoke=True))
    full = make_model(cfg, "cpu").init(0)
    two = [Shard(cfg, r, 2).params(full) for r in range(2)]
    three = [reshard_params(cfg, two, r, 3) for r in range(3)]
    for r, got in enumerate(three):
        want = dict(Shard(cfg, r, 3).params(full).named_parameters())
        for name, t in got.named_parameters():
            assert torch.equal(t, want[name]), (r, name)
    back = dict(unshard_params(cfg, three).named_parameters())
    for name, t in full.named_parameters():
        assert torch.equal(back[name], t), name
