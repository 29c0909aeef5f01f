"""Sequence-sharded activations (``seq_shard``) over gloo ranks on the CPU,
against the JAX package's single-device model and the port's
single-process step.

The reference's ``seq_shard_acts`` flag only constrains layouts: on one
device its forward is the plain one (``test_the_oracle_is_the_same_with_
and_without_seq_shard_acts``), and its train steps here run under it.  The
port's sequence-sharded form splits the residual stream's rows over the
model ranks between the blocks (``workers.tp_train`` with "seq_shard"),
so every check of ``tests/test_torch_tp_train.py`` holds again at the
same tolerances: two steps of the seven step configs at tp 2 against the
reference (deepseek-moe-16b in both MoE forms) and at tp 3 — where S 8
leaves the last rank one pad row, and ``resolve_for_tp`` pads every config
— against the port's single-process step on the padded config; the joined
first-batch gradient against the single-process one; every whole tensor's
gradient bit equal on every rank.  Also: a sequence-sharded prefill's
logits and cache against the reference (llama3-1b at tp 2, and zamba2 at
tp 3, whose mamba2 blocks the ranks run whole on the gathered sequence),
greedy steps from that cache, ``remat="full"``'s gradients against
``"none"``'s under ``seq_shard``, the collectives of a forward and of a
step, and the forms that need no group or refuse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.flags import override_flags
from repro.launch.steps import make_train_step as jmake_train_step
from repro.optim import adamw_init as jadamw_init
from repro_torch.configs import get_config
from repro_torch.configs.base import resolve_for_tp
from repro_torch.convert import params_from_numpy
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models.api import make_model
from repro_torch.models.transformer import Ctx, apply_model
from repro_torch.parallel.shard import Shard
from repro_torch.parallel.spawn import run_ranks
from test_torch_model import unbox
from test_torch_tp_train import CASES, LR, SPAWN_S, _case_id, _close, _joined, _single_step
from test_torch_train_steps import STEP_CONFIGS, _batch, _pair

TOL = dict(atol=2e-4, rtol=2e-4)  # the sharded forward's (tests/test_torch_tp_forward.py)
S_MAX = 16
DECODE = 3  # greedy steps from a prefill's cache
PREFILL = {"llama3-1b": 2, "zamba2-2.7b": 3}  # config -> tp of its sequence-sharded prefill
REMAT = (("llama3-1b", 2), ("rwkv6-7b", 3))  # (config, tp) trained with remat="full" too


@pytest.fixture(scope="module")
def reference():
    """name -> (numpy tree of the seed-0 weights, the two batches, the
    reference's losses and params after two steps under
    ``seq_shard_acts``), as ``test_torch_tp_train.py``'s fixture."""
    out = {}
    for name in STEP_CONFIGS:
        jm, jp, tm, _ = _pair(name)
        tree = unbox(jp)
        batches = [_batch(tm.cfg, k) for k in range(2)]
        losses = []
        with override_flags(seq_shard_acts=True):
            jstep = jax.jit(jmake_train_step(jm.cfg, jm, **LR))
            jopt = jadamw_init(jp)
            for b in batches:
                jp, jopt, jloss = jstep(jp, jopt, {n: jnp.asarray(v) for n, v in b.items()})
                losses.append(float(jloss))
        out[name] = (tree, batches, losses, params_from_numpy(tm.cfg, unbox(jp), "cpu"))
    return out


def _prompt(cfg):
    return np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, 8)).astype(np.int32)


@pytest.fixture(scope="module")
def prefills(reference):
    """name -> the reference's prefill logits and cache leaves ("g.b.key"),
    without and with ``seq_shard_acts``."""
    out = {}
    for name in PREFILL:
        jm, jp = _pair(name)[:2]
        prompt = _prompt(jm.cfg)
        runs = []
        for flag in (False, True):
            with override_flags(seq_shard_acts=flag):
                jl, jc = jm.prefill(jp, tokens=jnp.asarray(prompt), S_max=S_MAX)
            runs.append((np.asarray(jl), {f"{gi}.{bi}.{k}": np.asarray(x)
                                          for gi, unit in enumerate(jc["groups"])
                                          for bi, blk in enumerate(unit) for k, x in blk.items()}))
        out[name] = runs
    return out


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """(name, tp, form) -> every rank's sequence-sharded ``tp_train``;
    ("remat", name, tp) -> the same with remat="full"; ("prefill", name) ->
    every rank's ``seq_prefill``.  One spawn per world."""
    out = {}
    for tp in (2, 3):
        keys, calls = [], []

        def job(name, **kw):
            return {"cfg": get_config(name, smoke=True), "weights": ("numpy", reference[name][0]),
                    "batches": reference[name][1], "lr": LR, "seq_shard": True,
                    "all_grads": True, **kw}

        for case in (c for c in CASES if c[1] == tp):
            keys.append(case)
            calls.append(("tp_train", (job(case[0], moe_form=case[2]),)))
        for name, t in REMAT:
            if t == tp:
                keys.append(("remat", name, tp))
                calls.append(("tp_train", (job(name, remat="full"),)))
        for name, t in PREFILL.items():
            if t == tp:
                keys.append(("prefill", name))
                cfg = get_config(name, smoke=True)
                calls.append(("seq_prefill", ({"cfg": cfg, "weights": ("numpy", reference[name][0]),
                                               "prompt": _prompt(cfg), "S_max": S_MAX,
                                               "decode": DECODE},)))
        res = run_ranks("repro_torch.parallel.workers:several", tp, (calls,),
                        workdir=tmp_path_factory.mktemp(f"seqshard{tp}"), device="cpu",
                        timeout_s=SPAWN_S)
        for i, key in enumerate(keys):
            out[key] = [r[i] for r in res]
    return out


_SINGLE = {}


def _single(reference, name, tp):
    if (name, tp) not in _SINGLE:
        _SINGLE[name, tp] = _single_step(reference, name, tp)
    return _SINGLE[name, tp]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_two_seq_sharded_train_steps_match_the_reference(reference, ranks, case):
    """The losses on every rank and the joined parameters: against the
    reference's steps under ``seq_shard_acts`` at tp 2, against the port's
    single-process step on the padded config at tp 3."""
    name, tp, form = case
    per_rank = ranks[case]
    if tp == 2:
        want_losses, want = reference[name][2], reference[name][3]
    else:
        want_losses, want = _single(reference, name, tp)[:2]
    for r in per_rank:
        np.testing.assert_allclose(r["losses"], want_losses, rtol=1e-5,
                                   err_msg=f"{case} rank {r['rank']}")
        assert r["losses"] == per_rank[0]["losses"]
    joined = _joined(name, tp, form, per_rank)
    for pname, w in want.named_parameters():
        assert joined[pname].shape == w.shape, pname
        _close(joined[pname], w, f"{case} {pname}")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_the_seq_sharded_joined_gradient_is_the_single_process_gradient(reference, ranks, case):
    """After ``reduce_grads(..., seq_shard=True)``, joined, at 1e-4 of each
    tensor's scale: a norm whose rows' gradients were not summed over the
    ranks would be 1/tp of it."""
    name, tp, form = case
    want = _single(reference, name, tp)[3]
    joined = _joined(name, tp, form, ranks[case], "grads")
    for pname, w in want.items():
        g, w = joined[pname].numpy(), w.numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"{case} {pname}")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_seq_sharded_whole_gradients_are_the_same_bits_on_every_rank(ranks, case):
    per_rank = ranks[case]
    whole = per_rank[0]["whole_grads"]
    assert whole, case
    for r in per_rank[1:]:
        assert r["whole_grads"].keys() == whole.keys()
        for n, g in whole.items():
            assert np.array_equal(r["whole_grads"][n], g), (case, r["rank"], n)
            assert np.array_equal(r["params"][n], per_rank[0]["params"][n]), (case, n)


@pytest.mark.parametrize("name,tp", REMAT)
def test_remat_full_gives_the_same_gradients_under_seq_shard(ranks, name, tp):
    """Each unit recomputed in the backward, its all-gathers and
    reduce-scatters included: every rank's gradient and losses as without
    the recompute (the same operations on the same rows: bit for bit)."""
    for plain, full in zip(ranks[(name, tp, "tp")], ranks[("remat", name, tp)]):
        assert full["losses"] == plain["losses"]
        for n, g in plain["grads"].items():
            assert np.array_equal(full["grads"][n], g), (name, full["rank"], n)


@pytest.mark.parametrize("name", list(PREFILL))
def test_the_oracle_is_the_same_with_and_without_seq_shard_acts(prefills, name):
    """On one device the reference's constraints are no-ops: its prefill
    under ``seq_shard_acts`` is its plain prefill, bit for bit."""
    (jl, jc), (sl, sc) = prefills[name]
    assert np.array_equal(jl, sl)
    assert jc.keys() == sc.keys() and all(np.array_equal(jc[k], sc[k]) for k in jc)


@pytest.mark.parametrize("name", list(PREFILL))
def test_a_seq_sharded_prefill_matches_the_reference(prefills, ranks, name):
    """The logits on every rank within 2e-4 of the reference's under
    ``seq_shard_acts``, bit equal across ranks; the cache: the recurrent
    state leaves (whole on every rank) and the rank's KV heads of the
    reference's at 2e-4 where the config is not padded (tp 2), and every
    leaf within 1e-5 of its scale of the rank's whole-sequence prefill; the
    greedy steps from the cache those of the whole-sequence prefill's."""
    tp = PREFILL[name]
    cfg = get_config(name, smoke=True)
    jl, jc = prefills[name][1]
    per_rank = ranks[("prefill", name)]
    padded = resolve_for_tp(cfg, tp) != cfg
    for r in per_rank:
        got, plain = r["seq"], r["plain"]
        np.testing.assert_allclose(got["logits"], jl, **TOL, err_msg=f"{name} rank {r['rank']}")
        assert np.array_equal(got["logits"], per_rank[0]["seq"]["logits"])
        assert got["tokens"] == plain["tokens"] and len(got["tokens"][0]) == DECODE
        assert got["cache"].keys() == plain["cache"].keys() == jc.keys()
        kv_src = Shard(cfg, r["rank"], tp).attn[1]
        for key, leaf in got["cache"].items():
            w = plain["cache"][key]
            np.testing.assert_allclose(leaf, w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{name} {key}")
            want = jc[key] if key.endswith(("conv", "ssm")) else \
                None if padded else jc[key][..., list(kv_src), :]
            if want is not None:
                np.testing.assert_allclose(leaf, want, **TOL, err_msg=f"{name} {key}")


def test_collectives_of_a_seq_sharded_forward_and_train_step(ranks):
    """llama3-1b smoke at tp 2 (vocabulary split): a prefill issues one
    reduce-scatter for the lookup, then two all-gathers and two
    reduce-scatters per dense block, the final norm's rows gathered and the
    logits gathered, and no all-reduce (the whole-sequence form's lookup
    and two a block).  A train step adds the backward's counterparts (a
    reduce-scatter for each all-gather into rank-local work, an all-gather
    for each reduce-scatter), the logits' sum, the clip's norm and one sum
    of the gradients of the norms."""
    cfg = get_config("llama3-1b", smoke=True)
    L = cfg.n_layers
    assert Shard(cfg, 0, 2).vocab_split
    for r in ranks[("prefill", "llama3-1b")]:
        assert r["collectives"] == {"all_reduce": 0, "all_gather": 2 * L + 2,
                                    "reduce_scatter": 2 * L + 1, "broadcast": 0}
        assert r["launches"]["fused_swiglu"] == 0  # plain versions on the CPU
    for r in ranks[("llama3-1b", 2, "tp")]:
        per_step = {k: v // 2 for k, v in r["collectives"].items()}
        assert per_step == {"all_reduce": 3, "all_gather": (2 * L + 2) + (2 * L + 1),
                            "reduce_scatter": (2 * L + 1) + 2 * L, "broadcast": 0}


@pytest.mark.parametrize("name", ("llama3-1b", "zamba2-2.7b", "rwkv6-7b", "musicgen-large"))
def test_without_a_group_seq_shard_is_the_plain_forward(reference, name):
    """One rank holds every row: the same logits and gradients, bit for bit."""
    cfg = get_config(name, smoke=True)
    model = make_model(cfg, "cpu")
    params = params_from_numpy(cfg, reference[name][0], "cpu").requires_grad_(True)
    batch = reference[name][1][0]
    loss, grads = loss_and_grads(model, params, batch)
    seq_loss, seq_grads = loss_and_grads(model, params, batch, seq_shard=True)
    assert torch.equal(loss, seq_loss)
    assert all(torch.equal(a, b) for a, b in zip(grads, seq_grads))


def test_seq_shard_refuses_the_cached_forwards(reference):
    cfg = get_config("llama3-1b", smoke=True)
    model = make_model(cfg, "cpu")
    params = params_from_numpy(cfg, reference["llama3-1b"][0], "cpu")
    cache = model.init_cache(2, S_MAX)
    h = torch.zeros((2, 1, cfg.d_model))
    pos = torch.zeros((2, 1), dtype=torch.int32)
    ctx = Ctx(mode="cached", positions=pos, row_idx=pos,
              attn_mask=torch.ones((2, 1, S_MAX), dtype=torch.bool), row_start=0)
    with pytest.raises(ValueError, match="seq_shard"):
        apply_model(cfg, params, h, ctx, cache=cache, seq_shard=True)
    apply_model(cfg, params, h, ctx, cache=cache)  # the same call without it runs
