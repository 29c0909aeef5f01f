"""Tensor-parallel training over gloo ranks on the CPU, against the JAX
package's train step and the port's single-process one.

Two ``make_train_step`` steps of a model sharded over 2 and 3 ranks
(``workers.tp_train``), on the seven configs of
``tests/test_torch_train_steps.py`` (smoke size), deepseek-moe-16b in both
MoE forms.  At tp 2 no config is padded, and the joined parameters
(``Shard.join``) and the losses are held against the reference's
``make_train_step`` on the same numpy weights and batches; at tp 3
``resolve_for_tp`` pads every one of them (llama3-1b and
llama-3.2-vision-90b also get zero query slots and KV heads that two ranks
hold), and the comparison is with the port's single-process step on the
padded config and the padded weights, which ``test_torch_train_steps.py``
holds to the reference.  The tolerance is that file's: losses 1e-5
relative, parameters 1e-5 of each tensor's scale plus 1e-3 of step 1's
learning rate.  Also: every tensor that the ranks hold whole gets the same
gradient bits on every rank, the zero query slots stay zero, the clip's
norm over the group is the single-process norm, a serving forward issues
the collectives it issued before the collectives had a backward,
2 data x 2 model ranks equal the single-process step on the whole batch,
and with ``grad_compress_pod`` they average the gradient by the int8
exchange over the data ranks, within its rounding of the exact mean.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.launch.steps import make_train_step as jmake_train_step
from repro.optim import adamw_init as jadamw_init
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch.configs import get_config
from repro_torch.configs.base import resolve_for_tp
from repro_torch.convert import params_from_numpy
from repro_torch.launch.mesh import make_train_ranks
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models.api import make_model
from repro_torch.models.padding import pad_params
from repro_torch.models.transformer import param_where
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import global_norm
from repro_torch.parallel.shard import Shard
from repro_torch.parallel.spawn import run_ranks
from test_torch_model import unbox
from test_torch_train_steps import LR, STEP_CONFIGS, _batch, _pair

SPAWN_S = 120
# (config, tp, MoE form): every step config at tp 2 and 3, deepseek-moe's "ep" form at tp 2
CASES = [(name, tp, "tp") for tp in (2, 3) for name in STEP_CONFIGS] + \
    [("deepseek-moe-16b", 2, "ep")]
PAD_SLOTS = ("llama3-1b", "llama-3.2-vision-90b")  # zero query slots at tp 3
MESH = ("llama3-1b", 4, 2)  # (config, world, mesh_model): 2 data x 2 model ranks
LR1 = float(jwarmup_cosine(1, **LR))  # step 1's learning rate (step 0's is 0)


def _case_id(case):
    return f"{case[0]}-tp{case[1]}" + ("-ep" if case[2] == "ep" else "")


@pytest.fixture(scope="module")
def reference():
    """name -> (numpy tree of the seed-0 weights, the two batches, the
    reference's losses and params after two steps)."""
    out = {}
    for name in STEP_CONFIGS:
        jm, jp, tm, _ = _pair(name)
        tree = unbox(jp)
        batches = [_batch(tm.cfg, k) for k in range(2)]
        jstep = jax.jit(jmake_train_step(jm.cfg, jm, **LR))
        jopt = jadamw_init(jp)
        losses = []
        for b in batches:
            jp, jopt, jloss = jstep(jp, jopt, {n: jnp.asarray(v) for n, v in b.items()})
            losses.append(float(jloss))
        out[name] = (tree, batches, losses, params_from_numpy(tm.cfg, unbox(jp), "cpu"))
    return out


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """(name, tp, form) -> every rank's ``tp_train`` result; "mesh" -> the
    2 x 2 world's.  One spawn per world."""
    out = {}
    for tp in (2, 3):
        cases = [c for c in CASES if c[1] == tp]
        calls = [("tp_train", ({"cfg": get_config(name, smoke=True),
                                "weights": ("numpy", reference[name][0]),
                                "batches": reference[name][1], "lr": LR, "moe_form": form,
                                "all_grads": True,
                                "serve_prompt": reference[name][1][0]["tokens"]
                                if name == "llama3-1b" else None},))
                 for name, _, form in cases]
        res = run_ranks("repro_torch.parallel.workers:several", tp, (calls,),
                        workdir=tmp_path_factory.mktemp(f"tptrain{tp}"), device="cpu",
                        timeout_s=SPAWN_S)
        for i, case in enumerate(cases):
            out[case] = [r[i] for r in res]
    name, world, mesh_model = MESH
    cfg = get_config(name, smoke=True)
    job = {"cfg": cfg, "weights": ("numpy", reference[name][0]),
           "batches": reference[name][1], "lr": LR, "mesh_model": mesh_model, "all_grads": True}
    pod = {"grad_compress_pod": True}
    calls = [("tp_train", (job,)), ("tp_train", (dict(job, compress=True),)),
             ("train_step_error", (cfg, mesh_model, pod)), ("train_step_error", (cfg, world, pod))]
    res = run_ranks("repro_torch.parallel.workers:several", world, (calls,),
                    workdir=tmp_path_factory.mktemp("tptrain_mesh"), device="cpu",
                    timeout_s=SPAWN_S)
    for i, key in enumerate(("mesh", "mesh_int8", "pod_error", "pod_error_whole")):
        out[key] = [r[i] for r in res]
    return out


_SINGLE = {}


def _single(reference, name, tp):
    """``_single_step``, once per (config, tp)."""
    if (name, tp) not in _SINGLE:
        _SINGLE[name, tp] = _single_step(reference, name, tp)
    return _SINGLE[name, tp]


def _single_step(reference, name, tp):
    """The port's single-process step on the config ``resolve_for_tp`` gives
    at ``tp`` and the weights padded to it: (losses, params after two steps,
    the clip's norm of the first batch's gradient, that gradient by name)."""
    cfg = get_config(name, smoke=True)
    padded = resolve_for_tp(cfg, tp)
    tree, batches = reference[name][:2]
    params = pad_params(cfg, padded, params_from_numpy(cfg, tree, "cpu")).requires_grad_(True)
    model = make_model(padded, "cpu")
    _, grads = loss_and_grads(model, params, batches[0])
    gnorm = float(global_norm([g.float() for g in grads]))
    grads = {n: g for (n, _), g in zip(params.named_parameters(), grads)}
    step, opt, losses = make_train_step(padded, model, **LR), adamw_init(params), []
    for b in batches:
        params, opt, loss = step(params, opt, b)
        losses.append(float(loss))
    return losses, params, gnorm, grads


def _joined(name, tp, form, per_rank, what="params"):
    """name -> the padded model's tensor joined from every rank's part."""
    sh = Shard(get_config(name, smoke=True), 0, tp, form)
    return {n: sh.join(*param_where(n), [torch.tensor(r[what][n]) for r in per_rank])
            for n in per_rank[0][what]}


def _close(got, want, what):
    g, w = got.detach().numpy(), want.detach().numpy()
    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max() + 1e-3 * LR1,
                               err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_two_sharded_train_steps_match_the_reference(reference, ranks, case):
    """The losses on every rank and the joined parameters: against the
    reference where the config is not padded (tp 2), else against the
    port's single-process step on the padded config."""
    name, tp, form = case
    per_rank = ranks[case]
    if tp == 2:
        assert resolve_for_tp(get_config(name, smoke=True), tp) == get_config(name, smoke=True)
        want_losses, want = reference[name][2], reference[name][3]
    else:
        want_losses, want = _single(reference, name, tp)[:2]
    for r in per_rank:
        np.testing.assert_allclose(r["losses"], want_losses, rtol=1e-5, err_msg=f"{case} rank "
                                   f"{r['rank']}")
        assert r["losses"] == per_rank[0]["losses"]
    joined = _joined(name, tp, form, per_rank)
    for pname, w in want.named_parameters():
        assert joined[pname].shape == w.shape, pname
        _close(joined[pname], w, f"{case} {pname}")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_the_joined_gradient_is_the_single_process_gradient(reference, ranks, case):
    """The first batch's gradient after ``reduce_grads``, joined, against the
    single-process gradient of the (padded) model at 1e-4 of each tensor's
    scale, the tolerance at which ``test_torch_train_steps.py`` holds the
    gradient to the reference's.  AdamW's update does not see a gradient's
    scale, so this is the check that finds a tensor summed twice."""
    name, tp, form = case
    want = _single(reference, name, tp)[3]
    joined = _joined(name, tp, form, ranks[case], "grads")
    for pname, w in want.items():
        g, w = joined[pname].numpy(), w.numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"{case} {pname}")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_whole_gradients_are_the_same_bits_on_every_rank(ranks, case):
    """The gradient of every tensor that the ranks hold whole (the norms,
    the router, MLA's down projections, mamba2's BC and rwkv6's mixes once
    summed, replicated recurrent blocks), after ``reduce_grads``: bit equal
    on every rank, and their parameters after two steps too."""
    per_rank = ranks[case]
    whole = per_rank[0]["whole_grads"]
    assert whole, case
    for r in per_rank[1:]:
        assert r["whole_grads"].keys() == whole.keys()
        for n, g in whole.items():
            assert np.array_equal(r["whole_grads"][n], g), (case, r["rank"], n)
            assert np.array_equal(r["params"][n], per_rank[0]["params"][n]), (case, n)


@pytest.mark.parametrize("name", PAD_SLOTS)
def test_zero_query_slots_stay_zero_after_two_steps(ranks, name):
    """The zero query heads that ``attn_layout`` pads a rank with at tp 3
    are no heads of the model: their ``wq`` columns and ``wo`` rows stay
    exactly 0, and the KV heads that two ranks hold stay the same bits on
    both."""
    per_rank = ranks[(name, 3, "tp")]
    c = resolve_for_tp(get_config(name, smoke=True), 3)
    n_pads = 0
    for r in per_rank:
        q_src, kv_src = Shard(get_config(name, smoke=True), r["rank"], 3).attn
        pads = [s for s, src in enumerate(q_src) if src < 0]
        n_pads += len(pads)
        for pname, t in r["params"].items():
            if pname.endswith("attn.wo") and pads:
                assert not t[pads].any(), (r["rank"], pname)
            if pname.endswith("attn.wq") and pads:
                assert not t[:, pads].any(), (r["rank"], pname)
            if pname.endswith(("attn.wk", "attn.wv")):
                for other in per_rank:
                    o_kv = Shard(get_config(name, smoke=True), other["rank"], 3).attn[1]
                    for slot, h in enumerate(kv_src):
                        if h in o_kv:
                            assert np.array_equal(t[:, slot], other["params"][pname][
                                :, o_kv.index(h)]), (pname, h)
    assert n_pads and c.n_kv_heads % 3


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_the_group_clip_is_the_single_process_clip(reference, ranks, case):
    """The global norm the clip takes over the group (split leaves' squares
    summed over the ranks, whole ones and shared KV heads counted once) is
    the single-process gradient's norm, the same bits on every rank; within
    1e-4, the gradient's own tolerance (rwkv6's bonus gradient, most of its
    norm, differs from the single-process one by 2e-5)."""
    name, tp, _ = case
    want = _single(reference, name, tp)[2]
    for r in ranks[case]:
        assert r["gnorm"] == ranks[case][0]["gnorm"]
        np.testing.assert_allclose(r["gnorm"], want, rtol=1e-4, err_msg=f"{case}")


@pytest.mark.parametrize("case", [("llama3-1b", 2, "tp"), ("llama3-1b", 3, "tp")],
                         ids=_case_id)
def test_collectives_of_a_serving_forward_and_of_a_train_step(ranks, case):
    """A serving forward (no gradient) issues what it issued before the
    collectives had a backward: one all-reduce for the lookup where the
    vocabulary splits, two per dense block, one all-gather of the logits.
    A train step adds the backward's sums of the copies (one per sub-block,
    one for the logits) and one for the clip's norm, plus, where two ranks
    hold a KV head, one per wk/wv of every block."""
    name, tp, _ = case
    cfg = get_config(name, smoke=True)
    vocab = Shard(cfg, 0, tp).vocab_split
    L, dup = cfg.n_layers, 2 * cfg.n_layers if tp == 3 else 0
    for r in ranks[case]:
        assert r["serve_collectives"] == {"all_reduce": int(vocab) + 2 * L,
                                          "all_gather": int(vocab), "reduce_scatter": 0,
                                          "broadcast": 0}
        per_step = {k: v // 2 for k, v in r["collectives"].items()}
        assert per_step == {"all_reduce": int(vocab) + 2 * L + 2 * L + int(vocab) + 1 + dup,
                            "all_gather": int(vocab), "reduce_scatter": 0, "broadcast": 0}, \
            r["collectives"]


def test_two_data_by_two_model_ranks_are_the_single_process_step(reference, ranks):
    """A world of 4 ranks carved by ``make_train_ranks`` into 2 model groups
    of 2 consecutive ranks and 2 data groups: each data rank trains on its
    row of each global batch, the gradients averaged exactly.  The losses
    are the global batch's (the reference's), the ranks of one data group
    hold the same bits, and the joined parameters are the reference's."""
    name, world, mesh_model = MESH
    per_rank = ranks["mesh"]
    assert [(r["model_rank"], r["data_rank"]) for r in per_rank] == [(0, 0), (1, 0), (0, 1),
                                                                     (1, 1)]
    for r in per_rank:
        np.testing.assert_allclose(r["losses"], reference[name][2], rtol=1e-5)
        twin = per_rank[(r["rank"] + mesh_model) % world]  # the other data rank, same shard
        for n, t in r["params"].items():
            assert np.array_equal(t, twin["params"][n]), (r["rank"], n)
    joined = _joined(name, mesh_model, "tp", per_rank[:mesh_model])
    for pname, w in reference[name][3].named_parameters():
        _close(joined[pname], w, f"mesh {pname}")


def test_make_train_ranks_carves_model_then_data_groups():
    assert make_train_ranks(4, 2) == (((0, 1), (2, 3)), ((0, 2), (1, 3)))
    assert make_train_ranks(6, 3) == (((0, 1, 2), (3, 4, 5)), ((0, 3), (1, 4), (2, 5)))
    assert make_train_ranks(4, 4) == (((0, 1, 2, 3),), ((0,), (1,), (2,), (3,)))
    assert make_train_ranks(4, 1) == (((0,), (1,), (2,), (3,)), ((0, 1, 2, 3),))
    for world, m in ((4, 3), (6, 4), (2, 0)):
        with pytest.raises(ValueError, match="does not divide"):
            make_train_ranks(world, m)


def test_two_data_by_two_model_ranks_average_by_int8_with_grad_compress_pod(reference, ranks):
    """``grad_compress_pod`` with data ranks: the gradient averaged over each
    data group by ``pod_allreduce_compressed``.  Its first-batch gradient,
    joined, is the exact mean's within the int8 rounding — each data rank's
    part quantized at max|part| / 127, so off by at most half of that, and
    the mean by the mean of the halves (bounded with each data rank's whole
    single-process gradient) — plus the gradient's own 1e-4 of scale.  The
    losses (exact means; step 0's learning rate is 0) are the reference's,
    every whole gradient is the same bits on all four ranks, and the two
    data ranks of a shard hold the same parameters."""
    name, world, mesh_model = MESH
    per_rank, exact = ranks["mesh_int8"], ranks["mesh"]
    cfg = get_config(name, smoke=True)
    model = make_model(cfg, "cpu")
    params = params_from_numpy(cfg, reference[name][0], "cpu").requires_grad_(True)
    rows = reference[name][1][0]["tokens"]
    n = rows.shape[0] // (world // mesh_model)
    half = {}
    for d in range(world // mesh_model):
        _, grads = loss_and_grads(model, params, {"tokens": rows[d * n:(d + 1) * n]})
        for (pname, _), g in zip(params.named_parameters(), grads):
            half[pname] = half.get(pname, 0.0) + float(g.abs().max()) / 254 / (world // mesh_model)
    got = _joined(name, mesh_model, "tp", per_rank[:mesh_model], "grads")
    want = _joined(name, mesh_model, "tp", exact[:mesh_model], "grads")
    for pname, w in want.items():
        g, w = got[pname].numpy(), w.numpy()
        err, bound = np.abs(g - w).max(), half[pname] + 1e-4 * np.abs(w).max()
        assert err <= bound, (pname, err, bound)
        assert not np.array_equal(g, w) or not w.any(), pname  # the int8 path ran
    whole = per_rank[0]["whole_grads"]
    for r in per_rank:
        np.testing.assert_allclose(r["losses"], reference[name][2], rtol=1e-5)
        assert r["losses"] == exact[r["rank"]]["losses"]
        assert all(np.array_equal(g, whole[k]) for k, g in r["whole_grads"].items()), r["rank"]
        twin = per_rank[(r["rank"] + mesh_model) % world]
        for k, t in r["params"].items():
            assert np.array_equal(t, twin["params"][k]), (r["rank"], k)


def test_grad_compress_pod_on_a_sharded_model_needs_its_data_group(ranks):
    """Without ``data=``, ``grad_compress_pod`` averages over the whole world;
    on a model sharded over 2 of 4 ranks that would average different
    shards, so ``make_train_step`` refuses.  A model sharded over the whole
    world has no data ranks, and the flag builds a step."""
    for r in ranks["pod_error"]:
        assert "needs its data-parallel group" in r, r
    assert ranks["pod_error_whole"] == [""] * MESH[1]
