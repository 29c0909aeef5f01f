"""The dry run's cost counter (``repro_torch.launch.cost``), its roofline
(``launch/roofline.py``) and the kernels' work formulas
(``kernels/work.py``), on the CPU.

* ``model_flops_per_chip`` equals the reference's for every assigned
  architecture x shape x production mesh.
* A decode, a prefill, a train and a verify step of one smoke config per
  family count the same work — operations, bytes, calls per kernel
  wrapper, collectives — on CPU tensors (the plain versions) and on meta
  (the meta branches): a wrapper counts once, by its formula, whatever
  runs inside it.
* The collectives a ``CountingGroup`` counts on meta at tp 2 equal
  ``COLLECTIVES`` after the same steps on 2 gloo ranks, sequence-sharded
  (``seq_shard``) too; a reduce-scatter counts its whole operand and
  returns the rank's slice of it.
* The products' operations of a smoke decode and train step equal the
  reference's ``hlo_parse.analyze(...).flops`` of the compiled step on the
  CPU — tolerance 0 once the one term the two count differently is taken
  out: the port's fused_swiglu backward (``ops.swiglu_backward``)
  recomputes g = x@wg and u = x@wu, 4·M·K·N per MLP, where XLA's
  autodiff keeps them from the forward.  The decode is counted at a full
  cache, where the port's decode_attention (keys < the length) and the
  reference's masked product over S_max keys do the same work.
* The peak tracker gives the exact peak of a hand-built sequence of ops.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import resolve_for_tp as jresolve_for_tp
from repro.launch import steps as jsteps
from repro.launch.hlo_parse import analyze
from repro.launch.hlo_stats import model_flops_per_chip as jmodel_flops_per_chip
from repro.models.api import make_model as jmake_model
from repro.optim import adamw_init as jadamw_init
from repro_torch.configs import ASSIGNED, SHAPES, get_config
from repro_torch.kernels import work
from repro_torch.launch import cost, roofline, specs
from repro_torch.launch.mesh import production_mesh
from repro_torch.launch.steps import (
    make_decode_step,
    make_prefill_step,
    make_spec_verify_step,
    make_train_step,
)
from repro_torch.models.api import make_model
from repro_torch.optim import adamw_init
from repro_torch.parallel.group import CountingGroup
from repro_torch.parallel.spawn import run_ranks

FAMILIES = ("llama3-1b", "deepseek-moe-16b", "minicpm3-4b", "zamba2-2.7b", "rwkv6-7b",
            "llama-3.2-vision-90b", "musicgen-large")
TP_NAMES = ("llama3-1b",)
B, S, S_MAX = 2, 8, 16


@pytest.mark.parametrize("multi_pod", (False, True), ids=("pod1", "pod2"))
def test_model_flops_per_chip_equals_reference(multi_pod):
    mesh = production_mesh(multi_pod)
    n = int(np.prod(list(mesh.values())))
    for arch in ASSIGNED:
        jcfg = dataclasses.replace(jget_config(arch), dtype="bfloat16", param_dtype="bfloat16")
        jcfg = jresolve_for_tp(jcfg, mesh["model"])
        for shape in SHAPES:
            got = roofline.model_flops_per_chip(specs.dryrun_config(arch, mesh), SHAPES[shape], n)
            assert got == jmodel_flops_per_chip(jcfg, JSHAPES[shape], n), (arch, shape)


def _steps(cfg, device, group=None):
    """(name, step, args) of a decode, a prefill, a train and a verify step
    of ``cfg`` on ``device`` (weights without a draw on meta)."""
    model = make_model(cfg, device, group)
    params = model.init(0)
    tparams = model.init(0, trainable=True)
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(B, S + 1)), dtype=torch.int32,
                           device=device)
    batch = {"tokens": toks}
    enc = {}
    if cfg.n_enc_tokens:
        enc = {"enc": torch.zeros((B, cfg.n_enc_tokens, cfg.d_model), device=device)}
    if not cfg.embed_inputs:
        batch = {"embeds": torch.zeros((B, S, cfg.d_model), device=device), "labels": toks[:, 1:]}
    pre = {"tokens": toks[:, :S]} if cfg.embed_inputs else {"embeds": batch["embeds"]}
    cache = model.init_cache(B, S_MAX)
    cache["len"] = S
    out = [("decode", make_decode_step(cfg, model, S_max=S_MAX),
            (params, cache, toks[:, :1])),
           ("prefill", make_prefill_step(cfg, model, S_max=S_MAX), (params, {**pre, **enc})),
           ("train", make_train_step(cfg, model), (tparams, adamw_init(tparams),
                                                    {**batch, **enc}))]
    if not model.uses_chain_spec:
        n = 4
        pos = torch.arange(S, S + n, dtype=torch.int32, device=device).expand(B, n)
        mask = torch.arange(S_MAX, device=device)[None, None, :] <= pos[:, :, None]
        out.append(("verify", make_spec_verify_step(cfg, model, S_max=S_MAX, bs=n),
                    (params, model.init_cache(B, S_MAX), toks[:, :n], pos, pos, mask)))
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_counts_are_the_same_on_cpu_and_meta(name):
    cfg = get_config(name, smoke=True)
    cpu = {k: cost.count(step, *args)[0] for k, step, args in _steps(cfg, "cpu")}
    meta = {k: cost.count(step, *args)[0] for k, step, args in _steps(cfg, "meta")}
    assert cpu.keys() == meta.keys()
    for k in cpu:
        assert cpu[k].work() == meta[k].work(), f"{name} {k}"
        assert cpu[k].argument_bytes == meta[k].argument_bytes, f"{name} {k}"
        assert cpu[k].total_flops > 0 and cpu[k].total_bytes > 0
    assert meta["train"].flops["backward"] > meta["train"].flops["forward"]
    if "verify" in meta:  # GQA attends through tree_attention, MLA through latent_attention
        kernel = "latent_attention" if cfg.attn_kind == "mla" else "tree_attention"
        assert meta["verify"].calls.get(kernel, 0) > 0


@pytest.fixture(scope="module")
def real_tp2(tmp_path_factory):
    """``workers.remat_counts`` on 2 gloo ranks per TP_NAMES config."""
    calls = []
    for n in TP_NAMES:
        cfg = get_config(n, smoke=True)
        toks = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(B, S + 1))
        calls.append(("remat_counts", ({"cfg": cfg, "seed": 0,
                                        "batch": {"tokens": toks.astype(np.int32)},
                                        "prompt": toks[:, :S].astype(np.int32),
                                        "S_max": S_MAX},)))
    res = run_ranks("repro_torch.parallel.workers:several", 2, (calls,),
                    workdir=tmp_path_factory.mktemp("cost_tp2"), device="cpu", timeout_s=240)
    return {n: [r[i] for r in res] for i, n in enumerate(TP_NAMES)}


@pytest.mark.parametrize("name", TP_NAMES)
def test_collectives_counted_on_meta_equal_a_real_tp2_run(real_tp2, name):
    cfg = get_config(name, smoke=True)
    for rank in range(2):
        group = CountingGroup(rank, 2)
        model = make_model(cfg, "meta", group)
        params = model.init(0)
        toks = torch.zeros((B, S), dtype=torch.int32, device="meta")
        counted = {}
        with torch.no_grad():
            c, (_, cache) = cost.count(lambda p, t: model.prefill(p, t, S_max=S_MAX), params, toks)
            counted["prefill"] = c
            counted["decode"], _ = cost.count(
                lambda p, ca, t: model.decode_step(p, ca, t, S_MAX), params, cache, toks[:, :1])
            counted["prefill_seq"], _ = cost.count(
                lambda p, t: model.prefill(p, t, S_max=S_MAX, seq_shard=True), params, toks)
        tparams = model.init(0, trainable=True)
        for remat in ("none", "full"):
            for seq in (False, True):
                counted[f"train_seq_{remat}" if seq else f"train_{remat}"], _ = cost.count(
                    make_train_step(cfg, model, remat=remat, seq_shard=seq), tparams,
                    adamw_init(tparams),
                    {"tokens": torch.zeros((B, S + 1), dtype=torch.int32, device="meta")})
        real = real_tp2[name][rank]["collectives"]
        for k, c in counted.items():
            got = {kind: c.collectives.get(kind, {"count": 0})["count"] for kind in real[k]}
            assert got == real[k], f"{name} rank {rank} {k}"
        # the recompute's collectives are booked to the backward
        full, none = counted["train_full"], counted["train_none"]
        assert sum(v["count"] for v in full.collectives_by_phase["backward"].values()) > \
            sum(v["count"] for v in none.collectives_by_phase["backward"].values())
        # sequence-sharded, the all-reduces of the residual (the lookup's and two a block) are
        # gone; one sums the gradients of the norms, which each rank reads on its own rows
        fwd = {k: v["count"] for k, v in counted["train_none"].collectives_by_phase[
            "forward"].items()}
        seq = {k: v["count"] for k, v in counted["train_seq_none"].collectives_by_phase[
            "forward"].items()}
        assert seq["all_reduce"] == fwd["all_reduce"] - (1 + 2 * cfg.n_layers) + 1
        assert seq["reduce_scatter"] == 1 + 2 * cfg.n_layers


def test_reduce_scatter_counts_its_operand_and_returns_the_rank_slice():
    group = CountingGroup(1, 4)
    x = torch.empty((2, 8, 16), device="meta")
    c, out = cost.count(lambda t: group.reduce_scatter(t, 1), x)
    assert out.shape == (2, 2, 16)
    assert c.collectives == {"reduce_scatter": {"count": 1, "bytes": 2 * 8 * 16 * 4}}
    assert c.collective_axes == {"model": {"ranks": 4, "bytes": 2 * 8 * 16 * 4}}
    c, out = cost.count(lambda t: group.all_gather(t, 1), out)
    assert out.shape == (2, 8, 16) and c.collectives["all_gather"]["bytes"] == 2 * 2 * 16 * 4


def test_product_operations_equal_the_reference_hlo():
    name = "llama3-1b"
    jm = jmake_model(jget_config(name, smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(name, smoke=True)
    model = make_model(cfg, "meta")

    toks = jnp.zeros((B, S + 1), jnp.int32)
    compiled = jax.jit(jsteps.make_train_step(jm.cfg, jm)).lower(
        jp, jadamw_init(jp), {"tokens": toks}).compile()
    want = analyze(compiled.as_text()).flops
    params = model.init(0, trainable=True)
    got, _ = cost.count(make_train_step(cfg, model), params, adamw_init(params),
                        {"tokens": torch.zeros((B, S + 1), dtype=torch.int32, device="meta")})
    # the one term counted differently: swiglu_backward recomputes x@wg and x@wu
    recompute = cfg.n_layers * 4 * (B * S) * cfg.d_model * cfg.d_ff
    assert got.total_flops - recompute == want

    jcache = dict(jm.init_cache(B, S_MAX), len=S_MAX - 1)  # a full cache
    compiled = jax.jit(jsteps.make_decode_step(jm.cfg, jm, S_max=S_MAX)).lower(
        jp, jcache, jnp.zeros((B, 1), jnp.int32)).compile()
    want = analyze(compiled.as_text()).flops
    cache = model.init_cache(B, S_MAX)
    cache["len"] = S_MAX - 1
    got, _ = cost.count(make_decode_step(cfg, model, S_max=S_MAX), model.init(0), cache,
                        torch.zeros((B, 1), dtype=torch.int32, device="meta"))
    assert got.total_flops == want
    # stream_matmul: q, k, v, o and the down projection of every layer, and the lm_head;
    # rms_norm: the two pre-norms of every layer, and the final norm
    assert got.calls == {"decode_attention": cfg.n_layers, "fused_swiglu": cfg.n_layers,
                         "stream_matmul": 5 * cfg.n_layers + 1, "rms_norm": 2 * cfg.n_layers + 1}


def test_peak_tracker_on_a_hand_built_sequence():
    def ops(a):
        b = a * 2  # 400 bytes: live 800
        del a  # the argument stays alive with its caller
        c = torch.empty(1000, device="meta")  # 4000: live 4800, the peak
        del b, c  # live 400
        d = torch.empty(500, device="meta")  # 2000: live 2400
        e = d.view(50, 10)  # a view: no bytes
        return e

    a = torch.empty(100, device="meta")
    got, out = cost.count(ops, a)
    assert (got.argument_bytes, got.peak_bytes, got.output_bytes) == (400, 4800, 2000)
    assert got.bytes["forward"] == 400 + 400  # the product: 400 read, 400 written
    assert out.shape == (50, 10)


def test_work_formulas():
    q = torch.empty(2, 3, 8, 64)
    k = torch.empty(2, 100, 2, 64)
    mask = torch.zeros(2, 3, 100, dtype=torch.bool)
    mask[0, :, :10] = True
    assert work.tree_attention(q, k, k, mask, kv_bound=50) == \
        (4 * 64 * 8 * 2 * 3 * 50, 2 * q.numel() * 4 + mask.numel() + 2 * 2 * 50 * 2 * 64 * 4)
    assert work.tree_attention(q, k, k, mask, data=True) == \
        (4 * 64 * 8 * 30, 2 * q.numel() * 4 + mask.numel() + 2 * 10 * 2 * 64 * 4)
    x, w = torch.empty(5, 32), torch.empty(32, 16)
    assert work.fused_swiglu(x, w, w) == (4 * 5 * 32 * 16, (5 * 32 + 2 * 32 * 16 + 5 * 16) * 4)
    assert work.bound(3.35e12, 0, torch.float32) == (1e3, "bytes")
    assert work.bound(0, 989e12, torch.bfloat16) == (1e3, "operations")
