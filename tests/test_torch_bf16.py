"""The port's serving path in bf16 against the JAX package's, on the CPU.

The reference's models take ``dtype``/``param_dtype``, and every production
cell serves in bf16.  Here the smoke configs of llama3-70b (G 2), the
llama3-8b + llama3-1b pair and qwen2.5-14b (its QKV bias and norms drawn at
random), each with bf16 weights and compute, are initialised by the
reference and converted bit for bit (``convert.params_from_numpy`` widens a
bf16 array through float32, which holds it exactly).

* The prefill, one decode step and one tree-masked ``spec_forward`` give the
  reference's logits within ``LOGIT_TOL`` of the logits' scale: the kernels'
  bf16 tolerance (``tests/test_torch_kernels.py``), since both packages round
  every layer's activations to bf16, at other places.
* ``SpecEngine``, lockstep (parallel, serial) and async, emits the port's
  own bf16 greedy decode (the contract), and the reference's tokens with
  every ``SpecStats`` field equal, up to where the two greedy decodes part
  at a near tie of the reference's logits (within ``LOGIT_TOL``).
* The two rank layouts of the paper's headline deployment, with gloo ranks:
  llama3-70b over 3 ranks + llama3-1b on a fourth (``workers.split_engine``),
  and both models over 4 shared ranks (``workers.spec_engine``).  Every
  rank's tokens equal rank 0's and the target's greedy decode over the same
  ranks, lockstep and async, and the sharded prefill logits are within
  ``LOGIT_TOL`` of the single-process bf16 prefill.  A bf16 all-reduce sums
  in float32 in rank order (``parallel.group._ordered_sum``): a row's sum is
  the same alone and among others, and the same on every rank.
* ``tools/headline_nccl.py``, which runs those layouts at full size over
  NCCL, refuses a machine without four cards and imports no JAX.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.configs import get_config as jget_config
from repro.core.engine import SpecConfig as JSpecConfig
from repro.core.engine import SpecEngine as JSpecEngine
from repro.models.api import make_model as jmake_model
from repro_torch.configs import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import SpecConfig, SpecEngine
from repro_torch.models.api import make_model
from repro_torch.parallel.spawn import run_ranks
from test_torch_model import port_greedy, unbox

ROOT = pathlib.Path(__file__).resolve().parents[1]
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
S_MAX = 128
# of max|reference logits|: bf16 keeps 8 bits, and each package rounds every layer's
# activations at its own places (the kernels' bf16 tolerance, tests/test_torch_kernels.py)
LOGIT_TOL = 2e-2
BASE = dict(bs=8, w=4, c=2, d=2, n_cap=64, max_new=24)
RUNS = {"lockstep": BASE, "serial": dict(BASE, mode="serial"),
        "async": dict(BASE, async_rounds=True)}
STATS = ("rounds", "draft_steps", "emitted_rows", "accepted_rows", "spec_rounds", "spec_commits")
# name -> (target config, its seed, draft config or None: the target drafts for itself)
PAIRS = {"llama3-70b": ("llama3-70b", 3, "llama3-1b"), "llama3-8b": ("llama3-8b", 4, "llama3-1b"),
         "qwen2.5-14b": ("qwen2.5-14b", 5, None)}
RANK_RUNS = ("lockstep", "async")
SPAWN_S = 180


def _reference(name: str, seed: int):
    """(JAX model, its bf16 params, unboxed tree) of a smoke config in bf16,
    lm_head x4 (peaked greedy chains, as the serving weights); qwen2.5's
    QKV biases and norm weights drawn at random."""
    jm = jmake_model(dataclasses.replace(jget_config(name, smoke=True), **BF16))
    jp = jm.init(jax.random.PRNGKey(seed))
    jp["lm_head"].value = jp["lm_head"].value * 4.0
    if jm.cfg.qkv_bias:
        rng = np.random.default_rng(seed)
        (unit,) = jp["groups"][0]
        for key, base in (("bq", 0), ("bk", 0), ("bv", 0), ("ln1", 1), ("ln2", 1)):
            leaves = unit["attn"] if key.startswith("b") else unit
            leaves[key].value = jnp.asarray(
                base + 0.1 * rng.normal(size=leaves[key].value.shape), jnp.bfloat16)
    return jm, jp, unbox(jp)


@pytest.fixture(scope="module")
def models():
    """name -> {"target"/"draft": (JAX model, JAX params, tree, port model,
    port params)}; a self-drafting pair has no "draft"."""
    out = {}
    for name, (tname, seed, dname) in PAIRS.items():
        roles = {"target": (tname, seed)}
        if dname is not None:
            roles["draft"] = (dname, seed + 10)
        out[name] = {}
        for role, (cname, s) in roles.items():
            jm, jp, tree = _reference(cname, s)
            cfg = ModelConfig(**dataclasses.asdict(jm.cfg))
            out[name][role] = (jm, jp, tree, make_model(cfg, "cpu"),
                               params_from_numpy(cfg, tree, "cpu"))
    return out


def _prompt(vocab, B=2, P=8, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, P)).astype(np.int32)


def _bits(a) -> np.ndarray:
    return a.view(np.uint16) if isinstance(a, np.ndarray) else a.view(torch.int16).numpy()


def _dense_leaves(tree, params):
    """(numpy leaf, port tensor) of every weight of a dense model."""
    yield from ((tree[k], getattr(params, k)) for k in ("embed", "final_norm", "lm_head"))
    (unit,) = tree["groups"][0]
    for u, layer in enumerate(params.layers):
        yield unit["ln1"][u], layer.ln1
        yield unit["ln2"][u], layer.ln2
        for part in ("attn", "mlp"):
            yield from ((v[u], getattr(layer, part)[k]) for k, v in unit[part].items())


@pytest.mark.parametrize("name", list(PAIRS))
def test_a_bf16_tree_converts_bit_for_bit(models, name):
    _, _, tree, _, params = models[name]["target"]
    pairs = list(_dense_leaves(tree, params))
    assert len(pairs) == len(list(params.parameters()))
    for a, t in pairs:
        assert a.dtype.name == "bfloat16" and t.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(np.asarray(a)), _bits(t).view(np.uint16))


def _close(got, want, what):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.dtype == torch.bfloat16, what
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("name", list(PAIRS))
def test_bf16_prefill_and_decode_logits_match_reference(models, name):
    jm, jp, _, tm, tp = models[name]["target"]
    prompt = _prompt(jm.cfg.vocab_size, seed=1)
    jl, jc = jm.prefill(jp, tokens=jnp.asarray(prompt), S_max=S_MAX)
    tl, tc = tm.prefill(tp, prompt, S_max=S_MAX)
    _close(tl, jl, "prefill logits")
    tok = np.random.default_rng(2).integers(0, jm.cfg.vocab_size, size=(2, 1)).astype(np.int32)
    jl, _ = jm.decode_step(jp, jc, jnp.asarray(tok), S_MAX)
    tl, _ = tm.decode_step(tp, tc, tok, S_MAX)
    _close(tl, jl, "decode_step logits")


@pytest.mark.parametrize("name", list(PAIRS))
def test_bf16_verify_logits_match_reference(models, name):
    """A tree-masked ``spec_forward`` after the prefill, as a verify runs
    it: rows out of order, one skipped (-1), ancestor subsets."""
    jm, jp, _, tm, tp = models[name]["target"]
    B, P, n = 2, 8, 5
    prompt = _prompt(jm.cfg.vocab_size, B, P, seed=3)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jm.cfg.vocab_size, size=(B, n)).astype(np.int32)
    rows = np.array([[P - 1, P, -1, P + 2, P + 1], [P - 1, P + 1, P, P + 3, -1]], np.int32)
    positions = np.array([[P - 1, P, P, P + 1, P + 2]] * B, np.int32)
    mask = np.zeros((B, n, S_MAX), bool)
    mask[:, :, :P - 1] = True
    for b in range(B):
        for i in range(n):
            if rows[b, i] >= 0:
                mask[b, i, rows[b, i]] = True
                seen = rows[b, :i][rows[b, :i] >= 0]
                mask[b, i, seen] = rng.random(len(seen)) < 0.6
    _, jc = jm.prefill(jp, tokens=jnp.asarray(prompt), S_max=S_MAX)
    _, tc = tm.prefill(tp, prompt, S_max=S_MAX)
    jl, _ = jm.spec_forward(jp, jc, *map(jnp.asarray, (tokens, positions, rows, mask)))
    tl, _ = tm.spec_forward(tp, tc, tokens, positions, rows, mask)
    _close(tl, jl, "spec_forward logits")


def test_the_plain_attention_sums_alike_wherever_the_keys_lie():
    """A query's output is the same bits when its attended keys sit at
    other cache rows (a tree verify's ancestors against the decode's
    consecutive rows), in bf16 and float32."""
    from repro_torch.kernels.ref import tree_attention_ref

    rng = np.random.default_rng(7)
    for dtype in (torch.bfloat16, torch.float32):
        for trial in range(20):
            q, k, v = (torch.tensor(rng.normal(size=s), dtype=torch.float32).to(dtype)
                       for s in ((1, 1, 4, 16), (1, 64, 2, 16), (1, 64, 2, 16)))
            L = int(rng.integers(4, 40))
            at = np.sort(rng.choice(np.arange(L + 3, 64), size=3, replace=False))
            k2, v2 = k.clone(), v.clone()
            k2[:, at], v2[:, at] = k[:, L:L + 3], v[:, L:L + 3]  # the last 3 keys elsewhere
            k2[:, L:L + 3] = torch.tensor(rng.normal(size=(3, 2, 16)), dtype=dtype)
            m1 = torch.zeros((1, 1, 64), dtype=torch.bool)
            m1[..., :L + 3] = True
            m2 = torch.zeros_like(m1)
            m2[..., :L] = True
            m2[..., torch.as_tensor(at)] = True
            assert torch.equal(tree_attention_ref(q, k, v, m1), tree_attention_ref(q, k2, v2, m2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_plain_swiglu_gives_a_row_the_same_bits_alone_and_among_rows(dtype):
    from repro_torch.kernels.ref import fused_swiglu_ref

    rng = np.random.default_rng(8)
    x, wg, wu = (torch.tensor(rng.normal(size=s) * 0.2, dtype=torch.float32).to(dtype)
                 for s in ((8, 64), (64, 128), (64, 128)))
    rows = fused_swiglu_ref(x, wg, wu)
    for i in range(8):
        assert torch.equal(fused_swiglu_ref(x[i:i + 1], wg, wu)[0], rows[i])


@pytest.mark.parametrize("name", list(PAIRS))
def test_a_verify_recomputes_the_prompts_last_row_as_the_prefill_did(models, name):
    """The first verify's root is the prompt's last token, which the prefill
    already wrote: its logits and the K/V it writes again must be the
    prefill's bits, or the engine and the greedy decode start from other
    caches.  The prefill attends through the verify's kernel for that."""
    _, _, _, T, tp = models[name]["target"]
    prompt = _prompt(T.cfg.vocab_size, B=1, P=8, seed=9)
    lg, cache = T.prefill(tp, prompt, S_max=S_MAX)
    before = [{k: v.clone() for k, v in blk.items()} for blk in cache["groups"][0]]
    pos = np.array([[7, 8, 8]], np.int32)
    mask = np.zeros((1, 3, S_MAX), bool)
    mask[0, :, :8] = True
    mask[0, 1:, 8:10] = np.eye(2, dtype=bool)
    vl, cache = T.spec_forward(tp, cache, np.array([[int(prompt[0, -1]), 5, 6]], np.int32), pos,
                               np.array([[7, 8, 9]], np.int32), mask)
    assert torch.equal(vl[0, 0], lg[0, -1])
    for blk, old in zip(cache["groups"][0], before):
        for key in ("k", "v"):
            assert torch.equal(blk[key][:, :, :8], old[key][:, :, :8])


def test_a_long_prefill_attends_in_chunks_with_bounded_copies(models, monkeypatch):
    """A prefill of 520 rows at S_max 4096 (llama3-70b smoke, bf16): the
    reference's logits within the stated tolerance, and the decode step
    from its cache too.  It attends in query chunks of at most
    ``ATTN_CHUNK`` rows, each with ``kv_bound`` at the chunk's end, and the
    plain version's copies of the keys and values stay within
    ``REF_BLOCK_BYTES`` a block, where a copy for every row of a chunk at
    once would not."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.attention import ATTN_CHUNK

    jm, jp, _, tm, tp = models["llama3-70b"]["target"]
    n, S = 520, 4096
    prompt = _prompt(jm.cfg.vocab_size, B=1, P=n, seed=12)
    calls, blocks = [], []
    tree_attention, rows = ops.tree_attention, ref._tree_attention_rows

    def spy_attention(q, k, v, mask, *, kv_bound=None):
        calls.append((q.shape[1], kv_bound, k.shape[1]))
        return tree_attention(q, k, v, mask, kv_bound=kv_bound)

    def spy_rows(q, k, v, mask):
        blocks.append(2 * q.shape[0] * q.shape[1] * k[0].numel() * (k.element_size() + 4))
        return rows(q, k, v, mask)

    monkeypatch.setattr(ops, "tree_attention", spy_attention)
    monkeypatch.setattr(ref, "_tree_attention_rows", spy_rows)
    tl, tc = tm.prefill(tp, prompt, S_max=S)
    monkeypatch.undo()
    assert calls == [(ATTN_CHUNK, ATTN_CHUNK, S), (n - ATTN_CHUNK, n, S)] * jm.cfg.n_layers
    assert max(blocks) <= ref.REF_BLOCK_BYTES < sum(blocks) / (2 * jm.cfg.n_layers)
    jl, jc = jm.prefill(jp, tokens=jnp.asarray(prompt), S_max=S)
    _close(tl, jl, "long prefill logits")
    tok = np.array([[7]], np.int32)
    _close(tm.decode_step(tp, tc, tok, S)[0], jm.decode_step(jp, jc, jnp.asarray(tok), S)[0],
           "decode_step logits after the long prefill")


@pytest.fixture(scope="module")
def engines(models):
    """name -> the reference's engine (its jitted programs depend on bs, w
    and c only, so one serves every run by swapping its ``cfg``)."""
    out = {}
    for name, roles in models.items():
        T = roles["target"][0]
        D = roles["draft"][0] if "draft" in roles else T
        out[name] = JSpecEngine(T, D, JSpecConfig(**BASE), S_max_t=S_MAX, S_max_d=S_MAX)
    return out


@pytest.fixture(scope="module")
def greedy(models):
    """name -> (the engine tests' prompt, the port's greedy decode of every
    row, the reference's, the reference's top-2 logit gap at each position
    and its logits' scale)."""
    out = {}
    for name, roles in models.items():
        jm, jp, _, T, tp = roles["target"]
        prompt = _prompt(jm.cfg.vocab_size, seed=5)
        pref = jax.jit(lambda p, t: jm.prefill(p, tokens=t, S_max=S_MAX))
        step = jax.jit(lambda p, c, t: jm.decode_step(p, c, t, S_MAX))
        lg, cache = pref(jp, jnp.asarray(prompt))
        toks, gaps = [], []
        for _ in range(BASE["max_new"]):
            logits = np.asarray(jnp.asarray(lg[:, -1], jnp.float32))
            top = np.sort(logits, -1)
            gaps.append(top[:, -1] - top[:, -2])
            toks.append(logits.argmax(-1)[:, None].astype(np.int32))
            lg, cache = step(jp, cache, jnp.asarray(toks[-1]))
        out[name] = (prompt, port_greedy(T, tp, prompt, BASE["max_new"], S_MAX),
                     np.concatenate(toks, 1).tolist(), np.stack(gaps, 1), np.abs(logits).max())
    return out


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("name", list(PAIRS))
def test_bf16_engine_emits_its_greedy_decode_and_the_reference_tokens(models, engines, greedy,
                                                                      name, run):
    """The contract exactly: the port's speculative tokens are its own bf16
    greedy decode.  Against the reference: the two packages round at other
    places, so their greedy decodes may part where the reference's top-2
    logits are within ``LOGIT_TOL`` of a tie (and only there); up to that
    position every row's tokens are the reference's speculative tokens, and
    where no row parts, every ``SpecStats`` field is the reference's."""
    roles = models[name]
    _, jtp, _, T, tp = roles["target"]
    _, jdp, _, D, dp = roles.get("draft", roles["target"])
    prompt, mine_all, theirs_all, gaps, scale = greedy[name]
    je = engines[name]
    je.cfg = JSpecConfig(**RUNS[run])
    jout, jst = je.session(jtp, jdp).generate(prompt)
    out, st = SpecEngine(T, D, SpecConfig(**RUNS[run]), S_max_t=S_MAX,
                         S_max_d=S_MAX).session(tp, dp).generate(prompt)
    assert out == mine_all
    parted = []
    for b, (mine, theirs) in enumerate(zip(mine_all, theirs_all)):
        j = next((i for i, (x, y) in enumerate(zip(mine, theirs)) if x != y), len(mine))
        if j < len(mine):
            assert gaps[b, j] <= LOGIT_TOL * scale, f"row {b} parts from the reference at {j}"
            parted.append(b)
        assert out[b][:j] == jout[b][:j]
    if not parted:
        assert out == jout
        for key in STATS:
            assert np.array_equal(getattr(st, key), getattr(jst, key)), key
    if "draft" not in roles:  # drafting for itself the engine accepts: row moves run
        assert st.accepted > 0


def test_a_bf16_all_reduce_sums_each_row_alike_on_every_rank(layouts):
    """The 4 ranks' sum of their [5, 96] bf16 parts: row by row equal to the
    whole tensor's, every rank equal, each element the float32 sum of the
    parts in rank order rounded to bf16 once."""
    parts, sums = layouts["sums"]
    bf = torch.tensor(parts).to(torch.bfloat16).float()
    want = (bf[0] + bf[1] + bf[2] + bf[3]).to(torch.bfloat16).float().numpy()
    for res in sums:
        np.testing.assert_array_equal(res["whole"], res["rows"])
        np.testing.assert_array_equal(res["whole"], want)


def test_an_f32_all_reduce_on_a_serving_group_sums_each_row_alike(layouts):
    """F7's repair: the 4 ranks' float32 sum of their [5, 96] parts on a
    ``serving`` group is, row by row, the whole tensor's and every rank's,
    each element the float32 sum of the parts in rank order."""
    parts, _ = layouts["sums"]
    p = torch.tensor(parts)
    want = (((p[0] + p[1]) + p[2]) + p[3]).numpy()
    for res in layouts["f32_sums"]:
        np.testing.assert_array_equal(res["whole"], res["rows"])
        np.testing.assert_array_equal(res["whole"], want)


def test_a_serving_group_counts_the_all_gather_its_bf16_sum_runs():
    """The cost counter records what a group's all-reduce runs: the ring's
    all-reduce, or on a ``serving`` group a floating tensor's all-gather
    (float32 too since F7: over NCCL on 4 cards a ring sums a row's parts in
    an order set by the message's size)."""
    from repro_torch.launch import cost
    from repro_torch.parallel.group import CountingGroup

    plain, serving = CountingGroup(0, 4), CountingGroup(0, 4).serving()
    assert serving.ordered and serving.new_group().ordered and not plain.ordered
    for group, dtype, kind in ((plain, torch.bfloat16, "all_reduce"),
                               (plain, torch.float32, "all_reduce"),
                               (serving, torch.bfloat16, "all_gather"),
                               (serving, torch.float32, "all_gather")):
        x = torch.empty((2, 8), dtype=dtype, device="meta")
        c, out = cost.count(group.all_reduce, x)
        assert out is x
        assert c.collectives == {kind: {"count": 1, "bytes": 16 * x.element_size()}}


@pytest.fixture(scope="module")
def layouts(models, tmp_path_factory):
    """One spawn of 4 gloo ranks: the 3 + 1 split and the 4-rank shared
    layout of llama3-70b + llama3-1b (smoke, bf16, the reference's weights),
    lockstep and async, then the ranks' bf16 sums of rows."""
    roles = models["llama3-70b"]
    (_, _, ttree, T, _), (_, _, dtree, D, _) = roles["target"], roles["draft"]
    prompts = [_prompt(T.cfg.vocab_size, B=1, seed=10 + i) for i in range(2)]
    job = {"tcfg": T.cfg, "dcfg": D.cfg, "weights": ("numpy", ttree, dtree),
           "prompts": prompts, "S_max": S_MAX, "greedy_n": BASE["max_new"],
           "prefill_logits": True}
    runs = {run: dict(BASE, async_rounds=run == "async") for run in RANK_RUNS}
    parts = np.random.default_rng(6).normal(size=(4, 5, 96)).astype(np.float32)
    calls = [("split_engine", (dict(job, n_target=3,
                                    runs=[(r, "tree", kw) for r, kw in runs.items()]),)),
             ("spec_engine", (dict(job, runs=list(runs.items())),)),
             ("all_reduce_rows", (parts,)), ("all_reduce_rows", (parts, "float32"))]
    res = run_ranks("repro_torch.parallel.workers:several", 4, (calls,),
                    workdir=tmp_path_factory.mktemp("bf16_ranks"), device="cpu",
                    timeout_s=SPAWN_S)
    single = T.prefill(roles["target"][4], prompts[0], S_max=S_MAX)[0]
    return {"split": [r[0] for r in res], "shared": [r[1] for r in res],
            "sums": (parts, [r[2] for r in res]), "f32_sums": [r[3] for r in res],
            "single_prefill": single}


@pytest.mark.parametrize("run", RANK_RUNS)
@pytest.mark.parametrize("layout", ["split", "shared"])
def test_bf16_rank_layouts_emit_the_greedy_decode_over_their_ranks(layouts, layout, run):
    ranks = layouts[layout]
    targets = [r for r in ranks if r.get("role", "target") == "target"]
    if layout == "split":
        assert [r["role"] for r in ranks] == ["target"] * 3 + ["draft"]
    greedy = targets[0]["greedy"]
    first = ranks[0]["runs"][run]
    for r in targets:
        assert r["greedy"] == greedy
    for r in ranks:
        got = r["runs"][run]
        assert got["tokens"] == first["tokens"] and got["stats"] == first["stats"]
        for toks, want in zip(got["tokens"], greedy):
            assert toks == want[:len(toks)] and len(toks) == BASE["max_new"]


@pytest.mark.parametrize("layout", ["split", "shared"])
def test_bf16_sharded_prefill_is_near_the_single_process_one(layouts, layout):
    targets = [r for r in layouts[layout] if r.get("role", "target") == "target"]
    want = layouts["single_prefill"].float().numpy()
    for r in targets:
        np.testing.assert_array_equal(r["prefill_logits"], targets[0]["prefill_logits"])
        np.testing.assert_allclose(r["prefill_logits"], want, rtol=0,
                                   atol=LOGIT_TOL * np.abs(want).max())


def test_headline_tool_refuses_fewer_than_four_cards():
    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("four CUDA devices are present: the tool rightly runs on them")
    res = subprocess.run([sys.executable, str(ROOT / "tools" / "headline_nccl.py")],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode != 0 and "needs 4 CUDA device(s)" in res.stderr
    assert "every check passed" not in res.stdout


def test_the_hygiene_walk_covers_the_headline_tool():
    from test_torch_hygiene import PORT_FILES

    assert ROOT / "tools" / "headline_nccl.py" in PORT_FILES
