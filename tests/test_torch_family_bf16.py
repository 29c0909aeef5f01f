"""The family-specific serving products in bf16: the MoE (deepseek-moe-16b,
mixtral-8x22b), MLA (minicpm3-4b), mamba2 (zamba2-2.7b) and rwkv6 (rwkv6-7b)
smoke configs against the JAX package's, on the CPU.

Each config, with bf16 weights and compute and its lm_head x4 (peaked
greedy chains), is initialised by the reference and converted bit for bit
(``convert.params_from_numpy``).

* The batched serving product (``ops.stream_bmm``, the MoE's experts,
  rwkv6's token-shift projections, MLA's per-head products): its plain
  version against the reference's ``einsum("ecd,edf->ecf")`` (f32 2e-5,
  bf16 2e-2) and bit for bit ``torch.bmm``; on meta it counts what the
  ``torch.bmm`` it replaces counts (the dry run does not move) and
  allocates nothing but its output; it refuses a gradient and bad shapes.
* The prefill, a decode step and a verify (a tree-masked ``spec_forward``)
  or a chain forward give the reference's logits within ``LOGIT_TOL`` of the
  logits' scale (``tests/test_torch_bf16.py``'s tolerance), zamba2's within
  ``HYBRID_TOL`` (below); a batch row beyond it must be one whose routing
  met a near tie of the gates (the k-th and the next expert's gates within
  ``GATE_TIE``) in the port's forward, where the two packages may pick
  either expert, and at least one row must be within it.
* The engines emit the port's own bf16 greedy decode (the contract): the
  tree engine on the MoE and MLA configs drafting for themselves at d 2,
  the chain engine on zamba2 and rwkv6, parallel.
* ``tools/bf16_invariance.py``'s op probe on the same smoke models: the
  greedy decode step by step and the same tokens in one forward agree op by
  op, every product, norm, routing weight, expert result and sum, scan and
  attention row bit for bit (the card runs the probe at full width).
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.configs import get_config as jget_config
from repro.models.api import make_model as jmake_model
from repro_torch.configs import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.chain_engine import ChainConfig, ChainSpecEngine
from repro_torch.core.engine import SpecConfig, SpecEngine
from repro_torch.kernels import ops, ref, work
from repro_torch.launch import cost
from repro_torch.models.api import make_model
from test_torch_model import port_greedy, unbox

ROOT = pathlib.Path(__file__).resolve().parents[1]
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
S_MAX = 128
LOGIT_TOL = 2e-2  # of max|reference logits|: tests/test_torch_bf16.py's
# zamba2's logits: in bf16 each package's lie 1.0-4.0e-2 of their scale from the float32
# forward of the same weights (its two mamba2-unit recurrences and gated norm round at
# d 64), in other directions, so the two differ by up to 5.7e-2 over seeds 3-8 (the parent
# commit's port alike; its decode and chain logits by up to 2.0e-2)
HYBRID_TOL = 6e-2
# a routing decision whose k-th and (k+1)-th gates lie within this of each other is a near
# tie: bf16's 8 bits (2^-8 of a gate) may pick either expert in either package
GATE_TIE = 4e-3
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FAMILIES = {"deepseek-moe-16b": 3, "mixtral-8x22b": 4, "minicpm3-4b": 5, "zamba2-2.7b": 6,
            "rwkv6-7b": 7}  # config -> the seed of its weights
NEW = 16


@pytest.fixture(scope="module")
def models():
    """name -> (JAX model, JAX params, port model, port params), bf16."""
    out = {}
    for name, seed in FAMILIES.items():
        jm = jmake_model(dataclasses.replace(jget_config(name, smoke=True), **BF16))
        jp = jm.init(jax.random.PRNGKey(seed))
        jp["lm_head"].value = jp["lm_head"].value * 4.0
        cfg = ModelConfig(**dataclasses.asdict(jm.cfg))
        out[name] = (jm, jp, make_model(cfg, "cpu"), params_from_numpy(cfg, unbox(jp), "cpu"))
    return out


def _prompt(vocab, B=1, P=8, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, P)).astype(np.int32)


def _close(got, want, what, tol=LOGIT_TOL, ties=None):
    """got [B, ...] within ``tol`` of max|want|, but for batch rows of
    ``ties`` (a ``TieSpy``) that met a near tie of their gates; at least one
    row within it."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.dtype == torch.bfloat16, what
    got = got.float().numpy()
    err = np.abs(got - want).reshape(len(got), -1).max(-1) / np.abs(want).max()
    off = {b for b in range(len(got)) if err[b] > tol}
    assert off <= (set() if ties is None else ties.tied), \
        f"{what}: rows {sorted(off)} beyond {tol} of the logits' scale (errors {err})"
    assert len(off) < len(got), f"{what}: every row met a near tie"


class TieSpy:
    """The batch rows (of B) whose routing, in the port's forwards while it
    is installed, met a near tie of the gates (``GATE_TIE``)."""

    def __init__(self, monkeypatch, B):
        from repro_torch.models import moe

        self.tied, real = set(), moe.route

        def route(x2d, router, n_experts, top_k, cap):
            gates = torch.softmax(x2d.float() @ router.float(), dim=-1)
            top = gates.topk(top_k + 1, dim=-1).values
            near = (top[:, -2] - top[:, -1]) < GATE_TIE  # [T]: token rows, batch-major
            self.tied |= {int(t) * B // len(near) for t in near.nonzero()[:, 0]}
            return real(x2d, router, n_experts, top_k, cap)

        monkeypatch.setattr(moe, "route", route)



# -----------------------------------------------------------------------------
# the batched serving product
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,M,K,N", [(4, 1, 64, 96), (8, 5, 64, 128), (3, 17, 96, 40),
                                     (40, 8, 16, 16)])
def test_the_plain_batched_product_matches_the_reference_einsum(G, M, K, N, dtype):
    rng = np.random.default_rng(11)
    x = torch.tensor(rng.normal(size=(G, M, K)), dtype=torch.float32).to(dtype)
    w = torch.tensor(rng.normal(size=(G, K, N)) * K ** -0.5, dtype=torch.float32).to(dtype)
    got = ops.stream_bmm(x, w)
    assert got.dtype == dtype and got.shape == (G, M, N)
    assert torch.equal(got, torch.bmm(x, w)) and torch.equal(ref.stream_bmm_ref(x, w), got)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jnp.einsum("ecd,edf->ecf", jnp.asarray(x.float().numpy()).astype(jdt),
                      jnp.asarray(w.float().numpy()).astype(jdt))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,M,K,N", [(64, 8, 2048, 1408), (8, 16, 6144, 16384),
                                     (4, 1, 4096, 4096), (40, 7, 64, 256)])
def test_the_batched_product_on_meta_counts_the_bmm_it_replaces(G, M, K, N, dtype):
    x = torch.empty((G, M, K), dtype=dtype, device="meta")
    w = torch.empty((G, K, N), dtype=dtype, device="meta")
    out = ops.stream_bmm(x, w)
    assert out.shape == (G, M, N) and out.dtype == dtype and out.device.type == "meta"
    with torch.no_grad():
        plain, _ = cost.count(torch.bmm, x, w)
        ours, _ = cost.count(ops.stream_bmm, x, w)
    assert ours.flops == plain.flops and ours.bytes == plain.bytes
    assert ours.calls == {"stream_bmm": 1}
    assert (ours.flops["forward"], ours.bytes["forward"]) == work.stream_bmm(x, w)
    assert ours.peak_bytes == plain.peak_bytes  # nothing allocated but the output


def test_the_batched_product_refuses_a_gradient_and_bad_shapes():
    x = torch.ones((2, 3, 8), requires_grad=True)
    w = torch.ones((2, 8, 4))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.stream_bmm(x, w)
    with torch.no_grad():
        assert torch.equal(ops.stream_bmm(x, w), torch.full((2, 3, 4), 8.0))
    with pytest.raises(ValueError, match="bad shapes"):
        ops.stream_bmm(torch.ones(3, 3, 8), w)
    with pytest.raises(ValueError, match="bad shapes"):
        ops.stream_bmm(torch.ones(2, 8), w)


# -----------------------------------------------------------------------------
# the families' forwards in bf16 against the reference
# -----------------------------------------------------------------------------


def _tol(tm):
    return HYBRID_TOL if tm.cfg.shared_attn_every else LOGIT_TOL


@pytest.mark.parametrize("name", list(FAMILIES))
def test_bf16_prefill_and_decode_logits_match_reference(models, name, monkeypatch):
    jm, jp, tm, tp = models[name]
    B = 2
    ties = TieSpy(monkeypatch, B)
    prompt = _prompt(jm.cfg.vocab_size, B=B, seed=1)
    jl, jc = jm.prefill(jp, tokens=jnp.asarray(prompt), S_max=S_MAX)
    tl, tc = tm.prefill(tp, prompt, S_max=S_MAX)
    _close(tl, jl, "prefill logits", _tol(tm), ties)
    tok = np.random.default_rng(2).integers(0, jm.cfg.vocab_size, size=(B, 1)).astype(np.int32)
    jl, _ = jm.decode_step(jp, jc, jnp.asarray(tok), S_MAX)
    tl, _ = tm.decode_step(tp, tc, tok, S_MAX)
    _close(tl, jl, "decode_step logits", _tol(tm), ties)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_bf16_verify_or_chain_logits_match_reference(models, name, monkeypatch):
    """The attention families: a tree-masked ``spec_forward`` after the
    prefill (rows out of order, one skipped, ancestor subsets); the
    recurrent ones: a chain forward of 4 tokens committing 3."""
    jm, jp, tm, tp = models[name]
    B, P, n = 1, 8, 4
    prompt = _prompt(jm.cfg.vocab_size, B, P, seed=3)
    tokens = np.random.default_rng(4).integers(0, jm.cfg.vocab_size, size=(B, n)).astype(np.int32)
    ties = TieSpy(monkeypatch, B)
    _, jc = jm.prefill(jp, tokens=jnp.asarray(prompt), S_max=S_MAX)
    _, tc = tm.prefill(tp, prompt, S_max=S_MAX)
    if tm.uses_chain_spec:
        jl, _ = jm.chain_forward(jp, jc, jnp.asarray(tokens), 3, S_MAX)
        tl, _ = tm.chain_forward(tp, tc, tokens, 3, S_MAX)
        _close(tl, jl, "chain_forward logits", _tol(tm))
        return
    rows = np.array([[P, -1, P + 2, P + 1]], np.int32)
    positions = np.array([[P, P + 1, P + 1, P + 2]], np.int32)
    mask = np.zeros((B, n, S_MAX), bool)
    mask[:, :, :P] = True
    mask[0, 0, P] = mask[0, 2, [P, P + 2]] = mask[0, 3, [P, P + 1]] = True
    mask[0, 1, :] = False  # a query that sees no row
    jl, _ = jm.spec_forward(jp, jc, *map(jnp.asarray, (tokens, positions, rows, mask)))
    tl, _ = tm.spec_forward(tp, tc, tokens, positions, rows, mask)
    _close(tl, jl, "spec_forward logits", ties=ties)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_the_bf16_engine_emits_its_greedy_decode(models, name):
    _, _, tm, tp = models[name]
    prompt = _prompt(tm.cfg.vocab_size, seed=5)
    want = port_greedy(tm, tp, prompt, NEW, S_MAX)[0]
    if tm.uses_chain_spec:
        eng = ChainSpecEngine(tm, tm, ChainConfig(k=4, mode="parallel", max_new=NEW), S_MAX,
                              S_MAX)
    else:
        eng = SpecEngine(tm, tm, SpecConfig(bs=8, w=4, c=2, d=2, n_cap=64, max_new=NEW),
                         S_max_t=S_MAX, S_max_d=S_MAX)
    out, st = eng.session(tp, tp).generate(prompt)
    assert out[0] == want
    assert st.rounds < NEW  # drafted tokens beyond the root were accepted


@pytest.mark.parametrize("name", list(FAMILIES))
def test_the_op_probe_finds_no_differing_op_in_bf16(models, name):
    """``tools/bf16_invariance.py``'s part 4 on the smoke model: 8 decode
    steps against the same tokens in one forward, op by op."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import bf16_invariance
    finally:
        sys.path.remove(str(ROOT / "tools"))
    _, _, tm, tp = models[name]
    if tm.cfg.n_experts:  # the card's drop-free capacity: an expert's M is the forward's rows
        tm = make_model(dataclasses.replace(tm.cfg, capacity_factor=tm.cfg.n_experts
                                            / tm.cfg.moe_top_k), "cpu")
    prompt = torch.as_tensor(_prompt(tm.cfg.vocab_size, P=16, seed=6))
    with torch.no_grad():
        found, compared, seen, _ = bf16_invariance.probe_family(torch, tm, tp, prompt, 8, S_MAX)
    assert found is None and compared > 0, found
    assert "logits" in seen and "norm" in seen
    if tm.cfg.n_experts:
        assert {"route weights", "experts", "combine"} <= set(seen)
    if tm.cfg.attn_kind == "mla":
        assert {"latent_attention", "batched"} <= set(seen)
