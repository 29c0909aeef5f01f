"""The serving product, ``ops.stream_matmul``, the serving norm, ``ops.rms_norm``,
and the forwards that carry them.

The shared blocks' dense products (the q/k/v/o projections, the cross
block's, the MLP's down projection, zamba2's shared-block input and the
lm_head) go through ``models.common.project``: in a serving forward (no
gradient) ``ops.stream_matmul``, whose kernel sums each output over K in
an order that the number of rows does not choose; under a gradient plain
``x @ w``.  On the CPU both are ``x @ w``, so the port's results there are
what they were.  Checked here:

* the plain version against the reference's product (``jnp.dot`` on the
  same seeded numpy inputs; f32 2e-5, bf16 2e-2) and bit for bit against
  ``x @ w``, the wrapper with an x of any rank;
* at the smoke configs' product shapes, a row's bits among M rows (up to
  the 32 of a smoke prompt): in bf16 the same as alone; in float32 the same
  as among 2 rows (a single f32 row takes the BLAS's matrix-vector product,
  which the plain version keeps);
* the routing: a no-grad prefill, tree verify (or chain forward) and
  decode step of the dense, cross, zamba2 (its shared block and its mamba2
  layers), MoE (deepseek-moe-16b, mixtral-8x22b), MLA (minicpm3-4b) and
  rwkv6 smoke configs call the wrapper at every site of the table below (a
  spy) and the batched form (``ops.stream_bmm``, through
  ``models.common.project_batched``) at every batched site, with logits bit
  for bit those of plain products, the lm_head under a vocabulary group
  too; a training forward under a gradient calls them at none, and the
  wrappers refuse a gradient;
* the meta branch: the output's shape and dtype, no scratch beside it (the
  kernel combines its splits in a thread-block cluster), and
  ``launch/cost.py``'s count of it equal to its count of the ``x @ w`` it
  replaces (the dry run does not move);
* the kernels' plans: ``ops.matmul_plan`` (whole quanta that cover K
  exactly, at most one portable cluster of splits, a function of K, N and
  the dtype alone) and ``ops.rms_norm_plan`` (a function of d alone), at
  every serving product and norm of every ``PORTED`` config on every rank
  at tp 1-4, each product taken by the wrapper's checks or refused by name;
* the norm (``models.common.rms_norm``): the plain version against the
  reference's ``rms_norm`` and bit for bit the arithmetic the port ran
  before; a serving forward calls ``ops.rms_norm`` at every norm, a
  training forward at none; on meta its count is x read, the output
  written and the weight read, no operations;
* ``tree_attention``'s partials on meta: a row tile holds one query's heads.
"""

import dataclasses
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
from repro.models.common import rms_norm as jrms_norm

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import PORTED
from repro_torch.kernels import ops, ref, work
from repro_torch.launch import cost
from repro_torch.models import transformer
from repro_torch.models.api import make_model

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the rows of the smoke paths' products (a prompt of up to 32 tokens); the card's kernel is
# held at chip_smoke.MATMUL_INVARIANT_ROWS, up to 64.  The CPU's own bf16 product, which the
# plain version keeps, gives a row of the 1B smoke lm_head (K 32) other bits among 53 or more
ROWS = (2, 4, 8, 16, 17, 32)
# caller of models.common.project -> the products of the routing table it makes
SITES = {
    "_project_qkv": "wq/wk/wv", "_out_proj": "wo", "encoder_kv": "cross wk/wv on enc",
    "cross_attention": "cross wq", "_mlp_apply": "wd", "_apply_block": "zamba2 shared in_w",
    "logits_from_hidden": "lm_head", "mamba2_apply": "mamba2 w_in/out_proj",
    "route": "the MoE router (f32)", "_swiglu": "the MoE shared experts' wd",
    "_queries": "MLA w_dq/w_uq", "_latents": "MLA w_dkv", "_out": "MLA wo",
    "rwkv6_time_mix": "rwkv6 decay_a/decay_b/w_o", "rwkv6_channel_mix": "rwkv6 cm_k/cm_v/cm_r",
}
# caller of models.common.project_batched -> the batched products it makes
BATCHED_SITES = {"moe_apply": "the experts' wg/wu/wd", "rwkv6_time_mix": "rwkv6 w_rkvg",
                 "_per_head": "MLA W_uk/W_uv, head by head"}
# smoke config -> the sites its serving forward reaches
WANT = {
    "llama3-8b": {"_project_qkv", "_out_proj", "_mlp_apply", "logits_from_hidden"},
    "llama-3.2-vision-90b": {"_project_qkv", "_out_proj", "encoder_kv", "cross_attention",
                             "_mlp_apply", "logits_from_hidden"},
    "zamba2-2.7b": {"_project_qkv", "_out_proj", "_mlp_apply", "_apply_block",
                    "logits_from_hidden", "mamba2_apply"},
    "deepseek-moe-16b": {"_project_qkv", "_out_proj", "_mlp_apply", "route", "_swiglu",
                         "logits_from_hidden"},
    "mixtral-8x22b": {"_project_qkv", "_out_proj", "route", "logits_from_hidden"},
    "minicpm3-4b": {"_queries", "_latents", "_out", "_mlp_apply", "logits_from_hidden"},
    "rwkv6-7b": {"rwkv6_time_mix", "rwkv6_channel_mix", "logits_from_hidden"},
}
WANT_BATCHED = {"deepseek-moe-16b": {"moe_apply"}, "mixtral-8x22b": {"moe_apply"},
                "minicpm3-4b": {"_per_head"}, "rwkv6-7b": {"rwkv6_time_mix"}}
S_MAX = 64


def _draw(rng, shape, dtype, scale=1.0):
    return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32).to(dtype)


def smoke_shapes():
    """(label, K, N) of the dense products of the smoke llama3-8b and -1b."""
    out = []
    for name in ("llama3-8b", "llama3-1b"):
        c = get_config(name, smoke=True)
        d, hd = c.d_model, c.head_dim
        out += [(f"{name} wq", d, c.n_heads * hd), (f"{name} wk", d, c.n_kv_heads * hd),
                (f"{name} wo", c.n_heads * hd, d), (f"{name} wd", c.d_ff, d),
                (f"{name} lm_head", d, c.vocab_size)]
    return out


# -----------------------------------------------------------------------------
# the plain version and the wrapper on the CPU
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 64), (8, 64), (2, 3, 64), (17, 96)])
def test_plain_product_matches_the_reference_and_x_at_w(dtype, shape):
    rng = np.random.default_rng(3)
    K, N = shape[-1], 200
    x = _draw(rng, shape, dtype)
    w = _draw(rng, (K, N), dtype, K ** -0.5)
    got = ops.stream_matmul(x, w)
    assert got.dtype == dtype and got.shape == shape[:-1] + (N,)
    assert torch.equal(got, x @ w)
    assert torch.equal(ref.stream_matmul_ref(x, w), x @ w)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jnp.dot(jnp.asarray(x.float().numpy()).astype(jdt),
                   jnp.asarray(w.float().numpy()).astype(jdt),
                   preferred_element_type=jnp.float32).astype(jdt)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label,K,N", smoke_shapes())
def test_a_row_has_the_same_bits_among_any_number_of_rows(label, K, N, dtype):
    rng = np.random.default_rng(4)
    x = _draw(rng, (max(ROWS), K), dtype)
    w = _draw(rng, (K, N), dtype, K ** -0.5)
    if dtype == torch.bfloat16:
        single = torch.cat([ops.stream_matmul(x[r:r + 1], w) for r in range(max(ROWS))])
    else:  # a single f32 row is the BLAS's matrix-vector product: the row among 2 rows
        single = torch.cat([ops.stream_matmul(x[r:r + 1].expand(2, -1), w)[:1]
                            for r in range(max(ROWS))])
    for M in ROWS:
        assert torch.equal(ops.stream_matmul(x[:M], w), single[:M]), (label, M)


def test_the_wrapper_refuses_a_gradient_and_bad_shapes():
    x = torch.ones((2, 8), requires_grad=True)
    w = torch.ones((8, 4))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.stream_matmul(x, w)
    with torch.no_grad():
        assert torch.equal(ops.stream_matmul(x, w), torch.full((2, 4), 8.0))
    with pytest.raises(ValueError, match="bad shapes"):
        ops.stream_matmul(torch.ones(2, 7), w)
    with pytest.raises(TypeError, match="f32 or bf16"):
        ops.stream_matmul(torch.ones(2, 8, device="meta"),
                          torch.ones(8, 4, dtype=torch.bfloat16, device="meta"))


# -----------------------------------------------------------------------------
# the routing
# -----------------------------------------------------------------------------


class Spy:
    """Records the caller of ``models.common.project`` for each call of
    ``ops.stream_matmul`` (``wrapper``: of ``project_batched`` for each call
    of ``ops.stream_bmm``)."""

    def __init__(self, monkeypatch, wrapper="stream_matmul"):
        import inspect

        self.sites, self.calls = [], 0
        real = getattr(ops, wrapper)

        def spy(x, w):
            frame = inspect.currentframe().f_back.f_back  # spy <- project <- the site
            self.sites.append(frame.f_code.co_name)
            self.calls += 1
            return real(x, w)

        monkeypatch.setattr(ops, wrapper, spy)


def _serve(name, model, params):
    """A prefill, one tree verify (or a chain forward) and a decode step,
    no gradient; returns the logits of each."""
    c = model.cfg
    rng = np.random.default_rng(5)
    prompt = torch.tensor(rng.integers(0, c.vocab_size, size=(1, 8)), dtype=torch.int32)
    kw = {}
    if model.needs_enc():
        kw["enc"] = rng.normal(size=(1, c.n_enc_tokens, c.d_model)).astype(np.float32)
    with torch.no_grad():
        lg, cache = model.prefill(params, prompt, S_max=S_MAX, **kw)
        tok = lg[:, -1:].argmax(-1).to(torch.int32)
        out = [lg]
        if model.uses_chain_spec:
            lg2, cache = model.chain_forward(params, cache, torch.cat([tok, tok], 1), 2, S_MAX)
        else:
            n = 3
            tokens = tok.expand(1, n).contiguous()
            positions = torch.arange(8, 8 + n, dtype=torch.int32)[None]
            mask = torch.zeros((1, n, S_MAX), dtype=torch.bool)
            mask[:, :, :8] = True
            mask[:, :, 8:8 + n] = torch.tril(torch.ones((n, n), dtype=torch.bool))
            lg2, cache = model.spec_forward(params, cache, tokens, positions, positions, mask)
            cache["len"] = 9
        out.append(lg2)
        lg3, _ = model.decode_step(params, cache, tok, S_MAX)
        out.append(lg3)
    return out


@pytest.mark.parametrize("name", list(WANT))
def test_a_serving_forward_routes_every_shared_product_through_the_kernel(name, monkeypatch):
    model = make_model(get_config(name, smoke=True), "cpu")
    params = model.init(0)
    plain = _serve(name, model, params)
    spy, batched = Spy(monkeypatch), Spy(monkeypatch, "stream_bmm")
    routed = _serve(name, model, params)
    assert set(spy.sites) == WANT[name], sorted(set(spy.sites))
    assert set(spy.sites) <= set(SITES)
    assert set(batched.sites) == WANT_BATCHED.get(name, set()), sorted(set(batched.sites))
    assert set(batched.sites) <= set(BATCHED_SITES)
    for a, b in zip(plain, routed):  # the plain version is x @ w: the CPU's bits as they were
        assert torch.equal(a, b)


def test_the_plain_run_is_bit_for_bit_a_run_of_plain_products(monkeypatch):
    """With every ``project`` replaced by ``x @ w`` the logits are the same
    bits: routing through the wrapper changed nothing on the CPU."""
    from repro_torch.models import attention, common

    model = make_model(get_config("llama-3.2-vision-90b", smoke=True), "cpu")
    params = model.init(1)
    routed = _serve("llama-3.2-vision-90b", model, params)
    for mod in (common, attention, transformer):
        monkeypatch.setattr(mod, "project", lambda x, w: x @ w)
    for a, b in zip(routed, _serve("llama-3.2-vision-90b", model, params)):
        assert torch.equal(a, b)


def test_the_lm_head_under_a_vocabulary_group_goes_through_the_kernel(monkeypatch):
    class Whole:  # a vocabulary group of one rank
        def copy(self, t):
            return t

        def gather(self, t, dim=-1):
            return t

    model = make_model(get_config("llama3-8b", smoke=True), "cpu")
    params = model.init(2)
    h = torch.randn(1, 3, model.cfg.d_model)
    spy = Spy(monkeypatch)
    with torch.no_grad():
        got = transformer.logits_from_hidden(model.cfg, params, h, Whole())
    assert spy.sites == ["logits_from_hidden"]
    assert torch.equal(got, h @ params.lm_head)


class NormSpy:
    """Counts the calls of ``ops.rms_norm`` (through ``models.common``)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = ops.rms_norm

        def spy(x, weight, eps):
            self.calls += 1
            return real(x, weight, eps)

        monkeypatch.setattr(ops, "rms_norm", spy)


# smoke config -> the norms of a forward: 2 per attention + MLP block (the vision
# model's cross block too), per rwkv6 block (its two pre-norms; the time-mix's
# per-head norm is plain arithmetic) and per mamba2 block (its pre-norm and the SSD's
# gated norm), 2 more per MLA block (its q and kv latents), zamba2's shared block 2
# per invocation, and the final norm
def _norms(cfg):
    kinds = list(cfg.layer_kinds)
    mla = sum(k in ("dense", "moe") for k in kinds) if cfg.attn_kind == "mla" else 0
    return 2 * len(kinds) + 2 * mla + \
        2 * (len(kinds) // cfg.shared_attn_every if cfg.shared_attn_every else 0) + 1


@pytest.mark.parametrize("name", list(WANT))
def test_a_serving_forward_routes_every_norm_through_the_kernel(name, monkeypatch):
    model = make_model(get_config(name, smoke=True), "cpu")
    params = model.init(0)
    plain = _serve(name, model, params)
    spy = NormSpy(monkeypatch)
    routed = _serve(name, model, params)
    assert spy.calls == 3 * _norms(model.cfg)  # a prefill, a verify or a chain, a decode step
    for a, b in zip(plain, routed):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 64), (8, 64), (2, 3, 96)])
def test_the_plain_norm_matches_the_reference_and_the_arithmetic_before(dtype, shape):
    from repro_torch.models.common import rms_norm

    rng = np.random.default_rng(9)
    x = _draw(rng, shape, dtype)
    w = (1.0 + _draw(rng, shape[-1:], torch.float32, 0.1)).to(dtype)
    got = rms_norm(x, w, 1e-5)
    x32 = x.float()  # the port's norm before the kernel, written out
    before = (x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-5) * w.float()).to(dtype)
    assert got.dtype == dtype and torch.equal(got, before)
    assert torch.equal(ops.rms_norm(x, w, 1e-5), before)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jrms_norm(jnp.asarray(x.float().numpy()).astype(jdt),
                     jnp.asarray(w.float().numpy()).astype(jdt), 1e-5)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_norm_on_meta_counts_its_bytes_and_refuses_a_gradient(dtype):
    x = torch.empty((2, 5, 4096), dtype=dtype, device="meta")
    w = torch.empty((4096,), dtype=dtype, device="meta")
    out = ops.rms_norm(x, w, 1e-5)
    assert out.shape == x.shape and out.dtype == dtype and out.device.type == "meta"
    with torch.no_grad():
        got, _ = cost.count(lambda a, b: ops.rms_norm(a, b, 1e-5), x, w)
    es = x.element_size()
    assert got.calls == {"rms_norm": 1} and got.total_flops == 0
    assert got.bytes["forward"] == (2 * 10 * 4096 + 4096) * es
    with pytest.raises(RuntimeError, match="no backward"):
        ops.rms_norm(torch.ones(2, 8, requires_grad=True), torch.ones(8), 1e-5)
    with pytest.raises(ValueError, match="bad shapes"):
        ops.rms_norm(torch.ones(2, 8), torch.ones(7), 1e-5)


@pytest.mark.parametrize("name", list(WANT))
def test_a_training_forward_keeps_plain_products(name, monkeypatch):
    model = make_model(get_config(name, smoke=True), "cpu")
    params = model.init(0, trainable=True)
    c = model.cfg
    rng = np.random.default_rng(6)
    tokens = torch.tensor(rng.integers(0, c.vocab_size, size=(2, 8)), dtype=torch.int32)
    kw = {}
    if model.needs_enc():
        kw["enc"] = rng.normal(size=(2, c.n_enc_tokens, c.d_model)).astype(np.float32)
    spy, norms = Spy(monkeypatch), NormSpy(monkeypatch)
    batched = Spy(monkeypatch, "stream_bmm")
    logits = model.forward_train(params, tokens, **kw)
    logits.float().square().mean().backward()
    assert spy.calls == 0 and norms.calls == 0 and batched.calls == 0
    assert params.lm_head.grad is not None


# -----------------------------------------------------------------------------
# meta: the dry run
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_shape,K,N", [((1, 1, 4096), 4096, 4096), ((2, 16, 4096), 4096, 1024),
                                         ((8, 14336), 14336, 4096), ((1, 3, 2048), 2048, 128256),
                                         ((512, 4096), 4096, 4096)])
def test_meta_counts_as_the_product_it_replaces(x_shape, K, N, dtype):
    x = torch.empty(x_shape, dtype=dtype, device="meta")
    w = torch.empty((K, N), dtype=dtype, device="meta")
    out = ops.stream_matmul(x, w)
    assert out.shape == x_shape[:-1] + (N,) and out.dtype == dtype and out.device.type == "meta"
    with torch.no_grad():
        plain, _ = cost.count(lambda a, b: a @ b, x, w)
        ours, _ = cost.count(ops.stream_matmul, x, w)
    assert ours.flops == plain.flops and ours.bytes == plain.bytes
    assert ours.calls == {"stream_matmul": 1}
    assert (ours.flops["forward"], ours.bytes["forward"]) == work.stream_matmul(x, w)
    assert ours.peak_bytes == plain.peak_bytes  # the kernel allocates nothing but its output


def _plan_ok(K, N, dtype):
    """``ops.matmul_plan``'s contract, as csrc/stream_matmul.cu's launch
    checks it: a tile the kernel has, whole quanta a split, 1, 2, 4 or 8
    splits (at most one portable cluster) that cover K exactly, none empty."""
    tile, k_split, splits = ops.matmul_plan(K, N, dtype)
    assert tile in ((64, 128) if dtype == torch.bfloat16 else (64, 128, 256))
    assert k_split % ops._MATMUL_QUANTUM[dtype] == 0
    assert splits in (1, 2, 4, 8) and splits <= ops._MATMUL_CLUSTER
    assert (splits - 1) * k_split < K <= splits * k_split
    assert -(-N // tile) <= 65535


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 1024), (14336, 4096), (4096, 128256),
                                 (9560, 8192), (8192, 256), (2048, 512), (64, 8), (100, 3),
                                 (2560, 18362)])
def test_the_split_of_k_does_not_depend_on_the_rows(K, N, dtype):
    """The plan takes K, N and the dtype, nothing of x: one order of
    summation for every M.  It covers K with whole quanta and splits within
    one cluster, and is the same on every call."""
    _plan_ok(K, N, dtype)
    assert ops.matmul_plan(K, N, dtype) == ops.matmul_plan.__wrapped__(K, N, dtype)
    assert "M" not in inspect.signature(ops.matmul_plan).parameters


def test_the_meta_branch_allocates_no_scratch():
    """On meta the wrapper allocates the output and nothing else: the kernel
    keeps no split partials and no tickets in device memory."""
    x = torch.empty((16, 4096), dtype=torch.bfloat16, device="meta")
    w = torch.empty((4096, 1024), dtype=torch.bfloat16, device="meta")
    allocated = []
    real = torch.empty

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        allocated.append(tuple(out.shape))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "empty", spy)
        mp.setattr(torch, "zeros", spy)
        out = ops.stream_matmul(x, w)
    assert allocated == [(16, 1024)] and out.shape == (16, 1024)


def _serving_calls(arch):
    """(dtype, K, N) of every ``ops.stream_matmul`` call (and of each group of
    every ``ops.stream_bmm`` call) and (dtype, d) of
    every ``ops.rms_norm`` call of a 4-token prefill and a decode step, on
    meta at full width, of every rank at tp 1-4; the depth cut to two
    periods of the config's layer pattern (every kind of layer and of
    product stays), in bf16 (the dry run's dtype) and float32."""
    from repro_torch.launch import specs
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    products, norms = set(), set()
    real_mm, real_bmm, real_norm = ops.stream_matmul, ops.stream_bmm, ops.rms_norm

    def mm(x, w):
        products.add((x.dtype, w.shape[0], w.shape[1]))
        return real_mm(x, w)

    def bmm(x, w):  # each group's product takes the plain product's plan
        products.add((x.dtype, w.shape[1], w.shape[2]))
        return real_bmm(x, w)

    def norm(x, weight, eps):
        norms.add((x.dtype, x.shape[-1]))
        return real_norm(x, weight, eps)

    base = get_config(arch)
    period = math.lcm(len(base.block_pattern), base.shared_attn_every or 1,
                      base.cross_attn_every or 1)
    depth = min(base.n_layers, base.first_k_dense + 2 * period)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "stream_matmul", mm)
        mp.setattr(ops, "stream_bmm", bmm)
        mp.setattr(ops, "rms_norm", norm)
        for dtype in ("bfloat16", "float32"):
            cfg = dataclasses.replace(base, n_layers=depth, dtype=dtype, param_dtype=dtype)
            mp.setattr(specs, "published_config", lambda _arch, cfg=cfg: cfg)
            for tp in (1, 2, 3, 4):
                for rank in range(tp):
                    model = specs.rank_model(arch, {"model": tp}, rank)
                    params = specs.param_specs(model)
                    batch = specs.batch_specs(model.cfg, dataclasses.replace(
                        SHAPES["prefill_32k"], global_batch=1, seq_len=4), {"model": tp})
                    with torch.no_grad():
                        make_prefill_step(model.cfg, model, S_max=8)(params, batch)
                        cache = model.init_cache(1, 8, dtype)
                        cache["len"] = 4
                        tok = torch.empty((1, 1), dtype=torch.int32, device="meta")
                        make_decode_step(model.cfg, model, S_max=8)(params, cache, tok)
    return products, norms


# bf16 products the kernel refuses (K or N no multiple of 8), each by name, all of them on
# ranks of a tensor-parallel group, where no serving path runs these families in bf16:
# minicpm3-4b's vocabulary (73448) over 2 and 4 ranks; zamba2-2.7b's w_in at tp 4 (20
# mamba2 heads a rank: N 2708); at tp 3 the experts' share of d_ff (deepseek-moe-16b 470 of
# 1408, mixtral-8x22b 5462 of 16384) and deepseek-moe-16b's shared experts' wd (2 x 1410)
REFUSED = {"minicpm3-4b": {(2560, 36724), (2560, 18362)}, "zamba2-2.7b": {(2560, 2708)},
           "deepseek-moe-16b": {(470, 2048), (2048, 470), (2820, 2048)},
           "mixtral-8x22b": {(5462, 6144), (6144, 5462)}}


@pytest.mark.parametrize("arch", PORTED)
def test_every_serving_shape_is_taken_or_refused_by_name(arch):
    """Every (K, N) that a serving prefill or decode step of a ``PORTED``
    config passes to ``ops.stream_matmul`` on any rank at tp 1-4 has a plan
    that the kernel's launch accepts, or (bf16 only) a refusal that names
    the shape; every norm width has a plan that covers its row."""
    products, norms = _serving_calls(arch)
    assert products and norms
    refused = set()
    for dtype, K, N in products:
        why = ops.matmul_refusal(K, N, dtype)
        if why is not None:
            assert dtype == torch.bfloat16 and f"K={K} N={N}" in why
            refused.add((K, N))
            continue
        _plan_ok(K, N, dtype)
    assert refused == REFUSED.get(arch, set())
    for dtype, d in norms:
        vec, tpr, nv = ops.rms_norm_plan(d, dtype)
        assert d % vec == 0 and tpr * nv * vec >= d and nv <= (8 if vec > 1 else 16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_norm_launch_shape_depends_on_d_alone(dtype):
    """``ops.rms_norm_plan`` (values a load, threads a row, loads a thread)
    takes d and the dtype, nothing of x's rows: a row sums its squares in
    one order whatever M is.  16-byte loads where d allows, threads a power
    of two from 32 to 512, at most 4 loads a thread below 512 threads, and
    the loads cover the row with less than one load a thread to spare."""
    assert list(inspect.signature(ops.rms_norm_plan).parameters) == ["d", "dtype"]
    es = 4 if dtype == torch.float32 else 2
    for d in (1, 7, 64, 80, 100, 256, 512, 768, 1024, 2048, 2560, 4096, 5120, 6144, 8192, 16384):
        vec, tpr, nv = ops.rms_norm_plan(d, dtype)
        assert (vec, tpr, nv) == ops.rms_norm_plan.__wrapped__(d, dtype)
        assert vec == (16 // es if d % (16 // es) == 0 else 1)
        assert 32 <= tpr <= 512 and tpr & (tpr - 1) == 0 and nv & (nv - 1) == 0
        loads = d // vec
        assert tpr * nv >= loads and (nv == 1 or tpr * nv // 2 < loads)
        assert tpr == 512 or tpr == 32 or tpr * 4 >= loads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,n,hq,hkv,S", [(1, 8, 32, 8, 4096), (2, 512, 24, 3, 8192),
                                          (1, 4, 48, 1, 4096), (1, 1, 32, 8, 8192)])
def test_tree_attention_partials_take_one_query_per_row_tile(B, n, hq, hkv, S, dtype):
    """A row tile holds heads of one query (every row of a block attends the
    same ranks): n x ceil(G / rows) tiles of min(rows, G) partial rows."""
    rows = ops._ATTENTION_ROWS[dtype]
    G = hq // hkv
    q = torch.empty((B, n, hq, 128), dtype=dtype, device="meta")
    parts = ops._attention_scratch_meta(q, B, n, hq, hkv, 128, S, S)
    _, n_launch = ops.attn_plan(S)
    tiles = n * -(-G // rows)
    assert parts[0].numel() == B * hkv * tiles * min(rows, G) * n_launch * 128
    assert parts[1].numel() == B * hkv * tiles * min(rows, G) * n_launch * 2
