"""The port's kernels (``repro_torch.kernels``) against the JAX package's.

On the CPU every wrapper in ``repro_torch.kernels.ops`` takes its plain
PyTorch version (``repro_torch.kernels.ref``); these tests hold that version
against ``repro.kernels.ref`` and against the Pallas kernels run in
interpret mode through ``repro.kernels.ops``.  The CUDA kernels themselves
are held against the same plain versions on the card by ``chip_smoke.py``.

Tolerances: float32 2e-5 (the two sides sum in different orders), bfloat16
2e-2 (one bf16 rounding of the output), row moves and slot writes exact.
"""

import inspect
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

import jax

from repro.core import kv as jkv
from repro.flags import override_flags
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.kv_moves import slot_write_rows_pallas
from repro_torch.core import kv
from repro_torch.kernels import ops, ref

TREE_SHAPES = [  # (B, n, Hq, Hkv, hd, S), as tests/test_kernels.py
    (2, 4, 8, 2, 64, 96),
    (1, 8, 4, 4, 32, 128),
    (2, 3, 6, 3, 80, 200),
    (1, 16, 8, 1, 128, 256),
    (3, 1, 4, 2, 128, 64),
    # ... and the dense configs' head groupings: G 3 (llama3-3b), 7 (deepseek-coder-33b)
    # and 48 on one KV head at verify width 8 (granite-20b, MQA: 384 query rows)
    (2, 5, 9, 3, 64, 100),
    (1, 8, 14, 2, 128, 160),
    (1, 8, 48, 1, 128, 200),
]
DECODE_SHAPES = [  # (B, Hq, Hkv, hd, S): hd 64/80/128, G 1 and 4, S no multiple of 128
    (2, 8, 2, 64, 160),
    (2, 4, 4, 80, 200),
    (1, 16, 4, 128, 96),
    (3, 4, 4, 64, 100),
    (2, 8, 2, 80, 72),
    (2, 4, 4, 128, 136),
    # ... and G 3, 7, 8 and 48 (llama3-3b, deepseek-coder-33b, llama3-70b, granite-20b)
    (2, 6, 2, 128, 136),
    (1, 14, 2, 64, 100),
    (2, 16, 2, 128, 96),
    (2, 48, 1, 128, 160),
]
SWIGLU_SHAPES = [(8, 64, 128), (100, 96, 200), (1, 256, 64), (130, 128, 384)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(a, dtype):
    """The same numpy array as a JAX array and a torch tensor of ``dtype``."""
    return jnp.asarray(a, jnp.dtype(dtype)), torch.tensor(a).to(getattr(torch, dtype))


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", TREE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_attention_matches_reference(shape, dtype):
    B, n, hq, hkv, hd, S = shape
    rng = np.random.default_rng(sum(shape))
    (jq, q), (jk, k), (jv, v) = (_pair(rng.normal(size=s).astype(np.float32), dtype)
                                 for s in ((B, n, hq, hd), (B, S, hkv, hd), (B, S, hkv, hd)))
    m = rng.random((B, n, S)) < 0.5
    m[:, 0, :] = False  # a fully masked row gives exact zeros
    jm, mask = jnp.asarray(m), torch.tensor(m)
    launches = ops.launch_counts()
    got = ops.tree_attention(q, k, v, mask)
    assert ops.launch_counts() == launches, "a CPU tensor never launches a kernel"
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(_np32(got), _np32(jref.tree_attention_ref(jq, jk, jv, jm)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(_np32(got), _np32(jops.tree_attention(jq, jk, jv, jm)),
                               atol=tol, rtol=tol)
    assert (_np32(got)[:, 0] == 0).all()


def _decode_lengths(B, S, i):
    """Per-row lengths over 0..S: case i of four, each row its own."""
    return np.array([[0, 1, S // 2 + 3, S][(i + b) % 4] for b in range(B)], np.int32)


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_reference(shape, dtype):
    """The plain version against the reference's oracle, its Pallas kernel
    in interpret mode and its model path (``_attend`` under the length
    mask), lengths 0, 1, S/2 + 3 and S in every row position."""
    from repro.models.attention import _attend

    B, hq, hkv, hd, S = shape
    rng = np.random.default_rng(sum(shape))
    (jq, q), (jk, k), (jv, v) = (_pair(rng.normal(size=s).astype(np.float32), dtype)
                                 for s in ((B, hq, hd), (B, S, hkv, hd), (B, S, hkv, hd)))
    tol = TOL[dtype]
    for i in range(4):
        lens = _decode_lengths(B, S, i)
        launches = ops.launch_counts()
        got = ops.decode_attention(q, k, v, torch.tensor(lens))
        assert ops.launch_counts() == launches, "a CPU tensor never launches a kernel"
        assert got.dtype == q.dtype and got.shape == q.shape
        jl = jnp.asarray(lens)
        mask = jnp.arange(S)[None, :] < jl[:, None]
        for want in (jref.decode_attention_ref(jq, jk, jv, jl),
                     jops.decode_attention(jq, jk, jv, jl),
                     _attend(jq[:, None], jk, jv, mask[:, None, None, None, :])[:, 0]):
            np.testing.assert_allclose(_np32(got), _np32(want), atol=tol, rtol=tol)
        assert (_np32(got)[lens == 0] == 0).all()


def test_decode_attention_is_tree_attention_at_one_query():
    """A host-int length equals the same length per row, and the result is
    tree_attention's at n = 1 under the mask cols < length."""
    B, hq, hkv, hd, S = 2, 8, 2, 64, 160
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.normal(size=s).astype(np.float32))
               for s in ((B, hq, hd), (B, S, hkv, hd), (B, S, hkv, hd)))
    for L in (0, 1, 65, S):
        got = ops.decode_attention(q, k, v, L)
        assert torch.equal(got, ops.decode_attention(q, k, v, torch.full((B,), L)))
        mask = (torch.arange(S) < L).expand(B, 1, S)
        assert torch.equal(got, ops.tree_attention(q[:, None], k, v, mask)[:, 0])
    with pytest.raises(ValueError, match="length must be"):
        ops.decode_attention(q, k, v, torch.zeros(B + 1, dtype=torch.int32))


def _bf16_kernel_arithmetic(q, k, v, mask):
    """The bf16 kernel's arithmetic (csrc/attention.cuh) written out in torch:
    f32 scores of the bf16 values, the f32 softmax numerators P and their
    f32 sum l, P split into hi = bf16(p) and lo = bf16(p - hi), and P·V of
    the bf16 values over l.  The sums run in float64 and are rounded once
    to f32, so the result is a function of the inputs alone — not of the
    order in which a library sums in this process — and differs from the
    kernel's only by the kernel's own f32 summation order.
    q [B, n, Hq, hd], k/v [B, S, Hkv, hd] bf16, mask bool [B, n, S].
    Returns the f32 result before the output's bf16 rounding."""
    B, n, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.double().reshape(B, n, hkv, hq // hkv, hd)
    s = (torch.einsum("bnkgh,bskh->bkgns", qg, k.double()) / math.sqrt(hd)).float()
    m = mask[:, None, None]
    s = torch.where(m, s, torch.full_like(s, -1e30))
    p = torch.where(m, torch.exp(s - s.amax(-1, keepdim=True)), torch.zeros_like(s))
    l = p.double().sum(-1, keepdim=True).float()
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    o = torch.einsum("bkgns,bskh->bkgnh", hi.double() + lo.double(), v.double()).float()
    o = torch.where(l > 0, o / torch.where(l > 0, l, torch.ones_like(l)), torch.zeros_like(o))
    return o.permute(0, 3, 1, 2, 4).reshape(B, n, hq, hd)


def _exact_attention(q, k, v, mask):
    """Tree-masked attention of the same values in float64 (the plain
    version's function, without its f32 roundings); fully masked rows 0."""
    B, n, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.double().reshape(B, n, hkv, hq // hkv, hd)
    s = torch.einsum("bnkgh,bskh->bkgns", qg, k.double()) / math.sqrt(hd)
    m = mask[:, None, None]
    s = torch.where(m, s, torch.full_like(s, -math.inf))
    p = torch.where(m.any(-1, keepdim=True), torch.softmax(s, -1), torch.zeros_like(s))
    p = torch.nan_to_num(p)
    return torch.einsum("bkgns,bskh->bnkgh", p, v.double()).reshape(B, n, hq, hd)


def _bf16_cases():
    """Every TREE_SHAPES case (row 0 fully masked) and every DECODE_SHAPES
    case at its four length patterns (lengths 0 included), as (id, q, k, v,
    mask) with bf16 tensors from a seeded numpy generator."""
    for shape in TREE_SHAPES:
        B, n, hq, hkv, hd, S = shape
        rng = np.random.default_rng(sum(shape))
        q, k, v = (rng.normal(size=sh).astype(np.float32)
                   for sh in ((B, n, hq, hd), (B, S, hkv, hd), (B, S, hkv, hd)))
        m = rng.random((B, n, S)) < 0.5
        m[:, 0, :] = False
        yield f"tree{shape}", q, k, v, m
    for shape in DECODE_SHAPES:
        B, hq, hkv, hd, S = shape
        rng = np.random.default_rng(sum(shape))
        q, k, v = (rng.normal(size=sh).astype(np.float32)
                   for sh in ((B, 1, hq, hd), (B, S, hkv, hd), (B, S, hkv, hd)))
        for i in range(4):
            lens = _decode_lengths(B, S, i)
            yield f"decode{shape}-{i}", q, k, v, (np.arange(S)[None, :] < lens[:, None])[:, None]


@pytest.mark.parametrize("case", list(_bf16_cases()), ids=lambda c: c[0])
def test_bf16_kernel_arithmetic_matches_reference(case):
    """The bf16 kernel's split of P into hi + lo keeps the reference's f32 P:
    before the output's rounding it is within 1e-5 of the attention of the
    same bf16 values computed exactly (float64; one rounding of P would be
    ~1e-3 off), and after it within bf16's 2e-2 of the JAX package's
    reference; a fully masked row or a length 0 gives exact zeros.  Both
    sides sum in float64, so the verdict depends on the inputs alone: with
    f32 sums a library's order of summation, which may differ from one
    process to the next, moved P's last bits and, through the split, the
    result by up to the tolerance."""
    _, q, k, v, m = case
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "bfloat16") for a in (q, k, v))
    mask = torch.tensor(m)
    got = _bf16_kernel_arithmetic(tq, tk, tv, mask)
    want = _exact_attention(tq, tk, tv, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    plain = ref.tree_attention_ref(tq.float(), tk.float(), tv.float(), mask)
    np.testing.assert_allclose(plain.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    jwant = jref.tree_attention_ref(jq, jk, jv, jnp.asarray(m))
    np.testing.assert_allclose(_np32(got.to(torch.bfloat16)), _np32(jwant), atol=2e-2, rtol=2e-2)
    assert (got.numpy()[~m.any(-1)] == 0).all()


def test_attention_launch_plan_depends_on_S_and_the_bound_only():
    """The split length is a multiple of 64 (both dtypes' key tiles), a
    function of S alone, with at most 32 splits; the splits launched cover
    exactly the keys below the bound.  No argument of the plan is n, so a
    row is summed alike at every n, and decode_attention at length L gets
    tree_attention's plan under kv_bound L."""
    assert list(inspect.signature(ops.attn_plan).parameters) == ["S", "kv_end"]
    assert list(inspect.signature(ops.attn_split_keys).parameters) == ["S"]
    for S in list(range(1, 5000, 37)) + [512, 2048, 2049, 4096, 65536]:
        sk = ops.attn_split_keys(S)
        assert sk % 64 == 0 and -(-S // sk) <= 32
        assert sk == 64 or S > 2048
        assert ops.attn_plan(S) == ops.attn_plan(S, S) == (sk, -(-S // sk))
        for L in sorted({0, 1, sk - 1, sk, sk + 1, S // 2 + 3, S, S + 7}):
            split, n_launch = ops.attn_plan(S, L)
            live = min(L, S)
            assert split == sk and 1 <= n_launch <= 32
            assert n_launch * sk >= live and (n_launch == 1 or (n_launch - 1) * sk < live)
    assert ops.attn_plan(512, 48) == (64, 1)  # the paths' lengths: one live split
    assert ops.attn_plan(512, 56) == (64, 1) and ops.attn_plan(512, 65) == (64, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_attention_key_bound(dtype):
    """A bound the mask keeps gives the call without it, bit for bit; the
    CPU path refuses a bound the mask breaks."""
    B, n, hq, hkv, hd, S = 2, 4, 8, 2, 64, 160
    rng = np.random.default_rng(11)
    q, k, v = (_pair(rng.normal(size=sh).astype(np.float32), dtype)[1]
               for sh in ((B, n, hq, hd), (B, S, hkv, hd), (B, S, hkv, hd)))
    m = rng.random((B, n, S)) < 0.5
    m[:, :, 70:] = False
    mask = torch.tensor(m)
    want = ops.tree_attention(q, k, v, mask)
    for bound in (70, 71, S, S + 5):
        assert torch.equal(ops.tree_attention(q, k, v, mask, kv_bound=bound), want)
    mask[1, 2, 69] = True
    with pytest.raises(ValueError, match="kv_bound=69"):
        ops.tree_attention(q, k, v, mask, kv_bound=69)


@pytest.mark.parametrize("sliding_window", [0, 16])
@pytest.mark.parametrize("n", [1, 3])
def test_cached_attention_takes_decode_attention_for_a_decode_step(monkeypatch, n,
                                                                   sliding_window):
    """attention_cached sends a decode step (n = 1, contiguous rows, no
    window) to decode_attention with the length row_start + 1, and every
    other call to tree_attention with the key bound row_start + n; the
    outputs agree with the masked path."""
    from repro_torch.configs import ModelConfig
    from repro_torch.models import attention

    cfg = ModelConfig(name="a", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                      vocab_size=64, sliding_window=sliding_window)
    rng = np.random.default_rng(n)
    p = {name: torch.tensor(rng.normal(size=s).astype(np.float32) * 0.2)
         for name, s in (("wq", (32, 4, 8)), ("wk", (32, 2, 8)), ("wv", (32, 2, 8)),
                         ("wo", (4, 8, 32)))}
    B, S, start = 2, 40, 17
    x = torch.tensor(rng.normal(size=(B, n, 32)).astype(np.float32))
    ck, cv = (torch.tensor(rng.normal(size=(B, S, 2, 8)).astype(np.float32)) for _ in range(2))
    pos = start + torch.arange(n, dtype=torch.int32).expand(B, n)
    cols = torch.arange(S, dtype=torch.int32)
    mask = cols[None, None, :] <= pos[:, :, None]
    if sliding_window:
        mask &= cols[None, None, :] > pos[:, :, None] - sliding_window
    calls = []
    for name in ("decode_attention", "tree_attention"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _fn=fn, _n=name, **kw: calls.append(
            (_n, a[-1] if _n == "decode_attention" else kw.get("kv_bound"))) or _fn(*a, **kw))
    out, _, _ = attention.attention_cached(cfg, p, x, ck.clone(), cv.clone(), pos, pos, mask,
                                           row_start=start)
    monkeypatch.undo()
    if n == 1 and not sliding_window:
        assert calls == [("decode_attention", start + 1)]
    else:
        assert calls == [("tree_attention", start + n)]
    want, _, _ = attention.attention_cached(cfg, p, x, ck.clone(), cv.clone(), pos, pos, mask)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape", SWIGLU_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_swiglu_matches_reference(shape, dtype):
    T, d, ff = shape
    rng = np.random.default_rng(T + d + ff)
    jx, x = _pair(rng.normal(size=(T, d)).astype(np.float32), dtype)
    jg, wg = _pair((0.1 * rng.normal(size=(d, ff))).astype(np.float32), dtype)
    ju, wu = _pair((0.1 * rng.normal(size=(d, ff))).astype(np.float32), dtype)
    got = ops.fused_swiglu(x, wg, wu)
    assert got.dtype == x.dtype and got.shape == (T, ff)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np32(got), _np32(jref.fused_swiglu_ref(jx, jg, ju)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(_np32(got), _np32(jops.fused_swiglu(jx, jg, ju)),
                               atol=tol, rtol=tol)


def _swiglu_kernel_arithmetic(x, wg, wu, phases):
    """fused_swiglu's split-K arithmetic, written out in torch: per split of
    ``ops.stream_plan`` the products in f32 over the K values of each phase
    (f32: the two warps that share columns take k = phase mod 2; bf16: the
    MMA sums the split), the phases added in order, the splits in split
    order, then silu(g) * u in f32 on the complete sums."""
    M, K = x.shape
    k_split, splits = ops.stream_plan(K, wg.shape[1], ops._STREAM_TILE_N, ops._SWIGLU_K_QUANTUM)
    xf, gf, uf = x.float(), wg.float(), wu.float()
    g = u = 0.0
    for sp in range(splits):
        bg = bu = 0.0
        for ph in range(phases):
            ks = torch.arange(sp * k_split, min(K, (sp + 1) * k_split))
            ks = ks[ks % phases == ph]
            bg = bg + xf[:, ks] @ gf[ks]
            bu = bu + xf[:, ks] @ uf[ks]
        g, u = g + bg, u + bu
    return (torch.nn.functional.silu(g) * u).to(x.dtype)


@pytest.mark.parametrize("shape", SWIGLU_SHAPES + [(3, 1100, 128), (2, 4096, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_swiglu_split_sum_matches_reference(shape, dtype):
    """Summing K in the kernel's splits and phases, in their fixed order,
    keeps fused_swiglu within its tolerances of the JAX package's reference
    and of the plain version."""
    T, d, ff = shape
    rng = np.random.default_rng(3 * T + d + ff)
    jx, x = _pair(rng.normal(size=(T, d)).astype(np.float32), dtype)
    jg, wg = _pair((d ** -0.5 * rng.normal(size=(d, ff))).astype(np.float32), dtype)
    ju, wu = _pair((d ** -0.5 * rng.normal(size=(d, ff))).astype(np.float32), dtype)
    got = _swiglu_kernel_arithmetic(x, wg, wu, 2 if dtype == "float32" else 1)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np32(got), _np32(jref.fused_swiglu_ref(jx, jg, ju)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(_np32(got), _np32(ref.fused_swiglu_ref(x, wg, wu)),
                               atol=tol, rtol=tol)


def test_stream_plan_depends_on_K_N_and_the_quantum_only():
    """The weight streams' split of K takes K, N, the column tile and the
    quantum, never the rows of x; it covers K in whole quanta, and gives
    the card at least 132 blocks wherever the column tiles times the quanta
    of K allow it."""
    assert list(inspect.signature(ops.stream_plan).parameters) == ["K", "N", "tile_n",
                                                                    "k_quantum"]
    tile = ops._STREAM_TILE_N
    for q in (2, 6, 32, 64, 128, 2048):
        for K in sorted({q, 3 * q, 4096 // q * q or q, 14336 // q * q or q, 40 * q}):
            for N in (4, 100, 301, 1024, 4096, 8192, 10240, 14336, 128256):
                per, splits = ops.stream_plan(K, N, tile, q)
                tiles, quanta = -(-N // tile), -(-K // q)
                assert per % q == 0 and splits == -(-K // per) and (splits - 1) * per < K
                assert per <= max(ops._STREAM_MAX_K, q)
                if tiles * quanta >= 132:
                    assert tiles * splits >= 132, (K, N, q, per, splits)
    assert ops.stream_plan(4096, 14336, tile, ops._SWIGLU_K_QUANTUM) == (1024, 4)  # 224 blocks
    assert ops.stream_plan(2048, 8192, tile, ops._SWIGLU_K_QUANTUM) == (256, 8)  # 256 blocks


def _random_plan(rng, B, S, M):
    """tests/test_kv_moves.py's plans: overlapping windows, -1 sources,
    duplicate destinations only among masked-off entries."""
    src = rng.integers(0, S, size=(B, M)).astype(np.int32)
    src[rng.random((B, M)) < 0.2] = -1
    dst = np.stack([rng.permutation(S)[:M] for _ in range(B)]).astype(np.int32)
    mask = rng.random((B, M)) < 0.7
    for b in range(B):
        off = np.where(~mask[b])[0]
        if len(off) >= 2:
            dst[b, off[0]] = dst[b, off[1]]
    return src, dst, mask


def _kv_case(name):
    rng = np.random.default_rng(7)
    if name == "random":
        U, B, S, F, M = 2, 3, 16, 5, 7
        arr = rng.normal(size=(U, B, S, F)).astype(np.float32)
        return (arr, *_random_plan(rng, B, S, M))
    if name == "overlap":  # the compaction shift: dst window overlaps src window
        arr = rng.normal(size=(2, 1, 12, 2, 3)).astype(np.float32)
        src = np.array([[3, 4, 5, 6, 7]], np.int32)
        dst = np.array([[2, 3, 4, 5, 6]], np.int32)
        return arr, src, dst, np.ones((1, 5), bool)
    if name == "reversed":  # sources and destinations swap places
        arr = rng.normal(size=(1, 2, 8, 4)).astype(np.float32)
        src = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
        dst = src[:, ::-1].copy()
        return arr, src, dst, np.ones((2, 4), bool)
    if name == "negative":  # -1 sources and destinations, and an all-masked row
        arr = rng.normal(size=(2, 2, 6, 3)).astype(np.float32)
        src = np.array([[2, -1, 1], [0, 1, 2]], np.int32)
        dst = np.array([[4, 4, -1], [3, 4, 5]], np.int32)
        mask = np.array([[True, True, True], [False, False, False]])
        return arr, src, dst, mask
    if name == "empty":
        arr = rng.normal(size=(2, 1, 6, 3)).astype(np.float32)
        z = np.zeros((1, 0), np.int32)
        return arr, z, z, np.zeros((1, 0), bool)
    raise ValueError(name)


@pytest.mark.parametrize("case", ["random", "overlap", "reversed", "negative", "empty"])
def test_kv_move_rows_matches_reference_exactly(case):
    arr, src, dst, mask = _kv_case(case)
    j = tuple(map(jnp.asarray, (arr, src, dst, mask)))
    want = np.asarray(jref.kv_move_rows_ref(*j))
    with override_flags(use_pallas_kv_moves=True, pallas_interpret=True):
        fused = {dn: np.asarray(jops.kv_move_rows(*j, donate=dn)) for dn in (False, True)}
    t_arr = torch.tensor(arr)
    t_plan = tuple(map(torch.tensor, (src, dst, mask)))
    for donate in (False, True):
        before = t_arr.clone()
        got = ops.kv_move_rows(t_arr, *t_plan, donate=donate).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, fused[donate])
        assert torch.equal(t_arr, before), "the CPU path never writes its input"
    np.testing.assert_array_equal(ref.kv_move_rows_ref(t_arr, *t_plan).numpy(), want)


def test_kv_move_rows_copy_through_keeps_input():
    """``donate=False`` returns a fresh tensor with the rows moved and leaves
    the input bit for bit as it was (the async snapshot contract)."""
    rng = np.random.default_rng(0)
    arr = torch.tensor(rng.normal(size=(1, 1, 8, 3)).astype(np.float32))
    before = arr.clone()
    src, dst = torch.tensor([[0, 1]], dtype=torch.int32), torch.tensor([[4, 5]], dtype=torch.int32)
    out = ops.kv_move_rows(arr, src, dst, torch.ones(1, 2, dtype=torch.bool), donate=False)
    assert not torch.equal(out, before)
    assert torch.equal(out[0, 0, 4:6], before[0, 0, 0:2])
    assert torch.equal(arr, before)


def test_kv_move_rows_zero_moves_is_a_no_op():
    """An empty plan moves nothing: ``donate=True`` hands the buffer back,
    ``donate=False`` still returns a fresh tensor, never an alias."""
    arr = torch.tensor(np.random.default_rng(0).normal(size=(2, 1, 6, 3)).astype(np.float32))
    empty = torch.zeros(1, 0, dtype=torch.int32)
    no_mask = torch.zeros(1, 0, dtype=torch.bool)
    assert ops.kv_move_rows(arr, empty, empty, no_mask, donate=True) is arr
    fresh = ops.kv_move_rows(arr, empty, empty, no_mask, donate=False)
    assert fresh.data_ptr() != arr.data_ptr() and torch.equal(fresh, arr)


KV_CASES = ["random", "overlap", "reversed", "negative", "empty"]


@pytest.mark.parametrize("case", KV_CASES)
@pytest.mark.parametrize("donate", [False, True])
def test_kv_move_leaves_matches_reference_leaf_by_leaf(case, donate):
    """One ``kv_move_leaves`` call on two leaves of different U and row
    width (the case's leaf and a wider one of U + 1) against the
    reference's ``kv_move_rows_ref`` on each leaf alone, exactly."""
    arr, src, dst, mask = _kv_case(case)
    U, B, S = arr.shape[:3]
    other = np.random.default_rng(11).normal(size=(U + 1, B, S, 3, 4)).astype(np.float32)
    leaves = [torch.tensor(arr), torch.tensor(other)]
    before = [x.clone() for x in leaves]
    t_plan = tuple(map(torch.tensor, (src, dst, mask)))
    got = ops.kv_move_leaves(leaves, *t_plan, donate=donate)
    assert len(got) == 2
    for g, a in zip(got, (arr, other)):
        want = np.asarray(jref.kv_move_rows_ref(*map(jnp.asarray, (a, src, dst, mask))))
        np.testing.assert_array_equal(g.numpy(), want)
    for x, b in zip(leaves, before):
        assert torch.equal(x, b), "the CPU path never writes its input"
    if src.shape[1] == 0 and not donate:
        assert all(g.data_ptr() != x.data_ptr() for g, x in zip(got, leaves))


def test_apply_moves_is_one_call_per_cache(monkeypatch):
    """``apply_moves`` hands every row leaf of a cache (zamba2's shared
    block here: k and v between mamba2 state leaves) to one
    ``kv_move_leaves`` call, and ``donate=False`` leaves the cache as it
    was."""
    rng = np.random.default_rng(3)
    U, B, S = 2, 2, 10

    def leaf(*trail):
        return torch.tensor(rng.normal(size=(U, B) + trail).astype(np.float32))

    cache = {"len": 4, "groups": [({"conv": leaf(3, 5), "ssm": leaf(2, 3, 4)},
                                   {"k": leaf(S, 2, 3), "v": leaf(S, 2, 3)})]}
    before = [x.clone() for x in kv._flatten(cache["groups"])]
    src = torch.tensor([[1, 2], [3, -1]], dtype=torch.int32)
    dst = torch.tensor([[5, 6], [0, 1]], dtype=torch.int32)
    mask = torch.tensor([[True, True], [True, True]])
    calls = []
    real = ops.kv_move_leaves

    def spy(leaves, *a, **kw):
        calls.append([tuple(x.shape) for x in leaves])
        return real(leaves, *a, **kw)

    monkeypatch.setattr(ops, "kv_move_leaves", spy)
    monkeypatch.setattr(ops, "kv_move_rows", None)  # no leaf goes through the one-leaf call
    out = kv.apply_moves(cache, src, dst, mask, donate=False)
    assert calls == [[(U, B, S, 2, 3), (U, B, S, 2, 3)]]
    for x, b in zip(kv._flatten(cache["groups"]), before):
        assert torch.equal(x, b)
    unit = out["groups"][0]
    for key in ("k", "v"):
        np.testing.assert_array_equal(
            unit[1][key].numpy(), ref.kv_move_rows_ref(cache["groups"][0][1][key], src, dst,
                                                        mask).numpy())
    assert unit[0]["conv"] is cache["groups"][0][0]["conv"]  # state leaves are not moved
    assert out["len"] == 4


KV_PATH_SHAPES = [  # chip_smoke.py's KV_TIMED at the paths' caches: (U, M, Hkv, hd), S 512
    ("8B-reroot", (32, 73, 8, 128)), ("8B-compact", (32, 8, 8, 128)),
    ("1B-reroot", (16, 73, 8, 64)),
]


@pytest.mark.parametrize("label", [lb for lb, _ in KV_PATH_SHAPES])
@pytest.mark.parametrize("B", [1, 2])
def test_kv_move_plan_fills_the_card_from_the_shapes_alone(label, B):
    """``kv_move_plan`` takes shapes, never a plan's data, and gives at
    least two blocks per SM of an H100 (264) for the whole cache (k and v)
    at the paths' shapes in f32 (the paths' dtype) and at their B 2 in
    bf16, with row segments of at least 128 bytes.  (The 1B re-root in
    bf16 at B 1 has 1 KB rows: 256 blocks of 128 bytes.)"""
    assert list(inspect.signature(ops.kv_move_plan).parameters) == \
        ["leaf_shapes", "B", "M", "elem_bytes"]
    U, M, hkv, hd = dict(KV_PATH_SHAPES)[label]
    shape = (U, B, 512, hkv, hd)
    for es in (4, 2):
        chunk, blocks = ops.kv_move_plan([shape, shape], B, M, es)
        assert (chunk, blocks) == ops.kv_move_plan([shape, shape], B, M, es)
        assert chunk >= 128 and M * chunk <= 96 * 1024, (chunk, blocks)
        assert blocks >= (256 if (label, B, es) == ("1B-reroot", 1, 2) else 264), (chunk, blocks)
        assert blocks == 2 * U * B * -(-hkv * hd * es // chunk)
    assert ops.kv_move_plan([(32, 1, 512, 8, 128)], 1, 73, 4) == (256, 512)


def test_kv_move_leaves_refuses_what_one_launch_cannot_take():
    x = torch.zeros(2, 1, 6, 3)
    plan = (torch.zeros(1, 2, dtype=torch.int32), torch.zeros(1, 2, dtype=torch.int32),
            torch.ones(1, 2, dtype=torch.bool))
    with pytest.raises(ValueError, match="at most 16"):
        ops.kv_move_leaves([x] * 17, *plan)
    assert len(ops.kv_move_leaves([x] * 16, *plan)) == 16
    with pytest.raises(ValueError, match="no leaf"):
        ops.kv_move_leaves([], *plan)
    with pytest.raises(ValueError, match="B, S"):
        ops.kv_move_leaves([x, torch.zeros(2, 1, 5, 3)], *plan)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.kv_move_leaves([x, x.to(torch.bfloat16)], *plan)
    with pytest.raises(ValueError, match=r"\[B=1, M\]"):
        ops.kv_move_leaves([x], plan[0], plan[1][:, :1], plan[2])


def test_wrappers_refuse_mixed_and_foreign_devices():
    q = torch.zeros(1, 1, 2, 4)
    kv = torch.zeros(1, 3, 1, 4, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        ops.tree_attention(q, kv, kv, torch.ones(1, 1, 3, dtype=torch.bool))
    # meta is the dry run's device: shapes out, no arithmetic; any other raises
    x = torch.zeros(2, 4, device="meta")
    out = ops.fused_swiglu(x, torch.zeros(4, 3, device="meta"), torch.zeros(4, 3, device="meta"))
    assert out.is_meta and out.shape == (2, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        ops._route("fused_swiglu", types.SimpleNamespace(device=torch.device("xla")))


# -----------------------------------------------------------------------------
# slot_write_rows (the continuous-batching slot lifecycle)
# -----------------------------------------------------------------------------


def _slot_case(rng, dtype, B=3):
    """Two [U, B, S, Hkv, hd] leaves (k and v) and their one-row donors."""
    big = [rng.normal(size=(2, B, 6, 2, 4)).astype(np.float32) for _ in range(2)]
    one = [rng.normal(size=(2, 1, 6, 2, 4)).astype(np.float32) for _ in range(2)]
    return [_pair(a, dtype) for a in big], [_pair(a, dtype) for a in one]


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np32(g), _np32(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slot", [0, 1, 2])
def test_slot_write_rows_matches_pallas_exactly(dtype, slot):
    """Install and zero against ``slot_write_rows_pallas`` in interpret mode
    (zeroing = an all-zeros donor there, no donor here)."""
    big, one = _slot_case(np.random.default_rng(slot), dtype)
    jbig, tbig = [j for j, _ in big], [t for _, t in big]
    jone, tone = [j for j, _ in one], [t for _, t in one]
    before = [t.clone() for t in tbig]
    launches = ops.launch_counts()
    got = ops.slot_write_rows(tbig, tone, slot)
    assert ops.launch_counts() == launches, "a CPU tensor never launches a kernel"
    _same(got, slot_write_rows_pallas(jbig, jone, slot, interpret=True))
    _same(ref.slot_write_rows_ref(tbig, tone, slot), got)
    jzero = [jnp.zeros_like(j) for j in jone]
    zeroed = ops.slot_write_rows(tbig, None, slot)
    _same(zeroed, slot_write_rows_pallas(jbig, jzero, slot, interpret=True))
    assert all(not z[:, slot].any() for z in zeroed)
    _same(tbig, before)  # the CPU path returns fresh tensors
    for g, b in zip(got, before):
        others = [r for r in range(b.shape[1]) if r != slot]
        assert torch.equal(g[:, others], b[:, others])


@pytest.mark.parametrize("slot", [0, 2])
def test_install_and_zero_slot_match_the_reference(slot):
    """The port's ``install_slot``/``zero_slot`` against the reference's with
    its fused kernel on (interpret mode), on a cache of two layer groups."""
    rng = np.random.default_rng(10 + slot)

    def caches(B):
        arrs = [rng.normal(size=(2, B, 5, 2, 3)).astype(np.float32) for _ in range(4)]
        j = {"len": jnp.zeros((), jnp.int32),
             "groups": [({"k": jnp.asarray(arrs[0]), "v": jnp.asarray(arrs[1])},),
                        ({"k": jnp.asarray(arrs[2]), "v": jnp.asarray(arrs[3])},)]}
        t = {"len": 0, "groups": [({"k": torch.tensor(arrs[0]), "v": torch.tensor(arrs[1])},),
                                  ({"k": torch.tensor(arrs[2]), "v": torch.tensor(arrs[3])},)]}
        return j, t

    (jbig, tbig), (jone, tone) = caches(3), caches(1)
    with override_flags(use_pallas_kv_moves=True, pallas_interpret=True):
        want_inst = jkv.install_slot(jbig, jone, slot)
        want_zero = jkv.zero_slot(jbig, slot)
    for want, got in ((want_inst, kv.install_slot(tbig, tone, slot)),
                      (want_zero, kv.zero_slot(tbig, slot))):
        for w, g in zip(jax.tree.leaves(want["groups"]), kv._flatten(got["groups"])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got["len"] == tbig["len"]


def test_slot_write_rows_refuses_leaves_that_break_the_contract():
    big = [torch.zeros(2, 3, 4)]
    with pytest.raises(ValueError, match="does not match"):
        ops.slot_write_rows(big, [torch.zeros(2, 2, 4)], 0)
    with pytest.raises(TypeError, match="dtype"):
        ops.slot_write_rows(big, [torch.zeros(2, 1, 4, dtype=torch.bfloat16)], 0)
    with pytest.raises(ValueError, match="non-empty"):
        ops.slot_write_rows([], [], 0)
    with pytest.raises(ValueError, match="equal"):
        ops.slot_write_rows(big, [], 0)
    with pytest.raises(ValueError, match="slot 3"):
        ops.slot_write_rows(big, None, 3)
    with pytest.raises(ValueError, match="several devices"):
        ops.slot_write_rows(big, [torch.zeros(2, 1, 4, device="meta")], 0)
