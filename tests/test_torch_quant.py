"""The port's AWQ int4 path (``repro_torch.quant`` and ``ops.int4_matmul``)
against the JAX package's (``repro.quant``, ``repro.kernels``).

Quantization must equal the reference bit for bit: the packed bytes, the
scales, the (unrounded) zero points, the unpacked nibbles and the dequantized
weight.  On the CPU ``ops.int4_matmul`` takes its plain version; it is held
against the Pallas kernel in interpret mode, the reference's oracle on the
unpacked weight, and ``x @ dequantize(q)``, fed the reference's packed
bytes through ``convert.quantized_from_numpy``.  Tolerances: float32 1e-4
(the reference's own, ``tests/test_kernels.py``), bfloat16 2e-2 (one bf16
rounding of the output).  The CUDA kernel is held against the same plain
version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro import quant as jquant
from repro.core import kv as jkv
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import quant
from repro_torch.configs import get_config
from repro_torch.convert import quantized_from_numpy
from repro_torch.core import kv
from repro_torch.kernels import ops, ref
from repro_torch.models.api import make_model

QUANT_SHAPES = [(256, 64), (256, 96), (128, 300), (384, 128), (256, 301), (4096, 1024)]
MATMUL_SHAPES = [(8, 256, 96), (32, 128, 300), (5, 384, 128), (3, 256, 301), (0, 256, 96)]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _quantized_pair(w, g, device="cpu"):
    """The reference's QuantizedLinear of ``w`` and the same bytes as the port's."""
    jq = jquant.quantize_groupwise(jnp.asarray(w), g)
    tq = quantized_from_numpy(np.asarray(jq.qweight), np.asarray(jq.scales),
                              np.asarray(jq.zeros), jq.group_size, device)
    return jq, tq


@pytest.mark.parametrize("shape", QUANT_SHAPES)
def test_quantize_groupwise_equals_the_reference_bit_for_bit(shape):
    K, N = shape
    w = (np.random.default_rng(K + N).normal(size=shape) * 0.05).astype(np.float32)
    jq = jquant.quantize_groupwise(jnp.asarray(w), 128)
    tq = quant.quantize_groupwise(torch.tensor(w), 128)
    assert tq.group_size == jq.group_size == 128
    assert tq.qweight.dtype == torch.int8 and tuple(tq.qweight.shape) == (K // 2, N)
    assert tq.scales.dtype == tq.zeros.dtype == torch.float32
    for got, want in zip(tq[:3], jq[:3]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    unpacked = quant.unpack_int4(tq.qweight)
    np.testing.assert_array_equal(unpacked.numpy(), np.asarray(jquant.unpack_int4(jq.qweight)))
    assert torch.equal(quant.pack_int4(unpacked), tq.qweight)
    np.testing.assert_array_equal(quant.dequantize(tq).numpy(), np.asarray(jquant.dequantize(jq)))
    # the zero point is a float, never rounded; some byte has its high bit set
    assert not torch.equal(tq.zeros, tq.zeros.round())
    assert bool((tq.qweight < 0).any())


def test_int4_quant_error_bounded():
    """Groupwise 4-bit: max reconstruction error <= scale/2 per element."""
    w = (np.random.default_rng(1).normal(size=(256, 64)) * 0.1).astype(np.float32)
    q = quant.quantize_groupwise(torch.tensor(w), 128)
    err = (quant.dequantize(q) - torch.tensor(w)).abs()
    smax = q.scales.repeat_interleave(128, dim=0)
    assert bool((err <= smax / 2 + 1e-6).all())


@pytest.mark.parametrize("shape", MATMUL_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_matmul_matches_reference(shape, dtype):
    T, K, N = shape
    g = 128
    rng = np.random.default_rng(T + K + N)
    x = rng.normal(size=(T, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    jq, tq = _quantized_pair(w, g)
    jx, tx = jnp.asarray(x, jnp.dtype(dtype)), torch.tensor(x).to(getattr(torch, dtype))
    launches = ops.launch_counts()
    got = ops.int4_matmul(tx, tq.qweight, tq.scales, tq.zeros, group_size=g)
    assert ops.launch_counts() == launches, "a CPU tensor never launches a kernel"
    assert got.dtype == tx.dtype and tuple(got.shape) == (T, N)
    tol = TOL[dtype]
    oracle = (tx.float() @ quant.dequantize(tq)).to(tx.dtype)
    np.testing.assert_allclose(_np32(got), _np32(oracle), atol=tol, rtol=tol)
    want_ref = jref.int4_matmul_ref(jx, jquant.unpack_int4(jq.qweight), jq.scales, jq.zeros, g)
    np.testing.assert_allclose(_np32(got), _np32(want_ref), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np32(got), _np32(jx.astype(jnp.float32) @ jquant.dequantize(jq)),
                               atol=tol, rtol=tol)
    if T:  # the reference's kernel cannot take T = 0 (its 8-row block slices past the rows)
        want = jops.int4_matmul(jx, jq.qweight, jq.scales, jq.zeros, group_size=g)
        np.testing.assert_allclose(_np32(got), _np32(want), atol=tol, rtol=tol)


def test_int4_matmul_refuses_shapes_that_break_the_contract():
    x = torch.zeros(2, 256)
    q = quant.quantize_groupwise(torch.randn(256, 8), 128)
    with pytest.raises(ValueError, match="multiple of group_size"):
        ops.int4_matmul(torch.zeros(2, 200), torch.zeros(100, 8, dtype=torch.int8),
                        torch.zeros(1, 8), torch.zeros(1, 8), group_size=128)
    with pytest.raises(ValueError, match="packs 128 values"):
        ops.int4_matmul(x, q.qweight[:64], q.scales, q.zeros, group_size=128)
    with pytest.raises(ValueError, match="must be even"):
        ops.int4_matmul(torch.zeros(2, 6), torch.zeros(3, 8, dtype=torch.int8),
                        torch.zeros(2, 8), torch.zeros(2, 8), group_size=3)
    with pytest.raises(ValueError, match=r"scales\(4, 8\)"):
        ops.int4_matmul(x, q.qweight, q.scales.repeat(2, 1), q.zeros, group_size=128)
    with pytest.raises(TypeError, match="int8 packed"):
        ops.int4_matmul(x, q.qweight.float(), q.scales, q.zeros, group_size=128)
    with pytest.raises(ValueError, match="must be even and a multiple"):
        quant.quantize_groupwise(torch.zeros(200, 8), 128)


def test_int4_matmul_refuses_mixed_and_foreign_devices():
    q = quant.quantize_groupwise(torch.randn(256, 8), 128)
    with pytest.raises(ValueError, match="several devices"):
        ops.int4_matmul(torch.zeros(2, 256, device="meta"), q.qweight, q.scales, q.zeros)
    meta = [t.to("meta") for t in q[:3]]
    with pytest.raises(ValueError, match="unsupported device"):
        ops.int4_matmul(torch.zeros(2, 256, device="meta"), *meta)


def test_int4_matmul_takes_scales_of_another_float_dtype_as_f32():
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(4, 256)).astype(np.float32))
    q = quant.quantize_groupwise(torch.tensor(rng.normal(size=(256, 40)).astype(np.float32)), 128)
    s16, z16 = q.scales.to(torch.bfloat16), q.zeros.to(torch.bfloat16)
    got = ops.int4_matmul(x, q.qweight, s16, z16, group_size=128)
    assert torch.equal(got, ops.int4_matmul(x, q.qweight, s16.float(), z16.float(),
                                            group_size=128))
    want = jops.int4_matmul(jnp.asarray(x.numpy()), jnp.asarray(q.qweight.numpy()),
                            jnp.asarray(s16.float().numpy()).astype(jnp.bfloat16),
                            jnp.asarray(z16.float().numpy()).astype(jnp.bfloat16),
                            group_size=128)
    np.testing.assert_allclose(got.numpy(), _np32(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("K, N, g, want", [
    (4096, 14336, 128, (1024, 4)), (4096, 1024, 128, (128, 32)), (14336, 4096, 128, (896, 16)),
    (4096, 4096, 128, (256, 16)), (2048, 8192, 128, (256, 8)), (256, 96, 128, (128, 2)),
    (128, 300, 128, (128, 1)), (6144, 301, 64, (64, 96)), (4096, 128256, 128, (1024, 4))])
def test_int4_splits_cover_K_in_whole_groups(K, N, g, want):
    """int4_matmul's split (``ops.stream_plan`` with the group as the
    quantum) depends on K, N and the group size only: whole groups covering
    K, the column tiles times the splits within the blocks the plan aims at
    or one group per split, and no more than ``_STREAM_MAX_K`` per split
    (x in shared memory) unless one group is longer."""
    per, splits = ops.stream_plan(K, N, ops._STREAM_TILE_N, g)
    assert (per, splits) == want
    assert per % g == 0 and splits == -(-K // per) and (splits - 1) * per < K
    tiles = -(-N // ops._STREAM_TILE_N)
    assert tiles * splits <= max(ops._STREAM_BLOCKS, tiles) or per == g or \
        per == ops._STREAM_MAX_K // g * g
    assert per <= max(ops._STREAM_MAX_K, g)


def _int4_kernel_arithmetic(x, q, g, phases):
    """The CUDA kernel's factored arithmetic, written out in torch: per split
    of ``ops.stream_plan`` and per group, d = sum x*q (bf16 products are
    exact in f32) and X = sum x over the K values of each phase (f32: the
    warps that share columns read packed rows p = phase mod ``phases``;
    bf16: the MMA sums the whole group), acc += s * (d - z * X) per phase,
    the phases added in order, the splits added in split order."""
    T, K = x.shape
    N = q.qweight.shape[1]
    qv = quant.unpack_int4(q.qweight).float()
    xf = x.float()
    k_split, splits = ops.stream_plan(K, N, ops._STREAM_TILE_N, g)
    out = torch.zeros(T, N)
    for sp in range(splits):
        block = torch.zeros(T, N)
        for ph in range(phases):
            acc = torch.zeros(T, N)
            for gi in range(sp * k_split // g, min(K, (sp + 1) * k_split) // g):
                rows = torch.arange(gi * g // 2, (gi + 1) * g // 2)
                rows = rows[rows % phases == ph]
                ks = torch.stack([2 * rows, 2 * rows + 1], 1).reshape(-1)
                d = xf[:, ks] @ qv[ks]
                X = xf[:, ks].sum(1, keepdim=True)
                acc = acc + q.scales[gi] * (d - q.zeros[gi] * X)
            block = block + acc
        out = out + block
    return out.to(x.dtype)


@pytest.mark.parametrize("shape", [s for s in MATMUL_SHAPES if s[0]] + [(2, 2048, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_kernel_arithmetic_matches_reference(shape, dtype):
    """The factored form s * (d - z * X) that the kernel computes, instead
    of the reference's dequantized (q - z) * s per weight, stays within the
    int4 tolerances of the plain version and of the JAX package's oracle on
    the unpacked weight, split sums included."""
    T, K, N = shape
    g = 128
    rng = np.random.default_rng(T * K + N)
    x = rng.normal(size=(T, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    jq, tq = _quantized_pair(w, g)
    jx, tx = jnp.asarray(x, jnp.dtype(dtype)), torch.tensor(x).to(getattr(torch, dtype))
    got = _int4_kernel_arithmetic(tx, tq, g, 4 if dtype == "float32" else 1)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np32(got), _np32(ref.int4_matmul_ref(tx, *tq[:3], g)),
                               atol=tol, rtol=tol)
    want = jref.int4_matmul_ref(jx, jquant.unpack_int4(jq.qweight), jq.scales, jq.zeros, g)
    np.testing.assert_allclose(_np32(got), _np32(want), atol=tol, rtol=tol)


def test_quantized_from_numpy_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the conversion rightly runs on it")
    w = np.random.default_rng(5).normal(size=(128, 8)).astype(np.float32)
    jq = jquant.quantize_groupwise(jnp.asarray(w), 128)
    args = (np.asarray(jq.qweight), np.asarray(jq.scales), np.asarray(jq.zeros), 128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quantized_from_numpy(*args, None)
    tq = quantized_from_numpy(*args, "cpu")
    assert tq.qweight.device.type == "cpu" and tq.qweight.dtype == torch.int8


def test_awq_path_on_a_layer_matches_reference():
    """The slice as a whole, at a small size: every weight of layer 0 of the
    llama3-8b smoke config, as the forward multiplies by it ([K, N]),
    quantized by both packages (group 32) and multiplied at a decode step,
    an 8-row verify and a 16-row prompt, f32 and bf16."""
    cfg = get_config("llama3-8b", smoke=True)
    layer = make_model(cfg, "cpu").init(0).layers[0]
    d = cfg.d_model
    mats = {k: layer.attn[k].reshape(d, -1) for k in ("wq", "wk", "wv")}
    mats["wo"] = layer.attn["wo"].reshape(-1, d)
    mats.update({k: layer.mlp[k] for k in ("wg", "wu", "wd")})
    rng = np.random.default_rng(6)
    g = 32
    for name, w in mats.items():
        w = w.numpy()
        jq = jquant.quantize_groupwise(jnp.asarray(w), g)
        tq = quant.quantize_groupwise(torch.tensor(w), g)
        for got, want in zip(tq[:3], jq[:3]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for M in (1, 8, 16):
            x = rng.normal(size=(M, w.shape[0])).astype(np.float32)
            for dtype in ("float32", "bfloat16"):
                jx = jnp.asarray(x, jnp.dtype(dtype))
                tx = torch.tensor(x).to(getattr(torch, dtype))
                got = ops.int4_matmul(tx, *tq[:3], group_size=g)
                want = jops.int4_matmul(jx, jq.qweight, jq.scales, jq.zeros, group_size=g)
                np.testing.assert_allclose(_np32(got), _np32(want), atol=TOL[dtype],
                                           rtol=TOL[dtype], err_msg=f"{name} M={M} {dtype}")
                np.testing.assert_array_equal(
                    _np32(got), _np32(ref.int4_matmul_ref(tx, *tq[:3], g)))


def test_install_slot_casts_a_donor_of_another_dtype(monkeypatch):
    """A bf16 donor into an f32 cache: the reference casts the donor row
    (``kv.py``'s per-leaf fallback); the port casts it too, and still writes
    every leaf in one ``slot_write_rows`` call."""
    rng = np.random.default_rng(7)
    big = [rng.normal(size=(2, 3, 5, 2, 4)).astype(np.float32) for _ in range(2)]
    one = [rng.normal(size=(2, 1, 5, 2, 4)).astype(np.float32) for _ in range(2)]
    jbig = {"len": jnp.zeros((), jnp.int32),
            "groups": [({"k": jnp.asarray(big[0]), "v": jnp.asarray(big[1])},)]}
    jone = {"len": jnp.zeros((), jnp.int32),
            "groups": [({"k": jnp.asarray(one[0], jnp.bfloat16),
                         "v": jnp.asarray(one[1], jnp.bfloat16)},)]}
    tbig = {"len": 0, "groups": [({"k": torch.tensor(big[0]), "v": torch.tensor(big[1])},)]}
    tone = {"len": 0, "groups": [({"k": torch.tensor(one[0]).to(torch.bfloat16),
                                   "v": torch.tensor(one[1]).to(torch.bfloat16)},)]}
    calls = []
    write = ops.slot_write_rows
    monkeypatch.setattr(ops, "slot_write_rows", lambda *a: calls.append(a) or write(*a))
    got = kv.install_slot(tbig, tone, 1)
    want = jkv.install_slot(jbig, jone, 1)
    assert len(calls) == 1
    for w, g in zip(jax.tree.leaves(want["groups"]), kv._flatten(got["groups"])):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
