"""The dry run's cells and meta stand-ins (``repro_torch.configs`` cells,
``repro_torch.launch.specs``) against the reference's
(``repro.configs.base``, ``repro.launch.specs``).

* ``SHAPES``, ``cell_applicable`` (its reason strings too), ``ASSIGNED``
  and ``PAPER_OWN`` equal the reference's.
* Every applicable cell of every assigned architecture builds on meta at
  the mesh {"data": 1, "model": 1} and at pod1's rank, every tensor a meta
  tensor (no storage).
* A rank's cache bytes at one model rank equal the reference's
  ``cache_specs`` leaves' (bf16): qwen2.5-14b at B 8, S 64 and one
  architecture of each other family.
* A rank's weight bytes at tp 2 and 3 equal those of a real
  ``shard_params`` on the CPU, for each family's smoke config.
* The stub frontends' inputs have the reference's keys.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.configs import base as jbase
from repro.launch import specs as jspecs
from repro_torch.configs import (
    ASSIGNED,
    PAPER_OWN,
    SHAPES,
    all_arch_names,
    cell_applicable,
    get_config,
)
from repro_torch.launch import specs
from repro_torch.launch.cost import _tensors
from repro_torch.launch.mesh import production_mesh
from repro_torch.models.api import make_model
from repro_torch.parallel.group import CountingGroup
from repro_torch.parallel.shard import shard_params

ONE = {"data": 1, "model": 1}
CACHE_ARCHS = ("qwen2.5-14b", "mixtral-8x22b", "minicpm3-4b", "zamba2-2.7b", "rwkv6-7b",
               "llama-3.2-vision-90b", "musicgen-large")
SMOKE_FAMILIES = ("llama3-1b", "deepseek-moe-16b", "mixtral-8x22b", "minicpm3-4b",
                  "zamba2-2.7b", "rwkv6-7b", "llama-3.2-vision-90b")


def _jmesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def test_cells_equal_the_reference():
    assert ASSIGNED == jbase.ASSIGNED and PAPER_OWN == jbase.PAPER_OWN
    assert all_arch_names() == jbase.all_arch_names()
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    for arch in ASSIGNED:
        for name in SHAPES:
            assert cell_applicable(get_config(arch), SHAPES[name]) == \
                jbase.cell_applicable(jbase.get_config(arch), jbase.SHAPES[name]), (arch, name)


@pytest.mark.parametrize("mesh", (ONE, production_mesh(False)), ids=("one", "pod1"))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_every_applicable_cell_builds_on_meta(arch, mesh):
    for name, shape in SHAPES.items():
        if not cell_applicable(get_config(arch), shape)[0]:
            continue
        step, args, meta = specs.cell_specs(arch, name, mesh)
        tensors = _tensors(args)
        assert callable(step) and tensors
        assert all(t.is_meta for t in tensors), (arch, name)
        assert meta["rank_batch"] * meta["data_ranks"] == shape.global_batch
        if shape.kind == "train":
            assert all(p.requires_grad for p in args[0].parameters())


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_bytes_equal_the_reference(arch):
    B, S = 8, 64
    jcfg = jspecs.dryrun_config(arch, _jmesh())
    leaves = [v for v in jax.tree.leaves(jspecs.cache_specs(jcfg, _jmesh(), B, S)) if v.ndim]
    cache = _tensors(specs.cache_specs(specs.rank_model(arch, ONE), B, S))
    assert _nbytes(cache) == sum(int(np.prod(v.shape)) * v.dtype.itemsize for v in leaves)
    # leaf by leaf: the same sizes and dtypes (bf16 rows, the recurrent state in f32)
    assert sorted((t.numel(), str(t.dtype).removeprefix("torch.")) for t in cache) == \
        sorted((int(np.prod(v.shape)), str(v.dtype)) for v in leaves)


@pytest.mark.parametrize("tp", (2, 3))
@pytest.mark.parametrize("name", SMOKE_FAMILIES)
def test_rank_weight_bytes_equal_a_real_shard(name, tp):
    cfg = get_config(name, smoke=True)
    whole = make_model(cfg, "cpu").init(0)
    for rank in range(tp):
        real = shard_params(cfg, whole, CountingGroup(rank, tp, "cpu"))
        meta = make_model(cfg, "meta", CountingGroup(rank, tp)).init(0)
        assert [tuple(p.shape) for p in meta.parameters()] == \
            [tuple(p.shape) for p in real.parameters()], (name, tp, rank)
        assert _nbytes(meta.parameters()) == _nbytes(real.parameters())


@pytest.mark.parametrize("arch", ("musicgen-large", "llama-3.2-vision-90b", "qwen2.5-14b"))
@pytest.mark.parametrize("shape", ("train_4k", "prefill_32k"))
def test_stub_frontends_have_the_reference_keys(arch, shape):
    got = specs.batch_specs(specs.published_config(arch), SHAPES[shape], ONE)
    want = jspecs.batch_specs(jspecs.dryrun_config(arch, _jmesh()), jbase.SHAPES[shape],
                              _jmesh())
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape), (arch, shape, k)


def test_batch_axes_and_the_pod_meshes():
    pod1, pod2 = production_mesh(False), production_mesh(True)
    assert pod1 == {"data": 16, "model": 16} and pod2 == {"pod": 2, "data": 16, "model": 16}
    assert specs.batch_axes(pod2, 256) == ("pod", "data")
    assert specs.batch_axes(pod2, 16) == ("pod",)  # 16 rows: "data" dropped from the right
    assert specs.batch_axes(pod1, 1) == () and specs.data_ranks(pod1, 1) == 1
    assert specs.data_ranks(pod2, 128) == 32


def test_one_rank_stands_for_all():
    for arch in ASSIGNED:  # every rank of pod1 runs the same shapes
        specs.check_ranks_alike(arch, production_mesh(False))
    with pytest.raises(ValueError, match="different shapes"):  # 3 or 4 KV heads a rank
        specs.check_ranks_alike("llama3-70b", {"model": 3})
