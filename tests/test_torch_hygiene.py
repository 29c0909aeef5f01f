"""What the port may import and where it runs.

``repro_torch`` and ``chip_smoke.py`` import neither JAX nor anything of the
JAX package ``repro``; the port's entry points run on CUDA unless the
caller asks for the CPU, and without a CUDA device they raise instead of
falling back; ``chip_smoke.py`` fails without a card and outside a checkout.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
    sorted((ROOT / "tools").glob("*.py"))
OK_LINE = '{"ok": true'


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


def test_the_walk_covers_the_tools_and_the_port_linter():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"tools/split_nccl.py", "tools/fleet_nccl.py", "tools/train_nccl.py",
            "src/repro_torch/analysis/core.py",
            "src/repro_torch/analysis/rules/hotsync.py"} <= names


def test_importing_every_port_module_loads_no_jax():
    mods = sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(
        ".__init__") for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    assert len(mods) > 20 and out.strip() == "[]"


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points rightly run on it")


def test_entry_points_without_device_raise_on_a_machine_without_cuda():
    _no_cuda()
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.serve import build_engine
    from repro_torch.models.api import make_model

    cfg = get_config("llama3-8b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine("llama3-8b", "llama3-1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(cfg, {"groups": [({},)]}, None)
    with pytest.raises(ValueError):
        make_model(cfg, "mps")
    assert make_model(cfg, "meta").device == torch.device("meta")  # asked for by name only
    assert make_model(cfg, "cpu").device == torch.device("cpu")


def test_serve_cli_defaults_to_cuda():
    _no_cuda()
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "1"])


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=""))


def test_chip_smoke_fails_without_a_card():
    _no_cuda()
    res = _run_smoke(ROOT)
    assert res.returncode != 0 and OK_LINE not in res.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    res = _run_smoke(tmp_path)
    assert res.returncode != 0 and OK_LINE not in res.stdout


def test_weights_are_drawn_on_the_requested_device():
    from repro_torch.configs import get_config
    from repro_torch.models.api import make_model

    model = make_model(get_config("llama3-1b", smoke=True), "cpu")
    a, b = model.init(3), model.init(3)
    assert all(p.device.type == "cpu" for p in a.parameters())
    assert torch.equal(a.lm_head, b.lm_head) and not torch.equal(a.lm_head, model.init(4).lm_head)
    std = float(a.layers[0].mlp["wg"].std())
    assert np.isclose(std, model.cfg.d_model ** -0.5, rtol=0.1)
