"""The port's own linter, ``python -m repro_torch.analysis`` (a copy of
``repro.analysis``'s framework with torch-aware rules).

* ``src/repro_torch`` is clean modulo the port's baseline, which is empty
  (the reference's linter on ``src``: ``tests/test_analysis.py``).
* Each rule — AXIS, CLOCK, HOTSYNC, KERNELABI — trips on a bad snippet (and
  only that rule) and stays silent on a good one; the snippets are written
  here, to ``tmp_path``.
* Suppressions (``# repro_torch: disable=RULE``) work on the line and on
  the line above, an unused one is a finding, the reference's marker is
  not the port's; the baseline round-trips and goes stale; the CLI exits
  0, 1 and 2.
* The port's CLOCK gives the reference's findings line for line on
  ``tests/fixtures/analysis/clock_{bad,good}.py``.
* KERNELABI catches a ``SIGNATURES`` entry one argument short of its
  ``REPRO_EXPORT`` declaration.
* The designated per-round syncs carry the port's suppression; without it
  HOTSYNC reports them.
"""

import json
import os
import re
import shutil
import textwrap

import pytest

from repro.analysis import analyze_file as janalyze_file
from repro.analysis.project import ProjectContext as JProjectContext
from repro_torch.analysis import REGISTRY, analyze_file, build_project_context, main
from repro_torch.analysis.baseline import apply_baseline, load_baseline, write_baseline
from repro_torch.analysis.cli import DEFAULT_BASELINE, PACKAGE
from repro_torch.analysis.project import ProjectContext

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PORT = os.path.join(ROOT, "src", "repro_torch")
FIXTURES = os.path.join(HERE, "fixtures", "analysis")

BAD = {
    "CLOCK": """
        import time
        from time import perf_counter as pc

        def stamp():
            return time.time() + pc()
        """,
    "HOTSYNC": """
        import numpy as np
        import torch

        class SpecEngine:
            def step(self, x, ev, parts):
                n = x.sum().item()
                rows = x.cpu()
                torch.cuda.synchronize()
                ev.synchronize()
                k = int(x.argmax())
                first = x.argmax(-1).to(torch.int32)
                j = int(first[0])  # a name the method holds a tensor in
                if torch.any(x > 0):
                    pass
                m = max(first)  # iterates the tensor on the host
                a = np.asarray(torch.stack(parts))
                return n, rows, k, j, m, a
        """,
    "AXIS": """
        from repro_torch.parallel.rules import spec_for
        from repro_torch.parallel.group import CountingGroup

        def split(mesh, shape):
            g = CountingGroup(0, 2, axis="dta")
            return spec_for({"modle": 2}, ("embed", "ffn"), shape), mesh["mdl"], g
        """,
}
GOOD = {
    "CLOCK": """
        import time

        def nap(clock, s):
            time.sleep(s)
            return clock()
        """,
    "HOTSYNC": """
        import numpy as np
        import torch

        class SpecEngine:
            def step(self, x, host):
                if torch.is_grad_enabled():
                    x = x + 1
                n = int(host[0]) + int(len(host))  # host values: no transfer
                m = max(host) + np.asarray(host).size
                shape = tuple(x.shape) + (int(x.size(0)),)  # metadata: held on the host
                return x.argmax(-1), n, m, shape

        def report(x):  # outside the round: free to read the card
            return x.cpu().tolist()
        """,
    "AXIS": """
        from repro_torch.parallel.rules import spec_for

        def split(mesh, shape):
            return spec_for({"model": 2}, ("embed", "ff"), shape), mesh.get("data", 1)
        """,
}
BAD_COUNT = {"CLOCK": 2, "HOTSYNC": 9, "AXIS": 4}


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(text).lstrip())
    return p


def _scan(path, root, project=None):
    return analyze_file(str(path), str(root), project or build_project_context([PORT]))


def test_the_port_is_clean_modulo_its_empty_baseline(capsys):
    assert os.path.dirname(DEFAULT_BASELINE) == os.path.join(PORT, "analysis")
    assert load_baseline(DEFAULT_BASELINE) == {}
    assert PACKAGE == PORT
    assert main([]) == 0  # the default path: the port's package
    out = capsys.readouterr().out
    assert "-> clean" in out and "0 baselined" in out


def test_registry_has_the_four_rules():
    assert set(REGISTRY) == {"AXIS", "CLOCK", "HOTSYNC", "KERNELABI"}  # RETRACE: not ported


@pytest.mark.parametrize("rule", sorted(BAD))
def test_bad_snippet_trips_exactly_its_rule(tmp_path, rule):
    findings = _scan(_write(tmp_path, f"{rule.lower()}_bad.py", BAD[rule]), tmp_path)
    assert [f.rule for f in findings] == [rule] * BAD_COUNT[rule], findings


@pytest.mark.parametrize("rule", sorted(GOOD))
def test_good_snippet_is_clean(tmp_path, rule):
    assert _scan(_write(tmp_path, f"{rule.lower()}_good.py", GOOD[rule]), tmp_path) == []


def test_axis_checks_the_weight_axis_tables(tmp_path):
    table = 'WEIGHTS = {"wq": ("embed", "heds", "head_dim"), "wo": ("heads", None, "embed")}\n'
    findings = _scan(_write(tmp_path, "models/axes.py", table), tmp_path)
    assert [f.rule for f in findings] == ["AXIS"] and "did you mean 'heads'" in findings[0].message
    assert _scan(_write(tmp_path, "models/other.py", table), tmp_path) == []  # only axes.py


def test_project_context_reads_the_port(tmp_path):
    ctx = build_project_context([PORT])
    assert ctx.rules_file.endswith(os.path.join("parallel", "rules.py"))
    assert ctx.mesh_file.endswith(os.path.join("launch", "mesh.py"))
    assert {"pod", "data", "model"} <= ctx.mesh_axes
    assert {"embed", "heads", "ff", "experts_ep", "kv_seq"} <= ctx.logical_axes


def _kernel_tree(tmp_path, drop_arg: bool):
    """A copy of kernels/build.py and csrc/ (one argument dropped from
    tree_attention_launch's SIGNATURES entry when ``drop_arg``)."""
    src = os.path.join(PORT, "kernels")
    dst = tmp_path / "kernels"
    shutil.copytree(os.path.join(src, "csrc"), dst / "csrc")
    text = open(os.path.join(src, "build.py"), encoding="utf-8").read()
    if drop_arg:
        old = '"tree_attention_launch": [_P] * 8 + [_I] * 9 + [_F, _I, _P],'
        assert old in text
        text = text.replace(old, '"tree_attention_launch": [_P] * 8 + [_I] * 8 + [_F, _I, _P],')
    (dst / "build.py").write_text(text)
    return dst / "build.py"


def test_kernelabi_matches_the_real_table_and_catches_a_missing_argument(tmp_path):
    assert _scan(os.path.join(PORT, "kernels", "build.py"), PORT) == []
    findings = _scan(_kernel_tree(tmp_path, drop_arg=True), tmp_path)
    assert [f.rule for f in findings] == ["KERNELABI"]
    assert "tree_attention_launch" in findings[0].message
    assert "gives 19 argument(s)" in findings[0].message and "declares 20" in findings[0].message


def test_kernelabi_catches_a_wrong_type_and_a_missing_export(tmp_path):
    path = _kernel_tree(tmp_path, drop_arg=False)
    text = path.read_text()
    text = text.replace('"fused_swiglu_launch": [_P] * 6 + [_I] * 7 + [_P]',
                        '"fused_swiglu_launch": [_P] * 5 + [_I] * 8 + [_P]')
    text = text.replace('"slot_write_rows_max_leaves": [],', '"slot_write_rows_maxleaves": [],')
    path.write_text(text)
    msgs = [f.message for f in _scan(path, tmp_path)]
    assert any("fused_swiglu_launch` argument 5: SIGNATURES gives c_int" in m for m in msgs)
    assert any("slot_write_rows_maxleaves` has no REPRO_EXPORT" in m for m in msgs)


def test_suppression_in_both_placements_and_an_unused_one(tmp_path):
    text = """
        import time

        T0 = time.time()  # repro_torch: disable=CLOCK — same-line form

        # repro_torch: disable=CLOCK — standalone line directly above
        T1 = time.time()
        """
    assert _scan(_write(tmp_path, "s.py", text), tmp_path) == []
    unused = "X = 1  # repro_torch: disable=CLOCK — nothing to silence\n"
    assert [f.rule for f in _scan(_write(tmp_path, "u.py", unused), tmp_path)] == \
        ["UNUSED-SUPPRESS"]


def test_each_linter_reads_only_its_own_marker(tmp_path):
    ref_marked = "import time\nT = time.time()  # repro: disable=CLOCK — the reference's\n"
    port_marked = "import time\nT = time.time()  # repro_torch: disable=CLOCK — the port's\n"
    assert [f.rule for f in _scan(_write(tmp_path, "a.py", ref_marked), tmp_path)] == ["CLOCK"]
    assert _scan(_write(tmp_path, "b.py", port_marked), tmp_path) == []
    jfound = janalyze_file(str(tmp_path / "b.py"), str(tmp_path), JProjectContext())
    assert [f.rule for f in jfound] == ["CLOCK"]


def test_clock_gives_the_references_findings_on_its_fixtures():
    for name in ("clock_bad.py", "clock_good.py"):
        path = os.path.join(FIXTURES, name)
        mine = analyze_file(path, FIXTURES, ProjectContext(), [REGISTRY["CLOCK"]])
        from repro.analysis.core import REGISTRY as JREGISTRY

        theirs = janalyze_file(path, FIXTURES, JProjectContext(), [JREGISTRY["CLOCK"]])
        assert [(f.line, f.col, f.snippet) for f in mine] == \
            [(f.line, f.col, f.snippet) for f in theirs]
        assert [f.message.replace("repro_torch.", "repro.") for f in mine] == \
            [f.message for f in theirs]
    assert len(mine) == 0 and len(theirs) == 0  # clock_good.py


def test_baseline_round_trip_and_stale_entries(tmp_path):
    findings = _scan(_write(tmp_path, "c.py", BAD["CLOCK"]), tmp_path)
    path = str(tmp_path / "bl.json")
    assert write_baseline(path, findings, "fixture") == len(findings) == 2
    flagged, stale = apply_baseline(findings, load_baseline(path))
    assert stale == [] and all(f.baselined for f in flagged)
    baseline = load_baseline(path)
    victim = findings[0].fingerprint
    del baseline[victim]
    baseline["deadbeefdeadbeef#0"] = "gone"
    flagged, stale = apply_baseline(findings, baseline)
    assert [f.fingerprint for f in flagged if not f.baselined] == [victim]
    assert stale == ["deadbeefdeadbeef#0"]


def test_cli_exit_codes(tmp_path, capsys):
    good = _write(tmp_path, "g/clock_good.py", GOOD["CLOCK"])
    bad = _write(tmp_path, "b/clock_bad.py", BAD["CLOCK"])
    assert main([str(good), "--no-baseline"]) == 0
    assert main([str(bad), "--no-baseline"]) == 1
    assert main([str(tmp_path / "nothing-here"), "--no-baseline"]) == 2
    assert main([str(bad), "--rules", "NOSUCHRULE"]) == 2
    bl = tmp_path / "bl.json"
    assert main([str(bad.parent), "--write-baseline", str(bl), "--reason", "test"]) == 0
    assert main([str(bad.parent), "--baseline", str(bl)]) == 0
    report = tmp_path / "r.json"
    assert main([str(bad), "--no-baseline", "--format", "json", "--output", str(report)]) == 1
    assert json.loads(report.read_text())["summary"]["by_rule"] == {"CLOCK": 2}
    capsys.readouterr()


@pytest.mark.parametrize("path", ("core/engine.py", "core/chain_engine.py"))
def test_removing_a_designated_sync_suppression_resurfaces_it(tmp_path, path):
    project = build_project_context([PORT])
    full = os.path.join(PORT, path)
    text = open(full, encoding="utf-8").read()
    assert "# repro_torch: disable=HOTSYNC" in text
    assert not [f for f in analyze_file(full, PORT, project) if f.rule == "HOTSYNC"]
    kept = analyze_file(full, PORT, project, with_suppressed=True)
    assert [f for f in kept if f.rule == "HOTSYNC" and f.suppressed]
    stripped = re.sub(r"\s*# repro_torch: disable=HOTSYNC[^\n]*", "", text)
    p = tmp_path / os.path.basename(path)
    p.write_text(stripped)
    assert [f for f in analyze_file(str(p), str(tmp_path), project) if f.rule == "HOTSYNC"]
