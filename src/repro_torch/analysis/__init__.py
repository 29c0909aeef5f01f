"""repro_torch.analysis — the port's own static analysis (a copy of
``repro.analysis``'s framework, with torch-aware rules).

An AST-based lint pass (pure stdlib — it imports neither torch nor jax, so
it runs without a device backend) with the rules that matter to the port:

  AXIS       axis-name literals (models/axes.py's tables, spec_for calls,
             meshes) vs. ``parallel/rules.py`` + ``launch/mesh.py``
  CLOCK      raw wall-clock reads outside the Clock abstraction
  HOTSYNC    host syncs (.item(), .cpu(), .tolist(), synchronize, ...)
             inside the hot decode round
  KERNELABI  ``kernels/build.py``'s ctypes signatures vs. the kernels'
             ``REPRO_EXPORT`` declarations

RETRACE is not ported (the port compiles and captures nothing).  Run
``python -m repro_torch.analysis src/repro_torch``.  The suppression is
``# repro_torch: disable=RULE — reason``, on the line or directly above
it; the baseline is ``analysis-baseline.json`` in this package.
"""

from repro_torch.analysis import rules as _rules  # noqa: F401 — populate REGISTRY
from repro_torch.analysis.baseline import apply_baseline, load_baseline, write_baseline
from repro_torch.analysis.cli import main
from repro_torch.analysis.core import (
    REGISTRY,
    FileContext,
    Finding,
    Rule,
    analyze_file,
    analyze_paths,
    register,
)
from repro_torch.analysis.project import ProjectContext, build_project_context
from repro_torch.analysis.report import render_json, render_text, summarize

__all__ = [
    "REGISTRY",
    "FileContext",
    "Finding",
    "ProjectContext",
    "Rule",
    "analyze_file",
    "analyze_paths",
    "apply_baseline",
    "build_project_context",
    "load_baseline",
    "main",
    "register",
    "render_json",
    "render_text",
    "summarize",
    "write_baseline",
]
