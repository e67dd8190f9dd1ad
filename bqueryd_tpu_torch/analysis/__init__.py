"""Project-wide static analysis of the port: the gate its tests hold.

The port's copy of ``bqueryd_tpu/analysis/``, aimed at
``bqueryd_tpu_torch/`` and reading only that tree: its own config
registry (:mod:`.configreg`), the wire and span schemas of its own
``messages.py``, ``obs/trace.py`` and ``obs/slo.py``, and its own lock
declarations.  No module here imports torch, jax or anything of
``bqueryd_tpu``: it is plain ``ast`` and belongs with the control plane.
It runs three ways:

* ``python -m bqueryd_tpu_torch.analysis`` — text report, exit 1 on new
  gating findings (``--format json`` for the machine-readable record);
* from tests — ``tests/test_torch_analysis.py`` holds the shipped tree at
  zero gating findings;
* as a library — ``run_suite()`` returns the structured result
  ``chip_smoke.py`` prints before it touches the card.

Analyzer families (rule ids in each module's ``RULES``):

====================  =====================================================
config-registry       every ``BQUERYD_TPU_*`` env var the port reads in one
                      typed table (:mod:`.configreg`), synced with the
                      README's port section, no unregistered / dead /
                      import-latched reads
lock-discipline       declared guarded attributes touched only under their
                      lock (:mod:`.concurrency`); runtime lock-ORDER
                      recording with cycle detection lives in
                      :mod:`.lockorder` and is driven from tests
launch-purity         host syncs and impurity inside the kernel-launch
                      boundary of ``ops/onehot.py`` (:mod:`.purity`: the
                      port's counterpart of the reference's jit boundary),
                      cross-checked against ``obs.profile.instrument`` via
                      ``launch-uninstrumented``
wire-schema           envelope key literals in controller/worker/rpc vs the
                      schemas declared in ``messages.py`` (:mod:`.wire`)
span-schema           literal span/phase sites vs ``messages.SPAN_SCHEMA``
                      and the attribution map in ``obs.slo``
                      (:mod:`.spans`)
metric-lint /         static twins of the runtime metric lint
metric-readme         (:mod:`.metricslint`)
====================  =====================================================

Suppression model (framework-owned, :mod:`.core`): inline
``# bqtpu: allow[rule-id] <reason>`` pragmas with mandatory reasons, plus
the ``ANALYSIS_BASELINE_TORCH.json`` fingerprint baseline for
grandfathered findings — shipped empty, and stale entries are themselves
findings.
"""

from bqueryd_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    Project,
    SuiteResult,
    run_suite,
)


def default_analyzers():
    """The full suite, in report order."""
    from bqueryd_tpu_torch.analysis.concurrency import LockDisciplineAnalyzer
    from bqueryd_tpu_torch.analysis.configreg import ConfigRegistryAnalyzer
    from bqueryd_tpu_torch.analysis.metricslint import (
        MetricNameAnalyzer,
        MetricReadmeAnalyzer,
    )
    from bqueryd_tpu_torch.analysis.purity import LaunchPurityAnalyzer
    from bqueryd_tpu_torch.analysis.spans import SpanSchemaAnalyzer
    from bqueryd_tpu_torch.analysis.wire import WireSchemaAnalyzer

    return [
        ConfigRegistryAnalyzer(),
        LockDisciplineAnalyzer(),
        LaunchPurityAnalyzer(),
        WireSchemaAnalyzer(),
        SpanSchemaAnalyzer(),
        MetricNameAnalyzer(),
        MetricReadmeAnalyzer(),
    ]
