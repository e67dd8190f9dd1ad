"""CLI: ``python -m bqueryd_tpu_torch.analysis [--format text|json] [...]``.

Exit codes: 0 = clean (suppressed/baselined findings don't gate), 1 = new
gating findings, 2 = usage/internal error.  The JSON format is the
machine-readable record (schema ``bqueryd_tpu_torch.analysis/1``, see
:meth:`bqueryd_tpu_torch.analysis.core.SuiteResult.to_dict`).
"""

import argparse
import json
import sys


def main(argv=None):
    from bqueryd_tpu_torch.analysis import default_analyzers, run_suite

    parser = argparse.ArgumentParser(
        prog="python -m bqueryd_tpu_torch.analysis",
        description="static analysis suite of the PyTorch/CUDA port",
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="report format (json is the machine-readable record)",
    )
    parser.add_argument(
        "--root", default=None,
        help="project root (default: the checkout containing this package)",
    )
    parser.add_argument(
        "--baseline", default=None,
        help="baseline file (default: <root>/ANALYSIS_BASELINE_TORCH.json)",
    )
    parser.add_argument(
        "--analyzer", action="append", default=None, metavar="NAME",
        help="run only the named analyzer(s); repeatable",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print every rule id with its description and exit",
    )
    args = parser.parse_args(argv)

    analyzers = default_analyzers()
    if args.list_rules:
        from bqueryd_tpu_torch.analysis.core import known_rules

        for rule, description in sorted(known_rules(analyzers).items()):
            print(f"{rule}: {description}")
        return 0

    if args.analyzer:
        wanted = set(args.analyzer)
        analyzers = [a for a in analyzers if a.name in wanted]
        missing = wanted - {a.name for a in analyzers}
        if missing:
            print(
                f"unknown analyzer(s): {', '.join(sorted(missing))}",
                file=sys.stderr,
            )
            return 2

    try:
        result = run_suite(
            root=args.root, analyzers=analyzers,
            baseline_path=args.baseline,
        )
    except Exception as exc:  # a broken suite must fail loudly, not pass
        print(f"analysis suite error: {exc}", file=sys.stderr)
        return 2

    if args.format == "json":
        print(json.dumps(result.to_dict(), indent=1, sort_keys=True))
    else:
        print(result.render_text())
    return 1 if result.gating else 0


if __name__ == "__main__":
    sys.exit(main())
