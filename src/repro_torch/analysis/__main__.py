"""``python -m repro_torch.analysis`` -- the port's static-analysis CLI.

Subcommands::

    lint     AST lint (RL001-RL005) over src/repro_torch, diffed against
             the committed src/repro_torch/analysis/baseline.json
    graph    graph contracts (GC001-GC004) for committed scenarios
    modules  unreachable-module report (the dead-weight detector)

It writes the reference CLI's JSON report (``repro.analysis_report/v1``)
and takes its exit codes: 0 clean (or everything grandfathered), 5 on new
findings.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys

EXIT_FINDINGS = 5

#: the port's baseline, beside this module
DEFAULT_BASELINE = os.path.join("src", "repro_torch", "analysis",
                                "baseline.json")


def _report_and_exit(findings, baseline_path, json_out, tool, extra=None):
    from repro_torch.analysis.report import (diff_findings, load_baseline,
                                             make_report, write_report)
    baseline = []
    if baseline_path and os.path.exists(baseline_path):
        baseline = load_baseline(baseline_path)
    diff = diff_findings(findings, baseline, datetime.date.today())
    doc = make_report(findings, diff, tool=tool, extra=extra)
    if json_out:
        write_report(doc, json_out)
    for f in diff.grandfathered:
        print(f"grandfathered: {f.format()}")
    for f in diff.expired:
        print(f"EXPIRED baseline, finding active again: {f.format()}")
    for f in diff.new:
        print(f"NEW: {f.format()}")
    for e in diff.stale:
        print(f"stale baseline entry (matched nothing): {e.rule} "
              f"{e.path} [{e.symbol}]")
    s = doc["summary"]
    print(f"{tool}: {s['total']} finding(s) -- {s.get('new', 0)} new, "
          f"{s.get('grandfathered', 0)} grandfathered, "
          f"{s.get('expired', 0)} expired, "
          f"{s.get('stale_baseline', 0)} stale baseline entr(ies)")
    return 0 if diff.ok else EXIT_FINDINGS


def cmd_lint(args) -> int:
    from repro_torch.analysis.lint import LintConfig, lint_paths
    from repro_torch.analysis.report import baseline_from_findings
    findings = lint_paths(args.paths, LintConfig(), repo_root=args.root)
    if args.write_baseline:
        doc = baseline_from_findings(findings, reason=args.reason)
        with open(args.baseline, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        print(f"wrote {len(doc['entries'])} baseline entr(ies) to "
              f"{args.baseline}")
        return 0
    return _report_and_exit(findings, args.baseline, args.json,
                            tool="repro_torch.analysis.lint")


def cmd_graph(args) -> int:
    from repro_torch.analysis.graph_contract import check_scenarios
    kw = dict(n_steps=args.n_steps, max_casts=args.max_casts,
              device=args.device)
    findings = check_scenarios(args.scenarios or None, **kw)
    if args.kernels:
        # a second pass with the kernel mode forced (``fused``: the
        # one-kernel step, whatever the scenario's own policy)
        findings.extend(check_scenarios(args.scenarios or None,
                                        kernels=args.kernels, **kw))
    # the contracts are hard invariants: no baseline, every finding fails
    return _report_and_exit(findings, None, args.json,
                            tool="repro_torch.analysis.graph")


def cmd_modules(args) -> int:
    from repro_torch.analysis.lint import index_paths, unreachable_modules
    modules = index_paths([args.src] + list(args.entry_scripts),
                          repo_root=args.root)
    entries = list(args.entry)
    dead = unreachable_modules(modules, entries)
    doc = {"schema": "repro.analysis_report/v1",
           "tool": "repro_torch.analysis.modules",
           "entry_modules": entries,
           "unreachable": dead,
           "summary": {"total": len(dead)}}
    if args.json:
        from repro_torch.analysis.report import write_report
        write_report(doc, args.json)
    for m in dead:
        print(f"unreachable: {m}")
    print(f"repro_torch.analysis.modules: {len(dead)} module(s) unreachable "
          f"from {len(entries)} entry point(s) + entry scripts")
    return 0        # informational: excision happens in review


DEFAULT_ENTRIES = (
    "repro_torch.api.__main__", "repro_torch.serve.__main__",
    "repro_torch.analysis.__main__", "repro_torch.api",
    "repro_torch.perf.step_analysis",
    "repro_torch.launch.dryrun",    # python -m entry, not reached by imports
)


def main(argv=None) -> int:
    from repro_torch.analysis.graph_contract import DEFAULT_MAX_CASTS
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis and graph contracts of the "
                    "PyTorch/CUDA port")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("lint", help="AST lint rules RL001-RL005")
    p.add_argument("--paths", nargs="*", default=["src/repro_torch"],
                   help="files/directories to lint")
    p.add_argument("--root", default=".", help="repo root for rel paths")
    p.add_argument("--baseline", default=DEFAULT_BASELINE)
    p.add_argument("--json", default=None, metavar="OUT",
                   help="write repro.analysis_report/v1 JSON here")
    p.add_argument("--write-baseline", action="store_true",
                   help="(re)write the baseline from current findings")
    p.add_argument("--reason", default="grandfathered at introduction")
    p.set_defaults(fn=cmd_lint)

    p = sub.add_parser("graph", help="graph contracts for scenarios")
    p.add_argument("scenarios", nargs="*",
                   help="scenario JSONs (default examples/scenarios/*)")
    p.add_argument("--n-steps", type=int, default=16)
    p.add_argument("--max-casts", type=int, default=DEFAULT_MAX_CASTS)
    p.add_argument("--kernels", default=None, choices=("fused", "split"),
                   help="also check each scenario with this kernel mode "
                        "forced (fused: the one-kernel step's census)")
    p.add_argument("--device", default=None,
                   help="the device the sessions run on (the card when "
                        "absent; cpu for the plain versions)")
    p.add_argument("--json", default=None, metavar="OUT")
    p.set_defaults(fn=cmd_graph)

    p = sub.add_parser("modules", help="unreachable-module report")
    p.add_argument("--src", default="src/repro_torch")
    p.add_argument("--root", default=".")
    p.add_argument("--entry", nargs="*", default=list(DEFAULT_ENTRIES))
    p.add_argument("--entry-scripts", nargs="*",
                   default=["examples", "tools", "tests", "chip_smoke.py"],
                   help="scripts and directories whose imports count as "
                        "roots")
    p.add_argument("--json", default=None, metavar="OUT")
    p.set_defaults(fn=cmd_modules)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
