"""Command-line front end of the port's analyzer: ``python -m
difacto_tpu_torch.analysis`` (the flags and output formats of
difacto_tpu/analysis/cli.py).

Defaults are the port's layout: lint ``difacto_tpu_torch/`` and
``chip_smoke.py`` against the baseline at ``.lint-baseline-torch.json``
(when present). ``tests/``, the README's port section and the port's
docstrings are *reference corpora* for the cross-file registry rules,
not lint targets.

Exit codes: 0 clean, 1 findings, 2 usage/internal error (core.py).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from . import core

DEFAULT_PATHS = ["difacto_tpu_torch", "chip_smoke.py"]
DEFAULT_BASELINE = ".lint-baseline-torch.json"
PORT = "difacto_tpu_torch"
LOCKORDER = f"{PORT}/utils/lockorder.json"


def lock_graph(root) -> dict:
    """The static lock-order graph and race facts over the port, in the
    shape of ``utils/lockorder.json``: creation site -> lock id, the
    edges between lock ids, the cycles, the suppressed fields, and which
    of the fields the port traces (``shared.attr()``) are known-safe."""
    from .concurrency import get_model
    from .races import get_race_model
    root = Path(root).resolve()
    project = core.Project(root, [PORT])
    model = get_model(project)
    races = get_race_model(project)
    safe = races.known_safe()

    def shared_attr(fid: str) -> bool:
        path, qual = fid.split("::", 1)
        if "." not in qual:
            return False
        cls, name = qual.rsplit(".", 1)
        src = (root / path).read_text(encoding="utf-8")
        return f"    {name} = shared.attr()" in src \
            and f"class {cls}" in src

    fields = sorted(f for f in races.fields if shared_attr(f))
    return {
        "version": 1,
        "sites": {f"{li.path}:{li.line}": lid
                  for lid, li in sorted(model.locks.items())},
        "edges": sorted([a, b] for a, b in model.edges),
        "cycles": [list(c) for c in model.cycles],
        "race_suppressed": sorted(races.suppressed_fields),
        "race_traced_known_safe": [f for f in fields if f in safe],
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="difacto-lint",
        description="AST-based analyzer of the PyTorch port")
    p.add_argument("paths", nargs="*", default=None,
                   help=f"files/dirs to lint (default: {DEFAULT_PATHS})")
    p.add_argument("--root", default=".",
                   help="project root (README.md, tests/, baseline live here)")
    p.add_argument("--format",
                   choices=("text", "json", "github", "sarif"),
                   default="text", dest="fmt")
    p.add_argument("--baseline", default=None,
                   help=f"baseline file (default: <root>/{DEFAULT_BASELINE} "
                        f"when it exists; 'none' disables)")
    p.add_argument("--write-baseline", action="store_true",
                   help="grandfather all current findings into the "
                        "baseline and exit 0")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--no-cross", action="store_true",
                   help="skip cross-file registry rules (partial runs)")
    p.add_argument("--changed-only", action="store_true",
                   help="incremental mode: run LOCAL rules only on files "
                        "changed vs the merge-base (cross-file and "
                        "concurrency rules still see the whole tree)")
    p.add_argument("--base", default=None,
                   help="merge-base ref for --changed-only (default: "
                        "origin/main, then main)")
    p.add_argument("--write-lockorder", action="store_true",
                   help=f"write the static lock graph the card machine "
                        f"reads to <root>/{LOCKORDER} and exit")
    p.add_argument("--list-rules", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="text format: also print suppressed/baselined")
    return p


def changed_files(root, base=None):
    """Repo-relative ``.py`` paths changed vs the merge-base with
    ``base`` (default: origin/main, then main), plus worktree/index
    edits and untracked files — the --changed-only lint set. Returns
    None when git is unusable (callers fall back to a full run)."""
    import subprocess

    def git(*args):
        return subprocess.run(["git", "-C", str(root), *args],
                              capture_output=True, text=True, timeout=30)

    try:
        if git("rev-parse", "--git-dir").returncode != 0:
            return None
        names = set()
        merge_base = None
        for ref in ([base] if base else ["origin/main", "main"]):
            r = git("merge-base", "HEAD", ref)
            if r.returncode == 0:
                merge_base = r.stdout.strip()
                break
        if merge_base:
            r = git("diff", "--name-only", merge_base, "HEAD")
            if r.returncode == 0:
                names |= set(r.stdout.split())
        r = git("diff", "--name-only", "HEAD")   # worktree + index
        if r.returncode == 0:
            names |= set(r.stdout.split())
        r = git("ls-files", "--others", "--exclude-standard")
        if r.returncode == 0:
            names |= set(r.stdout.split())
        return {n for n in names if n.endswith(".py")}
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    rules = core.all_rules()
    if args.list_rules:
        for rid, r in sorted(rules.items()):
            scope = "cross" if r.cross else "local"
            print(f"{rid:18s} [{scope}] {r.summary}")
        return 0

    if args.write_lockorder:
        import json
        target = Path(args.root).resolve() / LOCKORDER
        target.write_text(json.dumps(lock_graph(args.root), indent=1)
                          + "\n", encoding="utf-8")
        print(f"difacto-lint: wrote {LOCKORDER}")
        return 0

    rule_ids = None
    if args.rules:
        rule_ids = [s.strip() for s in args.rules.split(",") if s.strip()]
    elif args.no_cross:
        rule_ids = [rid for rid, r in rules.items() if not r.cross]
    if args.no_cross and args.rules:
        rule_ids = [rid for rid in rule_ids
                    if rid in rules and not rules[rid].cross]

    root = Path(args.root).resolve()
    paths = args.paths or [p for p in DEFAULT_PATHS if (root / p).exists()]
    local_files = None
    if args.changed_only:
        local_files = changed_files(root, args.base)
        if local_files is None:
            print("difacto-lint: --changed-only needs git; running the "
                  "full tree", file=sys.stderr)
    try:
        project = core.Project(root, paths)
        res = core.run_project(project, rule_ids,
                               local_files=local_files)
    except ValueError as e:
        print(f"difacto-lint: {e}", file=sys.stderr)
        return 2

    baseline_path = args.baseline
    if baseline_path is None:
        cand = root / DEFAULT_BASELINE
        baseline_path = str(cand) if cand.exists() else "none"
    if args.write_baseline:
        target = baseline_path if baseline_path != "none" \
            else str(root / DEFAULT_BASELINE)
        n = core.write_baseline(res, target)
        print(f"difacto-lint: baselined {n} finding(s) -> {target}")
        return 0
    if baseline_path != "none":
        try:
            core.apply_baseline(res, core.load_baseline(baseline_path))
        except (ValueError, OSError) as e:
            print(f"difacto-lint: bad baseline: {e}", file=sys.stderr)
            return 2

    if args.fmt == "json":
        print(core.format_json(res))
    elif args.fmt == "github":
        print(core.format_github(res))
    elif args.fmt == "sarif":
        print(core.format_sarif(res))
    else:
        print(core.format_text(res, verbose=args.verbose))
    return 1 if res.active else 0


if __name__ == "__main__":
    sys.exit(main())
