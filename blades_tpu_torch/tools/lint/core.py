"""blades-lint core for the port: findings, pragma allowlist, file collection.

The counterpart of the JAX package's ``tools/lint/core.py``, over the
PyTorch port.  The bug classes that matter here are the ones that break
the port's load-bearing invariants: host syncs in the round body (each
one stalls the card's launch queue), raw clocks outside the span layer,
uncounted collectives, raw full traversals and decodes outside the pass
planner, metric-schema drift and stale artifact stamps.  Each invariant
is one :class:`LintPass`; this module is the shared plumbing.

Pragma grammar (the same as the JAX lint's, so one pragma serves both)::

    some_call()  # blades-lint: disable=<pass>[,<pass>] — <reason>
    # blades-lint: disable-file=<pass>[,<pass>] — <reason>

``disable=`` suppresses the named passes on ITS line; ``disable-file=``
(anywhere in the file, conventionally the header) suppresses them for
the whole file.  ``disable=all`` suppresses every pass.  A reason of at
least 8 characters is mandatory — a bare pragma defeats the audit trail
and is itself reported as a ``pragma`` finding, as is a pass name no
registered pass answers to (a typo'd pragma silently suppressing
nothing is worse than a loud one).
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import io
import re
import subprocess
import tokenize
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# Pass names contain hyphens, so the reason separator (an em/en dash or
# "-") must be whitespace-preceded: `disable=host-sync — once per round`.
PRAGMA_RE = re.compile(
    r"#\s*blades-lint:\s*(?P<kind>disable-file|disable)\s*=\s*"
    r"(?P<passes>[A-Za-z0-9_,\- ]+?)(?:\s+[—–-]+\s*(?P<reason>.*))?$"
)
MIN_REASON_LEN = 8

# Severities.  Only ERROR findings fail the run; WARNING surfaces in the
# report (and --json) but exits 0 — the schema pass's registered-but-
# never-stamped direction lives there.
ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One finding: where, which pass, what, and how to fix it."""

    pass_name: str
    path: str  # repo-relative
    line: int
    message: str
    fix_hint: str = ""
    severity: str = ERROR

    def render(self) -> str:
        tag = "" if self.severity == ERROR else f" {self.severity.upper()}"
        out = f"{self.path}:{self.line}:{tag} [{self.pass_name}] {self.message}"
        if self.fix_hint:
            out += f"\n    fix: {self.fix_hint}"
        return out

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Pragma:
    line: int  # 0 for file-level
    passes: Tuple[str, ...]
    reason: str
    file_level: bool


def _comment_tokens(text: str) -> List[Tuple[int, str]]:
    """(line, comment-text) for every actual ``#`` comment.

    Pragmas are recognized ONLY in comment tokens — a pragma spelled
    inside a docstring or string literal (e.g. a module documenting the
    grammar) must not become a live suppression.  Tokenization of a
    malformed file stops at the bad token; such files get a ``parse``
    finding anyway, so losing their trailing comments is fine.
    """
    out: List[Tuple[int, str]] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.string))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        pass
    return out


class SourceFile:
    """A parsed python file + its pragma allowlist, shared across passes."""

    def __init__(self, path: Path, root: Path):
        self.path = path
        self.rel = path.relative_to(root).as_posix()
        self.text = path.read_text(errors="replace")
        self.lines = self.text.splitlines()
        try:
            self.tree: Optional[ast.Module] = ast.parse(
                self.text, filename=self.rel)
            self.parse_error: Optional[SyntaxError] = None
        except SyntaxError as exc:
            self.tree = None
            self.parse_error = exc
        self.pragmas: List[Pragma] = []
        # Tokenizing is the costliest step of a scan: skip it in the files
        # that cannot hold a pragma.
        comments = (_comment_tokens(self.text) if "blades-lint" in self.text
                    else [])
        for lineno, comment in comments:
            m = PRAGMA_RE.search(comment)
            if not m:
                continue
            names = tuple(p.strip() for p in m.group("passes").split(",")
                          if p.strip())
            self.pragmas.append(Pragma(
                line=lineno, passes=names,
                reason=(m.group("reason") or "").strip(),
                file_level=m.group("kind") == "disable-file",
            ))

    @functools.cached_property
    def nodes(self) -> List[ast.AST]:
        """Every node of the tree (``ast.walk`` order), walked once and
        shared by the passes."""
        return [] if self.tree is None else list(ast.walk(self.tree))

    @functools.cached_property
    def calls(self) -> List[ast.Call]:
        return [n for n in self.nodes if isinstance(n, ast.Call)]

    @functools.cached_property
    def imports(self) -> List[ast.AST]:
        return [n for n in self.nodes
                if isinstance(n, (ast.Import, ast.ImportFrom))]

    def disabled(self, pass_name: str, line: int) -> bool:
        for p in self.pragmas:
            if pass_name in p.passes or "all" in p.passes:
                if p.file_level or p.line == line:
                    return True
        return False


class LintPass:
    """Base class: subclasses set ``name``/``doc`` and implement ``run``.

    ``run`` receives the :class:`LintContext` and yields findings; the
    runner applies pragma suppression afterwards, so passes never need
    to know the pragma grammar.
    """

    name: str = "unnamed"
    doc: str = ""

    def run(self, ctx: "LintContext") -> Iterable[Finding]:  # pragma: no cover
        raise NotImplementedError


class LintContext:
    """Everything a pass may need: the file set, the repo root, and
    whether this is a partial (``--changed`` / explicit-path) scan —
    passes checking repo-wide state (artifact stamps) skip partial
    scans rather than fail them on files nobody asked about."""

    def __init__(self, root: Path, files: Sequence[SourceFile],
                 partial: bool = False):
        self.root = root
        self.files = list(files)
        self.partial = partial
        self._by_rel = {f.rel: f for f in self.files}

    def file(self, rel: str) -> Optional[SourceFile]:
        return self._by_rel.get(rel)

    def matching(self, prefixes: Sequence[str]) -> List[SourceFile]:
        return [f for f in self.files
                if any(f.rel == p or f.rel.startswith(p.rstrip("/") + "/")
                       for p in prefixes)]


# Roots scanned by default: the port, its smoke script on the card and
# its tests.  The tests are a glob because ``tests/`` also holds the JAX
# package's tests (which the JAX lint scans).  Fixture snippets are
# DELIBERATE violations and must never enter the default tree scan.
DEFAULT_ROOTS = ("blades_tpu_torch", "chip_smoke.py", "tests/test_torch_*.py")
EXCLUDE_PARTS = ("lint_fixtures", "__pycache__")


def collect_files(root: Path,
                  only: Optional[Sequence[Path]] = None) -> List[SourceFile]:
    """The python files lint runs over, as parsed :class:`SourceFile`\\ s.

    ``only`` restricts collection to that explicit set (the ``--changed``
    and positional-path CLI modes); exclusions still apply.
    """
    if only is not None:
        # Explicit paths (--changed / CLI operands) are linted as asked —
        # including fixture files, which the tests target deliberately.
        return [SourceFile(p, root) for p in only
                if p.suffix == ".py" and p.is_file()]
    paths: List[Path] = []
    for r in DEFAULT_ROOTS:
        if "*" in r:
            paths.extend(sorted(root.glob(r)))
            continue
        p = root / r
        if p.is_file():
            paths.append(p)
        elif p.is_dir():
            paths.extend(sorted(p.rglob("*.py")))
    return [SourceFile(p, root) for p in paths
            if not any(part in EXCLUDE_PARTS for part in p.parts)]


def changed_files(root: Path) -> List[Path]:
    """Files changed vs HEAD plus untracked files (``--changed`` mode)."""
    names: Set[str] = set()
    for args in (["git", "diff", "--name-only", "HEAD"],
                 ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            r = subprocess.run(args, cwd=root, capture_output=True,
                               text=True, check=True)
        except (OSError, subprocess.CalledProcessError):
            continue
        names.update(n for n in r.stdout.splitlines() if n.strip())
    return [root / n for n in sorted(names) if (root / n).exists()]


def audit_pragmas(files: Sequence[SourceFile],
                  known_passes: Set[str]) -> List[Finding]:
    """The pragma allowlist's own checks: reasons and real pass names."""
    findings = []
    for f in files:
        for p in f.pragmas:
            where = p.line
            if len(p.reason) < MIN_REASON_LEN:
                findings.append(Finding(
                    "pragma", f.rel, where,
                    "blades-lint pragma without a justification",
                    fix_hint="append '— <why this line is exempt>' "
                             f"(>= {MIN_REASON_LEN} chars)",
                ))
            unknown = [n for n in p.passes
                       if n != "all" and n not in known_passes]
            if unknown:
                findings.append(Finding(
                    "pragma", f.rel, where,
                    f"pragma names unknown pass(es) {unknown}",
                    fix_hint="known passes: "
                             + ", ".join(sorted(known_passes)),
                ))
    return findings


def run_passes(root: Path, passes: Sequence[LintPass],
               only: Optional[Sequence[Path]] = None) -> List[Finding]:
    """Run every pass, apply pragma suppression, return sorted findings."""
    files = collect_files(root, only=only)
    ctx = LintContext(root, files, partial=only is not None)
    known = {p.name for p in passes}
    findings: List[Finding] = list(audit_pragmas(files, known))
    for f in files:
        if f.parse_error is not None:
            findings.append(Finding(
                "parse", f.rel, f.parse_error.lineno or 1,
                f"unparseable: {f.parse_error.msg}"))
    for p in passes:
        for finding in p.run(ctx):
            src = ctx.file(finding.path)
            if src is not None and src.disabled(p.name, finding.line):
                continue
            findings.append(finding)
    return sorted(findings, key=lambda x: (x.path, x.line, x.pass_name))
