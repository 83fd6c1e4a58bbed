"""`key=value` command-line flag system.

Replicates the reference CLI surface (parse/Parser.java:68, PreParser.java:12,
Parse.java; config-file format docs/readme_config.txt) so reference command
lines work verbatim:

  - flags are case-insensitive `key=value` tokens; bare `key` means `key=true`
    for booleans; `null`/empty -> None
  - booleans accept t/f/true/false/1/0 (Parse.parseBoolean semantics)
  - sizes accept K/M/G/T suffixes, binary multiples, e.g. `2g` (parseKMG)
  - `config=file` expands to one flag per line; `#` comments allowed
    (parse/Parser.java:667)
  - `in=a.fq,b.fq` comma lists; `in1=`/`in2=` pairs

Internally flags map onto typed dataclasses per tool; this module only does
the string layer.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


_KMG = {
    "k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40, "p": 1 << 50,
}


def parse_boolean(v: str | bool | None) -> bool:
    """Parse.parseBoolean: t/true/1/yes -> True, f/false/0/no -> False."""
    if isinstance(v, bool) or v is None:
        return bool(v) if v is not None else True
    s = v.strip().lower()
    if s in ("t", "true", "1", "yes", "y", ""):
        return True
    if s in ("f", "false", "0", "no", "n"):
        return False
    raise ValueError(f"cannot parse boolean from {v!r}")


def parse_kmg(v: str | int) -> int:
    """Parse a size with optional K/M/G/T/P suffix (binary multiples)."""
    if isinstance(v, int):
        return v
    s = v.strip().lower()
    if not s:
        raise ValueError("empty size")
    mult = 1
    if s[-1] in _KMG:
        mult = _KMG[s[-1]]
        s = s[:-1]
    return int(float(s) * mult)


def parse_int_list(v: str) -> list[int]:
    return [int(x) for x in v.split(",") if x != ""]


@dataclass
class ParsedArgs:
    """Result of tokenizing a command line: ordered (key, value) pairs with
    case-folded keys, plus conveniences for typed access."""

    pairs: list[tuple[str, str | None]] = field(default_factory=list)

    def get(self, *keys: str, default=None):
        """Last value wins, like the reference's sequential else-if chain."""
        out = default
        for k, v in self.pairs:
            if k in keys:
                out = v
        return out

    def get_bool(self, *keys: str, default: bool = False) -> bool:
        v = self.get(*keys, default=_SENTINEL)
        return default if v is _SENTINEL else parse_boolean(v)

    def get_int(self, *keys: str, default: int | None = None):
        v = self.get(*keys, default=_SENTINEL)
        return default if v is _SENTINEL or v is None else parse_kmg(v)

    def get_float(self, *keys: str, default: float | None = None):
        v = self.get(*keys, default=_SENTINEL)
        return default if v is _SENTINEL or v is None else float(v)

    def get_list(self, *keys: str) -> list[str]:
        v = self.get(*keys)
        return [] if v in (None, "") else v.split(",")

    def consume(self, known: set[str]) -> list[tuple[str, str | None]]:
        """Return pairs whose key is not in `known` (for per-tool chains)."""
        return [(k, v) for k, v in self.pairs if k not in known]


_SENTINEL = object()


def tokenize(args: list[str]) -> ParsedArgs:
    """Split args into case-folded (key, value) pairs, expanding config files.

    Mirrors PreParser + Parser behavior: `config=path` inlines the file
    (one flag per line, '#'-comments stripped); `key` alone -> (key, None);
    value keeps its original case (paths are case-sensitive), key folds.
    """
    out = ParsedArgs()
    for raw in args:
        if raw is None:
            continue
        raw = raw.strip()
        if not raw or raw == "--":
            continue
        # strip leading dashes so both `k=23` and `--k=23` work
        tok = raw.lstrip("-") if raw.startswith("-") and "=" in raw else raw
        if "=" in tok:
            k, v = tok.split("=", 1)
            k = k.strip().lower()
            v = v.strip()
            if v.lower() == "null":
                v = None
        else:
            k, v = tok.strip().lower(), None
        if k == "config" and v:
            for path in v.split(","):
                out.pairs.extend(_read_config(path).pairs)
            continue
        out.pairs.append((k, v))
    return out


def _read_config(path: str) -> ParsedArgs:
    if not os.path.exists(path):
        raise FileNotFoundError(f"config file not found: {path}")
    lines = []
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if line:
                lines.append(line)
    return tokenize(lines)


def test_output_files(overwrite: bool, *paths, inputs=()):
    """Output-collision guard (shared/Tools.testOutputFiles): refuse
    duplicate output paths, outputs that shadow inputs, and existing
    files unless overwrite is set. Returns the validated list."""
    import os

    outs = [p for p in paths if p]
    seen = set()
    ins = {os.path.abspath(p) for p in inputs if p}
    for p in outs:
        ap = os.path.abspath(p)
        if ap in seen:
            raise ValueError(f"duplicate output file: {p}")
        seen.add(ap)
        if ap in ins:
            raise ValueError(f"output file {p} is also an input")
        if os.path.exists(p) and not overwrite:
            raise ValueError(
                f"output file {p} exists; use overwrite=t (ow) to replace"
            )
    return outs
