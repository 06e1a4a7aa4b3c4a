"""OpenFOAM dictionary parser (the port's own copy of
`yade_openfoam_coupling_tpu/utils/foamdict.py`, plain Python).

The reference is configured entirely through OpenFOAM dictionaries —
`transportProperties` (`icoFoamYade/createFields.H:3-45`),
`controlDict`/`fvSolution`/`fvSchemes` (via `createTime.H`, `mesh.solver()`,
`piso.dict()`), `turbulenceProperties` (run-time model selection, C6), and
`g` (`readGravitationalAcceleration.H`). So that a user of the reference can
point this framework at an existing case directory, this module parses the
OpenFOAM dictionary format:

* `key value;` entries (words, numbers, strings, bools)
* dimensioned scalars: `nu nu [0 2 -1 0 0 0 0] 1e-06;` -> 1e-06
* vectors/lists: `(0 0 -9.81)`, `value uniform (0 0 0);`
* nested sub-dictionaries `{ ... }`
* `//` line and `/* */` block comments, `#include`-free subset
* the standard `FoamFile { ... }` header (parsed, kept under "FoamFile")

Output is plain nested dicts; `utils/config.py` maps them onto the typed
`CaseConfig`.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, List, Optional, Union


def strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    return text


_TOKEN_RE = re.compile(
    r"""
    \"[^\"]*\"          |   # quoted string
    \{ | \} | \( | \) | ;  |
    \[ | \]             |
    [^\s{}()\[\];]+         # bare word / number
    """,
    re.X,
)


def tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(strip_comments(text))


_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")


def _coerce(tok: str) -> Any:
    if tok.startswith('"') and tok.endswith('"'):
        return tok[1:-1]
    if _NUM_RE.match(tok):
        f = float(tok)
        if f.is_integer() and "." not in tok and "e" not in tok.lower():
            return int(tok)
        return f
    if tok in ("yes", "true", "on"):
        return True
    if tok in ("no", "false", "off"):
        return False
    return tok


class _Parser:
    def __init__(self, tokens: List[str]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        tok = self.toks[self.i]
        self.i += 1
        return tok

    def parse_dict_body(self, stop_at_brace: bool) -> dict:
        out: dict = {}
        while True:
            tok = self.peek()
            if tok is None:
                if stop_at_brace:
                    raise ValueError("unexpected EOF inside { }")
                return out
            if tok == "}":
                self.next()
                return out
            key = self.next()
            if self.peek() == "{":
                self.next()
                out[key] = self.parse_dict_body(True)
            else:
                out[key] = self.parse_value(key)
        return out

    def parse_value(self, key: str) -> Any:
        """Everything up to the terminating ';' (or a sub-dict)."""
        items: List[Any] = []
        while True:
            tok = self.peek()
            if tok is None:
                break
            if tok == ";":
                self.next()
                break
            if tok == "{":
                self.next()
                return self.parse_dict_body(True)
            if tok == "(":
                self.next()
                items.append(self.parse_list())
                continue
            if tok == "[":
                # dimension set: swallow tokens until ']'
                self.next()
                while self.peek() not in ("]", None):
                    self.next()
                if self.peek() == "]":
                    self.next()
                continue
            if tok == "}":
                break
            items.append(_coerce(self.next()))

        if not items:
            return None
        if len(items) == 1:
            return items[0]
        # dimensioned scalar pattern: `nu nu [..] 1e-6` -> repeated name
        # then value; `uniform (0 0 0)` -> keep the payload
        if items[0] == "uniform" and len(items) == 2:
            return items[1]
        if isinstance(items[-1], (int, float, list, tuple)):
            # keep the last concrete value (covers `name [dims] value`)
            tail = items[-1]
            if all(isinstance(x, str) for x in items[:-1]):
                return tail
        return items

    def parse_list(self) -> list:
        out: List[Any] = []
        while True:
            tok = self.peek()
            if tok is None:
                raise ValueError("unexpected EOF inside ( )")
            if tok == ")":
                self.next()
                return out
            if tok == "(":
                self.next()
                out.append(self.parse_list())
                continue
            if tok == "{":
                self.next()
                out.append(self.parse_dict_body(True))
                continue
            out.append(_coerce(self.next()))


def parse(text: str) -> dict:
    return _Parser(tokenize(text)).parse_dict_body(False)


def parse_file(path: Union[str, Path]) -> dict:
    return parse(Path(path).read_text())


def get(d: dict, path: str, default=None):
    """Dotted-path lookup: get(cfg, 'PISO.nCorrectors', 2)."""
    cur: Any = d
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return default
        cur = cur[part]
    return cur
