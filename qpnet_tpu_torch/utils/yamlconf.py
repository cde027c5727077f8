"""The recipe's YAML files without PyYAML: `conf/pow_f0_dict.yml`,
`validation_result.yml` and `loss-final.yml`.

The port runs where PyYAML is not installed, so it reads and writes the
small part of YAML 1.1 these files use:

  * `dump` gives the bytes `yaml.safe_dump` gives for a mapping of string
    keys to ints, floats and mappings of the same (sorted keys, block
    style, two-space indent), e.g. {speaker: {f0_min, f0_max, pow_th}};
  * `load` reads block or flow mappings of ints and floats, nested, with
    comments, the keys plain or quoted, as PyYAML's `safe_load` reads them
    (YAML 1.1 number forms: `010` is octal, `1e3` is a string), and raises
    ValueError on anything else: sequences, strings, booleans, nulls,
    anchors, several documents, keys that are not strings;
  * the trainer's loss history (a sequence of floats) and the validation
    CLI's result file, written as PyYAML writes them and read back.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Mapping, Sequence

# YAML 1.1 implicit types of a plain scalar, as PyYAML's resolver has them
_INT = re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
_OTHER = re.compile(
    r"yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off"
    r"|OFF|~|null|Null|NULL|<<|=|[0-9]{4}-[0-9]{2}-[0-9]{2}"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt]|[ \t]+)[0-9]{1,2}:[0-9]{2}"
    r":[0-9]{2}(?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9]{1,2}(?::[0-9]{2})?))?")
# keys `dump` writes: plain when they read back as strings, else quoted
_KEY = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,126}")
_INDICATORS = "-?:,[]{}#&*!|>%@`"
_FLOW_KEY = re.compile(r"[^,:{}\[\]]*")
_FLOW_VALUE = re.compile(r"[^,{}\[\]]*")


def _sexagesimal(text: str) -> float:
    value = 0
    for part in text.split(":"):
        value = value * 60 + float(part)
    return value


def scalar(text: str):
    """The int or float a plain YAML 1.1 scalar stands for; ValueError if
    it stands for something else."""
    if _INT.fullmatch(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * int(_sexagesimal(v))
        return sign * int(v)
    if _FLOAT.fullmatch(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        return sign * (_sexagesimal(v) if ":" in v else float(v))
    raise ValueError(f"not a YAML int or float: {text!r}")


def _is_string(text: str) -> bool:
    """Whether a plain scalar reads back as a string."""
    return not (text == "" or _INT.fullmatch(text) or _FLOAT.fullmatch(text)
                or _OTHER.fullmatch(text))


def _yaml_float(v: float) -> str:
    """A float as PyYAML's representer writes it."""
    if v != v:
        return ".nan"
    if math.isinf(v):
        return ".inf" if v > 0 else "-.inf"
    text = repr(float(v)).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


# --- writing ---------------------------------------------------------------

def _key(k) -> str:
    if type(k) is not str or not _KEY.fullmatch(k):
        raise ValueError(f"key {k!r}: dump writes keys of letters, digits, "
                         f"'_', '.' and '-' (not first), under 128 long")
    return k if _is_string(k) else f"'{k}'"


def _dump(mapping: Mapping, indent: str, out: List[str]) -> None:
    for k in sorted(mapping):
        v = mapping[k]
        if isinstance(v, Mapping):
            if v:
                out.append(f"{indent}{_key(k)}:\n")
                _dump(v, indent + "  ", out)
            else:
                out.append(f"{indent}{_key(k)}: {{}}\n")
        elif type(v) is int:
            out.append(f"{indent}{_key(k)}: {v}\n")
        elif type(v) is float:
            out.append(f"{indent}{_key(k)}: {_yaml_float(v)}\n")
        else:
            raise ValueError(f"{k!r}: dump writes ints, floats and "
                             f"mappings, not {type(v).__name__}")


def dump(mapping: Mapping) -> str:
    """The text `yaml.safe_dump(mapping)` gives (see the module's doc)."""
    if not mapping:
        return "{}\n"
    out: List[str] = []
    _dump(mapping, "", out)
    return "".join(out)


# --- reading ---------------------------------------------------------------

def _strip_comment(line: str) -> str:
    """The line without its comment: a '#' at its start or after a blank,
    outside quotes."""
    i = 0
    while i < len(line):
        c = line[i]
        if c in "'\"" and (i == 0 or line[i - 1] in " \t{,:"):
            i = _quoted(line, i)[1]
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _quoted(s: str, i: int):
    """(text, end) of the quoted scalar starting at s[i]."""
    q, j = s[i], i + 1
    while j < len(s):
        if q == '"' and s[j] == "\\":
            j += 2
        elif s[j] == q and q == "'" and s[j + 1:j + 2] == "'":
            j += 2
        elif s[j] == q:
            body = s[i + 1:j]
            if q == "'":
                return body.replace("''", "'"), j + 1
            return (body.encode("ascii", "backslashreplace")
                    .decode("unicode_escape"), j + 1)
        else:
            j += 1
    raise ValueError(f"unterminated quote: {s[i:]!r}")


def _plain_key(text: str) -> str:
    text = text.strip()
    if not text or text[0] in _INDICATORS or not _is_string(text):
        raise ValueError(f"key {text!r} is not a plain string")
    return text


class _Flow:
    """A flow mapping `{k: v, ...}` of numbers and flow mappings."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t\n":
            self.i += 1

    def _expect(self, c):
        self._ws()
        if self.s[self.i:self.i + 1] != c:
            raise ValueError(f"expected {c!r} at {self.s[self.i:]!r}")
        self.i += 1

    def mapping(self) -> Dict:
        self._expect("{")
        out = {}
        while True:
            self._ws()
            if self.s[self.i:self.i + 1] == "}":
                self.i += 1
                return out
            if self.s[self.i:self.i + 1] in ("'", '"'):
                key, self.i = _quoted(self.s, self.i)
            else:
                m = _FLOW_KEY.match(self.s, self.i)
                key, self.i = _plain_key(m.group()), m.end()
            self._expect(":")
            self._ws()
            if self.s[self.i:self.i + 1] == "{":
                out[key] = self.mapping()
            else:
                m = _FLOW_VALUE.match(self.s, self.i)
                out[key], self.i = scalar(m.group().strip()), m.end()
            self._ws()
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
            elif self.s[self.i:self.i + 1] != "}":
                raise ValueError(f"expected ',' or '}}' at "
                                 f"{self.s[self.i:]!r}")

    def whole(self) -> Dict:
        out = self.mapping()
        self._ws()
        if self.i != len(self.s):
            raise ValueError(f"text after the mapping: {self.s[self.i:]!r}")
        return out


def _flow_text(lines, i):
    """The flow mapping that starts on lines[i] (it may go on over the next
    lines), and the index of the line after it."""
    text = lines[i][1]
    i += 1
    while text.count("{") > text.count("}") and i < len(lines):
        text += " " + lines[i][1].strip()
        i += 1
    return text, i


def _block(lines, i, indent):
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        s = lines[i][1][indent:]
        if s[0] in "'\"":
            key, j = _quoted(s, 0)
            if s[j:j + 1] != ":":
                raise ValueError(f"expected ':' after the key: {s!r}")
            rest = s[j + 1:]
        else:
            j = s.find(": ")
            if j < 0 and s.endswith(":"):
                j = len(s) - 1
            if j < 0:
                raise ValueError(f"not a `key: value` line: {s!r}")
            key, rest = _plain_key(s[:j]), s[j + 1:]
        if rest and rest[0] not in " \t":
            raise ValueError(f"expected a blank after ':': {s!r}")
        rest = rest.strip()
        if rest.startswith("{"):
            text, i = _flow_text(lines, i)
            out[key] = _Flow(text[text.index("{", indent + j):]).whole()
        elif rest:
            out[key] = scalar(rest)
            i += 1
        elif i + 1 < len(lines) and lines[i + 1][0] > indent:
            out[key], i = _block(lines, i + 1, lines[i + 1][0])
        else:
            raise ValueError(f"{key!r} has no value (null)")
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"unexpected indent: {lines[i][1]!r}")
    return out, i


def load(text: str) -> Dict:
    """The mapping `yaml.safe_load(text)` reads, for the mappings of
    numbers described in the module's doc; {} for an empty document."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if not line.strip():
            continue
        body = line.lstrip(" ")
        if body[0] == "\t" or body.startswith(("---", "...", "%")):
            raise ValueError(f"not a mapping line: {raw!r}")
        lines.append((len(line) - len(body), line))
    if not lines:
        return {}
    if lines[0][1].lstrip().startswith("{"):
        return _Flow("\n".join(s for _, s in lines)).whole()
    out, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected line: {lines[i][1]!r}")
    return out


def read(path: str) -> Dict:
    with open(path, encoding="utf-8") as f:
        return load(f.read())


def write(path: str, mapping: Mapping) -> None:
    text = dump(mapping)
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)


# --- loss-final.yml: a sequence of floats, as PyYAML's safe_dump writes it,
# so both packages (and yaml.safe_load) read it back equal ------------------

def write_loss_record(path: str, losses: Sequence[float]) -> None:
    text = "".join(f"- {_yaml_float(v)}\n" for v in losses) or "[]\n"
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)


def read_loss_record(path: str) -> List[float]:
    with open(path, encoding="utf-8") as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if lines in ([], ["[]"]):
        return []
    return [float(scalar(ln[1:].strip())) for ln in lines]   # "- <float>"


# --- validation_result.yml: {checkpoint name: mean loss}, keys sorted as
# PyYAML's safe_dump sorts them; the port quotes every key (any file name),
# and reads the plain, single- and double-quoted keys both CLIs write -------

def write_validation_record(path: str, results: Mapping[str, float]) -> None:
    text = "".join("'%s': %s\n" % (k.replace("'", "''"), _yaml_float(v))
                   for k, v in sorted(results.items())) or "{}\n"
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)


def read_validation_record(path: str) -> Dict[str, float]:
    return {k: float(v) for k, v in read(path).items()}
