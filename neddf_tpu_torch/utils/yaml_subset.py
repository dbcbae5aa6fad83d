"""A small YAML reader and writer for the subset the repo's configs use
(no PyYAML).

Supported: block mappings and block sequences (including a sequence at
the same indentation as its key, and ``- key: value`` items), flow
mappings/sequences of scalars (``{a: 1, b: [2, 3]}``), full-line and
trailing comments, single/double-quoted strings, and PyYAML's
(YAML 1.1) resolution of plain scalars into null, bool, int and float.
Anchors, tags, multi-document streams and block scalars (``|``, ``>``)
are not supported and raise. ``dumps`` writes block mappings and
sequences of scalars, quoting every string that would not read back as
itself, so ``loads(dumps(x)) == x`` and PyYAML reads the same values.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Any, List, Tuple, Union

# PyYAML's implicit resolvers (yaml/resolver.py), decimal forms only
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN))$"
)


def _plain_scalar(text: str) -> Any:
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        low = text.replace("_", "").lower()
        if low.endswith("inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        if low == ".nan":
            return float("nan")
        return float(low)
    if text[:1] in "&*!|>%@`":
        raise ValueError(f"yaml_subset: unsupported construct {text!r}")
    return text


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """Parse a quoted scalar starting at text[i]; returns (value, end)."""
    quote = text[i]
    out = []
    j = i + 1
    while j < len(text):
        ch = text[j]
        if quote == "'" and ch == "'":
            if text[j + 1 : j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if quote == '"' and ch == "\\":
            nxt = text[j + 1]
            out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/"}[nxt])
            j += 2
            continue
        if quote == '"' and ch == '"':
            return "".join(out), j + 1
        out.append(ch)
        j += 1
    raise ValueError(f"yaml_subset: unterminated string in {text!r}")


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _flow(text: str, i: int, stop: str) -> Tuple[Any, int]:
    """Parse one flow node at text[i]; stops before any char in ``stop``."""
    while text[i] == " ":
        i += 1
    ch = text[i]
    if ch == "{":
        out = {}
        i += 1
        while True:
            while text[i] == " ":
                i += 1
            if text[i] == "}":
                return out, i + 1
            key, i = _flow(text, i, ":")
            i += 1  # ':'
            val, i = _flow(text, i, ",}")
            out[key] = val
            while text[i] == " ":
                i += 1
            if text[i] == ",":
                i += 1
    if ch == "[":
        out_l: List[Any] = []
        i += 1
        while True:
            while text[i] == " ":
                i += 1
            if text[i] == "]":
                return out_l, i + 1
            val, i = _flow(text, i, ",]")
            out_l.append(val)
            while text[i] == " ":
                i += 1
            if text[i] == ",":
                i += 1
    if ch in "'\"":
        return _quoted(text, i)
    j = i
    while j < len(text) and text[j] not in stop:
        j += 1
    return _plain_scalar(text[i:j].strip()), j


def parse_scalar(text: str) -> Any:
    """Parse an inline value: a (quoted) scalar or a flow collection."""
    text = text.strip()
    if not text:
        return None
    if text[0] in "{[" or text[0] in "'\"":
        val, end = _flow(text + "\0", 0, "\0")
        if text[end:].strip():
            raise ValueError(f"yaml_subset: trailing text in {text!r}")
        return val
    return _plain_scalar(text)


def _split_key(content: str) -> Tuple[Any, str]:
    """Split ``key: rest`` (key may be quoted); raises if not a mapping."""
    if content[0] in "'\"":
        key, end = _quoted(content, 0)
        rest = content[end:]
        if not rest.startswith(":"):
            raise ValueError(f"yaml_subset: expected ':' in {content!r}")
        return key, rest[1:].strip()
    m = re.match(r"^([^:]*?)\s*:(?:\s+|$)(.*)$", content)
    if m is None:
        raise ValueError(f"yaml_subset: not a mapping entry: {content!r}")
    return _plain_scalar(m.group(1)), m.group(2).strip()


def _is_mapping_entry(content: str) -> bool:
    if content[0] in "{[":
        return False
    try:
        _split_key(content)
    except (ValueError, KeyError):
        return False
    return True


def _block(lines: List[Tuple[int, str]], i: int, indent: int) -> Tuple[Any, int]:
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _child(lines, i, indent, allow_same_indent_seq):
    """Value of a key/item whose inline part was empty."""
    if i < len(lines):
        ind, content = lines[i]
        if ind > indent:
            return _block(lines, i, ind)
        if allow_same_indent_seq and ind == indent and (
            content.startswith("- ") or content == "-"
        ):
            return _sequence(lines, i, indent)
    return None, i


def _mapping(lines, i, indent):
    out = {}
    while i < len(lines):
        ind, content = lines[i]
        if ind < indent or content.startswith("- ") or content == "-":
            break
        if ind > indent:
            raise ValueError(f"yaml_subset: bad indentation at {content!r}")
        key, rest = _split_key(content)
        i += 1
        if rest:
            out[key] = parse_scalar(rest)
        else:
            out[key], i = _child(lines, i, indent, True)
    return out, i


def _sequence(lines, i, indent):
    out = []
    while i < len(lines):
        ind, content = lines[i]
        if ind != indent or not (content.startswith("- ") or content == "-"):
            break
        rest = content[1:].lstrip()
        if not rest:
            val, i = _child(lines, i + 1, indent, False)
        elif _is_mapping_entry(rest):
            # "- key: v" opens a mapping whose column is that of "key"
            col = indent + (len(content) - len(rest))
            lines[i] = (col, rest)
            val, i = _mapping(lines, i, col)
        else:
            val, i = parse_scalar(rest), i + 1
        out.append(val)
    return out, i


def loads(text: str) -> Any:
    """Parse one YAML document of the supported subset."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError("yaml_subset: tabs in indentation")
        stripped = _strip_comment(raw)
        if stripped.strip() in ("", "---"):
            continue
        lines.append((len(stripped) - len(stripped.lstrip()), stripped.strip()))
    if not lines:
        return None
    if len(lines) == 1 and not _is_mapping_entry(lines[0][1]) and not (
        lines[0][1].startswith("- ") or lines[0][1] == "-"
    ):
        return parse_scalar(lines[0][1])
    val, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"yaml_subset: unparsed line {lines[i][1]!r}")
    return val


def load(path: Union[str, Path]) -> Any:
    return loads(Path(path).read_text())


def _scalar_text(value: Any) -> str:
    if value is None:
        return "null"
    if value is True or value is False:
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if value in (float("inf"), float("-inf")):
            return "-.inf" if value < 0 else ".inf"
        text = repr(value)
        if "e" in text and "." not in text:  # YAML 1.1 floats need a dot
            mant, exp = text.split("e")
            text = f"{mant}.0e{exp}"
        if "e" in text and text.split("e")[1][0] not in "+-":
            mant, exp = text.split("e")
            text = f"{mant}e+{exp}"
        return text
    if isinstance(value, str):
        plain = value and value == value.strip() and not any(
            ch in value for ch in ":#{}[],&*!|>'\"%@`\n") and value[0] not in "-?"
        if plain and _plain_scalar(value) == value:
            return value
        return "'" + value.replace("'", "''") + "'"
    raise TypeError(f"yaml_subset: cannot write {type(value).__name__}")


def _dump(value: Any, indent: int, lines: List[str]) -> None:
    pad = " " * indent
    if isinstance(value, dict):
        for key, item in value.items():
            head = f"{pad}{_scalar_text(key)}:"
            if isinstance(item, (dict, list)) and item:
                lines.append(head)
                _dump(item, indent + 2, lines)
            elif isinstance(item, (dict, list)):
                lines.append(f"{head} {'{}' if isinstance(item, dict) else '[]'}")
            else:
                lines.append(f"{head} {_scalar_text(item)}")
    elif isinstance(value, list):
        for item in value:
            if isinstance(item, dict) and item:
                sub: List[str] = []
                _dump(item, indent + 2, sub)
                lines.append(f"{pad}- {sub[0].lstrip()}")
                lines.extend(sub[1:])
            elif isinstance(item, list) and item:
                raise ValueError("yaml_subset: nested sequences are not supported")
            else:
                lines.append(f"{pad}- {_scalar_text(item)}")
    else:
        lines.append(pad + _scalar_text(value))


def dumps(value: Any) -> str:
    """Write a mapping / sequence / scalar tree as block YAML."""
    if isinstance(value, (dict, list)) and not value:
        return "{}\n" if isinstance(value, dict) else "[]\n"
    lines: List[str] = []
    _dump(value, 0, lines)
    return "\n".join(lines) + "\n"
