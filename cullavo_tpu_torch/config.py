"""Configuration system (counterpart of ``cullavo_tpu/config.py``): several
YAML files merged with later-file precedence, dotted-key nesting
(``MODEL.BACKBONE.NAME`` creates nested dicts), JSON ``--config_overrides``,
and ``--overrides K V`` pairs whose values are coerced to the type of the
existing entry ("false"/"False" map to False).  The config is frozen after
load.

The files are read by the port's own reader of the YAML subset the repo's
configs use (the machine with the card has no ``yaml``): block mappings,
flow lists, plain and quoted scalars, full-line and trailing comments.
Plain scalars resolve as PyYAML's ``safe_load`` resolves them (YAML 1.1):
``null``/``~``/empty, the boolean words (``yes``/``no``/``on``/``off`` too),
decimal ints and floats (underscores allowed), where a float needs a dot
and a signed exponent, so ``2e-5`` stays the string ``'2e-5'``.  Anything
outside the subset raises: anchors, aliases, tags, block scalars, block
sequences, flow mappings, several documents, tabs, timestamps, merge keys,
base-60, binary, octal and hex numbers, ``.inf``/``.nan`` and ``\\u``
escapes.
"""
from __future__ import annotations

import argparse
import copy
import json
import re
from typing import Any, Iterable, Mapping

__all__ = [
    "Config",
    "YamlSubsetError",
    "parse_yaml",
    "load_config",
    "merge_dotted",
    "apply_overrides",
    "load_opt_command",
]


# ---------------------------------------------------------------------------
# the YAML subset
# ---------------------------------------------------------------------------

class YamlSubsetError(ValueError):
    """A config file uses YAML that the port's reader does not take."""


# PyYAML's implicit resolvers (yaml/resolver.py), in its order of trial
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$""", re.X)
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
# the rest of PyYAML's float and int forms, which no config uses: base 60,
# .inf/.nan, binary, octal, hex
_OTHER_NUMBER = re.compile(r"""^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN)
                    |[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                    (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_BOOL_WORDS = {"yes": True, "true": True, "on": True, "no": False, "false": False, "off": False}
_KEY = re.compile(r"^([^\s#'\"\[\]{},&*!|>%@`?-][^:#]*?|-[^\s:#][^:#]*?)\s*:(?:\s+|$)(.*)$")
_DQ_ESCAPES = {"0": "\0", "t": "\t", "n": "\n", "r": "\r", '"': '"', "/": "/", "\\": "\\"}


def _plain_scalar(text: str, where: str):
    """A plain scalar resolved as PyYAML's SafeLoader resolves it."""
    if _BOOL.match(text):
        return _BOOL_WORDS[text.lower()]
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _OTHER_NUMBER.match(text):
        raise YamlSubsetError(f"{where}: {text!r} (base 60, .inf/.nan, binary, octal and hex "
                              "numbers) is outside the YAML subset")
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _NULL.match(text):
        return None
    if text == "<<" or _TIMESTAMP.match(text) or text == "=":
        raise YamlSubsetError(f"{where}: {text!r} (merge keys, timestamps and value keys) is "
                              "outside the YAML subset")
    if text[0] in "&*!|>%@`{" or text.startswith(("- ", "? ")) or text == "-":
        raise YamlSubsetError(f"{where}: {text!r}: anchors, aliases, tags, block scalars, "
                              "block sequences and flow mappings are outside the YAML subset")
    if ": " in text or text.endswith(":"):
        raise YamlSubsetError(f"{where}: a mapping inside the plain scalar {text!r}")
    return text


def _quoted(text: str, i: int, where: str):
    """The quoted scalar starting at ``text[i]`` -> (value, index past it)."""
    q = text[i]
    out, j = [], i + 1
    while j < len(text):
        c = text[j]
        if q == "'" and c == "'":
            if text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == '"':
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            e = text[j + 1:j + 2]
            if e not in _DQ_ESCAPES:
                raise YamlSubsetError(f"{where}: the escape \\{e} is outside the YAML subset")
            out.append(_DQ_ESCAPES[e])
            j += 2
            continue
        out.append(c)
        j += 1
    raise YamlSubsetError(f"{where}: unterminated quoted scalar (multi-line scalars are "
                          "outside the YAML subset)")


def _strip_comment(text: str, where: str) -> str:
    """``text`` without a trailing comment (a ``#`` after white space, outside
    quotes) and trailing white space."""
    j, n = 0, len(text)
    while j < n:
        c = text[j]
        before = text[:j].rstrip(" ")
        if c in "'\"" and (not before or before[-1] in "[," or (before[-1] == ":"
                                                                and text[j - 1] == " ")):
            _, j = _quoted(text, j, where)
            continue
        if c == "#" and (j == 0 or text[j - 1] == " "):
            return text[:j].rstrip()
        j += 1
    return text.rstrip()


def _flow_list(text: str, i: int, where: str):
    """The flow list starting at ``text[i] == '['`` -> (list, index past it)."""
    out, j = [], i + 1
    while True:
        while j < len(text) and text[j] == " ":
            j += 1
        if j >= len(text):
            raise YamlSubsetError(f"{where}: unterminated flow list (multi-line flow "
                                  "collections are outside the YAML subset)")
        c = text[j]
        if c == "]":
            return out, j + 1
        if c == "[":
            item, j = _flow_list(text, j, where)
        elif c in "'\"":
            item, j = _quoted(text, j, where)
        elif c == "{":
            raise YamlSubsetError(f"{where}: flow mappings are outside the YAML subset")
        else:
            k = j
            while k < len(text) and text[k] not in ",[]{}":
                k += 1
            if not text[j:k].strip():
                raise YamlSubsetError(f"{where}: an empty entry in a flow list")
            item = _plain_scalar(text[j:k].strip(), where)
            j = k
        out.append(item)
        while j < len(text) and text[j] == " ":
            j += 1
        if text[j:j + 1] == ",":
            j += 1
        elif text[j:j + 1] != "]":
            raise YamlSubsetError(f"{where}: expected ',' or ']' in a flow list")


def _value(text: str, where: str):
    """The scalar or flow list of a whole line's value."""
    if not text:
        return None
    if text[0] == "[":
        value, end = _flow_list(text, 0, where)
    elif text[0] in "'\"":
        value, end = _quoted(text, 0, where)
    else:
        return _plain_scalar(text, where)
    if text[end:].strip():
        raise YamlSubsetError(f"{where}: text after the value: {text[end:]!r}")
    return value


def _key(text: str, where: str):
    key = _plain_scalar(text, where)
    if key == "<<":
        raise YamlSubsetError(f"{where}: merge keys are outside the YAML subset")
    return key


def parse_yaml(text: str, name: str = "<string>"):
    """The value of a YAML document in the subset the port reads (see the
    module docstring): a dict, or None for an empty document, as
    ``yaml.safe_load`` gives it."""
    if "\t" in text:
        raise YamlSubsetError(f"{name}: tabs are outside the YAML subset")
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{n}"
        body = _strip_comment(raw, where)
        if not body.strip():
            continue
        if body.startswith(("---", "...")) and body[3:4] in ("", " "):
            if lines or body.startswith("...") or body[3:].strip():
                raise YamlSubsetError(f"{where}: several documents (or a document marker "
                                      "after content) are outside the YAML subset")
            continue
        lines.append((len(body) - len(body.lstrip(" ")), body.strip(), where))
    if not lines:
        return None
    if len(lines) == 1 and not _KEY.match(lines[0][1]):
        if lines[0][0]:
            raise YamlSubsetError(f"{lines[0][2]}: an indented top-level scalar")
        return _value(lines[0][1], lines[0][2])

    root: dict = {}
    stack = [(-1, root)]                  # (indent of the mapping's keys, mapping)
    pending = None                        # (mapping, key) awaiting a nested block
    for indent, body, where in lines:
        m = _KEY.match(body)
        if m is None:
            raise YamlSubsetError(f"{where}: {body!r} is not a 'key: value' line (block "
                                  "sequences and multi-line scalars are outside the subset)")
        if pending is not None:
            parent, key = pending
            if indent > stack[-1][0]:
                child: dict = {}
                parent[key] = child
                stack.append((indent, child))
            pending = None
        while len(stack) > 1 and indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            if stack[-1][0] == -1 and len(stack) == 1:
                stack[0] = (indent, root)
            else:
                raise YamlSubsetError(f"{where}: indentation {indent} matches no open "
                                      "mapping")
        mapping = stack[-1][1]
        key = _key(m.group(1), where)
        rest = m.group(2).strip()
        if rest:
            mapping[key] = _value(rest, where)
        else:
            mapping[key] = None
            pending = (mapping, key)
    return root


# ---------------------------------------------------------------------------
# merge and overrides
# ---------------------------------------------------------------------------

_JSON_NUMBER = re.compile(r"-?(?:0|[1-9]\d*)(?:\.\d+)?(?:[eE][-+]?\d+)?")
_JSON_STRING = re.compile(r'"(?:[^"\\\x00-\x1f]|\\(?:["\\/bfnrt]|u[0-9a-fA-F]{4}))*"')
_JSON_WORDS = ("true", "false", "null", "NaN", "Infinity", "-Infinity")


def _json_end(s: str, i: int) -> int:
    """Index past the JSON value at ``s[i:]`` (after white space), or -1
    where there is none: the grammar ``json.loads`` takes, NaN and the
    infinities included."""
    while i < len(s) and s[i] in " \t\n\r":
        i += 1
    if i >= len(s):
        return -1
    c = s[i]
    if c in "[{":
        close, i = "]" if c == "[" else "}", i + 1
        first = True
        while True:
            j = i
            while j < len(s) and s[j] in " \t\n\r":
                j += 1
            if j < len(s) and s[j] == close and first:
                return j + 1
            if c == "{":
                m = _JSON_STRING.match(s, j)
                if m is None:
                    return -1
                j = m.end()
                while j < len(s) and s[j] in " \t\n\r":
                    j += 1
                if s[j:j + 1] != ":":
                    return -1
                j += 1
            i = _json_end(s, j)
            if i < 0:
                return -1
            while i < len(s) and s[i] in " \t\n\r":
                i += 1
            if s[i:i + 1] == close:
                return i + 1
            if s[i:i + 1] != ",":
                return -1
            i, first = i + 1, False
    for word in _JSON_WORDS:
        if s.startswith(word, i):
            return i + len(word)
    m = (_JSON_STRING if c == '"' else _JSON_NUMBER).match(s, i)
    return m.end() if m else -1


def _is_json(s: str) -> bool:
    end = _json_end(s, 0)
    return end >= 0 and not s[end:].strip(" \t\n\r")


def _coerce(new_value: str, old_value: Any) -> Any:
    """Coerce a CLI string to the type of the existing config value: the
    existing value's type wins, and "false"/"False"/"0" give False for a
    bool (``bool("False")`` is True).  Without an existing value: the JSON
    value where the string is JSON, else the string."""
    if isinstance(old_value, bool):
        if new_value in ("false", "False", "0"):
            return False
        if new_value in ("true", "True", "1"):
            return True
        return bool(new_value)
    if isinstance(old_value, int):
        return int(new_value)
    if isinstance(old_value, float):
        return float(new_value)
    if isinstance(old_value, (list, dict)):
        return json.loads(new_value)
    if old_value is None:
        return json.loads(new_value) if _is_json(new_value) else new_value
    return type(old_value)(new_value)


def merge_dotted(base: dict, updates: Mapping[str, Any]) -> dict:
    """Merge ``updates`` into ``base`` where keys may be dotted paths.

    ``{"MODEL.BACKBONE.NAME": "focal"}`` creates/updates
    ``base["MODEL"]["BACKBONE"]["NAME"]``.  Plain nested dicts in ``updates``
    are merged recursively; scalars/lists replace.
    """
    for key, value in updates.items():
        parts = key.split(".")
        node = base
        for part in parts[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, dict):
                nxt = {}
                node[part] = nxt
            node = nxt
        leaf = parts[-1]
        if isinstance(value, Mapping) and isinstance(node.get(leaf), dict):
            merge_dotted(node[leaf], value)
        else:
            node[leaf] = copy.deepcopy(value) if isinstance(value, (dict, list)) else value
    return base


def apply_overrides(cfg: dict, pairs: Iterable[str]) -> dict:
    """Apply ``K V`` override pairs with type coercion from existing values."""
    pairs = list(pairs)
    if len(pairs) % 2 != 0:
        raise ValueError(f"--overrides expects K V pairs, got odd count: {pairs}")
    for key, raw in zip(pairs[::2], pairs[1::2]):
        parts = key.split(".")
        node = cfg
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        old = node.get(parts[-1])
        node[parts[-1]] = _coerce(raw, old)
    return cfg


class Config:
    """Immutable view over a nested config dict.

    Attribute access and item access both work; nested dicts come back as
    ``Config``.  ``get`` mirrors ``dict.get``.  Mutation raises.  The entry
    points take ``to_dict()``.
    """

    __slots__ = ("_data",)

    def __init__(self, data: dict):
        object.__setattr__(self, "_data", data)

    # -- read access ------------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        value = self._data[key]
        return Config(value) if isinstance(value, dict) else value

    def __getattr__(self, key: str) -> Any:
        if key == "_data" or key not in self._data:
            raise AttributeError(key)
        return self[key]

    def get(self, key: str, default: Any = None) -> Any:
        value = self._data.get(key, default)
        return Config(value) if isinstance(value, dict) else value

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        for k, v in self._data.items():
            yield k, (Config(v) if isinstance(v, dict) else v)

    def to_dict(self) -> dict:
        return copy.deepcopy(self._data)

    def __repr__(self) -> str:
        return f"Config({self._data!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, Config):
            return self._data == other._data
        return self._data == other

    # -- no mutation ------------------------------------------------------
    def __setattr__(self, key, value):
        raise TypeError("Config is immutable after load")

    def __setitem__(self, key, value):
        raise TypeError("Config is immutable after load")


def load_config(
    conf_files: Iterable[str],
    overrides: Iterable[str] = (),
    config_overrides_json: str | None = None,
) -> Config:
    """Load + merge YAML files (later files win), then apply overrides."""
    cfg: dict = {}
    for path in conf_files:
        with open(path) as f:
            loaded = parse_yaml(f.read(), str(path)) or {}
        if not isinstance(loaded, dict):
            raise YamlSubsetError(f"{path}: the document is not a mapping")
        merge_dotted(cfg, loaded)
    if config_overrides_json:
        merge_dotted(cfg, json.loads(config_overrides_json))
    apply_overrides(cfg, overrides)
    return Config(cfg)


def load_opt_command(argv: list[str] | None = None):
    """CLI parsing: ``command --conf_files ... [--config_overrides JSON]
    [--overrides K V ...]``.  Returns ``(Config, argparse.Namespace)``."""
    parser = argparse.ArgumentParser("cullavo_tpu_torch")
    parser.add_argument("command", choices=["train", "eval", "serve"])
    parser.add_argument("--conf_files", nargs="+", required=True)
    parser.add_argument("--config_overrides", default=None,
                        help="JSON dict of dotted-key overrides")
    parser.add_argument("--overrides", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)
    cfg = load_config(args.conf_files, args.overrides, args.config_overrides)
    return cfg, args
